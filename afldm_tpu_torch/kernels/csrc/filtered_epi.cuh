// The filtered activation's activations and the epilogues of its products,
// shared by the plane kernels and the banded chains (filtered_act.cu) and
// K1's and K2's fused level chains (filtered_banded_mma.cu).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace afldm_filtered {

enum Act { SILU = 0, GELU = 1, RELU = 2, MISH = 3, LEAKY_RELU = 4, TANH = 5,
           LINEAR = 6, NONE = -1 };

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case SILU: return v / (1.0f + expf(-v));
    case GELU: {  // tanh approximation, as in the JAX package
      const float c = 0.7978845608028654f;
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case RELU: return fmaxf(v, 0.0f);
    case MISH: {
      float sp = v > 20.0f ? v : log1pf(expf(v));
      return v * tanhf(sp);
    }
    case LEAKY_RELU: return v >= 0.0f ? v : 0.2f * v;
    case TANH: return tanhf(v);
    default: return v;
  }
}

// act′(v), the derivatives of pallas_kernels.py::_act_and_grad: relu′(0) = 1
// and leaky_relu′(0) = 1 (x >= 0), gelu in its tanh approximation.
__device__ __forceinline__ float act_grad(float v, int act) {
  switch (act) {
    case SILU: {
      const float s = 1.0f / (1.0f + expf(-v));
      return s * (1.0f + v * (1.0f - s));
    }
    case GELU: {
      const float c = 0.7978845608028654f;
      const float t = tanhf(c * (v + 0.044715f * v * v * v));
      const float du = c * (1.0f + 3.0f * 0.044715f * v * v);
      return 0.5f * (1.0f + t) + 0.5f * v * (1.0f - t * t) * du;
    }
    case RELU: return v >= 0.0f ? 1.0f : 0.0f;
    case MISH: {
      const float sp = v > 20.0f ? v : log1pf(expf(v));
      const float t = tanhf(sp);
      return t + v * (1.0f - t * t) / (1.0f + expf(-v));
    }
    case LEAKY_RELU: return v >= 0.0f ? 1.0f : 0.2f;
    case TANH: {
      const float t = tanhf(v);
      return 1.0f - t * t;
    }
    default: return 1.0f;
  }
}

// The epilogues of filtered_tile.cuh's products and of the tiled GEMM
// (filtered_gemm.cuh), which reads C first where kReadsC.
struct Identity {
  static constexpr bool kReadsC = false;
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct Activation {
  static constexpr bool kReadsC = false;
  int act;
  __device__ __forceinline__ float operator()(float v) const {
    return apply_act(v, act);
  }
  // v[i] = act(v[i]) for N values, the act chosen once for all of them
  // (K5's middle pair): each case is apply_act's own arithmetic
  template <int N>
  __device__ __forceinline__ void map(float (&v)[N]) const {
    const auto each = [&](int a) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = apply_act(v[i], a);
    };
    switch (act) {
      case SILU: each(SILU); break;
      case GELU: each(GELU); break;
      case RELU: each(RELU); break;
      case MISH: each(MISH); break;
      case LEAKY_RELU: each(LEAKY_RELU); break;
      case TANH: each(TANH); break;
      default: break;
    }
  }
};
// act′(C's old value) ⊙ the product: K5b's mᵀ and K2's m, over the
// pre-activation
struct MulActGrad {
  static constexpr bool kReadsC = true;
  int act;
  __device__ __forceinline__ float operator()(float v, float old) const {
    return act_grad(old, act) * v;
  }
  // v[i] = act′(v[i]) for N values, the act chosen once for all of them
  // (K2's fused level chain, which multiplies the cotangent's product in
  // afterwards): each case is act_grad's own arithmetic
  template <int N>
  __device__ __forceinline__ void grads(float (&v)[N]) const {
    const auto each = [&](int a) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = act_grad(v[i], a);
    };
    switch (act) {
      case SILU: each(SILU); break;
      case GELU: each(GELU); break;
      case RELU: each(RELU); break;
      case MISH: each(MISH); break;
      case LEAKY_RELU: each(LEAKY_RELU); break;
      case TANH: each(TANH); break;
      default: each(NONE); break;
    }
  }
};

}  // namespace afldm_filtered
