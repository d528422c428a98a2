// Filtered activation (the alias-free "warped nonlinearity") for Hopper, f32.
//
//   out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ      for every (n, c) plane of NCHW x
//
// U (2N×N) is the ideal 2x upsampling operator and D (N×2N) the ideal
// low-pass + decimate operator, both dense circulant, built on the host
// (afldm_tpu_torch/ops/ideal_lpf.py) and passed in; the W-side operators
// arrive transposed (U_wᵀ: W×2W, D_wᵀ: 2W×W) so every product below reads
// row-major operands.
//
// and its VJP for whole planes,
//
//   dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w
//
// Replaces:
//   filtered_act_plane     <- afldm_tpu/ops/pallas_kernels.py::_forward (K5)
//   filtered_act_plane_bwd <- the kernel inside pallas_kernels.py::_bwd_rule
//                             (K5b)
//   filtered_act_banded    <- afldm_tpu/ops/pallas_kernels.py::_forward_spatial (K1)
//   filtered_act_banded_bwd <- afldm_tpu/ops/pallas_kernels.py::_bwd_spatial (K2)
//
// What bounds it on this card: arithmetic. A plane of side S costs
// 24·S³ FLOP (four products) against 8·S² bytes of input and output, so at
// 32-128 px it does 100-400 FLOP per byte, far above the f32 ridge of
// 67 TFLOP/s ÷ 3.35 TB/s ≈ 20. Without tensor cores (exact f32 is the
// parity default) the ceiling is the f32 FMA rate.
//
// What the design does about it: the 2H×2W intermediate never leaves the
// SM, so device memory sees each input and output once; each thread keeps
// a 4×4 register tile of its product so one pair of operand loads feeds
// 16 FMAs. The TPU's lane-multiple-of-128 and 10 MB VMEM rules do not
// apply here: the limit is the 227 KB of shared memory of a block.
//   * plane (H, W <= 64): one block holds P whole planes (P·24·H·W bytes:
//     the input staged inside the 2x intermediate, which it outlives, plus a
//     2H×W half-resampled buffer). Small planes are packed P to a block so
//     that 256 threads have work.
//   * banded (96-512 px): at 128 px the 2x plane alone is 256 KB, over the
//     limit. The 2H intermediate rows are walked in bands of R rows:
//       u = U_h[r,:]·x ;  h = act(u·U_wᵀ) ;  t = h·D_wᵀ ;  acc += D_h[:,r]·t
//     so only R×3W floats of intermediate live in shared memory. The H×W
//     accumulator stays in shared memory up to 64 KB (128 px); above that it
//     accumulates in the output plane itself, which only this block touches.
//     x is read from device memory (L1/L2-resident) once per band.
//   * plane backward (H, W <= 64): six products per plane, 12H²W + 24HW²
//     FLOP (36·S³, 1.5x the forward), again arithmetic-bound. Like the JAX
//     rule it saves x, not the 4x pre-activation, and recomputes it. One
//     block holds P planes of 7·H·W floats: the 2H×2W pre-activation (x is
//     staged inside it), g, and one 2H×W temporary. act′(pre) ⊙ (D_hᵀ g D_w)
//     is formed in the epilogue of the last product of g's chain, in place
//     over the pre-activation, so the 2x cotangent is never stored: 28 KB a
//     plane at 32 px, 112 KB at 64 px (one plane a block).
//   * banded backward (96-512 px): the same six products, 12H²W + 24HW²
//     FLOP. The TPU kernel holds the 2H×2W pre-activation and cotangent of
//     a whole plane in VMEM (512 KB at 128 px); here the 2H rows are walked
//     in bands of R, as in the banded forward:
//       u = U_h[r,:]·x ;  pre = u·U_wᵀ ;  v = D_hᵀ[r,:]·g ;
//       m = act′(pre) ⊙ (v·D_w) ;  t = m·U_w ;  dx += U_hᵀ[:,r]·t
//     u, v and t share one R×W buffer and pre/m one R×2W buffer (m formed
//     in the epilogue of v·D_w, in place over pre), so a band costs 3·R·W
//     floats, 48 KB at 128 px with R = 32; the H×W accumulator follows the
//     forward's rule (shared memory up to 64 KB, else the block's dx plane).
// Operators are read through the read-only path from device memory; every
// block reads the same few KB, which stay in L2 and L1.
// Making it fast (tensor-core TF32 splits, wgmma, TMA) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// How block_gemm writes its product P into C.
enum Epilogue {
  STORE = 0,     // C = act(P)  (act NONE: C = P)
  ACCUM = 1,     // C += P
  MUL_DACT = 2,  // C = act′(C) ⊙ P, C read and written by the same thread
};

// C[p] (epilogue) A[p] · B[p] for p < P, all row-major with leading
// dimensions lda/ldb/ldc and per-plane strides sA/sB/sC (0: shared by all
// planes). M and N are multiples of 4. Thread t owns the 4×4 tile of rows
// {tm + i·M/4} and cols {tn + j·N/4}: neighbouring threads read
// neighbouring B columns (conflict-free, coalesced) and mostly the same A
// element (a broadcast).
template <int EPI>
__device__ __forceinline__ void block_gemm(
    const float* __restrict__ A, int lda, long long sA,
    const float* __restrict__ B, int ldb, long long sB,
    float* __restrict__ C, int ldc, long long sC,
    int P, int M, int N, int K, int act) {
  const int tm_n = M >> 2, tn_n = N >> 2;
  const int tiles = tm_n * tn_n;
  for (int t = threadIdx.x; t < P * tiles; t += blockDim.x) {
    const int p = t / tiles;
    const int r = t - p * tiles;
    const int tm = r / tn_n, tn = r - tm * tn_n;
    const float* a = A + p * sA + (long long)tm * lda;
    const float* b = B + p * sB + tn;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const long long a_step = (long long)tm_n * lda;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[i * a_step + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[(long long)k * ldb + j * tn_n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    float* c = C + p * sC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long idx = (long long)(tm + i * tm_n) * ldc + tn + j * tn_n;
        if (EPI == ACCUM) {
          c[idx] += acc[i][j];
        } else if (EPI == MUL_DACT) {
          c[idx] = act_grad(c[idx], act) * acc[i][j];
        } else {
          c[idx] = act == NONE ? acc[i][j] : apply_act(acc[i][j], act);
        }
      }
    }
  }
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
filtered_act_plane_kernel(const float* __restrict__ x, float* __restrict__ out,
                          const float* __restrict__ uh,
                          const float* __restrict__ uwT,
                          const float* __restrict__ dh,
                          const float* __restrict__ dwT,
                          int nplanes, int H, int W, int ppb, int act) {
  extern __shared__ float smem[];
  const long long HW = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * ppb;
  const int P = min((long long)ppb, nplanes - p0);
  float* hi = smem;               // P × (2H×2W); x is staged here first
  float* t = smem + ppb * 4 * HW;  // P × (2H×W)
  const float* xg = x + p0 * HW;
  for (long long i = threadIdx.x; i < P * HW; i += blockDim.x) hi[i] = xg[i];
  __syncthreads();
  // t = U_h · x                      (2H × W)
  block_gemm<STORE>(uh, H, 0, hi, W, HW, t, W, 2 * HW, P, 2 * H, W, H, NONE);
  __syncthreads();
  // hi = act(t · U_wᵀ)               (2H × 2W); overwrites the staged x
  block_gemm<STORE>(t, W, 2 * HW, uwT, 2 * W, 0, hi, 2 * W, 4 * HW, P, 2 * H,
                    2 * W, W, act);
  __syncthreads();
  // t = hi · D_wᵀ                    (2H × W)
  block_gemm<STORE>(hi, 2 * W, 4 * HW, dwT, W, 0, t, W, 2 * HW, P, 2 * H, W,
                    2 * W, NONE);
  __syncthreads();
  // out = D_h · t                    (H × W), straight to device memory
  block_gemm<STORE>(dh, 2 * H, 0, t, W, 2 * HW, out + p0 * HW, W, HW, P, H, W,
                    2 * H, NONE);
}

// dx for P planes a block. Operators, all row-major: uh = U_h (2H×H),
// uwT = U_wᵀ (W×2W), dhT = D_hᵀ (2H×H), dw = D_w (W×2W), uw = U_w (2W×W),
// uhT = U_hᵀ (H×2H).
__global__ void __launch_bounds__(kThreads)
filtered_act_plane_bwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ g,
                              float* __restrict__ dx,
                              const float* __restrict__ uh,
                              const float* __restrict__ uwT,
                              const float* __restrict__ dhT,
                              const float* __restrict__ dw,
                              const float* __restrict__ uw,
                              const float* __restrict__ uhT,
                              int nplanes, int H, int W, int ppb, int act) {
  extern __shared__ float smem[];
  const long long HW = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * ppb;
  const int P = min((long long)ppb, nplanes - p0);
  float* hi = smem;                 // P × (2H×2W); x is staged here first
  float* t = hi + ppb * 4 * HW;     // P × (2H×W)
  float* gs = t + ppb * 2 * HW;     // P × (H×W)
  const float* xg = x + p0 * HW;
  const float* gg = g + p0 * HW;
  for (long long i = threadIdx.x; i < P * HW; i += blockDim.x) {
    hi[i] = xg[i];
    gs[i] = gg[i];
  }
  __syncthreads();
  // t = U_h · x                      (2H × W)
  block_gemm<STORE>(uh, H, 0, hi, W, HW, t, W, 2 * HW, P, 2 * H, W, H, NONE);
  __syncthreads();
  // hi = t · U_wᵀ = pre              (2H × 2W); overwrites the staged x
  block_gemm<STORE>(t, W, 2 * HW, uwT, 2 * W, 0, hi, 2 * W, 4 * HW, P, 2 * H,
                    2 * W, W, NONE);
  __syncthreads();
  // t = D_hᵀ · g                     (2H × W)
  block_gemm<STORE>(dhT, H, 0, gs, W, HW, t, W, 2 * HW, P, 2 * H, W, H, NONE);
  __syncthreads();
  // hi = act′(pre) ⊙ (t · D_w) = m   (2H × 2W), in place
  block_gemm<MUL_DACT>(t, W, 2 * HW, dw, 2 * W, 0, hi, 2 * W, 4 * HW, P,
                       2 * H, 2 * W, W, act);
  __syncthreads();
  // t = m · U_w                      (2H × W)
  block_gemm<STORE>(hi, 2 * W, 4 * HW, uw, W, 0, t, W, 2 * HW, P, 2 * H, W,
                    2 * W, NONE);
  __syncthreads();
  // dx = U_hᵀ · t                    (H × W), straight to device memory
  block_gemm<STORE>(uhT, 2 * H, 0, t, W, 2 * HW, dx + p0 * HW, W, HW, P, H, W,
                    2 * H, NONE);
}

__global__ void __launch_bounds__(kThreads)
filtered_act_banded_kernel(const float* __restrict__ x, float* __restrict__ out,
                           const float* __restrict__ uh,
                           const float* __restrict__ uwT,
                           const float* __restrict__ dh,
                           const float* __restrict__ dwT,
                           int H, int W, int R, int acc_in_smem, int act) {
  extern __shared__ float smem[];
  const long long HW = (long long)H * W;
  const float* xp = x + blockIdx.x * HW;
  float* op = out + blockIdx.x * HW;
  float* u = smem;                  // R × W, reused for t
  float* hb = smem + R * W;         // R × 2W
  float* acc = acc_in_smem ? hb + 2 * R * W : op;  // H × W
  for (long long i = threadIdx.x; i < HW; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  for (int r0 = 0; r0 < 2 * H; r0 += R) {
    // u = U_h[r0:r0+R, :] · x        (R × W)
    block_gemm<STORE>(uh + (long long)r0 * H, H, 0, xp, W, 0, u, W, 0, 1, R,
                      W, H, NONE);
    __syncthreads();
    // hb = act(u · U_wᵀ)             (R × 2W)
    block_gemm<STORE>(u, W, 0, uwT, 2 * W, 0, hb, 2 * W, 0, 1, R, 2 * W, W,
                      act);
    __syncthreads();
    // u = hb · D_wᵀ                  (R × W)
    block_gemm<STORE>(hb, 2 * W, 0, dwT, W, 0, u, W, 0, 1, R, W, 2 * W, NONE);
    __syncthreads();
    // acc += D_h[:, r0:r0+R] · u     (H × W)
    block_gemm<ACCUM>(dh + r0, 2 * H, 0, u, W, 0, acc, W, 0, 1, H, W, R, NONE);
    __syncthreads();
  }
  if (acc_in_smem)
    for (long long i = threadIdx.x; i < HW; i += blockDim.x) op[i] = acc[i];
}

// dx for one 96-512 px plane a block, the 2H rows walked in bands of R.
// Operators as for filtered_act_plane_bwd_kernel.
__global__ void __launch_bounds__(kThreads)
filtered_act_banded_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ g,
                               float* __restrict__ dx,
                               const float* __restrict__ uh,
                               const float* __restrict__ uwT,
                               const float* __restrict__ dhT,
                               const float* __restrict__ dw,
                               const float* __restrict__ uw,
                               const float* __restrict__ uhT,
                               int H, int W, int R, int acc_in_smem, int act) {
  extern __shared__ float smem[];
  const long long HW = (long long)H * W;
  const float* xp = x + blockIdx.x * HW;
  const float* gp = g + blockIdx.x * HW;
  float* op = dx + blockIdx.x * HW;
  float* ub = smem;                 // R × W: u, then v, then t
  float* hb = smem + R * W;         // R × 2W: pre, then m
  float* acc = acc_in_smem ? hb + 2 * R * W : op;  // H × W
  for (long long i = threadIdx.x; i < HW; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  for (int r0 = 0; r0 < 2 * H; r0 += R) {
    // ub = U_h[r0:r0+R, :] · x         (R × W)
    block_gemm<STORE>(uh + (long long)r0 * H, H, 0, xp, W, 0, ub, W, 0, 1, R,
                      W, H, NONE);
    __syncthreads();
    // hb = ub · U_wᵀ = pre             (R × 2W)
    block_gemm<STORE>(ub, W, 0, uwT, 2 * W, 0, hb, 2 * W, 0, 1, R, 2 * W, W,
                      NONE);
    __syncthreads();
    // ub = D_hᵀ[r0:r0+R, :] · g        (R × W)
    block_gemm<STORE>(dhT + (long long)r0 * H, H, 0, gp, W, 0, ub, W, 0, 1, R,
                      W, H, NONE);
    __syncthreads();
    // hb = act′(pre) ⊙ (ub · D_w) = m  (R × 2W), in place
    block_gemm<MUL_DACT>(ub, W, 0, dw, 2 * W, 0, hb, 2 * W, 0, 1, R, 2 * W, W,
                         act);
    __syncthreads();
    // ub = hb · U_w                    (R × W)
    block_gemm<STORE>(hb, 2 * W, 0, uw, W, 0, ub, W, 0, 1, R, W, 2 * W, NONE);
    __syncthreads();
    // acc += U_hᵀ[:, r0:r0+R] · ub     (H × W)
    block_gemm<ACCUM>(uhT + r0, 2 * H, 0, ub, W, 0, acc, W, 0, 1, H, W, R,
                      NONE);
    __syncthreads();
  }
  if (acc_in_smem)
    for (long long i = threadIdx.x; i < HW; i += blockDim.x) op[i] = acc[i];
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int filtered_act_plane_f32(const float* x, float* out,
                                      const float* uh, const float* uwT,
                                      const float* dh, const float* dwT,
                                      int nplanes, int H, int W, int ppb,
                                      int act, void* stream) {
  const size_t smem = (size_t)ppb * 6 * H * W * sizeof(float);
  int err = set_smem((const void*)filtered_act_plane_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (nplanes + ppb - 1) / ppb;
  filtered_act_plane_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, uh, uwT, dh, dwT, nplanes, H, W, ppb, act);
  return (int)cudaGetLastError();
}

extern "C" int filtered_act_plane_bwd_f32(
    const float* x, const float* g, float* dx, const float* uh,
    const float* uwT, const float* dhT, const float* dw, const float* uw,
    const float* uhT, int nplanes, int H, int W, int ppb, int act,
    void* stream) {
  const size_t smem = (size_t)ppb * 7 * H * W * sizeof(float);
  int err = set_smem((const void*)filtered_act_plane_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (nplanes + ppb - 1) / ppb;
  filtered_act_plane_bwd_kernel<<<blocks, kThreads, smem,
                                  (cudaStream_t)stream>>>(
      x, g, dx, uh, uwT, dhT, dw, uw, uhT, nplanes, H, W, ppb, act);
  return (int)cudaGetLastError();
}

extern "C" int filtered_act_banded_f32(const float* x, float* out,
                                       const float* uh, const float* uwT,
                                       const float* dh, const float* dwT,
                                       int nplanes, int H, int W, int R,
                                       int acc_in_smem, int act,
                                       void* stream) {
  const size_t smem =
      ((size_t)3 * R * W + (acc_in_smem ? (size_t)H * W : 0)) * sizeof(float);
  int err = set_smem((const void*)filtered_act_banded_kernel, smem);
  if (err != cudaSuccess) return err;
  filtered_act_banded_kernel<<<nplanes, kThreads, smem,
                               (cudaStream_t)stream>>>(
      x, out, uh, uwT, dh, dwT, H, W, R, acc_in_smem, act);
  return (int)cudaGetLastError();
}

extern "C" int filtered_act_banded_bwd_f32(
    const float* x, const float* g, float* dx, const float* uh,
    const float* uwT, const float* dhT, const float* dw, const float* uw,
    const float* uhT, int nplanes, int H, int W, int R, int acc_in_smem,
    int act, void* stream) {
  const size_t smem =
      ((size_t)3 * R * W + (acc_in_smem ? (size_t)H * W : 0)) * sizeof(float);
  int err = set_smem((const void*)filtered_act_banded_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  filtered_act_banded_bwd_kernel<<<nplanes, kThreads, smem,
                                   (cudaStream_t)stream>>>(
      x, g, dx, uh, uwT, dhT, dw, uw, uhT, H, W, R, acc_in_smem, act);
  return (int)cudaGetLastError();
}
