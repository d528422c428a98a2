// Two-KV flash-attention forward for Hopper, f32: for each leading index b
//   out = (1 - α_b)·softmax(q·k0ᵀ·scale)·v0 + α_b·softmax(q·k1ᵀ·scale)·v1
// without materialising either Lq×Lk score matrix.
//
// Replaces: afldm_tpu/ops/attention.py::_flash2_kernel / _flash2_3d (K6),
// the CFA-interpolation attention of layers.Attention's kv_override2 branch.
// Same semantics: f32 scores, f32 online softmax per KV set, each set
// normalised by its own row sum, the blend in f32, one α per leading index.
//
// What bounds it on this card: arithmetic, as for flash_fwd.cu (K3). At the
// FFHQ interp shapes (D = 24, L = 1024) a head does 8·L²·D = 201 MFLOP
// against q, two K/V sets and out (~0.5 MB): far above the f32 ridge, and
// exact f32 keeps it off the tensor cores, so the ceiling is the f32 FMA
// rate. At L = 4 the launch and the idle rows of a tile dominate.
//
// What the design does about it: flash_fwd.cu's tile design — one block of
// 256 threads per (batch·head, 64-row Q tile), K/V walked in 64-row tiles
// staged in shared memory (rows padded to DP+1 floats), four threads per Q
// row, D zero-padded to DP in {32, 64, 128, 256}, ragged Lq/Lk masked, inputs
// read through (b1, b2, row) strides so K/V expanded from one image (stride
// 0) are never copied. The Q tile is staged once for both KV sets. Two live
// online-softmax states would double the per-thread accumulator (128 floats
// a thread at DP = 256) and spill, so the sets run one after the other with
// one accumulator: set 0 finishes and each thread writes (1-α)·o0 for its
// own elements of the output row, then set 1 runs and each thread adds α·o1
// to the same elements, which only it reads and writes. Tensor cores and a
// deeper pipeline are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 per Q row
constexpr int kPLD = kBK + 1;

// One KV set through the staged Q tile: leaves this thread's DP/4 columns of
// the unnormalised accumulator in acc and returns the row sum l.
template <int DP>
__device__ __forceinline__ float attend_set(
    const float* __restrict__ kb, const float* __restrict__ vb,
    long long ksl, long long vsl, int Lk, int D, float scale,
    const float* Qs, float* Ks, float* Vs, float* Ps, float (&acc)[DP / 4]) {
  constexpr int LD = DP + 1;
  constexpr int NACC = DP / 4;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c4 = tid & 3;

  float m = -INFINITY, l = 0.0f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int rr = i / DP, d = i - rr * DP;
      const bool ok = k0 + rr < Lk && d < D;
      Ks[rr * LD + d] = ok ? kb[(long long)(k0 + rr) * ksl + d] : 0.0f;
      Vs[rr * LD + d] = ok ? vb[(long long)(k0 + rr) * vsl + d] : 0.0f;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j)
        s[j] = fmaf(qv, Ks[(c4 + 4 * j) * LD + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      s[j] = (k0 + c4 + 4 * j < Lk) ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);   // finite: every tile has a valid key
    const float corr = expf(m - m_new);  // 0 on the first tile
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      Ps[r * kPLD + c4 + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same 4 lanes

#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] *= corr;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = Ps[r * kPLD + kk];
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        acc[j] = fmaf(p, Vs[kk * LD + c4 + 4 * j], acc[j]);
    }
  }
  return l;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash2_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k0,
                  const float* __restrict__ v0, const float* __restrict__ k1,
                  const float* __restrict__ v1,
                  const float* __restrict__ alpha, float* __restrict__ out,
                  int B2, int Lq, int Lk, int D,
                  long long qs1, long long qs2, long long qsl,
                  long long k0s1, long long k0s2, long long k0sl,
                  long long v0s1, long long v0s2, long long v0sl,
                  long long k1s1, long long k1s2, long long k1sl,
                  long long v1s1, long long v1s2, long long v1sl,
                  float scale, int n_qtiles) {
  constexpr int LD = DP + 1;
  constexpr int NACC = DP / 4;
  extern __shared__ float sm[];
  float* Qs = sm;                 // kBQ × LD
  float* Ks = Qs + kBQ * LD;      // kBK × LD
  float* Vs = Ks + kBK * LD;      // kBK × LD
  float* Ps = Vs + kBK * LD;      // kBQ × kPLD

  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * kBQ;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const float* qb = q + b1 * qs1 + b2 * qs2;

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c4 = tid & 3;

  // staged once for both sets; the first tile's __syncthreads publishes it
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int rr = i / DP, d = i - rr * DP;
    Qs[rr * LD + d] =
        (q0 + rr < Lq && d < D) ? qb[(long long)(q0 + rr) * qsl + d] : 0.0f;
  }

  const float a = alpha[b];
  const int row = q0 + r;
  float* ob = out + ((long long)b * Lq + (row < Lq ? row : 0)) * D;
  float acc[NACC];

  float l = attend_set<DP>(k0 + b1 * k0s1 + b2 * k0s2,
                           v0 + b1 * v0s1 + b2 * v0s2, k0sl, v0sl, Lk, D,
                           scale, Qs, Ks, Vs, Ps, acc);
  if (row < Lq) {
    const float inv = 1.0f / l;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) ob[d] = (1.0f - a) * (acc[j] * inv);
    }
  }

  l = attend_set<DP>(k1 + b1 * k1s1 + b2 * k1s2, v1 + b1 * v1s1 + b2 * v1s2,
                     k1sl, v1sl, Lk, D, scale, Qs, Ks, Vs, Ps, acc);
  if (row < Lq) {
    const float inv = 1.0f / l;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) ob[d] = ob[d] + a * (acc[j] * inv);
    }
  }
}

template <int DP>
int launch(const float* q, const float* k0, const float* v0, const float* k1,
           const float* v1, const float* alpha, float* out, int B1, int B2,
           int Lq, int Lk, int D, const long long* st, float scale,
           cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kBQ + 2 * kBK) * (DP + 1) + (size_t)kBQ * kPLD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash2_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_qtiles = (Lq + kBQ - 1) / kBQ;
  const long long blocks = (long long)B1 * B2 * n_qtiles;
  flash2_fwd_kernel<DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k0, v0, k1, v1, alpha, out, B2, Lq, Lk, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], scale, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// out is contiguous (B1, B2, Lq, D); alpha is contiguous (B1·B2); q, k0, v0,
// k1, v1 have unit stride along D and the given (b1, b2, row) strides in
// elements; k0, v0, k1, v1 share the shape (B1, B2, Lk, D).
extern "C" int flash2_fwd_f32(
    const float* q, const float* k0, const float* v0, const float* k1,
    const float* v1, const float* alpha, float* out, int B1, int B2, int Lq,
    int Lk, int D, long long qs1, long long qs2, long long qsl,
    long long k0s1, long long k0s2, long long k0sl, long long v0s1,
    long long v0s2, long long v0sl, long long k1s1, long long k1s2,
    long long k1sl, long long v1s1, long long v1s2, long long v1sl,
    float scale, void* stream) {
  const long long st[15] = {qs1, qs2, qsl, k0s1, k0s2, k0sl, v0s1, v0s2,
                            v0sl, k1s1, k1s2, k1sl, v1s1, v1s2, v1sl};
  cudaStream_t s = (cudaStream_t)stream;
#define AFLDM_FLASH2(DP) \
  return launch<DP>(q, k0, v0, k1, v1, alpha, out, B1, B2, Lq, Lk, D, st, \
                    scale, s)
  if (D <= 32) AFLDM_FLASH2(32);
  if (D <= 64) AFLDM_FLASH2(64);
  if (D <= 128) AFLDM_FLASH2(128);
  if (D <= 256) AFLDM_FLASH2(256);
#undef AFLDM_FLASH2
  return (int)cudaErrorInvalidValue;
}
