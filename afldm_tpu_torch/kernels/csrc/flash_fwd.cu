// Flash-attention forward for Hopper, f32: out = softmax(q·kᵀ·scale)·v and
// the per-row logsumexp, never materialising the Lq×Lk score matrix.
//
// Replaces: afldm_tpu/ops/attention.py::_flash_kernel / _flash_3d (K3).
// Same semantics: f32 scores, f32 online softmax, p in v's dtype (f32
// here) for p·v; lse = m + log(l), shape (B, Lq, 1).
//
// What bounds it on this card: at the UNet's shapes (D = 24, L <= 1024)
// arithmetic. A 1024-token head does 4·L²·D = 100 MFLOP against 4·L·D·4 =
// 0.4 MB of q, k, v and out: ~250 FLOP per byte, far above the f32 ridge
// (~20). Exact f32 keeps it off the tensor cores, so the ceiling is the f32
// FMA rate; at L = 4 and 16 the launch and the idle rows of a tile dominate.
//
// What the design does about it: one block of 256 threads per
// (batch·head, 64-row Q tile) walks the K/V sequence in 64-row tiles staged
// in shared memory (rows padded to DP+1 floats: conflict-free column reads).
// Four threads share a Q row: each computes 16 of the tile's 64 scores,
// the row max and sum are combined with two warp shuffles, and each keeps
// DP/4 of the row's f32 accumulator in registers. D is zero-padded to
// DP in {32, 64, 128, 256} inside the kernel (zeros do not change q·kᵀ) and
// the padding is never written out. Ragged Lq and Lk are masked: a key
// beyond Lk scores -inf, a query beyond Lq is computed on zeros and not
// stored. Inputs are addressed through (b1, b2, row) strides, so a K/V batch
// expanded from 1 (stride 0, the CFA LOAD pass) is read without a copy.
// Tensor cores (TF32 or bf16 with an accuracy check), TMA and a deeper
// pipeline are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 per Q row
constexpr int kPLD = kBK + 1;

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int B2, int Lq, int Lk, int D,
                 long long qs1, long long qs2, long long qsl,
                 long long ks1, long long ks2, long long ksl,
                 long long vs1, long long vs2, long long vsl, float scale,
                 int n_qtiles) {
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
  const float* kb = k + b1 * ks1 + b2 * ks2;
  const float* vb = v + b1 * vs1 + b2 * vs2;

  const int tid = threadIdx.x;
  const int r = tid >> 2;    // Q row within the tile
  const int c4 = tid & 3;    // this thread's column phase

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int rr = i / DP, d = i - rr * DP;
    Qs[rr * LD + d] =
        (q0 + rr < Lq && d < D) ? qb[(long long)(q0 + rr) * qsl + d] : 0.0f;
  }

  float m = -INFINITY, l = 0.0f;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs are no longer read
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

  const int row = q0 + r;
  if (row < Lq) {
    float* ob = out + ((long long)b * Lq + row) * D;
    const float inv = 1.0f / l;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) ob[d] = acc[j] * inv;
    }
    if (c4 == 0) lse[(long long)b * Lq + row] = m + logf(l);
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B1, int B2, int Lq, int Lk, int D, long long qs1,
           long long qs2, long long qsl, long long ks1, long long ks2,
           long long ksl, long long vs1, long long vs2, long long vsl,
           float scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kBQ + 2 * kBK) * (DP + 1) + (size_t)kBQ * kPLD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_qtiles = (Lq + kBQ - 1) / kBQ;
  const long long blocks = (long long)B1 * B2 * n_qtiles;
  flash_fwd_kernel<DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, out, lse, B2, Lq, Lk, D, qs1, qs2, qsl, ks1, ks2, ksl, vs1,
      vs2, vsl, scale, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// out and lse are contiguous (B1, B2, Lq, D) and (B1, B2, Lq); q, k, v have
// unit stride along D and the given (b1, b2, row) strides in elements.
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* out, float* lse, int B1, int B2, int Lq,
                             int Lk, int D, long long qs1, long long qs2,
                             long long qsl, long long ks1, long long ks2,
                             long long ksl, long long vs1, long long vs2,
                             long long vsl, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define AFLDM_FLASH(DP)                                                       \
  return launch<DP>(q, k, v, out, lse, B1, B2, Lq, Lk, D, qs1, qs2, qsl, ks1, \
                    ks2, ksl, vs1, vs2, vsl, scale, s)
  if (D <= 32) AFLDM_FLASH(32);
  if (D <= 64) AFLDM_FLASH(64);
  if (D <= 128) AFLDM_FLASH(128);
  if (D <= 256) AFLDM_FLASH(256);
#undef AFLDM_FLASH
  return (int)cudaErrorInvalidValue;
}
