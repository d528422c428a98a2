// Flash-attention backward for Hopper, f32: given q, k, v, the forward's
// per-row logsumexp lse and dO, and delta = rowsum(dO ⊙ O) (computed outside,
// as the JAX package does at attention.py:282),
//
//   p  = exp(q·kᵀ·scale − lse)             (recomputed, never stored)
//   ds = p ⊙ (dO·vᵀ − delta) · scale
//   dq = ds · k,   dk = dsᵀ · q,   dv = pᵀ · dO
//
// Replaces:
//   flash_bwd_dq  <- afldm_tpu/ops/attention.py::_flash_bwd_dq_kernel (K4a)
//   flash_bwd_dkv <- afldm_tpu/ops/attention.py::_flash_bwd_dkv_kernel (K4b)
//
// What bounds it on this card: at the UNet's shapes (D = 24, L <= 1024)
// arithmetic. A 1024-token head costs dq 6·L²·D and dkv 8·L²·D FLOP (150 and
// 200 MFLOP) against ~0.5 MB of q, k, v, dO, lse, delta and the gradients:
// ~700 FLOP per byte, far above the f32 ridge (~20); exact f32 keeps it off
// the tensor cores, so the ceiling is the f32 FMA rate.
//
// What the design does about it: the TPU kernels carry their accumulators
// across a sequential grid axis in VMEM scratch; here that axis becomes a
// loop inside one block of 256 threads, and the accumulators stay in
// registers.
//   * dq: one block per (batch·head, 64-row Q tile) keeps the Q and dO tiles
//     in shared memory and walks K/V in tiles of BK rows. Four threads share
//     a Q row: each scores BK/4 keys (q·k and dO·v in one pass over D), forms
//     ds, writes it to a shared row, and accumulates DP/4 columns of dq.
//   * dkv: one block per (batch·head, 64-row K/V tile) keeps K and V in
//     shared memory and walks Q/dO in tiles of BQ rows. Four threads share a
//     key row and keep DP/4 columns of both dk and dv in registers; p and ds
//     go through shared rows as above.
// D is zero-padded to DP in {32, 64, 128, 256} in shared memory (zeros change
// no dot product) and the padding is never written. Ragged lengths are
// masked: a key beyond Lk or a query beyond Lq gets p = ds = 0 and is not
// stored. q, k, v and dO are read through (b1, b2, row) strides with a unit
// stride along D, so a K/V batch expanded from 1 (stride 0, the CFA LOAD
// pass) and a transposed dO are read without copies; dq, dk and dv are
// written dense per (b1, b2), and autograd sums dk, dv over an expanded
// batch. Rows are padded to DP+1 floats: conflict-free column reads.
// Tensor cores (3xTF32 or bf16 with an accuracy check), TMA and a fused
// single-pass dq/dkv with atomics are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // Q rows of a dq block, K/V rows of a dkv block
constexpr int kThreads = 256;  // 4 per row

struct Strides {
  long long b1, b2, row;
};

__device__ __forceinline__ const float* base(const float* t, const Strides& s,
                                             int b1, int b2) {
  return t + b1 * s.b1 + b2 * s.b2;
}

// rows [r0, r0 + n) of a (L, D) matrix into an n × LD shared tile, zero
// beyond L and beyond D
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld_src, int r0, int n,
                                          int L, int D) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int rr = i / DP, d = i - rr * DP;
    dst[rr * LD + d] =
        (r0 + rr < L && d < D) ? src[(long long)(r0 + rr) * ld_src + d] : 0.0f;
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int B2, int Lq, int Lk, int D, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale, int n_qtiles) {
  constexpr int LD = DP + 1;
  constexpr int NACC = DP / 4;
  constexpr int NS = BK / 4;
  constexpr int PLD = BK + 1;
  extern __shared__ float sm[];
  float* Qs = sm;                  // kRows × LD
  float* Os = Qs + kRows * LD;     // kRows × LD  (dO)
  float* Ks = Os + kRows * LD;     // BK × LD
  float* Vs = Ks + BK * LD;        // BK × LD
  float* Ps = Vs + BK * LD;        // kRows × PLD (ds)

  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * kRows;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const float* kb = base(k, ks, b1, b2);
  const float* vb = base(v, vs, b1, b2);

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c4 = tid & 3;
  const int row = q0 + r;

  load_tile<DP>(Qs, base(q, qs, b1, b2), qs.row, q0, kRows, Lq, D);
  load_tile<DP>(Os, base(dout, os, b1, b2), os.row, q0, kRows, Lq, D);
  const float lse_r = row < Lq ? lse[(long long)b * Lq + row] : 0.0f;
  const float dl_r = row < Lq ? delta[(long long)b * Lq + row] : 0.0f;

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    load_tile<DP>(Ks, kb, ks.row, k0, BK, Lk, D);
    load_tile<DP>(Vs, vb, vs.row, k0, BK, Lk, D);
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      const float qv = Qs[r * LD + d];
      const float ov = Os[r * LD + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j] = fmaf(qv, Ks[(c4 + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(ov, Vs[(c4 + 4 * j) * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p =
          (k0 + c4 + 4 * j < Lk) ? expf(s[j] * scale - lse_r) : 0.0f;
      Ps[r * PLD + c4 + 4 * j] = p * (dp[j] - dl_r) * scale;
    }
    __syncwarp();  // a row's ds is written and read by the same 4 lanes

    for (int kk = 0; kk < BK; ++kk) {
      const float ds = Ps[r * PLD + kk];
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        acc[j] = fmaf(ds, Ks[kk * LD + c4 + 4 * j], acc[j]);
    }
  }

  if (row < Lq) {
    float* out = dq + ((long long)b * Lq + row) * D;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) out[d] = acc[j];
    }
  }
}

template <int DP, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int B2, int Lq, int Lk, int D,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, int n_ktiles) {
  constexpr int LD = DP + 1;
  constexpr int NACC = DP / 4;
  constexpr int NS = BQ / 4;
  constexpr int PLD = BQ + 1;
  extern __shared__ float sm[];
  float* Ks = sm;                  // kRows × LD
  float* Vs = Ks + kRows * LD;     // kRows × LD
  float* Qs = Vs + kRows * LD;     // BQ × LD
  float* Os = Qs + BQ * LD;        // BQ × LD  (dO)
  float* Ps = Os + BQ * LD;        // kRows × PLD (p)
  float* Ds = Ps + kRows * PLD;    // kRows × PLD (ds)
  float* Ls = Ds + kRows * PLD;    // BQ (lse)
  float* Dl = Ls + BQ;             // BQ (delta)

  const int b = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x - b * n_ktiles) * kRows;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const float* qb = base(q, qs, b1, b2);
  const float* ob = base(dout, os, b1, b2);

  const int tid = threadIdx.x;
  const int r = tid >> 2;  // key row within the tile
  const int c4 = tid & 3;

  load_tile<DP>(Ks, base(k, ks, b1, b2), ks.row, k0, kRows, Lk, D);
  load_tile<DP>(Vs, base(v, vs, b1, b2), vs.row, k0, kRows, Lk, D);

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) dk_acc[j] = dv_acc[j] = 0.0f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    __syncthreads();  // the previous tile's Qs/Os/Ps/Ds are no longer read
    load_tile<DP>(Qs, qb, qs.row, q0, BQ, Lq, D);
    load_tile<DP>(Os, ob, os.row, q0, BQ, Lq, D);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool ok = q0 + i < Lq;
      Ls[i] = ok ? lse[(long long)b * Lq + q0 + i] : 0.0f;
      Dl[i] = ok ? delta[(long long)b * Lq + q0 + i] : 0.0f;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      const float kv = Ks[r * LD + d];
      const float vv = Vs[r * LD + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j] = fmaf(kv, Qs[(c4 + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(vv, Os[(c4 + 4 * j) * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int i = c4 + 4 * j;
      const float p = (q0 + i < Lq) ? expf(s[j] * scale - Ls[i]) : 0.0f;
      Ps[r * PLD + i] = p;
      Ds[r * PLD + i] = p * (dp[j] - Dl[i]) * scale;
    }
    __syncwarp();  // a key row's p and ds are written and read by 4 lanes

    for (int ii = 0; ii < BQ; ++ii) {
      const float p = Ps[r * PLD + ii];
      const float ds = Ds[r * PLD + ii];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        dv_acc[j] = fmaf(p, Os[ii * LD + c4 + 4 * j], dv_acc[j]);
        dk_acc[j] = fmaf(ds, Qs[ii * LD + c4 + 4 * j], dk_acc[j]);
      }
    }
  }

  const int krow = k0 + r;
  if (krow < Lk) {
    const long long off = ((long long)b * Lk + krow) * D;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = c4 + 4 * j;
      if (d < D) {
        dk[off + d] = dk_acc[j];
        dv[off + d] = dv_acc[j];
      }
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the inner tile: 64 rows up to DP = 128, 32 at DP = 256 (shared memory)
template <int DP>
constexpr int inner_rows() {
  return DP <= 128 ? 64 : 32;
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, int B1, int B2,
              int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
              Strides os, float scale, cudaStream_t stream) {
  constexpr int BK = inner_rows<DP>();
  const size_t smem =
      ((size_t)(2 * kRows + 2 * BK) * (DP + 1) + (size_t)kRows * (BK + 1)) *
      sizeof(float);
  int err = set_smem((const void*)flash_bwd_dq_kernel<DP, BK>, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Lq + kRows - 1) / kRows;
  const long long blocks = (long long)B1 * B2 * n_qtiles;
  flash_bwd_dq_kernel<DP, BK><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, B2, Lq, Lk, D, qs, ks, vs, os, scale,
      n_qtiles);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B1, int B2, int Lq, int Lk, int D,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               cudaStream_t stream) {
  constexpr int BQ = inner_rows<DP>();
  const size_t smem =
      ((size_t)(2 * kRows + 2 * BQ) * (DP + 1) +
       (size_t)2 * kRows * (BQ + 1) + 2 * BQ) * sizeof(float);
  int err = set_smem((const void*)flash_bwd_dkv_kernel<DP, BQ>, smem);
  if (err != cudaSuccess) return err;
  const int n_ktiles = (Lk + kRows - 1) / kRows;
  const long long blocks = (long long)B1 * B2 * n_ktiles;
  flash_bwd_dkv_kernel<DP, BQ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, B2, Lq, Lk, D, qs, ks, vs, os, scale,
      n_ktiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dq is contiguous (B1, B2, Lq, D); lse and delta contiguous (B1, B2, Lq);
// q, k, v and dO have unit stride along D and the given (b1, b2, row)
// strides in elements.
extern "C" int flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                const float* dout, const float* lse,
                                const float* delta, float* dq, int B1, int B2,
                                int Lq, int Lk, int D, long long qs1,
                                long long qs2, long long qsl, long long ks1,
                                long long ks2, long long ksl, long long vs1,
                                long long vs2, long long vsl, long long os1,
                                long long os2, long long osl, float scale,
                                void* stream) {
  const Strides qs{qs1, qs2, qsl}, ks{ks1, ks2, ksl}, vs{vs1, vs2, vsl},
      os{os1, os2, osl};
  cudaStream_t s = (cudaStream_t)stream;
#define AFLDM_DQ(DP)                                                          \
  return launch_dq<DP>(q, k, v, dout, lse, delta, dq, B1, B2, Lq, Lk, D, qs, \
                       ks, vs, os, scale, s)
  if (D <= 32) AFLDM_DQ(32);
  if (D <= 64) AFLDM_DQ(64);
  if (D <= 128) AFLDM_DQ(128);
  if (D <= 256) AFLDM_DQ(256);
#undef AFLDM_DQ
  return (int)cudaErrorInvalidValue;
}

// dk and dv are contiguous (B1, B2, Lk, D); the rest as above.
extern "C" int flash_bwd_dkv_f32(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, int B1, int B2, int Lq,
                                 int Lk, int D, long long qs1, long long qs2,
                                 long long qsl, long long ks1, long long ks2,
                                 long long ksl, long long vs1, long long vs2,
                                 long long vsl, long long os1, long long os2,
                                 long long osl, float scale, void* stream) {
  const Strides qs{qs1, qs2, qsl}, ks{ks1, ks2, ksl}, vs{vs1, vs2, vsl},
      os{os1, os2, osl};
  cudaStream_t s = (cudaStream_t)stream;
#define AFLDM_DKV(DP)                                                        \
  return launch_dkv<DP>(q, k, v, dout, lse, delta, dk, dv, B1, B2, Lq, Lk, \
                        D, qs, ks, vs, os, scale, s)
  if (D <= 32) AFLDM_DKV(32);
  if (D <= 64) AFLDM_DKV(64);
  if (D <= 128) AFLDM_DKV(128);
  if (D <= 256) AFLDM_DKV(256);
#undef AFLDM_DKV
  return (int)cudaErrorInvalidValue;
}
