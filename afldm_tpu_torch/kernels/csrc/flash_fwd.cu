// Flash-attention forward for Hopper, f32: out = softmax(q·kᵀ·scale)·v and
// the per-row logsumexp, never materialising the Lq×Lk score matrix.
//
// Replaces: afldm_tpu/ops/attention.py::_flash_kernel / _flash_3d (K3).
// Same semantics: f32 scores, f32 online softmax, p in v's dtype (f32
// here) for p·v; lse = m + log(l), shape (B, Lq, 1).
//
// What bounds it on this card: arithmetic. A 1024-token head does
// 4·L²·D = 100 MFLOP at D = 24 against 4·L·D·4 = 0.4 MB of q, k, v and out:
// ~250 FLOP per byte, far above the f32 ridge (~20). Exact f32 keeps it off
// the tensor cores, so the ceiling is the f32 FMA rate (67 TFLOP/s); at
// L = 4 and 16 the launch and the idle rows of a tile dominate.
//
// What the design does about it: the tile loop of flash_tile.cuh. One block
// per (batch·head, Q tile of 128 rows; 64 at DP = 256) walks K/V in 64-key
// tiles double-buffered through cp.async; each thread keeps a 4×TN micro-
// tile of the scores and a 4×TD micro-tile of the output in registers, so
// each shared-memory read feeds at least 4 FMAs (one fed one before). D is
// zero-padded to DP in {24, 32, 40, 64, 80, 128, 160, 256} and the padding
// is never written out. Ragged Lq and Lk are masked: a key beyond Lk scores
// -inf, a query beyond Lq is computed on zeros and not stored. Inputs are
// addressed through (b1, b2, row) strides, so a K/V batch expanded from 1
// (stride 0, the CFA LOAD pass) is read without a copy. Tensor cores
// (3×TF32 with an accuracy check) are later work for f32.
//
// bf16 q, k, v (flash_fwd_bf16): the function of _flash_kernel at bf16,
// an online softmax over BK-key tiles that rounds the unnormalised p =
// exp(s − m_running) to bf16 for p·v, sums l from the unrounded f32 p and
// divides once at the end; out bf16, lse f32 (flash_tile.cuh's bf16
// forward tile loop, fwd_walk with OnlineSoftmax). Bound: 4·Lq·Lk·D FLOP a
// head at the bf16 tensor rate (at D = 24, padded to 32, and L = 1024:
// 101 MFLOP against 0.2 MB), and one exponential a score on the SFU, which
// at the model's D of 24 and 40 is the tighter of the two. The design:
// one walk over K/V through a two-stage cp.async ring, 128-key tiles (64
// where all the keys fit in 64), 16 query rows a warp, P kept in registers
// as the A fragments of each tile's P·V, which is summed from zero and
// added to o in f32, exp2 with the scale folded into one FFMA, 1/l once in
// the epilogue.

#include "flash_tile.cuh"

namespace {

using namespace afldm_flash;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int B2, int Lq, int Lk, int D,
                 long long qs1, long long qs2, long long qsl,
                 long long ks1, long long ks2, long long ksl,
                 long long vs1, long long vs2, long long vsl, float scale,
                 int n_qtiles, int vec) {
  extern __shared__ __align__(16) float sm[];
  const Smem<C> S(sm);
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;

  stage_rows<C, C::BQ>(S.Qs, q + b1 * qs1 + b2 * qs2, qsl, q0, Lq, D, vec);
  cp_async_commit();
  Attend<C> at(S.Qs, S.Ps, scale, Lk);
  walk_kv<C>(k + b1 * ks1 + b2 * ks2, v + b1 * vs1 + b2 * vs2, ksl, vsl, Lk,
             D, vec, S.Ks, S.Vs, at);

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const float inv = at.inv_l(i);  // shuffles: every lane, before the mask
    const float ls = at.lse(i);
    const int row = q0 + at.ln.row(i);
    if (row >= Lq) continue;
    float* ob = out + ((long long)b * Lq + row) * D;
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      const int d = at.ln.col(t);
      if (d < D) ob[d] = at.acc[i][t] * inv;
    }
    if (at.ln.c == 0) lse[(long long)b * Lq + row] = ls;
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int B2, int Lq, int Lk, int D,
                      long long qs1, long long qs2, long long qsl,
                      long long ks1, long long ks2, long long ksl,
                      long long vs1, long long vs2, long long vsl,
                      float scale, int n_qtiles, int vec) {
  extern __shared__ __align__(16) unsigned char smb[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smb);
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;

  stage_rows_bf16<C, C::BQ>(Qs, q + b1 * qs1 + b2 * qs2, qsl, q0, Lq, D,
                            vec);
  cp_async_commit();
  OnlineSoftmax<C> sm(scale);
  float o[C::DT][4];
  fwd_walk<C>(Qs, Qs + C::BQ * C::LD, k + b1 * ks1 + b2 * ks2,
              v + b1 * vs1 + b2 * vs2, ksl, vsl, Lk, D, vec, sm, o);
  float inv[2], ls[2];
  sm.finish(inv, ls);
  __nv_bfloat16* ob = out + (long long)b * Lq * D;
  for_out_fwd<C>(q0, Lq, D, [&](int row, int d, int h, int j) {
    store_pair_bf16(ob + (long long)row * D + d, d, D, o[j][2 * h] * inv[h],
                    o[j][2 * h + 1] * inv[h]);
  });
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * (threadIdx.x >> 5) + (lane >> 2) + 8 * h;
    if ((lane & 3) == 0 && row < Lq) lse[(long long)b * Lq + row] = ls[h];
  }
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
  const int vec = vec_ok(q, qs1, qs2, qsl, D) && vec_ok(k, ks1, ks2, ksl, D) &&
                  vec_ok(v, vs1, vs2, vsl, D);
  return with_dp(D, [&](auto dp) {
    using C = FlashCfg<decltype(dp)::value>;
    const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
    return launch_tiles<C>(flash_fwd_kernel<C>, (long long)B1 * B2 * n_qtiles,
                           (cudaStream_t)stream, q, k, v, out, lse, B2, Lq, Lk,
                           D, qs1, qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl,
                           scale, n_qtiles, vec);
  });
}

// The bf16 forward: q, k, v, out bf16, lse f32, the same arguments; the
// scale must be positive (the row max is taken over the raw scores).
extern "C" int flash_fwd_bf16(const __nv_bfloat16* q,
                              const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* out,
                              float* lse, int B1, int B2, int Lq, int Lk,
                              int D, long long qs1, long long qs2,
                              long long qsl, long long ks1, long long ks2,
                              long long ksl, long long vs1, long long vs2,
                              long long vsl, float scale, void* stream) {
  const int vec = vec_ok_bf16(q, qs1, qs2, qsl, D) &&
                  vec_ok_bf16(k, ks1, ks2, ksl, D) &&
                  vec_ok_bf16(v, vs1, vs2, vsl, D);
  if (!(scale > 0.0f)) return (int)cudaErrorInvalidValue;
  return with_dp_mma(D, [&](auto dp) {
    return with_fwd_cfg<decltype(dp)::value>(Lk, [&](auto cfg) {
      using C = decltype(cfg);
      const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
      return launch_mma_tiles<C>(flash_fwd_bf16_kernel<C>,
                                 (long long)B1 * B2 * n_qtiles,
                                 (cudaStream_t)stream, q, k, v, out, lse, B2,
                                 Lq, Lk, D, qs1, qs2, qsl, ks1, ks2, ksl, vs1,
                                 vs2, vsl, scale, n_qtiles, vec);
    });
  });
}
