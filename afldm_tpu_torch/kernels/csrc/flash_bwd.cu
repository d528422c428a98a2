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
// What bounds it on this card: arithmetic. A 1024-token head at D = 24
// costs dq 6·L²·D and dkv 8·L²·D FLOP (150 and 200 MFLOP) against ~0.5 MB
// of q, k, v, dO, lse, delta and the gradients: ~700 FLOP per byte, far
// above the f32 ridge (~20). Exact f32 keeps it off the tensor cores, so
// the ceiling is the f32 FMA rate (67 TFLOP/s).
//
// What the design does about it: the tile loop of flash_tile.cuh, as in
// the forward (see the backward's part there). The TPU kernels carry their
// accumulators across a sequential grid axis in VMEM scratch; here that
// axis is a loop inside the block and the accumulators are register
// micro-tiles, every shared read feeding at least 4 FMAs.
//   * dq: one block per (batch·head, Q tile) stages the Q and dO tiles and
//     walks V and K in 64-key tiles through walk_kv's double buffer (V
//     first: dp, then s, ds and ds·K on the same K tile).
//   * dkv: one block per (batch·head, K/V tile) stages the K and V tiles
//     and walks Q and dO in step through walk_pair, two stages where
//     shared memory allows, each with its tile's lse and delta.
// Two kernels and no atomics, as in JAX: the gradients are deterministic.
// D is zero-padded to DP in {24, 32, 40, 64, 80, 128, 160, 256} (zeros
// change no dot product) and the padding is never written. Ragged lengths
// are masked: a key beyond Lk or a query beyond Lq gets p = ds = 0 and is
// not stored. q, k, v and dO are read through (b1, b2, row) strides with a
// unit stride along D, so a K/V batch expanded from 1 (stride 0, the CFA
// LOAD pass) and a transposed dO are read without copies; 16-byte cp.async
// where every base and stride allows, else the masked scalar copy. dq, dk
// and dv are written dense per (b1, b2), and autograd sums dk, dv over an
// expanded batch. Tensor cores (3×TF32 with an accuracy check) and a fused
// single pass with atomic dq are later work.
//
// bf16 q, k, v and dO (flash_bwd_dq_bf16, flash_bwd_dkv_bf16; the JAX
// kernels' bf16 semantics, flash_tile.cuh's bf16 backward): the same two
// kernels on bf16 tensor cores (mma.sync m16n8k16, fragments by ldmatrix,
// K3/bf16's staging), ds and p rounded to bf16 in registers before they are
// the A operand of dq += ds·K, dv += pᵀ·dO and dk += dsᵀ·Q, accumulators
// f32, the gradients rounded to bf16 once at the store. What bounds them
// there: the products at the tensor cores' bf16 rate (~990 TFLOP/s) make
// the same 1024-token head a few µs of arithmetic, so at the path's small
// heads the loads of the walked tiles and the exp of p weigh as much. wgmma
// and TMA are later work.

#include "flash_tile.cuh"

namespace {

using namespace afldm_flash;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int B2, int Lq, int Lk, int D, long long qs1,
                    long long qs2, long long qsl, long long ks1, long long ks2,
                    long long ksl, long long vs1, long long vs2, long long vsl,
                    long long os1, long long os2, long long osl, float scale,
                    int n_qtiles, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                   // BQ × LD
  float* Os = Qs + C::BQ * C::LD;   // BQ × LD (dO)
  float* Va = Os + C::BQ * C::LD;   // kBK × LD (V tiles)
  float* Kb = Va + kBK * C::LD;     // kBK × LD (K tiles)
  float* Ps = Kb + kBK * C::LD;     // BQ × PLD (dp, then ds)
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;

  stage_rows<C, C::BQ>(Qs, q + b1 * qs1 + b2 * qs2, qsl, q0, Lq, D, vec);
  stage_rows<C, C::BQ>(Os, dout + b1 * os1 + b2 * os2, osl, q0, Lq, D, vec);
  cp_async_commit();
  DqBody<C> body(Qs, Os, Ps, scale, Lk, lse + (long long)b * Lq,
                 delta + (long long)b * Lq, q0, Lq);
  walk_kv<C>(v + b1 * vs1 + b2 * vs2, k + b1 * ks1 + b2 * ks2, vsl, ksl, Lk,
             D, vec, Va, Kb, body);

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = q0 + body.ln.row(i);
    if (row >= Lq) continue;
    float* out = dq + ((long long)b * Lq + row) * D;
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      const int d = body.ln.col(t);
      if (d < D) out[d] = body.acc[i][t];
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int B2, int Lq, int Lk, int D,
                     long long qs1, long long qs2, long long qsl,
                     long long ks1, long long ks2, long long ksl,
                     long long vs1, long long vs2, long long vsl,
                     long long os1, long long os2, long long osl, float scale,
                     int n_ktiles, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                   // BQ × LD (this block's key rows)
  float* Vs = Ks + C::BQ * C::LD;   // BQ × LD
  float* Ps = Vs + C::BQ * C::LD;   // BQ × PLD (p, then ds)
  float* St = Ps + C::BQ * C::PLD;  // kStages × (Q, dO, lse, delta)
  const int b = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x - b * n_ktiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;

  stage_rows<C, C::BQ>(Ks, k + b1 * ks1 + b2 * ks2, ksl, k0, Lk, D, vec);
  stage_rows<C, C::BQ>(Vs, v + b1 * vs1 + b2 * vs2, vsl, k0, Lk, D, vec);
  cp_async_commit();
  DkvBody<C> body(Ks, Vs, Ps, scale, Lq);
  walk_pair<C, C::kStages>(q + b1 * qs1 + b2 * qs2,
                           dout + b1 * os1 + b2 * os2, qsl, osl,
                           lse + (long long)b * Lq, delta + (long long)b * Lq,
                           Lq, D, vec, St, body);

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = k0 + body.ln.row(i);
    if (row >= Lk) continue;
    const long long off = ((long long)b * Lk + row) * D;
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      const int d = body.ln.col(t);
      if (d < D) {
        dk[off + d] = body.dk[i][t];
        dv[off + d] = body.dv[i][t];
      }
    }
  }
}

// dq for bf16 q, k, v and dO (K4a/bf16, flash_tile.cuh's bf16 backward):
// a block's rows are a 64-row Q tile; it walks K and V in 64-key tiles,
// double-buffered. Per tile: dp = dO·Vᵀ and s = Q·Kᵀ (mma_scores), p and ds
// in f32 registers, ds rounded to bf16 as the A operand of dq += ds·K.
template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash_bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B2,
    int Lq, int Lk, int D, long long qs1, long long qs2, long long qsl,
    long long ks1, long long ks2, long long ksl, long long vs1, long long vs2,
    long long vsl, long long os1, long long os2, long long osl, float scale,
    int n_qtiles, int vec) {
  extern __shared__ __align__(16) unsigned char smb[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smb);
  __nv_bfloat16* Os = Qs + C::BQ * C::LD;
  __nv_bfloat16* Kb[2] = {Os + C::BQ * C::LD, Os + (C::BQ + kBK) * C::LD};
  __nv_bfloat16* Vb[2] = {Kb[1] + kBK * C::LD, Kb[1] + 2 * kBK * C::LD};
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / C::CS, cs = warp - rg * C::CS;
  const int g = lane >> 2;
  const __nv_bfloat16* kb = k + b1 * ks1 + b2 * ks2;
  const __nv_bfloat16* vb = v + b1 * vs1 + b2 * vs2;

  stage_rows_bf16<C, C::BQ>(Qs, q + b1 * qs1 + b2 * qs2, qsl, q0, Lq, D, vec);
  stage_rows_bf16<C, C::BQ>(Os, dout + b1 * os1 + b2 * os2, osl, q0, Lq, D,
                            vec);
  stage_rows_bf16<C, kBK>(Kb[0], kb, ksl, 0, Lk, D, vec);
  stage_rows_bf16<C, kBK>(Vb[0], vb, vsl, 0, Lk, D, vec);
  cp_async_commit();
  float ls[2], dl[2];  // rows q0 + 16·rg + g + 8h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * rg + g + 8 * h;
    ls[h] = row < Lq ? lse[(long long)b * Lq + row] : 0.0f;
    dl[h] = row < Lq ? delta[(long long)b * Lq + row] : 0.0f;
  }
  float acc[C::DWT][4];
#pragma unroll
  for (int j = 0; j < C::DWT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int k0 = 0, it = 0; k0 < Lk; k0 += kBK, ++it) {
    const int cur = it & 1;
    cp_async_wait<0>();  // tile j (and Q, dO) landed
    __syncthreads();     // and tile j − 1's buffers are no longer read
    if (k0 + kBK < Lk) {
      stage_rows_bf16<C, kBK>(Kb[cur ^ 1], kb, ksl, k0 + kBK, Lk, D, vec);
      stage_rows_bf16<C, kBK>(Vb[cur ^ 1], vb, vsl, k0 + kBK, Lk, D, vec);
    }
    cp_async_commit();
    float dp[C::NT][4], s[C::NT][4];
    mma_scores<C>(Os, Vb[cur], rg, lane, dp);
    mma_scores<C>(Qs, Kb[cur], rg, lane, s);
    unsigned da[kBK / 16][4];
    ds_fragments<C>(da, s, dp, ls, dl, scale, k0, Lk, lane);
    mma_walked<C>(acc, da, trans_base<C>(Kb[cur], cs, lane));
  }
  cp_async_wait<0>();
  store_rows_bf16<C>(dq + (long long)b * Lq * D, acc, q0 + 16 * rg, Lq, D, cs,
                     lane);
}

// dk and dv for bf16 q, k, v and dO (K4b/bf16): a block's rows are a
// 64-row K/V tile; it walks Q and dO in 64-query tiles with their lse and
// delta, double-buffered. Per tile: sᵀ = K·Qᵀ, pᵀ rounded to bf16 for dv +=
// pᵀ·dO; dpᵀ = V·dOᵀ, dsᵀ rounded to bf16 for dk += dsᵀ·Q.
template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash_bwd_dkv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int B2, int Lq, int Lk, int D,
    long long qs1, long long qs2, long long qsl, long long ks1, long long ks2,
    long long ksl, long long vs1, long long vs2, long long vsl, long long os1,
    long long os2, long long osl, float scale, int n_ktiles, int vec) {
  extern __shared__ __align__(16) unsigned char smb[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smb);
  __nv_bfloat16* Vs = Ks + C::BQ * C::LD;
  __nv_bfloat16* Qb[2] = {Vs + C::BQ * C::LD, Vs + (C::BQ + kBK) * C::LD};
  __nv_bfloat16* Ob[2] = {Qb[1] + kBK * C::LD, Qb[1] + 2 * kBK * C::LD};
  float* xs = reinterpret_cast<float*>(Ob[1] + kBK * C::LD);  // 2 × (lse, δ)
  const int b = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x - b * n_ktiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / C::CS, cs = warp - rg * C::CS;
  const __nv_bfloat16* qb = q + b1 * qs1 + b2 * qs2;
  const __nv_bfloat16* ob = dout + b1 * os1 + b2 * os2;
  const float* lse_b = lse + (long long)b * Lq;
  const float* dl_b = delta + (long long)b * Lq;
  auto stage_step = [&](int buf, int r0) {
    stage_rows_bf16<C, kBK>(Qb[buf], qb, qsl, r0, Lq, D, vec);
    stage_rows_bf16<C, kBK>(Ob[buf], ob, osl, r0, Lq, D, vec);
    stage_vec<C>(xs + buf * 2 * kBK, lse_b, r0, Lq);
    stage_vec<C>(xs + buf * 2 * kBK + kBK, dl_b, r0, Lq);
  };

  stage_rows_bf16<C, C::BQ>(Ks, k + b1 * ks1 + b2 * ks2, ksl, k0, Lk, D, vec);
  stage_rows_bf16<C, C::BQ>(Vs, v + b1 * vs1 + b2 * vs2, vsl, k0, Lk, D, vec);
  stage_step(0, 0);
  cp_async_commit();
  float dka[C::DWT][4], dva[C::DWT][4];
#pragma unroll
  for (int j = 0; j < C::DWT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;

  for (int q0 = 0, it = 0; q0 < Lq; q0 += kBK, ++it) {
    const int cur = it & 1;
    cp_async_wait<0>();  // step j (and K, V) landed
    __syncthreads();     // and step j − 1's buffers are no longer read
    if (q0 + kBK < Lq) stage_step(cur ^ 1, q0 + kBK);
    cp_async_commit();
    const float* xl = xs + cur * 2 * kBK;  // the tile's lse, then delta
    float p[C::NT][4];
    mma_scores<C>(Ks, Qb[cur], rg, lane, p);  // sᵀ, then pᵀ in place
    unsigned pa[kBK / 16][4];
    p_fragments<C>(pa, p, xl, scale, q0, Lq, lane);
    mma_walked<C>(dva, pa, trans_base<C>(Ob[cur], cs, lane));
    float dp[C::NT][4];
    mma_scores<C>(Vs, Ob[cur], rg, lane, dp);  // dpᵀ
    unsigned da[kBK / 16][4];
    dst_fragments<C>(da, p, dp, xl + kBK, scale, lane);
    mma_walked<C>(dka, da, trans_base<C>(Qb[cur], cs, lane));
  }
  cp_async_wait<0>();
  const long long off = (long long)b * Lk * D;
  store_rows_bf16<C>(dk + off, dka, k0 + 16 * rg, Lk, D, cs, lane);
  store_rows_bf16<C>(dv + off, dva, k0 + 16 * rg, Lk, D, cs, lane);
}

int vec_all(const float* q, const float* k, const float* v, const float* dout,
            const long long* s, int D) {
  return vec_ok(q, s[0], s[1], s[2], D) && vec_ok(k, s[3], s[4], s[5], D) &&
         vec_ok(v, s[6], s[7], s[8], D) && vec_ok(dout, s[9], s[10], s[11], D);
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
  const long long s[12] = {qs1, qs2, qsl, ks1, ks2, ksl,
                           vs1, vs2, vsl, os1, os2, osl};
  const int vec = vec_all(q, k, v, dout, s, D);
  return with_dp(D, [&](auto dp) {
    using C = DqCfg<BwdCfg<decltype(dp)::value>>;
    const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
    return launch_tiles<C>(flash_bwd_dq_kernel<C>,
                           (long long)B1 * B2 * n_qtiles, (cudaStream_t)stream,
                           q, k, v, dout, lse, delta, dq, B2, Lq, Lk, D, qs1,
                           qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl, os1, os2,
                           osl, scale, n_qtiles, vec);
  });
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
  const long long s[12] = {qs1, qs2, qsl, ks1, ks2, ksl,
                           vs1, vs2, vsl, os1, os2, osl};
  const int vec = vec_all(q, k, v, dout, s, D);
  return with_dp(D, [&](auto dp) {
    using C = DkvCfg<BwdCfg<decltype(dp)::value>>;
    const int n_ktiles = (Lk + C::BQ - 1) / C::BQ;
    return launch_tiles<C>(flash_bwd_dkv_kernel<C>,
                           (long long)B1 * B2 * n_ktiles, (cudaStream_t)stream,
                           q, k, v, dout, lse, delta, dk, dv, B2, Lq, Lk, D,
                           qs1, qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl, os1,
                           os2, osl, scale, n_ktiles, vec);
  });
}

namespace {

int vec_all_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, const __nv_bfloat16* dout,
                 const long long* s, int D) {
  return vec_ok_bf16(q, s[0], s[1], s[2], D) &&
         vec_ok_bf16(k, s[3], s[4], s[5], D) &&
         vec_ok_bf16(v, s[6], s[7], s[8], D) &&
         vec_ok_bf16(dout, s[9], s[10], s[11], D);
}

}  // namespace

// dq for bf16 q, k, v, dO and dq (lse, delta f32): flash_bwd_dq_f32's
// arguments.
extern "C" int flash_bwd_dq_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, const float* lse, const float* delta,
    __nv_bfloat16* dq, int B1, int B2, int Lq, int Lk, int D, long long qs1,
    long long qs2, long long qsl, long long ks1, long long ks2, long long ksl,
    long long vs1, long long vs2, long long vsl, long long os1, long long os2,
    long long osl, float scale, void* stream) {
  const long long s[12] = {qs1, qs2, qsl, ks1, ks2, ksl,
                           vs1, vs2, vsl, os1, os2, osl};
  const int vec = vec_all_bf16(q, k, v, dout, s, D);
  return with_bwd_mma<160, false>(D, [&](auto cfg) {
    using C = decltype(cfg);
    const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
    return launch_mma_tiles<C>(flash_bwd_dq_bf16_kernel<C>,
                               (long long)B1 * B2 * n_qtiles,
                               (cudaStream_t)stream, q, k, v, dout, lse,
                               delta, dq, B2, Lq, Lk, D, qs1, qs2, qsl, ks1,
                               ks2, ksl, vs1, vs2, vsl, os1, os2, osl, scale,
                               n_qtiles, vec);
  });
}

// dk and dv for bf16 q, k, v, dO, dk and dv (lse, delta f32):
// flash_bwd_dkv_f32's arguments.
extern "C" int flash_bwd_dkv_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, const float* lse, const float* delta,
    __nv_bfloat16* dk, __nv_bfloat16* dv, int B1, int B2, int Lq, int Lk,
    int D, long long qs1, long long qs2, long long qsl, long long ks1,
    long long ks2, long long ksl, long long vs1, long long vs2, long long vsl,
    long long os1, long long os2, long long osl, float scale, void* stream) {
  const long long s[12] = {qs1, qs2, qsl, ks1, ks2, ksl,
                           vs1, vs2, vsl, os1, os2, osl};
  const int vec = vec_all_bf16(q, k, v, dout, s, D);
  return with_bwd_mma<80, true>(D, [&](auto cfg) {
    using C = decltype(cfg);
    const int n_ktiles = (Lk + C::BQ - 1) / C::BQ;
    return launch_mma_tiles<C>(flash_bwd_dkv_bf16_kernel<C>,
                               (long long)B1 * B2 * n_ktiles,
                               (cudaStream_t)stream, q, k, v, dout, lse,
                               delta, dk, dv, B2, Lq, Lk, D, qs1, qs2, qsl,
                               ks1, ks2, ksl, vs1, vs2, vsl, os1, os2, osl,
                               scale, n_ktiles, vec);
  });
}
