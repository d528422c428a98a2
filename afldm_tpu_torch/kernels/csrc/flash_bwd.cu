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
// kernels on bf16 tensor cores (mma.sync m16n8k16, fragments by ldmatrix),
// ds and p rounded to bf16 in registers before they are the A operand of
// dq += ds·K, dv += pᵀ·dO and dk += dsᵀ·Q, accumulators f32, the gradients
// rounded to bf16 once at the store. What bounds them there: the products
// at the tensor cores' bf16 rate (~990 TFLOP/s) make the same 1024-token
// head a few µs of arithmetic, so at the path's small heads the exp of p on
// the SFU weighs as much. The design (flash_tile.cuh): the fixed rows' A
// fragments held in registers up to DP = 80, p by ex2.approx with the
// scale folded into one FFMA (bwd_p_exp2), a kStages ring of BK-row walked tiles with one barrier a
// tile, 16 walked rows at a time with P and dS in registers; and, where
// B·H·⌈Lk/64⌉ blocks would leave SMs idle (the SD trainers' cross-attention
// over 77 text tokens), dkv's query walk split over blocks
// (flash_bwd_dkv_bf16_split) into f32 partials that dkv_reduce_kernel
// (flash_bwd_dkv_reduce) sums in a fixed order, one rounding to bf16: no
// atomics, the same bits on every call. wgmma and TMA are later work.

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

// dq for bf16 q, k, v and dO (K4a/bf16, flash_tile.cuh's bf16 backward): a
// block's fixed rows are a 64-row Q tile with its dO rows, their A
// fragments held by FixedA; it walks K and V through bwd_walk's ring, 16
// keys at a time: dp = dO·Vᵀ and s = Q·Kᵀ (chunk_scores), p and ds in f32
// registers, ds rounded to bf16 as the A fragment of dq += ds·K.
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
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smb[];
  bf16* Qs = reinterpret_cast<bf16*>(smb + C::fixed_offset);
  bf16* Os = Qs + C::BQ * C::LD;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / C::CS, cs = warp - rg * C::CS;
  const bf16* kb = k + b1 * ks1 + b2 * ks2;
  const bf16* vb = v + b1 * vs1 + b2 * vs2;

  stage_rows_bf16<C, C::BQ>(Qs, q + b1 * qs1 + b2 * qs2, qsl, q0, Lq, D, vec);
  stage_rows_bf16<C, C::BQ>(Os, dout + b1 * os1 + b2 * os2, osl, q0, Lq, D,
                            vec);
  float ls[2], dl[2];  // lse and delta of rows q0 + 16·rg + g + 8h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * rg + (lane >> 2) + 8 * h;
    ls[h] = row < Lq ? lse[(long long)b * Lq + row] : 0.0f;
    dl[h] = row < Lq ? delta[(long long)b * Lq + row] : 0.0f;
  }
  float acc[C::DWT][4];
#pragma unroll
  for (int j = 0; j < C::DWT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  FixedA<C> qa(Qs, rg, lane), oa(Os, rg, lane);
  const int sb = score_base<C>(lane), tt = trans_base<C>(cs, lane);

  bwd_walk<C>(
      smb + C::ring_offset, 0, (Lk + C::BK - 1) / C::BK,
      [&](int t, unsigned char* st) {
        bf16* Ks = reinterpret_cast<bf16*>(st);
        stage_rows_bf16<C, C::BK>(Ks, kb, ksl, t * C::BK, Lk, D, vec);
        stage_rows_bf16<C, C::BK>(Ks + C::BK * C::LD, vb, vsl, t * C::BK, Lk,
                                  D, vec);
      },
      [&] {
        qa.load();
        oa.load();
      },
      [&](const unsigned char* st, int k0) {
        const bf16* Ks = reinterpret_cast<const bf16*>(st);
        const bf16* Vs = Ks + C::BK * C::LD;
        const bool ragged = k0 + C::BK > Lk;
#pragma unroll
        for (int c = 0; c < C::BK / 16; ++c) {
          if (k0 + 16 * c >= Lk) break;
          float p[2][4], dp[2][4];
          chunk_scores<C>(oa, Vs + 16 * c * C::LD + sb, dp);
          chunk_scores<C>(qa, Ks + 16 * c * C::LD + sb, p);  // s
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[u][e] = bwd_p_exp2(p[u][e], scale, ls[e >> 1]);
          if (ragged) zero_past(p, k0 + 16 * c, Lk, lane);
          unsigned da[4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              da[2 * u + h] = pack_bf16x2(
                  bwd_ds(p[u][2 * h], dp[u][2 * h], dl[h], scale),
                  bwd_ds(p[u][2 * h + 1], dp[u][2 * h + 1], dl[h], scale));
          chunk_walked<C>(acc, da, Ks + 16 * c * C::LD + tt);
        }
      });
  store_rows<C>(dq + (long long)b * Lq * D, acc, q0 + 16 * rg, Lq, D, cs,
                lane);
}

// dk and dv for bf16 q, k, v and dO (K4b/bf16): a block's fixed rows are a
// 64-row K/V tile, their A fragments held by FixedA; it walks Q and dO with
// their lse and delta through bwd_walk's ring, 16 queries at a time: sᵀ =
// K·Qᵀ and dpᵀ = V·dOᵀ (chunk_scores), pᵀ rounded to bf16 for dv += pᵀ·dO
// and dsᵀ rounded to bf16 for dk += dsᵀ·Q. With ``splits`` > 1 the block
// walks one of ``splits`` runs of ``per`` query tiles and writes f32
// partials to ``ws`` (split s's dk at ws + 2s·n, its dv at ws + (2s + 1)·n,
// n = B1·B2·Lk·D) for dkv_reduce_kernel; else bf16 dk and dv.
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
    long long os2, long long osl, float scale, int n_ktiles, int vec,
    float* __restrict__ ws, int splits, int per) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smb[];
  bf16* Ks = reinterpret_cast<bf16*>(smb + C::fixed_offset);
  bf16* Vs = Ks + C::BQ * C::LD;
  const int bs = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x - bs * n_ktiles) * C::BQ;
  const int b = bs / splits, split = bs - b * splits;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / C::CS, cs = warp - rg * C::CS;
  const bf16* qb = q + b1 * qs1 + b2 * qs2;
  const bf16* ob = dout + b1 * os1 + b2 * os2;
  const float* lse_b = lse + (long long)b * Lq;
  const float* dl_b = delta + (long long)b * Lq;
  const int n_tiles = (Lq + C::BK - 1) / C::BK;
  const int t0 = split * per;
  const int t1 = t0 + per < n_tiles ? t0 + per : n_tiles;

  stage_rows_bf16<C, C::BQ>(Ks, k + b1 * ks1 + b2 * ks2, ksl, k0, Lk, D, vec);
  stage_rows_bf16<C, C::BQ>(Vs, v + b1 * vs1 + b2 * vs2, vsl, k0, Lk, D, vec);
  float dka[C::DWT][4], dva[C::DWT][4];
#pragma unroll
  for (int j = 0; j < C::DWT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  FixedA<C> ka(Ks, rg, lane), va(Vs, rg, lane);
  const int sb = score_base<C>(lane), tt = trans_base<C>(cs, lane);
  const int t2 = 2 * (lane & 3);

  bwd_walk<C>(
      smb + C::ring_offset, t0, t1,
      [&](int t, unsigned char* st) {
        bf16* Qt = reinterpret_cast<bf16*>(st);
        float* xs = reinterpret_cast<float*>(Qt + 2 * C::BK * C::LD);
        stage_rows_bf16<C, C::BK>(Qt, qb, qsl, t * C::BK, Lq, D, vec);
        stage_rows_bf16<C, C::BK>(Qt + C::BK * C::LD, ob, osl, t * C::BK, Lq,
                                  D, vec);
        stage_vec<C, C::BK>(xs, lse_b, t * C::BK, Lq);
        stage_vec<C, C::BK>(xs + C::BK, dl_b, t * C::BK, Lq);
      },
      [&] {
        ka.load();
        va.load();
      },
      [&](const unsigned char* st, int q0) {
        const bf16* Qt = reinterpret_cast<const bf16*>(st);
        const bf16* Ot = Qt + C::BK * C::LD;
        const float* xl = reinterpret_cast<const float*>(Ot + C::BK * C::LD);
        const bool ragged = q0 + C::BK > Lq;
#pragma unroll
        for (int c = 0; c < C::BK / 16; ++c) {
          if (q0 + 16 * c >= Lq) break;
          float p[2][4], dp[2][4];
          chunk_scores<C>(ka, Qt + 16 * c * C::LD + sb, p);   // sᵀ
          chunk_scores<C>(va, Ot + 16 * c * C::LD + sb, dp);  // dpᵀ
          float2 dl[2];  // delta of this lane's queries 16c + 8u + 2t + e
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qi = 16 * c + 8 * u + t2;
            const float2 l2 = *reinterpret_cast<const float2*>(xl + qi);
            dl[u] = *reinterpret_cast<const float2*>(xl + C::BK + qi);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[u][e] = bwd_p_exp2(p[u][e], scale, e & 1 ? l2.y : l2.x);
          }
          if (ragged) zero_past(p, q0 + 16 * c, Lq, lane);
          unsigned pa[4], da[4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              pa[2 * u + h] = pack_bf16x2(p[u][2 * h], p[u][2 * h + 1]);
              da[2 * u + h] = pack_bf16x2(
                  bwd_ds(p[u][2 * h], dp[u][2 * h], dl[u].x, scale),
                  bwd_ds(p[u][2 * h + 1], dp[u][2 * h + 1], dl[u].y, scale));
            }
          chunk_walked<C>(dva, pa, Ot + 16 * c * C::LD + tt);
          chunk_walked<C>(dka, da, Qt + 16 * c * C::LD + tt);
        }
      });
  const long long off = (long long)b * Lk * D;
  if (splits == 1) {
    store_rows<C>(dk + off, dka, k0 + 16 * rg, Lk, D, cs, lane);
    store_rows<C>(dv + off, dva, k0 + 16 * rg, Lk, D, cs, lane);
  } else {
    const long long n = (long long)(gridDim.x / (n_ktiles * splits)) * Lk * D;
    store_rows<C>(ws + 2 * split * n + off, dka, k0 + 16 * rg, Lk, D, cs,
                  lane);
    store_rows<C>(ws + (2 * split + 1) * n + off, dva, k0 + 16 * rg, Lk, D,
                  cs, lane);
  }
}

// out[i] = bf16(ws[i] + ws[n2 + i] + … + ws[(splits − 1)·n2 + i]) for i <
// n2, summed in f32 in split order: the split dkv's partials (dk's, then
// dv's, n2 = 2·B1·B2·Lk·D) into dk and dv. Four elements a thread, 16-byte
// loads where n2 % 4 == 0 (vec). Bound: the bytes, (splits·4 + 2)·n2.
__global__ void __launch_bounds__(256)
dkv_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                  long long n2, int splits, int vec) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n2) return;
  if (vec) {
    float4 a = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < splits; ++s) {
      const float4 t = *reinterpret_cast<const float4*>(ws + s * n2 + i);
      a.x = __fadd_rn(a.x, t.x);
      a.y = __fadd_rn(a.y, t.y);
      a.z = __fadd_rn(a.z, t.z);
      a.w = __fadd_rn(a.w, t.w);
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + i);
    o[0] = __floats2bfloat162_rn(a.x, a.y);
    o[1] = __floats2bfloat162_rn(a.z, a.w);
    return;
  }
  for (long long e = i; e < i + 4 && e < n2; ++e) {
    float a = ws[e];
    for (int s = 1; s < splits; ++s) a = __fadd_rn(a, ws[s * n2 + e]);
    out[e] = __float2bfloat16_rn(a);
  }
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
  return with_bwd_mma<false>(D, [&](auto cfg) {
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

namespace {

// flash_bwd_dkv_bf16_kernel on B1·B2·⌈Lk/BQ⌉ blocks times ``splits``, each
// split walking ⌈tiles / splits⌉ query tiles; ws: the f32 partials where
// splits > 1. Refuses a split count other than dkv_splits' plan.
int launch_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, const __nv_bfloat16* dout,
                    const float* lse, const float* delta, __nv_bfloat16* dk,
                    __nv_bfloat16* dv, float* ws, int splits, int B1, int B2,
                    int Lq, int Lk, int D, const long long* s, float scale,
                    void* stream) {
  const int vec = vec_all_bf16(q, k, v, dout, s, D);
  return with_bwd_mma<true>(D, [&](auto cfg) {
    using C = decltype(cfg);
    if (splits > 1 && splits != dkv_splits<C>((long long)B1 * B2, Lq, Lk))
      return (int)cudaErrorInvalidValue;
    const int n_ktiles = (Lk + C::BQ - 1) / C::BQ;
    const int tiles = (Lq + C::BK - 1) / C::BK;
    const int per = (tiles + splits - 1) / splits;
    return launch_mma_tiles<C>(
        flash_bwd_dkv_bf16_kernel<C>, (long long)B1 * B2 * splits * n_ktiles,
        (cudaStream_t)stream, q, k, v, dout, lse, delta, dk, dv, B2, Lq, Lk,
        D, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
        s[11], scale, n_ktiles, vec, ws, splits, per);
  });
}

}  // namespace

// dk and dv for bf16 q, k, v, dO, dk and dv (lse, delta f32), one block a
// K/V tile walking every query: flash_bwd_dkv_f32's arguments.
extern "C" int flash_bwd_dkv_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, const float* lse, const float* delta,
    __nv_bfloat16* dk, __nv_bfloat16* dv, int B1, int B2, int Lq, int Lk,
    int D, long long qs1, long long qs2, long long qsl, long long ks1,
    long long ks2, long long ksl, long long vs1, long long vs2, long long vsl,
    long long os1, long long os2, long long osl, float scale, void* stream) {
  const long long s[12] = {qs1, qs2, qsl, ks1, ks2, ksl,
                           vs1, vs2, vsl, os1, os2, osl};
  return launch_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, nullptr, 1, B1,
                         B2, Lq, Lk, D, s, scale, stream);
}

// The split dkv (flash_tile.cuh::dkv_splits > 1): ``splits`` blocks a K/V
// tile, each walking its run of query tiles, their f32 partials of dk and
// dv into ws, contiguous (splits, 2, B1, B2, Lk, D), for
// flash_bwd_dkv_reduce. Arguments as flash_bwd_dkv_bf16's, with ws in place
// of dk and dv and the split count after the scale; another count than the
// plan's is refused.
extern "C" int flash_bwd_dkv_bf16_split(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, const float* lse, const float* delta,
    float* ws, int B1, int B2, int Lq, int Lk, int D, long long qs1,
    long long qs2, long long qsl, long long ks1, long long ks2, long long ksl,
    long long vs1, long long vs2, long long vsl, long long os1, long long os2,
    long long osl, float scale, int splits, void* stream) {
  if (splits < 2) return (int)cudaErrorInvalidValue;
  const long long s[12] = {qs1, qs2, qsl, ks1, ks2, ksl,
                           vs1, vs2, vsl, os1, os2, osl};
  return launch_dkv_bf16(q, k, v, dout, lse, delta, nullptr, nullptr, ws,
                         splits, B1, B2, Lq, Lk, D, s, scale, stream);
}

// dk and dv (bf16, contiguous (2, B1, B2, Lk, D): out) from the split
// dkv's partials ws (f32, contiguous (splits, 2, B1, B2, Lk, D)); n2 =
// 2·B1·B2·Lk·D.
extern "C" int flash_bwd_dkv_reduce(const float* ws, __nv_bfloat16* out,
                                    long long n2, int splits, void* stream) {
  if (splits < 1 || n2 < 0) return (int)cudaErrorInvalidValue;
  if (n2 == 0) return 0;
  const int vec = (n2 % 4 == 0 && ((uintptr_t)ws & 15) == 0 &&
                   ((uintptr_t)out & 7) == 0);
  const long long blocks = (n2 + 4 * 256 - 1) / (4 * 256);
  dkv_reduce_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      ws, out, n2, splits, vec);
  return (int)cudaGetLastError();
}
