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
// What the design does about it: K3's tile loop (flash_tile.cuh: register
// micro-tiles, double-buffered cp.async K/V tiles, D padded to a multiple of
// 8, ragged Lq/Lk masked, (b1, b2, row) strides so K/V expanded from one
// image are never copied), run twice over a Q tile staged once. Two live
// online-softmax states would double the per-thread accumulator and spill,
// so the sets run one after the other with one accumulator: set 0 finishes
// and each thread writes (1-α)·o0 for its own elements of the output rows,
// then set 1 runs and each thread adds α·o1 to the same elements, which only
// it reads and writes.
//
// bf16 q, k0, v0, k1, v1 (flash2_fwd_bf16): the function of _flash2_kernel
// at bf16: for each set K3/bf16's online softmax (flash_tile.cuh's bf16
// forward tile loop, p rounded to bf16 unnormalised, l from the f32 p),
// then bf16((1 − α)·acc₀/l₀ + α·acc₁/l₁), blended in f32 and rounded once.
// Bound: 8·Lq·Lk·D FLOP a head at the bf16 tensor rate, and two
// exponentials a (query, key) pair on the SFU. The design: the Q tile is
// staged once; each set is walked once (fwd_walk); set 0's (1 − α)·o₀
// waits in f32 in shared memory (Fwd2Cfg's stash, each element written and
// read back by the thread that owns it) while set 1 runs, so both states
// meet in one store without doubling the accumulator registers.

#include "flash_tile.cuh"

namespace {

using namespace afldm_flash;

struct Strides {
  long long s[15];  // q, k0, v0, k1, v1: (b1, b2, row) each
};

template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash2_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k0,
                  const float* __restrict__ v0, const float* __restrict__ k1,
                  const float* __restrict__ v1,
                  const float* __restrict__ alpha, float* __restrict__ out,
                  int B2, int Lq, int Lk, int D, Strides st, float scale,
                  int n_qtiles, int vec) {
  extern __shared__ __align__(16) float sm[];
  const Smem<C> S(sm);
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const long long* s = st.s;
  auto at_b = [&](const float* t, int i) {
    return t + b1 * s[3 * i] + b2 * s[3 * i + 1];
  };

  // staged once for both sets; the first set's first tile waits for it
  stage_rows<C, C::BQ>(S.Qs, at_b(q, 0), s[2], q0, Lq, D, vec);
  cp_async_commit();
  const float a = alpha[b];
  Attend<C> at(S.Qs, S.Ps, scale, Lk);

  walk_kv<C>(at_b(k0, 1), at_b(v0, 2), s[5], s[8], Lk, D, vec, S.Ks, S.Vs,
             at);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const float inv = at.inv_l(i);  // shuffles: every lane, before the mask
    const int row = q0 + at.ln.row(i);
    if (row >= Lq) continue;
    float* ob = out + ((long long)b * Lq + row) * D;
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      const int d = at.ln.col(t);
      if (d < D) ob[d] = (1.0f - a) * (at.acc[i][t] * inv);
    }
  }

  at.reset();
  walk_kv<C>(at_b(k1, 3), at_b(v1, 4), s[11], s[14], Lk, D, vec, S.Ks, S.Vs,
             at);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const float inv = at.inv_l(i);
    const int row = q0 + at.ln.row(i);
    if (row >= Lq) continue;
    float* ob = out + ((long long)b * Lq + row) * D;
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      const int d = at.ln.col(t);
      if (d < D) ob[d] = ob[d] + a * (at.acc[i][t] * inv);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads)
flash2_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k0,
                       const __nv_bfloat16* __restrict__ v0,
                       const __nv_bfloat16* __restrict__ k1,
                       const __nv_bfloat16* __restrict__ v1,
                       const float* __restrict__ alpha,
                       __nv_bfloat16* __restrict__ out, int B2, int Lq,
                       int Lk, int D, Strides st, float scale, int n_qtiles,
                       int vec) {
  extern __shared__ __align__(16) unsigned char smb[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smb);
  __nv_bfloat16* ring = Qs + C::BQ * C::LD;
  // (1 − α)·o₀, element (j, e) of thread x at [(4j + e)·T + x]
  float* stash = reinterpret_cast<float*>(smb + C::stash_offset) +
                 threadIdx.x;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - b * n_qtiles) * C::BQ;
  const int b1 = b / B2, b2 = b - b1 * B2;
  const long long* s = st.s;
  auto at_b = [&](const __nv_bfloat16* t, int i) {
    return t + b1 * s[3 * i] + b2 * s[3 * i + 1];
  };

  // staged once for both sets
  stage_rows_bf16<C, C::BQ>(Qs, at_b(q, 0), s[2], q0, Lq, D, vec);
  cp_async_commit();
  const float a = alpha[b];
  OnlineSoftmax<C> sm(scale);
  float o[C::DT][4], inv[2], ls[2];
  fwd_walk<C>(Qs, ring, at_b(k0, 1), at_b(v0, 2), s[5], s[8], Lk, D, vec,
              sm, o);
  sm.finish(inv, ls);
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      stash[(4 * j + e) * C::kThreads] = (1.0f - a) * (o[j][e] * inv[e >> 1]);
  sm.reset();
  fwd_walk<C>(Qs, ring, at_b(k1, 3), at_b(v1, 4), s[11], s[14], Lk, D, vec,
              sm, o);
  sm.finish(inv, ls);
  __nv_bfloat16* ob = out + (long long)b * Lq * D;
  for_out_fwd<C>(q0, Lq, D, [&](int row, int d, int h, int j) {
    const float* w = stash + (4 * j + 2 * h) * C::kThreads;
    store_pair_bf16(ob + (long long)row * D + d, d, D,
                    w[0] + a * (o[j][2 * h] * inv[h]),
                    w[C::kThreads] + a * (o[j][2 * h + 1] * inv[h]));
  });
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
  const Strides st{{qs1, qs2, qsl, k0s1, k0s2, k0sl, v0s1, v0s2, v0sl, k1s1,
                    k1s2, k1sl, v1s1, v1s2, v1sl}};
  const float* ts[5] = {q, k0, v0, k1, v1};
  int vec = 1;
  for (int i = 0; i < 5; ++i)
    vec &= vec_ok(ts[i], st.s[3 * i], st.s[3 * i + 1], st.s[3 * i + 2], D);
  return with_dp(D, [&](auto dp) {
    using C = FlashCfg<decltype(dp)::value>;
    const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
    return launch_tiles<C>(flash2_fwd_kernel<C>, (long long)B1 * B2 * n_qtiles,
                           (cudaStream_t)stream, q, k0, v0, k1, v1, alpha, out,
                           B2, Lq, Lk, D, st, scale, n_qtiles, vec);
  });
}

// The bf16 forward: q, k0, v0, k1, v1 and out bf16, alpha f32, the same
// arguments; the scale must be positive.
extern "C" int flash2_fwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k0,
    const __nv_bfloat16* v0, const __nv_bfloat16* k1,
    const __nv_bfloat16* v1, const float* alpha, __nv_bfloat16* out, int B1,
    int B2, int Lq, int Lk, int D, long long qs1, long long qs2,
    long long qsl, long long k0s1, long long k0s2, long long k0sl,
    long long v0s1, long long v0s2, long long v0sl, long long k1s1,
    long long k1s2, long long k1sl, long long v1s1, long long v1s2,
    long long v1sl, float scale, void* stream) {
  const Strides st{{qs1, qs2, qsl, k0s1, k0s2, k0sl, v0s1, v0s2, v0sl, k1s1,
                    k1s2, k1sl, v1s1, v1s2, v1sl}};
  const __nv_bfloat16* ts[5] = {q, k0, v0, k1, v1};
  int vec = 1;
  for (int i = 0; i < 5; ++i)
    vec &= vec_ok_bf16(ts[i], st.s[3 * i], st.s[3 * i + 1], st.s[3 * i + 2],
                       D);
  if (!(scale > 0.0f)) return (int)cudaErrorInvalidValue;
  return with_dp_mma(D, [&](auto dp) {
    return with_fwd_cfg<decltype(dp)::value>(Lk, [&](auto cfg) {
      using C = Fwd2Cfg<decltype(cfg)>;
      const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
      return launch_mma_tiles<C>(flash2_fwd_bf16_kernel<C>,
                                 (long long)B1 * B2 * n_qtiles,
                                 (cudaStream_t)stream, q, k0, v0, k1, v1,
                                 alpha, out, B2, Lq, Lk, D, st, scale,
                                 n_qtiles, vec);
    });
  });
}
