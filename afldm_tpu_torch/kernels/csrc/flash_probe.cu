// Attribution probes of the flash-attention forward (K3), f32 and bf16: two
// kernels with K3's grid, staging and tile loop whose arithmetic is cut
// down, so that flash - dots_only is the online softmax's share of K3's
// time and stream_only is the share of its loads.
//
// Replaces: scripts/bench_flash_sweep.py::dots_only_kernel and
// ::stream_only_kernel (P1 and P2, launched through probe()).
//   P1 flash_probe_dots_f32:   for each K tile acc += (q·k_tileᵀ)·v_tile; no
//      scale, no max, no exp (the softmax replaced by the identity), so
//      out = (q·kᵀ)·v. The matmul-plus-memory floor of K3.
//   P2 flash_probe_stream_f32: for each K tile acc += q + colsum(k_tile) +
//      colsum(v_tile); no products, so out = (Lk/64)·q + Σk + Σv. The pure
//      memory floor of K3's loads. Its value depends on the tile count: the
//      tile here is 64 rows.
//
// What bounds them on this card: P1 does K3's 4·Lq·Lk·D FLOPs per (b·h)
// and is bound by the f32 FMA rate like K3. P2 does almost no arithmetic;
// its bound is the bytes of q, k, v and out read or written once, but like
// K3 it restages each K/V tile once per Q tile (Lq/BQ times), so it
// measures what K3's load pattern costs, which is the point of the probe.
//
// What the design does: K3's own code, from flash_tile.cuh: the same grid,
// block layout, Q and double-buffered cp.async K/V staging, D padding and
// (b1, b2, row) strides (stride-0 K/V allowed). P1 runs the score and P·V
// products with the identity in place of the softmax update; P2 runs the
// staging alone and sums each staged tile's columns. The wrappers require
// Lq and Lk to be multiples of 64, so no key is masked (Q rows past Lq in a
// 128-row tile are computed on zeros and not stored).
//
// bf16 q, k, v (the _bf16 entries, the JAX bodies at bf16).
//   P1 flash_probe_dots_bf16: s = q·k_tileᵀ on the bf16 tensor cores into
//      f32, rounded to bf16 as `s.astype(v_ref.dtype)` does, then acc +=
//      s_bf16·v_tile in f32 and out rounded to bf16 once. It is K3/bf16's
//      tile loop (flash_tile.cuh's fwd_walk on FwdCfg: its grid, K/V ring
//      and products) with the identity for p (IdentityP), so the sweep's
//      1 − P1/K3 is the online softmax's share. Its bound is the bf16
//      tensor-core rate, 4·Lq·Lk·D FLOPs per (b·h).
//   P2 flash_probe_stream_bf16: MmaCfg's grid and staging (64-row Q tiles
//      of 4 warps, stage_rows_bf16): each staged bf16 K and V tile's column
//      sums in f32 (over its 64 rows, ascending), acc += q + colsum(k) +
//      colsum(v) in f32 for each element, out rounded to bf16 once. Bound:
//      the bytes, as for f32.

#include "flash_tile.cuh"

namespace {

using namespace afldm_flash;

template <class T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int B2, Lq, Lk, D;
  long long qs1, qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl;
  int n_qtiles, vec;
};

// P1's body: the score product with the identity as its softmax.
template <class C>
struct Dots {
  Lane<C> ln;
  const float* Qs;
  float* Ps;
  float acc[C::TM][C::TD];
  __device__ __forceinline__ Dots(const float* Qs_, float* Ps_)
      : Qs(Qs_), Ps(Ps_) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int t = 0; t < C::TD; ++t) acc[i][t] = 0.0f;
  }
  __device__ __forceinline__ void on_k(const float* Ks, int) {
    float s[C::TM][C::TN];
    score_tile<C>(Qs, Ks, ln, s);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        Ps[ln.row(i) * C::PLD + ln.key(j)] = s[i][j];
    __syncwarp();  // a row's P is written and read by one warp's lanes
  }
  __device__ __forceinline__ void on_v(const float* Vs, int) {
    pv_tile<C>(Ps, Vs, ln, acc);
  }
};

// P2's body: the column sums of each staged K and V tile (into the P
// buffer, 2·DP floats), added to q for this thread's elements.
template <class C>
struct Stream {
  Lane<C> ln;
  const float* Qs;
  float* Cs;
  float acc[C::TM][C::TD];
  __device__ __forceinline__ Stream(const float* Qs_, float* Cs_)
      : Qs(Qs_), Cs(Cs_) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int t = 0; t < C::TD; ++t) acc[i][t] = 0.0f;
  }
  __device__ __forceinline__ void colsum(const float* T, float* dst) {
    for (int c = threadIdx.x; c < C::DP; c += C::kThreads) {
      float sum = 0.0f;
      for (int rr = 0; rr < kBK; ++rr) sum += T[rr * C::LD + c];
      dst[c] = sum;
    }
  }
  __device__ __forceinline__ void on_k(const float* Ks, int) {
    colsum(Ks, Cs);
  }
  __device__ __forceinline__ void on_v(const float* Vs, int) {
    colsum(Vs, Cs + C::DP);
    __syncthreads();  // both column sums are written
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int t = 0; t < C::TD; ++t) {
        const int d = ln.col(t);
        acc[i][t] += Qs[ln.row(i) * C::LD + d] + Cs[d] + Cs[C::DP + d];
      }
  }
};

template <class C, template <class> class Body>
__global__ void __launch_bounds__(C::kThreads) probe_kernel(Args<float> a) {
  extern __shared__ __align__(16) float sm[];
  const Smem<C> S(sm);
  const int b = blockIdx.x / a.n_qtiles;
  const int q0 = (blockIdx.x - b * a.n_qtiles) * C::BQ;
  const int b1 = b / a.B2, b2 = b - b1 * a.B2;
  stage_rows<C, C::BQ>(S.Qs, a.q + b1 * a.qs1 + b2 * a.qs2, a.qsl, q0, a.Lq,
                       a.D, a.vec);
  cp_async_commit();
  Body<C> body(S.Qs, S.Ps);
  walk_kv<C>(a.k + b1 * a.ks1 + b2 * a.ks2, a.v + b1 * a.vs1 + b2 * a.vs2,
             a.ksl, a.vsl, a.Lk, a.D, a.vec, S.Ks, S.Vs, body);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = q0 + body.ln.row(i);
    if (row >= a.Lq) continue;
    float* ob = a.out + ((long long)b * a.Lq + row) * a.D;
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      const int d = body.ln.col(t);
      if (d < a.D) ob[d] = body.acc[i][t];
    }
  }
}

template <template <class> class Body>
int dispatch(const float* q, const float* k, const float* v, float* out,
             int B1, int B2, int Lq, int Lk, int D, long long qs1,
             long long qs2, long long qsl, long long ks1, long long ks2,
             long long ksl, long long vs1, long long vs2, long long vsl,
             void* stream) {
  if (Lq % kBK != 0 || Lk % kBK != 0 || Lq == 0 || Lk == 0)
    return (int)cudaErrorInvalidValue;
  const int vec = vec_ok(q, qs1, qs2, qsl, D) && vec_ok(k, ks1, ks2, ksl, D) &&
                  vec_ok(v, vs1, vs2, vsl, D);
  return with_dp(D, [&](auto dp) {
    using C = FlashCfg<decltype(dp)::value>;
    const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
    const Args<float> a{q,   k,   v,   out, B2,  Lq,  Lk,       D,  qs1,
                        qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl, n_qtiles,
                        vec};
    return launch_tiles<C>(probe_kernel<C, Body>, (long long)B1 * B2 * n_qtiles,
                           (cudaStream_t)stream, a);
  });
}

using bf16 = __nv_bfloat16;

// P2's bf16 body: K_j in K0 and V_j in Vs, each tile's f32 column sums in
// the otherwise unused K1 buffer (2·DP floats fit in its 64·LD bf16), added
// to q for each of this thread's elements (mma_scores' accumulator
// layout). K_{j+1} is in flight while V_j's sums are taken.
struct StreamBf16 {
  template <class C>
  __device__ __forceinline__ static void colsum(const bf16* T, float* dst) {
    for (int c = threadIdx.x; c < C::DP; c += C::kThreads) {
      float sum = 0.0f;
      for (int rr = 0; rr < kBK; ++rr)
        sum += __bfloat162float(T[rr * C::LD + c]);
      dst[c] = sum;
    }
  }
  template <class C>
  __device__ __forceinline__ static void run(const MmaSmem<C>& S,
                                             const bf16* kb, const bf16* vb,
                                             const Args<bf16>& a,
                                             float (&o)[C::DT][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    float* Cs = reinterpret_cast<float*>(S.K1);
#pragma unroll
    for (int t = 0; t < C::DT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
    stage_rows_bf16<C, kBK>(S.K0, kb, a.ksl, 0, a.Lk, a.D, a.vec);
    cp_async_commit();
    stage_rows_bf16<C, kBK>(S.Vs, vb, a.vsl, 0, a.Lk, a.D, a.vec);
    cp_async_commit();
    for (int k0 = 0; k0 < a.Lk; k0 += kBK) {
      cp_async_wait<1>();  // all but V_j: K_j (and Q) have landed
      __syncthreads();
      colsum<C>(S.K0, Cs);
      __syncthreads();     // K_j is no longer read
      if (k0 + kBK < a.Lk)
        stage_rows_bf16<C, kBK>(S.K0, kb, a.ksl, k0 + kBK, a.Lk, a.D, a.vec);
      cp_async_commit();
      cp_async_wait<1>();  // all but K_{j+1}: V_j has landed
      __syncthreads();
      colsum<C>(S.Vs, Cs + C::DP);
      __syncthreads();     // V_j is no longer read; both sums are written
      if (k0 + kBK < a.Lk)
        stage_rows_bf16<C, kBK>(S.Vs, vb, a.vsl, k0 + kBK, a.Lk, a.D, a.vec);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < C::DT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 8 * j + t2 + e;
            const float qv =
                __bfloat162float(S.Qs[(16 * warp + g + 8 * h) * C::LD + d]);
            o[j][2 * h + e] += qv + Cs[d] + Cs[C::DP + d];
          }
      // the next tile's sums overwrite Cs after the wait and sync at the top
    }
    cp_async_wait<0>();
  }
};

// P1's bf16 kernel: K3/bf16's walk with the identity for p.
template <class C>
__global__ void __launch_bounds__(C::kThreads)
    probe_dots_bf16_kernel(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smb[];
  bf16* Qs = reinterpret_cast<bf16*>(smb);
  const int b = blockIdx.x / a.n_qtiles;
  const int q0 = (blockIdx.x - b * a.n_qtiles) * C::BQ;
  const int b1 = b / a.B2, b2 = b - b1 * a.B2;
  stage_rows_bf16<C, C::BQ>(Qs, a.q + b1 * a.qs1 + b2 * a.qs2, a.qsl, q0,
                            a.Lq, a.D, a.vec);
  cp_async_commit();
  IdentityP<C> id;
  float o[C::DT][4];
  fwd_walk<C>(Qs, Qs + C::BQ * C::LD, a.k + b1 * a.ks1 + b2 * a.ks2,
              a.v + b1 * a.vs1 + b2 * a.vs2, a.ksl, a.vsl, a.Lk, a.D, a.vec,
              id, o);
  bf16* ob = a.out + (long long)b * a.Lq * a.D;
  for_out_fwd<C>(q0, a.Lq, a.D, [&](int row, int d, int h, int j) {
    store_pair_bf16(ob + (long long)row * a.D + d, d, a.D, o[j][2 * h],
                    o[j][2 * h + 1]);
  });
}

template <class C, class Body>
__global__ void __launch_bounds__(C::kThreads)
    probe_bf16_kernel(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smb[];
  const MmaSmem<C> S(reinterpret_cast<bf16*>(smb));
  const int b = blockIdx.x / a.n_qtiles;
  const int q0 = (blockIdx.x - b * a.n_qtiles) * C::BQ;
  const int b1 = b / a.B2, b2 = b - b1 * a.B2;
  stage_rows_bf16<C, C::BQ>(S.Qs, a.q + b1 * a.qs1 + b2 * a.qs2, a.qsl, q0,
                            a.Lq, a.D, a.vec);
  cp_async_commit();
  float o[C::DT][4];
  Body::template run<C>(S, a.k + b1 * a.ks1 + b2 * a.ks2,
                        a.v + b1 * a.vs1 + b2 * a.vs2, a, o);
  bf16* ob = a.out + (long long)b * a.Lq * a.D;
  for_out<C>(q0, a.Lq, a.D, [&](int row, int d, int e, int j) {
    ob[(long long)row * a.D + d] = __float2bfloat16_rn(o[j][e]);
  });
}

// Launches P1 (Body void: probe_dots_bf16_kernel on FwdCfg) or P2
// (StreamBf16 on MmaCfg).
template <class Body>
int dispatch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                  int B1, int B2, int Lq, int Lk, int D, long long qs1,
                  long long qs2, long long qsl, long long ks1, long long ks2,
                  long long ksl, long long vs1, long long vs2, long long vsl,
                  void* stream) {
  if (Lq % kBK != 0 || Lk % kBK != 0 || Lq == 0 || Lk == 0)
    return (int)cudaErrorInvalidValue;
  const int vec = vec_ok_bf16(q, qs1, qs2, qsl, D) &&
                  vec_ok_bf16(k, ks1, ks2, ksl, D) &&
                  vec_ok_bf16(v, vs1, vs2, vsl, D);
  return with_dp_mma(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (std::is_void_v<Body>) {
      using C = FwdCfg<DP>;
      const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
      const Args<bf16> a{q,   k,   v,   out, B2,  Lq,  Lk,       D,  qs1,
                         qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl, n_qtiles,
                         vec};
      return launch_mma_tiles<C>(probe_dots_bf16_kernel<C>,
                                 (long long)B1 * B2 * n_qtiles,
                                 (cudaStream_t)stream, a);
    } else {
      using C = MmaCfg<DP>;
      static_assert(2 * C::DP * sizeof(float) <= kBK * C::LD * sizeof(bf16),
                    "P2's column sums fit in the K1 buffer");
      const int n_qtiles = (Lq + C::BQ - 1) / C::BQ;
      const Args<bf16> a{q,   k,   v,   out, B2,  Lq,  Lk,       D,  qs1,
                         qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl, n_qtiles,
                         vec};
      return launch_mma_tiles<C>(probe_bf16_kernel<C, Body>,
                                 (long long)B1 * B2 * n_qtiles,
                                 (cudaStream_t)stream, a);
    }
  });
}

}  // namespace

// out is contiguous (B1, B2, Lq, D); q, k, v have unit stride along D and
// the given (b1, b2, row) strides in elements. Lq and Lk are multiples of 64.
extern "C" int flash_probe_dots_f32(const float* q, const float* k,
                                    const float* v, float* out, int B1,
                                    int B2, int Lq, int Lk, int D,
                                    long long qs1, long long qs2,
                                    long long qsl, long long ks1,
                                    long long ks2, long long ksl,
                                    long long vs1, long long vs2,
                                    long long vsl, void* stream) {
  return dispatch<Dots>(q, k, v, out, B1, B2, Lq, Lk, D, qs1, qs2, qsl, ks1,
                        ks2, ksl, vs1, vs2, vsl, stream);
}

extern "C" int flash_probe_stream_f32(const float* q, const float* k,
                                      const float* v, float* out, int B1,
                                      int B2, int Lq, int Lk, int D,
                                      long long qs1, long long qs2,
                                      long long qsl, long long ks1,
                                      long long ks2, long long ksl,
                                      long long vs1, long long vs2,
                                      long long vsl, void* stream) {
  return dispatch<Stream>(q, k, v, out, B1, B2, Lq, Lk, D, qs1, qs2, qsl, ks1,
                          ks2, ksl, vs1, vs2, vsl, stream);
}

// The bf16 probes: q, k, v and out bfloat16, the same arguments.
extern "C" int flash_probe_dots_bf16(const bf16* q, const bf16* k,
                                     const bf16* v, bf16* out, int B1, int B2,
                                     int Lq, int Lk, int D, long long qs1,
                                     long long qs2, long long qsl,
                                     long long ks1, long long ks2,
                                     long long ksl, long long vs1,
                                     long long vs2, long long vsl,
                                     void* stream) {
  return dispatch_bf16<void>(q, k, v, out, B1, B2, Lq, Lk, D, qs1, qs2,
                                 qsl, ks1, ks2, ksl, vs1, vs2, vsl, stream);
}

extern "C" int flash_probe_stream_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, bf16* out, int B1,
                                       int B2, int Lq, int Lk, int D,
                                       long long qs1, long long qs2,
                                       long long qsl, long long ks1,
                                       long long ks2, long long ksl,
                                       long long vs1, long long vs2,
                                       long long vsl, void* stream) {
  return dispatch_bf16<StreamBf16>(q, k, v, out, B1, B2, Lq, Lk, D, qs1, qs2,
                                   qsl, ks1, ks2, ksl, vs1, vs2, vsl, stream);
}
