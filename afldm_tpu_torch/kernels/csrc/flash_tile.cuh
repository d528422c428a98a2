// The register-tiled f32 tile loop shared by the flash-attention forward
// (flash_fwd.cu, K3), the two-KV forward (flash2_fwd.cu, K6), the
// attribution probes (flash_probe.cu, P1 and P2) and the flash backward
// (flash_bwd.cu, K4a and K4b): staging of the Q tile and of the K/V tiles,
// the score product, the online-softmax update, the P·V product, and the
// backward's p/ds step, bodies and walker (at the end of this file). Each
// .cu keeps only its kernel's prologue and epilogue.
//
// Layout of a block (FlashCfg<DP>): kThreads threads in TR row groups × TC
// column groups; thread (r, c) owns the TM = 4 query rows {r + TR·i} of the
// BQ-row Q tile. In the score product it owns the TN keys {c + TC·j} of the
// 64-key tile, a TM×TN register micro-tile of S; in the P·V product the TD
// output columns of its column group (chunks of CW columns, interleaved
// with the other groups' chunks), a TM×TD micro-tile of O. Every value read
// from shared memory feeds TN (a q value), TM (a k or v value) or TD (a p
// value) FMAs, all at least 4. The row max and row sum live in the TC lanes
// of one warp that share a row group and are combined with shuffles.
//
// D is zero-padded to DP, the smallest of {24, 32, 40, 64, 80, 128, 160,
// 256} at least D, so the model's head dims 24, 40, 80 and 160 waste no
// FMA. Tiles are row-major with rows padded to LD = DP + 4 floats: DP % 8 ==
// 0 makes LD/4 odd, so the 8 lanes of a float4 phase that read 8 different
// rows hit 8 different bank quads. K is not staged transposed: cp.async
// copies 16 contiguous bytes and cannot transpose, and a thread's keys at
// four consecutive d are one float4 per key instead, the same reuse.
//
// Staging: where every row base is 16-byte aligned and D % 4 == 0 (the
// wrapper checks it), 16-byte cp.async copies, zero-filled past D and past
// the last row; otherwise a masked scalar copy in the same loop. The chunk
// index is split by a compile-time constant (a multiply, not a division).
// K and V of a tile take two buffers: while the score product and softmax
// of tile j run, V_j is in flight; while its P·V product runs, K_{j+1} is.
//
// The arithmetic is exact f32 FMA, in the order of the plain version's
// sums over d and over keys; no TF32, no tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "filtered_mma.cuh"

namespace afldm_flash {

constexpr int kBK = 64;  // keys per K/V tile

template <int DP_, int kThreads_, int TC_, int CW_>
struct Cfg {
  static constexpr int DP = DP_;
  static constexpr int kThreads = kThreads_;
  static constexpr int TC = TC_;                // column groups
  static constexpr int TR = kThreads / TC;      // row groups
  static constexpr int TM = 4;                  // rows a thread
  static constexpr int BQ = TR * TM;            // Q tile rows
  static constexpr int TN = kBK / TC;           // keys a thread
  static constexpr int TD = DP / TC;            // output columns a thread
  static constexpr int CW = CW_;                // columns a vector read
  static constexpr int LD = DP + 4;             // padded tile row
  static constexpr int PLD = kBK + TC;          // padded P row
  static_assert(DP % 8 == 0 && kBK % TC == 0 && DP % TC == 0, "tiling");
  static_assert(TD % CW == 0 && (CW == 1 || CW == 2 || CW == 4), "chunks");
  static_assert(TN >= 4 && TD >= 4, "each shared read feeds >= 4 FMAs");
  // Q, two K/V buffers, P
  static constexpr size_t smem_floats =
      (size_t)BQ * LD + 2 * (size_t)kBK * LD + (size_t)BQ * PLD;
};

template <int DP> struct FlashCfg;
template <> struct FlashCfg<24> : Cfg<24, 128, 4, 2> {};
template <> struct FlashCfg<32> : Cfg<32, 256, 8, 4> {};
template <> struct FlashCfg<40> : Cfg<40, 256, 8, 1> {};
template <> struct FlashCfg<64> : Cfg<64, 256, 8, 4> {};
template <> struct FlashCfg<80> : Cfg<80, 256, 8, 2> {};
template <> struct FlashCfg<128> : Cfg<128, 256, 8, 4> {};
template <> struct FlashCfg<160> : Cfg<160, 256, 8, 4> {};
template <> struct FlashCfg<256> : Cfg<256, 256, 16, 4> {};

// f(std::integral_constant<int, DP>) for the smallest instantiated DP >= D.
template <class F>
int with_dp(int D, F&& f) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  if (D <= 24) return f(std::integral_constant<int, 24>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 40) return f(std::integral_constant<int, 40>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 80) return f(std::integral_constant<int, 80>{});
  if (D <= 128) return f(std::integral_constant<int, 128>{});
  if (D <= 160) return f(std::integral_constant<int, 160>{});
  if (D <= 256) return f(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

// True when a (b1, b2, row)-strided f32 tensor can be staged with 16-byte
// copies: base and every stride a multiple of 4 floats, and D % 4 == 0.
inline bool vec_ok(const float* p, long long s1, long long s2, long long sl,
                   int D) {
  return ((uintptr_t)p & 15) == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
         sl % 4 == 0 && D % 4 == 0;
}

// Sets the dynamic shared memory of ``kernel`` and launches it on one
// block per (b, Q tile).
template <class C, class K, class... Args>
int launch_tiles(K kernel, long long n_blocks, cudaStream_t stream,
                 Args... args) {
  const size_t smem = C::smem_floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)n_blocks, C::kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[rr][0:DP] = src rows r0 + rr (rr < ROWS) at row stride ``rs``,
// zero past D and past row L. Issues cp.async copies (vec) or copies
// synchronously; the caller commits the group.
template <class C, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long rs, int r0, int L,
                                           int D, bool vec) {
  constexpr int CPR = C::DP / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += C::kThreads) {
    const int rr = i / CPR;
    const int d = (i - rr * CPR) * 4;
    const int row = r0 + rr;
    float* s = dst + rr * C::LD + d;
    const float* g = src + (long long)row * rs + d;
    if (vec) {
      const bool ok = row < L && d < D;
      cp_async16(s, ok ? g : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = (row < L && d + e < D) ? g[e] : 0.0f;
    }
  }
}

// This thread's place in the block.
template <class C>
struct Lane {
  int r, c;
  __device__ __forceinline__ Lane()
      : r(threadIdx.x / C::TC), c(threadIdx.x % C::TC) {}
  __device__ __forceinline__ int row(int i) const { return r + C::TR * i; }
  __device__ __forceinline__ int key(int j) const { return c + C::TC * j; }
  // the output column of this thread's t-th accumulator
  __device__ __forceinline__ int col(int t) const {
    return ((t / C::CW) * C::TC + c) * C::CW + t % C::CW;
  }
};

// Max or sum over the TC lanes of a row group (one warp).
template <class C>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = C::TC / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <class C>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = C::TC / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s = Q_tile · K_tileᵀ for this thread's TM rows and TN keys, d ascending.
template <class C>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks,
                                           const Lane<C>& ln,
                                           float (&s)[C::TM][C::TN]) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < C::DP; d += 4) {
    float4 qa[C::TM], kb[C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      qa[i] = *reinterpret_cast<const float4*>(Qs + ln.row(i) * C::LD + d);
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      kb[j] = *reinterpret_cast<const float4*>(Ks + ln.key(j) * C::LD + d);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        float a = s[i][j];
        a = fmaf(qa[i].x, kb[j].x, a);
        a = fmaf(qa[i].y, kb[j].y, a);
        a = fmaf(qa[i].z, kb[j].z, a);
        s[i][j] = fmaf(qa[i].w, kb[j].w, a);
      }
  }
}

// acc += P_tile · V_tile for this thread's TM rows and TD columns, keys
// ascending. P rows are read by the lanes of the warp that wrote them.
template <class C>
__device__ __forceinline__ void pv_tile(const float* Ps, const float* Vs,
                                        const Lane<C>& ln,
                                        float (&acc)[C::TM][C::TD]) {
#pragma unroll 2
  for (int k = 0; k < kBK; k += 4) {
    float4 p[C::TM];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + ln.row(i) * C::PLD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* vr = Vs + (k + kk) * C::LD;
      float v[C::TD];
#pragma unroll
      for (int g = 0; g < C::TD / C::CW; ++g) {
        const float* src = vr + (g * C::TC + ln.c) * C::CW;
        if constexpr (C::CW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          v[4 * g] = t.x; v[4 * g + 1] = t.y;
          v[4 * g + 2] = t.z; v[4 * g + 3] = t.w;
        } else if constexpr (C::CW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(src);
          v[2 * g] = t.x; v[2 * g + 1] = t.y;
        } else {
          v[g] = *src;
        }
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y
                       : kk == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int t = 0; t < C::TD; ++t) acc[i][t] = fmaf(pk, v[t], acc[i][t]);
      }
    }
  }
}

// Walks the K/V sequence in 64-key tiles through two buffers: body.on_k(Ks,
// k0) once K's tile is in shared memory, body.on_v(Vs, k0) once V's is.
// Every thread calls it. The Q tile, if staged just before and committed,
// has landed by the first on_k.
template <class C, class Body>
__device__ __forceinline__ void walk_kv(const float* kb, const float* vb,
                                        long long ksl, long long vsl, int Lk,
                                        int D, bool vec, float* Ks, float* Vs,
                                        Body& body) {
  stage_rows<C, kBK>(Ks, kb, ksl, 0, Lk, D, vec);
  cp_async_commit();
  stage_rows<C, kBK>(Vs, vb, vsl, 0, Lk, D, vec);
  cp_async_commit();
  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    cp_async_wait<1>();  // all but V_j: K_j (and Q) have landed
    __syncthreads();
    body.on_k(Ks, k0);
    __syncthreads();     // K_j is no longer read
    if (k0 + kBK < Lk) stage_rows<C, kBK>(Ks, kb, ksl, k0 + kBK, Lk, D, vec);
    cp_async_commit();
    cp_async_wait<1>();  // all but K_{j+1}: V_j has landed
    __syncthreads();
    body.on_v(Vs, k0);
    __syncthreads();     // V_j and P are no longer read
    if (k0 + kBK < Lk) stage_rows<C, kBK>(Vs, vb, vsl, k0 + kBK, Lk, D, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// The shared-memory carve-up of a block.
template <class C>
struct Smem {
  float* Qs;  // BQ × LD
  float* Ks;  // kBK × LD
  float* Vs;  // kBK × LD
  float* Ps;  // BQ × PLD
  __device__ __forceinline__ explicit Smem(float* sm)
      : Qs(sm), Ks(sm + C::BQ * C::LD), Vs(Ks + kBK * C::LD),
        Ps(Vs + kBK * C::LD) {}
};

// One online-softmax attention of the staged Q tile over one K/V set:
// acc holds the unnormalised output, m the row max, l this thread's share
// of the row sum (row_sum over the row group gives the whole).
template <class C>
struct Attend {
  Lane<C> ln;
  const float* Qs;
  float* Ps;
  float scale;
  int Lk;
  float acc[C::TM][C::TD];
  float m[C::TM], l[C::TM];

  __device__ __forceinline__ Attend(const float* Qs_, float* Ps_, float sc,
                                    int Lk_)
      : Qs(Qs_), Ps(Ps_), scale(sc), Lk(Lk_) {
    reset();
  }
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.0f;
#pragma unroll
      for (int t = 0; t < C::TD; ++t) acc[i][t] = 0.0f;
    }
  }
  // scores, then the online-softmax update: keys past Lk score -inf, the
  // accumulator is rescaled by exp(m_old - m_new) and p goes to Ps
  __device__ __forceinline__ void on_k(const float* Ks, int k0) {
    float s[C::TM][C::TN];
    score_tile<C>(Qs, Ks, ln, s);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        s[i][j] = (k0 + ln.key(j) < Lk) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max<C>(mx));  // finite: a valid key
      const float corr = expf(m[i] - m_new);             // 0 on the first tile
      m[i] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[ln.row(i) * C::PLD + ln.key(j)] = p;
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int t = 0; t < C::TD; ++t) acc[i][t] *= corr;
    }
    __syncwarp();  // a row's P is written and read by one warp's lanes
  }
  __device__ __forceinline__ void on_v(const float* Vs, int) {
    pv_tile<C>(Ps, Vs, ln, acc);
  }
  // 1 / (the whole row sum) for row i; every lane of the row group calls it
  __device__ __forceinline__ float inv_l(int i) const {
    return 1.0f / row_sum<C>(l[i]);
  }
  __device__ __forceinline__ float lse(int i) const {
    return m[i] + logf(row_sum<C>(l[i]));
  }
};

// ---------------------------------------------------------------------------
// The backward (K4a, K4b). Both kernels recompute p = exp(s·scale − lse)
// from the forward's lse and form ds = p ⊙ (dp − delta)·scale, and each of
// their products is one of the two above:
//
//   dq  (a block's rows: a Q tile; it walks K/V)
//       dp = dO·Vᵀ, s = Q·Kᵀ           score_tile
//       dq += ds·K                     pv_tile
//   dkv (a block's rows: a K/V tile; it walks Q and dO)
//       sᵀ = K·Qᵀ, dpᵀ = V·dOᵀ         score_tile
//       dv += pᵀ·dO, dk += dsᵀ·Q       pv_tile
//
// so every shared read feeds at least 4 FMAs, as in the forward. Only one
// TM×TN score micro-tile is live at a time: p, dp and ds pass through the
// block's P tile, each element written and read back by the thread that
// owns it, and a row of P is read by the warp that wrote it.
//
// BwdCfg<DP> is the forward's tiling up to DP = 80. At DP = 128 and 160 a
// block holds a Q tile (dq) or K/V tile (dkv) besides the walked tiles and
// a second row tile (dO, or V), so 128 rows do not fit 227 KB: 16 column
// groups of 256 threads make 64-row tiles; at DP = 256, 128 threads make
// 32-row tiles.

template <int DP> struct BwdCfg;
template <> struct BwdCfg<24> : Cfg<24, 128, 4, 2> {};
template <> struct BwdCfg<32> : Cfg<32, 256, 8, 4> {};
template <> struct BwdCfg<40> : Cfg<40, 256, 8, 1> {};
template <> struct BwdCfg<64> : Cfg<64, 256, 8, 4> {};
template <> struct BwdCfg<80> : Cfg<80, 256, 8, 2> {};
template <> struct BwdCfg<128> : Cfg<128, 256, 16, 4> {};
template <> struct BwdCfg<160> : Cfg<160, 256, 16, 2> {};
template <> struct BwdCfg<256> : Cfg<256, 128, 16, 4> {};

constexpr size_t kMaxSmemBytes = 232448;  // a block's shared memory, 227 KB

// dq's shared memory: the Q and dO tiles, walk_kv's two buffers, P.
template <class B>
struct DqCfg : B {
  static constexpr size_t smem_floats =
      2 * (size_t)B::BQ * B::LD + 2 * (size_t)kBK * B::LD +
      (size_t)B::BQ * B::PLD;
  static_assert(smem_floats * sizeof(float) <= kMaxSmemBytes, "dq smem");
};

// dkv's: the K and V tiles, P, and kStages stages of walk_pair (a Q and a
// dO tile and their 64 lse and delta values): two where they fit.
template <class B>
struct DkvCfg : B {
  static constexpr size_t stage_floats = 2 * (size_t)kBK * B::LD + 2 * kBK;
  static constexpr size_t fixed_floats =
      2 * (size_t)B::BQ * B::LD + (size_t)B::BQ * B::PLD;
  static constexpr int kStages =
      (fixed_floats + 2 * stage_floats) * sizeof(float) <= kMaxSmemBytes ? 2
                                                                         : 1;
  static constexpr size_t smem_floats = fixed_floats + kStages * stage_floats;
  static_assert(smem_floats * sizeof(float) <= kMaxSmemBytes, "dkv smem");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// dst[0:N] = src[r0 : r0 + N], zero past L, by 4-byte cp.async copies
// (a row of lse or delta: any base, no alignment needed).
template <class C, int N = kBK>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int L) {
  for (int i = threadIdx.x; i < N; i += C::kThreads) {
    const bool ok = r0 + i < L;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

// p of one (query, key) pair, 0 where either is past its length.
__device__ __forceinline__ float bwd_p(float s, float scale, float lse,
                                       bool valid) {
  return valid ? expf(s * scale - lse) : 0.0f;
}
__device__ __forceinline__ float bwd_ds(float p, float dp, float delta,
                                        float scale) {
  return p * (dp - delta) * scale;
}

// Walks the Q and dO sequences (dkv) in 64-row tiles, with each tile's 64
// lse and delta values, through S stages: body.on_pair(Qs, Os, xs, r0) once
// both tiles of step j and xs = [lse | delta] have landed, with step
// j + S − 1 in flight meanwhile (S = 1: none). Every thread calls it. Row
// tiles staged and committed just before have landed by the first on_pair.
template <class C, int S, class Body>
__device__ __forceinline__ void walk_pair(const float* qb, const float* ob,
                                          long long qsl, long long osl,
                                          const float* lse, const float* dl,
                                          int L, int D, bool vec, float* buf,
                                          Body& body) {
  constexpr size_t kStage = 2 * (size_t)kBK * C::LD + 2 * kBK;
  const int n = (L + kBK - 1) / kBK;
  auto stage_step = [&](int j) {  // step j into its stage; empty past n
    if (j < n) {
      float* s = buf + (j % S) * kStage;
      stage_rows<C, kBK>(s, qb, qsl, j * kBK, L, D, vec);
      stage_rows<C, kBK>(s + kBK * C::LD, ob, osl, j * kBK, L, D, vec);
      stage_vec<C>(s + 2 * kBK * C::LD, lse, j * kBK, L);
      stage_vec<C>(s + 2 * kBK * C::LD + kBK, dl, j * kBK, L);
    }
    cp_async_commit();
  };
  for (int j = 0; j < S - 1; ++j) stage_step(j);
  for (int j = 0; j < n; ++j) {
    stage_step(j + S - 1);
    cp_async_wait<S - 1>();  // all but the newest S − 1: step j has landed
    __syncthreads();
    const float* s = buf + (j % S) * kStage;
    body.on_pair(s, s + kBK * C::LD, s + 2 * kBK * C::LD, j * kBK);
    __syncthreads();         // step j's stage and P are no longer read
  }
  cp_async_wait<0>();
}

// The dq body (K4a) for walk_kv, which is handed V's sequence first and
// K's second: on_k(V_j) forms dp = dO·V_jᵀ into P; on_v(K_j) forms s =
// Q·K_jᵀ, p and ds over dp in place, then acc += ds·K_j. Both uses of K_j
// fall in one call, so walk_kv's two buffers serve unchanged, with one tile
// in flight while the other is computed on. The rows' lse and delta stay in
// registers.
template <class C>
struct DqBody {
  Lane<C> ln;
  const float* Qs;
  const float* Os;
  float* Ps;
  float scale;
  int Lk;
  float lse[C::TM], dl[C::TM];
  float acc[C::TM][C::TD];

  // lse_b, dl_b: this (b1, b2)'s Lq values; q0: the tile's first row
  __device__ __forceinline__ DqBody(const float* Qs_, const float* Os_,
                                    float* Ps_, float sc, int Lk_,
                                    const float* lse_b, const float* dl_b,
                                    int q0, int Lq)
      : Qs(Qs_), Os(Os_), Ps(Ps_), scale(sc), Lk(Lk_) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int row = q0 + ln.row(i);
      lse[i] = row < Lq ? lse_b[row] : 0.0f;
      dl[i] = row < Lq ? dl_b[row] : 0.0f;
#pragma unroll
      for (int t = 0; t < C::TD; ++t) acc[i][t] = 0.0f;
    }
  }
  __device__ __forceinline__ void on_k(const float* Vs, int) {
    float dp[C::TM][C::TN];
    score_tile<C>(Os, Vs, ln, dp);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        Ps[ln.row(i) * C::PLD + ln.key(j)] = dp[i][j];
  }
  __device__ __forceinline__ void on_v(const float* Ks, int k0) {
    float s[C::TM][C::TN];
    score_tile<C>(Qs, Ks, ln, s);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        float* pp = Ps + ln.row(i) * C::PLD + ln.key(j);
        const float p = bwd_p(s[i][j], scale, lse[i], k0 + ln.key(j) < Lk);
        *pp = bwd_ds(p, *pp, dl[i], scale);
      }
    __syncwarp();  // a row's ds is written and read by one warp's lanes
    pv_tile<C>(Ps, Ks, ln, acc);
  }
};

// The dkv body (K4b) for walk_pair: the block's K and V tiles are its rows,
// the walked Q/dO tile's 64 queries its columns. p goes to P for dv +=
// pᵀ·dO; then dp, and ds over p in place for dk += dsᵀ·Q.
template <class C>
struct DkvBody {
  Lane<C> ln;
  const float* Ks;
  const float* Vs;
  float* Ps;
  float scale;
  int Lq;
  float dk[C::TM][C::TD], dv[C::TM][C::TD];

  __device__ __forceinline__ DkvBody(const float* Ks_, const float* Vs_,
                                     float* Ps_, float sc, int Lq_)
      : Ks(Ks_), Vs(Vs_), Ps(Ps_), scale(sc), Lq(Lq_) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int t = 0; t < C::TD; ++t) dk[i][t] = dv[i][t] = 0.0f;
  }
  // xs: the tile's 64 lse values, then its 64 delta values
  __device__ __forceinline__ void on_pair(const float* Qs, const float* Os,
                                          const float* xs, int q0) {
    float s[C::TM][C::TN];
    score_tile<C>(Ks, Qs, ln, s);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        Ps[ln.row(i) * C::PLD + ln.key(j)] =
            bwd_p(s[i][j], scale, xs[ln.key(j)], q0 + ln.key(j) < Lq);
    __syncwarp();
    pv_tile<C>(Ps, Os, ln, dv);
    score_tile<C>(Vs, Os, ln, s);  // dpᵀ
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        s[i][j] = bwd_ds(Ps[ln.row(i) * C::PLD + ln.key(j)], s[i][j],
                         xs[kBK + ln.key(j)], scale);
    __syncwarp();  // the row group's lanes have read P for dv
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        Ps[ln.row(i) * C::PLD + ln.key(j)] = s[i][j];
    __syncwarp();
    pv_tile<C>(Ps, Qs, ln, dk);
  }
};

// ---------------------------------------------------------------------------
// The bf16 staging and products shared by the bf16 kernels: MmaCfg (the
// grid of P2/bf16, flash_probe_stream_bf16), with_dp_mma, stage_rows_bf16
// (also the bf16 backward's, below) and mma_scores. The bf16 forward tile
// loop of K3, K6 and P1 follows them.
//
// A warp of MmaCfg owns 16 query rows (4 warps, a 64-row Q tile a block)
// and runs mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on
// fragments loaded by ldmatrix (filtered_mma.cuh): Q as the A operand of
// S = Q·Kᵀ, K rows as its B operand.
//
// D is zero-padded to DP, a multiple of 16 (the path's 24 to 32, the SD
// UNet's 40 to 48); rows are DP + 8 bf16 apart in shared memory, an odd
// multiple of 16 bytes, so the 8 rows an ldmatrix phase reads fall on
// different 16-byte bank groups. Staging is 16-byte cp.async (8 bf16)
// where every row base is 16-byte aligned and D % 8 == 0, else a masked
// scalar copy; keys past Lk score -inf, queries past Lq run on zero rows
// and are not stored. K/V with a batch stride of 0 are read in place.

template <int DP_>
struct MmaCfg {
  static constexpr int DP = DP_;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;  // Q tile rows
  static constexpr int LD = DP + 8;       // padded row, in bf16
  static constexpr int NT = kBK / 8;      // 8-key score tiles of a warp
  static constexpr int DT = DP / 8;       // 8-column output tiles of a warp
  static_assert(DP % 16 == 0, "mma k steps");
  // Q, P2's K tile, its column sums (the K1 buffer), V
  static constexpr size_t smem_bytes = (size_t)(BQ + 3 * kBK) * LD * 2;
};

// f(std::integral_constant<int, DP>) for the smallest instantiated
// multiple of 16 at least D.
template <class F>
int with_dp_mma(int D, F&& f) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 48) return f(std::integral_constant<int, 48>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 80) return f(std::integral_constant<int, 80>{});
  if (D <= 128) return f(std::integral_constant<int, 128>{});
  if (D <= 160) return f(std::integral_constant<int, 160>{});
  if (D <= 256) return f(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

// True when a (b1, b2, row)-strided bf16 tensor can be staged with 16-byte
// copies: base 16-byte aligned, every stride a multiple of 8, D % 8 == 0.
inline bool vec_ok_bf16(const void* p, long long s1, long long s2,
                        long long sl, int D) {
  return ((uintptr_t)p & 15) == 0 && s1 % 8 == 0 && s2 % 8 == 0 &&
         sl % 8 == 0 && D % 8 == 0;
}

// Sets the dynamic shared memory of a bf16 kernel and launches it on one
// block per (b, Q tile).
template <class C, class K, class... Args>
int launch_mma_tiles(K kernel, long long n_blocks, cudaStream_t stream,
                     Args... args) {
  if (C::smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)n_blocks, C::kThreads, C::smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// dst[rr][0:DP] = bf16 src rows r0 + rr (rr < ROWS) at row stride ``rs``,
// zero past D and past row L; cp.async (vec) or a synchronous copy. The
// caller commits the group.
template <class C, int ROWS>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long rs, int r0, int L,
                                                int D, bool vec) {
  constexpr int CPR = C::DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += C::kThreads) {
    const int rr = i / CPR;
    const int d = (i - rr * CPR) * 8;
    const int row = r0 + rr;
    __nv_bfloat16* s = dst + rr * C::LD + d;
    const __nv_bfloat16* g = src + (long long)row * rs + d;
    if (vec) {
      const bool ok = row < L && d < D;  // D % 8 == 0: all 8 or none
      cp_async16(reinterpret_cast<float*>(s),
                 reinterpret_cast<const float*>(ok ? g : src), ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[e] = (row < L && d + e < D) ? g[e] : __float2bfloat16(0.0f);
    }
  }
}

// S = Q·Kᵀ over a warp's 16 rows and a tile's 64 keys: s[j] holds keys
// 8j + 2t, 8j + 2t + 1 of rows g (e 0, 1) and g + 8 (e 2, 3), g = lane/4,
// t = lane%4.
template <class C>
__device__ __forceinline__ void mma_scores(const __nv_bfloat16* Qs,
                                           const __nv_bfloat16* Ks, int warp,
                                           int lane, float (&s)[C::NT][4]) {
  using afldm_filtered::ldsm_x4;
  using afldm_filtered::mma_bf16;
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  const __nv_bfloat16* qa =
      Qs + (16 * warp + (lane & 15)) * C::LD + 8 * (lane >> 4);
  const __nv_bfloat16* kb =
      Ks + ((lane & 7) + 8 * (lane >> 4)) * C::LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int k0 = 0; k0 < C::DP; k0 += 16) {
    unsigned a[4];
    ldsm_x4(a, qa + k0);
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np) {
      unsigned b[4];
      ldsm_x4(b, kb + 16 * np * C::LD + k0);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward tile loop of K3 and K6 (flash_fwd_bf16, flash2_fwd_bf16)
// and of P1 (flash_probe_dots_bf16, the identity for p). It computes what
// the TPU kernels _flash_kernel and _flash2_kernel compute at bf16
// (afldm_tpu/ops/attention.py): for each key tile of BK keys, in order,
//   s = q·kᵀ summed in f32, times the scale;   m' = max(m, rowmax s);
//   p = exp(s − m') in f32;                     c = exp(m − m');
//   l = l·c + rowsum p (the unrounded p);       acc = acc·c + bf16(p)·v,
// summed in f32; then out = bf16(acc / l) and lse = m + log l. K6 keeps
// two such states and stores bf16((1 − α)·acc₀/l₀ + α·acc₁/l₁), rounded
// once. Its plain versions are ops/attention.py::flash_fwd_plain and
// flash2_fwd_plain at the same BK (flash_bf16_key_tile).
//
// Bound: 4·Lq·Lk·D FLOP a head at the bf16 tensor rate (989 TFLOP/s), and
// one exponential a score on the SFU, 16 a clock an SM: at the model's D of
// 24 and 40 the exponentials, not the products, set the ceiling.
//
// What the design does about it:
// - One walk over K/V a set. A warp owns 16 query rows, 4 warps a block
//   (a 64-row Q tile). S = Q·K_jᵀ runs on mma.sync m16n8k16 from ldmatrix
//   (Q rows as A, K rows as B); the S accumulators of two neighbouring
//   8-key tiles are the A fragment of P·V over those 16 keys, so P never
//   leaves the registers, and V comes through ldmatrix.trans.
// - Each tile's P·V is summed on the tensor cores from zero and then added
//   as o = o·c + P·V in f32, as the TPU kernel adds its pv: fed through
//   the tensor cores' accumulation, which truncates, the running o drifted
//   to 0.10 of bf16's own error from the plain version at 4096 keys. 32
//   rows a warp spilled with that sum beside the scores of 128 keys.
// - exp2 with the scale folded in: the row max is taken over the raw
//   scores (the scale is positive), and p = ex2(s·(scale·log₂e) −
//   m·(scale·log₂e)), one FFMA and one ex2.approx a score, packed to bf16
//   as it is made. o and l are rescaled once a tile and row; l stays split
//   over a row's 4 lanes until the epilogue, which multiplies by 1/l once
//   and forms lse = m·scale + log l.
// - A K/V ring of kStages stages on 16-byte cp.async: the copy of tile
//   j + 1 is issued right after tile j's one barrier and lands during tile
//   j's products.
// - BK from one table a DP (FwdCfg): 128 keys up to DP = 128, 64 at 160,
//   32 at 256 (K6's f32 stash leaves no room for more there);
//   ops/attention.py::flash_bf16_key_tile mirrors it. Where Lk fits in 64
//   keys, 64-key tiles (with_fwd_cfg), one tile either way.
// Staging, padding, masking and strides are those of stage_rows_bf16
// above. wgmma and TMA are later work.

template <int DP_, int BK_>
struct FwdMma {
  static constexpr int DP = DP_;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;   // Q tile rows
  static constexpr int BK = BK_;           // keys a K/V tile
  static constexpr int kStages = 2;        // the K/V ring
  static constexpr int LD = DP + 8;        // padded row, in bf16
  static constexpr int NT = BK / 8;        // 8-key score tiles
  static constexpr int KS = BK / 16;       // 16-key steps of P·V
  static constexpr int DT = DP / 8;        // 8-column output tiles
  static_assert(DP % 16 == 0 && BK % 16 == 0, "mma k steps");
  // a stage: K_j, then V_j
  static constexpr size_t kv_elems = 2 * (size_t)BK * LD;
  // Q, the ring
  static constexpr size_t smem_bytes =
      ((size_t)BQ * LD + kStages * kv_elems) * sizeof(__nv_bfloat16);
  static_assert(smem_bytes <= kMaxSmemBytes, "bf16 forward smem");
};

template <int DP> struct FwdCfg;
template <> struct FwdCfg<32> : FwdMma<32, 128> {};
template <> struct FwdCfg<48> : FwdMma<48, 128> {};
template <> struct FwdCfg<64> : FwdMma<64, 128> {};
template <> struct FwdCfg<80> : FwdMma<80, 128> {};
template <> struct FwdCfg<128> : FwdMma<128, 128> {};
template <> struct FwdCfg<160> : FwdMma<160, 64> {};
template <> struct FwdCfg<256> : FwdMma<256, 32> {};

// f(C{}) for the bf16 forward's tiles at DP: FwdCfg<DP>, or 64-key tiles
// where Lk fits in 64 keys. Both then walk one tile, so the function is the
// same; the short sequences (L = 4) stage and multiply fewer zero rows: on
// an H100 (kernel_check.py --graph) K3/bf16 at (16, 32, 4, 24) takes 0.0044
// ms a call against 0.0072 on 128-key tiles, K6/bf16 at (17, 32, 4, 24)
// 0.0089 against 0.0140.
template <int DP, class F>
int with_fwd_cfg(int Lk, F&& f) {
  if constexpr (FwdCfg<DP>::BK > 64)
    if (Lk <= 64) return f(FwdMma<DP, 64>{});
  return f(FwdCfg<DP>{});
}

// K6's: K3's tiles and, after the ring, a stash of (1 − α)·o₀ in f32 for
// each thread's output elements.
template <class C>
struct Fwd2Cfg : C {
  static constexpr size_t stash_offset = C::smem_bytes;
  static constexpr size_t smem_bytes =
      C::smem_bytes + (size_t)C::BQ * C::DP * sizeof(float);
  static_assert(smem_bytes <= kMaxSmemBytes, "bf16 two-KV forward smem");
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (v0, v1) rounded to bf16, packed as one A-fragment register.
__device__ __forceinline__ unsigned pack_bf16x2(float v0, float v1) {
  const __nv_bfloat162 pb = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const unsigned*>(&pb);
}

// The A fragments of P·V over a tile: pa[kk][2·(j & 1) + h] holds keys
// 8j + 2t, 8j + 2t + 1 of row g + 8h, j = 2kk or 2kk + 1.
template <class C>
using PFrag = unsigned[C::KS][4];

// The online softmax of a warp's rows g and g + 8: m the raw row max, l
// this lane's share of the row sum (the quad's 4 lanes hold the whole),
// c = scale·log₂e.
template <class C>
struct OnlineSoftmax {
  static constexpr bool kRescale = true;
  float m[2], l[2];
  float c, scale;

  __device__ __forceinline__ explicit OnlineSoftmax(float sc)
      : c(sc * 1.4426950408889634f), scale(sc) {
    reset();
  }
  __device__ __forceinline__ void reset() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
  }
  // s: the raw scores of the tile from key k0; pa = bf16(p), p = exp2(s·c
  // − m'·c), 0 past Lk; corr = exp2((m − m')·c), 0 on the first tile.
  __device__ __forceinline__ void update(float (&s)[C::NT][4], int k0, int Lk,
                                         int lane, float (&corr)[2],
                                         PFrag<C>& pa) {
    const int t2 = 2 * (lane & 3);
    if (k0 + C::BK > Lk) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + t2 + (e & 1) >= Lk) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float nm = -mx * c;  // finite: every tile holds a valid key
      corr[h] = ex2_approx(fmaf(m[h], c, nm));
      m[h] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const float p0 = ex2_approx(fmaf(s[j][2 * h], c, nm));
        const float p1 = ex2_approx(fmaf(s[j][2 * h + 1], c, nm));
        sum += p0;
        sum += p1;
        pa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(p0, p1);
      }
      l[h] = l[h] * corr[h] + sum;
    }
  }
  // 1 / l and lse = m·scale + log l of rows g and g + 8; every lane calls it
  __device__ __forceinline__ void finish(float (&inv)[2],
                                         float (&lse)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      inv[h] = 1.0f / t;
      lse[h] = m[h] * scale + logf(t);
    }
  }
};

// P1's p: the scores themselves, rounded to bf16 by the packing of the A
// fragments, no rescaling. Keys past Lk score 0 on their zero rows.
template <class C>
struct IdentityP {
  static constexpr bool kRescale = false;
  __device__ __forceinline__ void update(float (&s)[C::NT][4], int, int, int,
                                         float (&)[2], PFrag<C>& pa) {
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(s[j][2 * h], s[j][2 * h + 1]);
  }
};

// o = the body's P·V over one K/V set, walked once in BK-key tiles through
// the kStages-stage ring: per tile S = Q·K_jᵀ, body.update (P from S,
// packed as the A fragments, and the rescale c), then o = o·c + bf16(P)·V_j
// (c = 1 where Body::kRescale is false). o is in mma_scores' accumulator
// layout (the warp's 16 rows × DP columns). Every thread calls it; the Q
// tile, if staged and committed just before, has landed by the first scores.
// On return the ring is free.
template <class C, class Body>
__device__ __forceinline__ void fwd_walk(
    const __nv_bfloat16* Qs, __nv_bfloat16* ring, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, long long ksl, long long vsl, int Lk, int D,
    bool vec, Body& body, float (&o)[C::DT][4]) {
  using afldm_filtered::ldsm_x4_t;
  using afldm_filtered::mma_bf16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < C::DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
  const int n = (Lk + C::BK - 1) / C::BK;
  auto stage = [&](int j) {  // tile j into its stage; an empty group past n
    if (j < n) {
      __nv_bfloat16* Ks = ring + (j % C::kStages) * C::kv_elems;
      stage_rows_bf16<C, C::BK>(Ks, kb, ksl, j * C::BK, Lk, D, vec);
      stage_rows_bf16<C, C::BK>(Ks + C::BK * C::LD, vb, vsl, j * C::BK, Lk,
                                D, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < C::kStages - 1; ++j) stage(j);
  const int vt = ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LD + 8 * (lane >> 4);
  for (int j = 0; j < n; ++j) {
    cp_async_wait<C::kStages - 2>();  // tile j (and Q) have landed
    __syncthreads();  // for every thread; and tile j − 1's stage is free
    stage(j + C::kStages - 1);
    const __nv_bfloat16* Ks = ring + (j % C::kStages) * C::kv_elems;
    const __nv_bfloat16* Vs = Ks + C::BK * C::LD + vt;
    float s[C::NT][4];
    mma_scores<C>(Qs, Ks, warp, lane, s);
    float corr[2];
    PFrag<C> pa;
    body.update(s, j * C::BK, Lk, lane, corr, pa);
    // the tile's P·V from zero, 16 output columns at a time, then o = o·c +
    // P·V in f32
#pragma unroll
    for (int dp = 0; dp < C::DT / 2; ++dp) {
      float pv[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        unsigned b[4];
        ldsm_x4_t(b, Vs + 16 * kk * C::LD + 16 * dp);
        mma_bf16(pv[0], pa[kk], b[0], b[1]);
        mma_bf16(pv[1], pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& acc = o[2 * dp + u][e];
          if constexpr (Body::kRescale)
            acc = __fadd_rn(__fmul_rn(acc, corr[e >> 1]), pv[u][e]);
          else
            acc = __fadd_rn(acc, pv[u][e]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring
}

// Calls f(row, d, h, j) for each pair of output elements (d, d + 1) a
// thread holds, o[j][2h], o[j][2h + 1]: rows q0 + 16·warp + g + 8h below Lq
// and columns d = 8j + 2t below D (d + 1 may be D).
template <class C, class F>
__device__ __forceinline__ void for_out_fwd(int q0, int Lq, int D, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < C::DT; ++j) {
      const int d = 8 * j + t2;
      if (d < D) f(row, d, h, j);
    }
  }
}

// Stores the pair (v0, v1) of row-major bf16 output columns d, d + 1 at p,
// rounded to bf16; v1 only where d + 1 < D. One 4-byte store where D is
// even (p is then 4-byte aligned).
__device__ __forceinline__ void store_pair_bf16(__nv_bfloat16* p, int d,
                                                int D, float v0, float v1) {
  if ((D & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (d + 1 < D) p[1] = __float2bfloat16_rn(v1);
  }
}

// The shared-memory carve-up of a bf16 block.
template <class C>
struct MmaSmem {
  __nv_bfloat16 *Qs, *K0, *K1, *Vs;
  __device__ __forceinline__ explicit MmaSmem(__nv_bfloat16* sm)
      : Qs(sm), K0(sm + C::BQ * C::LD), K1(K0 + kBK * C::LD),
        Vs(K1 + kBK * C::LD) {}
};

// Calls f(row, d, e, h, j) for the output elements a thread holds, rows
// q0 + 16·warp + g + 8h and columns d = 8j + 2t + e below (Lq, D).
template <class C, class F>
__device__ __forceinline__ void for_out(int q0, int Lq, int D, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + t2 + e;
        if (d < D) f(row, d, 2 * h + e, j);
      }
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward (flash_bwd_dq_bf16, flash_bwd_dkv_bf16: K4a and K4b for
// bf16 q, k, v and dO), the semantics of the JAX kernels at bf16: s and dp
// from bf16 products summed in f32, p = exp(s·scale − lse) and ds = p ⊙ (dp −
// delta)·scale in f32, ds (and, for dv, p) rounded to bf16 before it is the
// A operand of the second product of its pair, every accumulator f32, dq,
// dk and dv rounded to bf16 once at the store. lse and delta stay f32. The
// plain versions are ops/attention.py::_bwd_dq_plain and _bwd_dkv_plain.
//
// Bound: dq 6·Lq·Lk·D and dkv 8·Lq·Lk·D FLOP a head at the bf16 tensor
// rate, and one exponential a score on the SFU, 16 a clock an SM: at the
// path's D of 24 and 40 the exponentials weigh as much as the products.
//
// A block's fixed rows are a 64-row tile (Q and dO for dq; K and V for
// dkv) in 4 row groups of 16; it walks the other side (K and V; Q, dO and
// their lse and delta) in BK-row tiles. What the design does:
// - The fixed rows' A fragments of a warp's two score products (FixedA)
//   are read by ldmatrix once, after the prologue's copy lands, and held
//   in registers for the whole walk up to DP = 80 (2 × DP/16 × 4
//   registers: 24 at DP = 48). From DP = 128 they do not fit beside the
//   accumulators and are read from shared memory at each use. Where they
//   are held, the fixed tile lies in the ring's last stage, which is first
//   written after every warp has its fragments.
// - The walk goes 16 walked rows at a time: the two 16 × 16 score tiles of
//   the pair (s and dp; sᵀ and dpᵀ), then p and ds from them in registers,
//   packed to bf16 as the A fragment of the second products over those 16
//   rows of depth. P and dS never touch shared memory, and 16 score
//   registers are live.
// - exp2 with the scale folded in (bwd_p_exp2): t = s·scale − lse by one
//   FFMA, then ex2.approx of t·log₂e with the remainder of that product's
//   rounding restored, four FMA-pipe operations and one ex2 a score (expf
//   took ~20). On the ragged last tile p = 0 at the walked rows past Lk
//   (dq) or Lq (dkv), and its 16-row chunks wholly past the end are
//   skipped.
// - A ring of kStages stages of BK walked rows on 16-byte cp.async
//   (bwd_walk: cp_async_wait<kStages − 2>, one barrier a tile, the next
//   copy issued right after it); BK from one table a DP (BwdTile: 128 rows
//   up to DP = 80, 64 above), which ops/attention.py::
//   flash_bwd_bf16_walk_tile mirrors.
// - dkv splits its query walk over several blocks where B·H·⌈Lk/64⌉ blocks
//   would not give each SM of the card one (dkv_splits, mirrored by
//   ops/attention.py::flash_bwd_dkv_splits: the SD trainers' 77 text
//   tokens). Each split writes f32 partials of dk and dv, which a second
//   kernel (flash_bwd.cu's dkv_reduce_kernel) sums in split order and
//   rounds to bf16 once. No atomics: every call gives the same bits.
// The second products' f32 accumulators of a row group are 16 × DP: at
// large DP, CS warps share a row group, each computing the row group's
// scores (CS times over) and accumulating DW = DP / CS of the columns, so
// that no thread holds more than 64 accumulators of one product (dkv holds
// dk and dv). Staging is K3/bf16's (stage_rows_bf16, rows padded to LD = DP
// + 8); D is zero-padded to DP, a multiple of 16 (24 to 32, 40 to 48), and
// rows past their length are zero and never stored.

// The walked tile's depth BK at DP, for both kernels
// (ops/attention.py::flash_bwd_bf16_walk_tile mirrors it). On an H100
// (kernel_check.py --graph, K4a/bf16 and K4b/bf16 at their chip_smoke.py
// shapes), 128 rows in a ring of two stages beat 64 rows in three at DP 48
// and 80 and match them at DP 32; three stages of 128 rows hold fewer
// blocks an SM (dq at (2, 8, 4096, 40): 0.393 against 0.330 ms), so
// kStages is 2.
template <int BK_>
struct BwdTileOf {
  static constexpr int BK = BK_;
};
template <int DP> struct BwdTile;
template <> struct BwdTile<32> : BwdTileOf<128> {};
template <> struct BwdTile<48> : BwdTileOf<128> {};
template <> struct BwdTile<64> : BwdTileOf<128> {};
template <> struct BwdTile<80> : BwdTileOf<128> {};
template <> struct BwdTile<128> : BwdTileOf<64> {};
template <> struct BwdTile<160> : BwdTileOf<64> {};
template <> struct BwdTile<256> : BwdTileOf<64> {};

template <int DP_, int CS_, bool DKV_>
struct BwdMmaCfg {
  static constexpr int DP = DP_;
  static constexpr int CS = CS_;          // warps sharing a row group
  static constexpr int kWarps = 4 * CS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 64;           // the block's fixed rows
  static constexpr int BK = BwdTile<DP>::BK;  // walked rows a stage
  static constexpr int kStages = 2;       // the ring (BwdTile)
  static constexpr int LD = DP + 8;       // padded row, in bf16
  static constexpr int KS = DP / 16;      // k steps of a score product
  static constexpr int DW = DP / CS;      // accumulator columns a warp
  static constexpr int DWT = DW / 8;      // its 8-column tiles
  static constexpr bool kRegA = DP <= 80;  // the fixed A fragments held
  static_assert(DP % 16 == 0 && DW % 16 == 0 && BK % 16 == 0, "mma steps");
  // a stage: two walked tiles (K and V; Q and dO) and, for dkv, the Q
  // tile's BK lse and BK delta values
  static constexpr size_t stage_bytes =
      2 * (size_t)BK * LD * 2 + (DKV_ ? 2 * (size_t)BK * sizeof(float) : 0);
  static constexpr size_t fixed_bytes = 2 * (size_t)BQ * LD * 2;
  static_assert(fixed_bytes <= stage_bytes, "the fixed tile fits a stage");
  // the fixed tile in the ring's last stage where its fragments are held,
  // else before the ring
  static constexpr size_t fixed_offset =
      kRegA ? (kStages - 1) * stage_bytes : 0;
  static constexpr size_t ring_offset = kRegA ? 0 : fixed_bytes;
  static constexpr size_t smem_bytes = ring_offset + kStages * stage_bytes;
  static_assert(smem_bytes <= kMaxSmemBytes, "bf16 backward smem");
};

// f(BwdMmaCfg<DP, CS, DKV>) for the smallest multiple of 16 DP at least D:
// CS = 1 up to DP = 160 for dq and up to 80 for dkv (two accumulators),
// else 2, and 4 at DP = 256 for dkv.
template <bool DKV, class F>
int with_bwd_mma(int D, F&& f) {
  return with_dp_mma(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr int CS = DP <= (DKV ? 80 : 160) ? 1 : (DKV && DP > 160) ? 4 : 2;
    return f(BwdMmaCfg<DP, CS, DKV>{});
  });
}

constexpr int kSplitSMs = 132;  // the SMs of an H100 SXM

// The blocks over which dkv splits its query walk (C: dkv's BwdMmaCfg):
// one where the B·H·⌈Lk/BQ⌉ blocks give each SM one or the walk has fewer
// than 4 tiles; else up to ⌈2·kSplitSMs / blocks⌉ splits of at least 2
// tiles each, balanced so that none is empty.
// ops/attention.py::flash_bwd_dkv_splits mirrors it.
template <class C>
inline int dkv_splits(long long bh, int Lq, int Lk) {
  const long long blocks = bh * ((Lk + C::BQ - 1) / C::BQ);
  const long long tiles = (Lq + C::BK - 1) / C::BK;
  if (blocks >= kSplitSMs || tiles < 4) return 1;
  const long long want = (2 * kSplitSMs + blocks - 1) / blocks;
  const long long s = tiles / 2 < want ? tiles / 2 : want;
  const long long per = (tiles + s - 1) / s;
  return (int)((tiles + per - 1) / per);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// p = exp(s·scale − lse) of the bf16 backward, on ex2.approx with the scale
// folded into one FFMA: t = s·scale − lse rounded once (as the plain
// version's torch.exp argument is, up to its rounding of s·scale), h =
// t·log₂e rounded, p = ex2.approx(h)·(1 + r) with r = t − h·ln 2, the
// remainder that the rounding of h dropped (one FFMA, and one FFMA for p):
// four FMA-pipe operations and one ex2 a score. Without r, p is off the
// plain version's by several f32 ulps, and p, rounded to bf16 as dv's A
// operand, lands on the other side of a rounding edge often enough to take
// dv at (2, 8, 4096, 40) past the card tests' bound on the RMS ratio
// (kernel_check.py --spread_bwd). s is finite; zero_past sets p = 0 where
// the walked row lies past its length.
__device__ __forceinline__ float bwd_p_exp2(float s, float scale, float lse) {
  const float t = fmaf(s, scale, -lse);
  const float h = t * kLog2e;
  const float p = ex2_approx(h);
  return fmaf(p, fmaf(-h, kLn2, t), p);
}

// A warp's A fragments of its 16 fixed rows for the score products, one k
// step of 16 columns at a time: held in registers (C::kRegA; read by
// ldmatrix once, in load) or read from the fixed tile at each use.
template <class C>
struct FixedA {
  unsigned r[C::kRegA ? C::KS : 1][4];
  const __nv_bfloat16* p;
  __device__ __forceinline__ FixedA(const __nv_bfloat16* tile, int rg,
                                    int lane)
      : p(tile + (16 * rg + (lane & 15)) * C::LD + 8 * (lane >> 4)) {}
  __device__ __forceinline__ void load() {
    if constexpr (C::kRegA) {
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk)
        afldm_filtered::ldsm_x4(r[kk], p + 16 * kk);
    }
  }
  __device__ __forceinline__ void get(int kk, unsigned (&a)[4]) const {
    if constexpr (C::kRegA) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = r[kk][e];
    } else {
      afldm_filtered::ldsm_x4(a, p + 16 * kk);
    }
  }
};

// A lane's ldmatrix offset into a walked tile: as the B operand of a score
// product (its rows the score's columns), and transposed as the B operand
// of a second product (its rows the depth, this warp's DW columns).
template <class C>
__device__ __forceinline__ int score_base(int lane) {
  return ((lane & 7) + 8 * (lane >> 4)) * C::LD + 8 * ((lane >> 3) & 1);
}
template <class C>
__device__ __forceinline__ int trans_base(int cs, int lane) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LD + 8 * (lane >> 4) +
         cs * C::DW;
}

// s = A·Tᵀ over a warp's 16 fixed rows and 16 walked rows (tb: the walked
// tile at the chunk's first row plus score_base): s[u] holds walked rows 8u
// + 2t, 8u + 2t + 1 of fixed rows g (e 0, 1) and g + 8 (e 2, 3), g =
// lane/4, t = lane%4.
template <class C>
__device__ __forceinline__ void chunk_scores(const FixedA<C>& fa,
                                             const __nv_bfloat16* tb,
                                             float (&s)[2][4]) {
  using afldm_filtered::ldsm_x4;
  using afldm_filtered::mma_bf16;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[u][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) {
    unsigned a[4], b[4];
    fa.get(kk, a);
    ldsm_x4(b, tb + 16 * kk);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
}

// acc += A·T over 16 walked rows of depth: A the bf16 A fragment of a row
// group's 16 rows over them (pack_bf16x2 of chunk_scores' layout: word 2u +
// h holds row g + 8h, walked rows 8u + 2t, 8u + 2t + 1), T those walked
// rows at tt (the chunk's first row plus trans_base), this warp's columns.
template <class C>
__device__ __forceinline__ void chunk_walked(float (&acc)[C::DWT][4],
                                             const unsigned (&a)[4],
                                             const __nv_bfloat16* tt) {
  using afldm_filtered::ldsm_x4_t;
  using afldm_filtered::mma_bf16;
#pragma unroll
  for (int dp = 0; dp < C::DWT / 2; ++dp) {
    unsigned b[4];
    ldsm_x4_t(b, tt + 16 * dp);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// p = 0 at the walked rows r0 + 8u + 2t + (e & 1) at or past L.
__device__ __forceinline__ void zero_past(float (&p)[2][4], int r0, int L,
                                          int lane) {
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r0 + 8 * u + t2 + (e & 1) >= L) p[u][e] = 0.0f;
}

// Walks tiles t0 .. t1 − 1 of BK walked rows through the ring of kStages
// stages at ``ring``: stage(t, dst) issues tile t's copies into its stage
// (the walk commits them). The fixed rows, staged by the caller just
// before, land with the first tile; then every thread calls load_fixed
// (the fragments FixedA holds), and body(stage, r0) runs on each tile in
// order, tile i + kStages − 1 in flight meanwhile. Every thread calls it.
template <class C, class Stage, class Load, class Body>
__device__ __forceinline__ void bwd_walk(unsigned char* ring, int t0, int t1,
                                         Stage&& stage, Load&& load_fixed,
                                         Body&& body) {
  auto issue = [&](int i) {  // the walk's tile i; an empty group past t1
    if (t0 + i < t1) stage(t0 + i, ring + (i % C::kStages) * C::stage_bytes);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) issue(i);
  cp_async_wait<C::kStages - 2>();  // the fixed rows and tile t0
  __syncthreads();
  load_fixed();
  for (int i = 0; t0 + i < t1; ++i) {
    cp_async_wait<C::kStages - 2>();  // tile t0 + i has landed
    __syncthreads();  // for every thread; and the stage that the next copy
                      // fills (the fixed tile's, at i = 0) is read no more
    issue(i + C::kStages - 1);
    body(ring + (i % C::kStages) * C::stage_bytes, (t0 + i) * C::BK);
  }
  cp_async_wait<0>();
}

// Stores a warp's 16 rows × DW columns of acc (f32, or rounded to bf16),
// rows r0 + g + 8h below L and columns below D, into the dense (·, D) rows
// of ``out``.
template <class C, class T>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[C::DWT][4],
                                           int r0, int L, int D, int cs,
                                           int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < C::DWT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = cs * C::DW + 8 * j + t2 + e;
        if (d >= D) continue;
        if constexpr (std::is_same<T, float>::value)
          out[(long long)row * D + d] = acc[j][2 * h + e];
        else
          out[(long long)row * D + d] = __float2bfloat16_rn(acc[j][2 * h + e]);
      }
  }
}

}  // namespace afldm_flash
