// K1's and K2's reduced precision levels ("high": 3 bf16 passes a
// product, "default": 1) for Hopper: the banded filtered activation
//
//   out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ      for every (n, c) plane
//
// in _forward_spatial's order, H side first in both filter pairs:
//
//   t  = U_h · x        (2H × W)    depth H
//   hi = act(t · U_wᵀ)  (2H × 2W)   depth W
//   lo = D_h · hi       (H × 2W)    depth 2H
//   out = lo · D_wᵀ     (H × W)     depth 2W
//
// and its VJP for the cotangent g, in _bwd_spatial's order, H side first
// in every filter pair:
//
//   t  = U_h · x,  v = D_hᵀ · g              (2H × W)    depth H
//   m  = act′(t · U_wᵀ) ⊙ (v · D_w)           (2H × 2W)   depth W
//   s  = U_hᵀ · m                            (H × 2W)    depth 2H
//   dx = s · U_w                             (H × W)     depth 2W
//
// Replaces the reduced levels of afldm_tpu/ops/pallas_kernels.py::
// _forward_spatial and _bwd_spatial (their _mm and _precise_dot): every
// product a·b runs as ah·bh + ah·bl + al·bh ('high') or ah·bh ('default')
// on bf16 tensor cores (filtered_mma.cuh), each f32 result split again
// before the product that reads it.
//
// Two launches a chunk of planes, where the GEMM chains before them took
// four (K1) and six (K2) through an f32 scratch:
//   * up (K1's products 1 and 2): a block owns a 64-row strip of the 2H
//     side of one plane. It computes t's strip, U_h's rows of the strip
//     times x, kBN columns at a time, and splits it from the registers into
//     bf16 pieces that stay in shared memory; then hi's strip,
//     act(t · U_wᵀ), which leaves the block as split bf16 pieces in the
//     scratch (hi and lo at 'high', hi alone at 'default'): the values the
//     next product splits them into, so device memory sees 2 or 4 bytes an
//     element of hi and no byte of t.
//   * the backward's up (K2's products 1 to 4): the same for a strip of 64
//     (or, where t's and v's strips are too wide for shared memory, 32)
//     rows with two strips in shared memory, t's and v's (D_hᵀ's rows times
//     g); then, kBN columns at a time, pre = t · U_wᵀ, whose sums give way
//     to act′(pre) in the registers, and ds = v · D_w, and m = act′(pre) ⊙
//     ds leaves as split bf16 pieces in the scratch: no byte of t, v or pre
//     reaches device memory.
//   * down (K1's products 3 and 4, K2's 5 and 6): a block owns a strip of
//     64 (or, where the 2W side is too wide for shared memory, 32) rows of
//     the H side of one plane. It computes lo's strip, D_h's rows times hi
//     (K2: s's, U_hᵀ's rows times m) with the pieces streamed in, into bf16
//     pieces in shared memory, then out's strip, lo · D_wᵀ (K2: dx = s ·
//     U_w), to device memory (f32, or bf16 rounded once).
// Blocks run plane by plane (blockIdx.x = plane · strips + strip), so the
// strips of one plane, which all read that plane's x (and g) or hi (m),
// run together and their re-reads hit L2.
//
// Staging: the operators arrive as split blobs built once on the host
// (ops/filtered_act.py::_mma_blobs, zero-padded pieces), hi's or m's
// pieces as the up launch wrote them; both come in by 16-byte cp.async
// into a ring of slabs, with no register split. x and g come in raw the
// same way (8-byte copies for bf16) and are split from shared memory into
// their pieces one slab ahead of their products. A piece of hi, m or out
// leaves through the ring, free once its products are done, in 16-byte (a
// bf16 out: 8-byte) rows.
//
// Every output element's sum is the one filtered_gemm.cuh's
// filtered_gemm_mma_kernel forms, so both launches give the GEMM chains'
// results bit for bit: mma.sync m16n8k16 over 16-deep steps in ascending k,
// each step's ah·bh from zero added into the accumulator (by TwoSum at 3
// passes), the small passes ah·bl then al·bh into their own accumulator,
// added once at the end; the fragments are the GEMM's (ldmatrix .trans for
// a k-major A slab and for B, plain for A's row-major strip), and act (K2:
// act′(pre) times the sum, MulActGrad) is the GEMM's epilogue on that f32
// sum.
//
// What bounds it (PERF.md §6): at 'default' shared memory, each warp's
// ldmatrix fragments of its 32 × 32 piece and the slabs' copies, and the
// epilogues (act, act′: an expf and a division an element); at 'high' the
// issue of the TwoSum after every 16-deep step (~7 FP32 instructions an
// element a step against 3 mma) by one block an SM. Neither wgmma nor TMA
// (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "filtered_epi.cuh"
#include "filtered_mma.cuh"

namespace {

using afldm_filtered::add_two_sum;
using afldm_filtered::ldsm_x4;
using afldm_filtered::ldsm_x4_t;
using afldm_filtered::load4;
using afldm_filtered::mma_bf16;
using afldm_filtered::mma_ld;
using afldm_filtered::pad16;
using afldm_filtered::split2;
using afldm_filtered::store2;
using bf16 = __nv_bfloat16;

constexpr int kBN = 128;     // the columns of a block's result at a time
constexpr int kUpRows = 64;  // the up launch's strip

// One launch's tile: a strip of BM rows, kBN columns at a time, WARPS_M ×
// 4 warps each a (BM / WARPS_M) × 32 piece of it in m16n8 accumulators,
// over a ring of STAGES slabs BK deep (BK / 16 steps a barrier). A stage
// holds A's k-major slab (BK rows of BM: hi, then lo), B's (BK rows of
// kBN) and, for a launch that stages x (XB bytes an element), x's raw slab
// (BK rows of kBN). MIN_BLOCKS: the blocks an SM its registers allow.
template <int PASSES, int BM, int BK, int STAGES, int XB = 0,
          int WARPS_M = 2, int MIN_BLOCKS = 1>
struct Cfg {
  static constexpr int kPieces = PASSES == 3 ? 2 : 1;
  static constexpr int kBK = BK, kStages = STAGES;
  static constexpr int kThreads = 32 * WARPS_M * 4, kMinBlocks = MIN_BLOCKS;
  static constexpr int WM = BM / WARPS_M, WN = kBN / 4;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BM + 8, LDB = kBN + 8;
  static constexpr int A_PIECE = BK * LDA, B_PIECE = BK * LDB;
  static constexpr int A_STAGE = kPieces * A_PIECE;
  static constexpr int B_STAGE = kPieces * B_PIECE;
  static constexpr int RAW = BK * kBN * XB / 2;  // in bf16 elements
  static constexpr int STAGE = A_STAGE + B_STAGE + RAW;
  // shared bytes: ``strips`` strips' pieces (rows of ``ld`` bf16) and the
  // ring
  static constexpr size_t smem(int ld, int strips = 1) {
    return 2 * ((size_t)strips * kPieces * BM * ld + (size_t)STAGES * STAGE);
  }
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

// Issues the copies of a slab: rows k0 … k0 + BK - 1 and columns c0 …
// c0 + COLS - 1 of a split operand in device memory (rows ``ld`` apart,
// its lo piece ``lo`` after its hi piece) into dst (rows LD apart, pieces
// PIECE apart); rows past ``rows`` and columns past ``cols`` (a multiple
// of 8) fill zeros.
template <int THREADS, int PIECES, int BK, int COLS, int LD, int PIECE>
__device__ __forceinline__ void slab_async(bf16* dst, const bf16* src,
                                           long long ld, long long lo, int k0,
                                           int rows, int c0, int cols) {
  constexpr int CH = COLS / 8, N = PIECES * BK * CH;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    if (N % THREADS != 0 && i >= N) break;
    const int pc = i / (BK * CH), q = i - pc * BK * CH;
    const int r = q / CH, c = 8 * (q - r * CH);
    const bool ok = k0 + r < rows && c0 + c < cols;
    cp_async16_zfill(dst + pc * PIECE + r * LD + c,
                     ok ? src + pc * lo + (long long)(k0 + r) * ld + c0 + c
                        : src,
                     ok);
  }
}

// x's raw slab: rows k0 … k0 + BK - 1, columns c0 … c0 + kBN - 1 of an
// H × W plane of T, 4 elements a copy (16 bytes of f32, 8 of bf16: a
// bf16 row of W % 8 == 4 elements is 8-byte aligned only), into dst (BK
// rows of kBN T), zeros past the edges.
template <int THREADS, class T, int BK>
__device__ __forceinline__ void raw_async(void* dst, const T* src, int W,
                                          int k0, int H, int c0) {
  constexpr int CH = kBN / 4, N = BK * CH;
  T* d = reinterpret_cast<T*>(dst);
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + threadIdx.x, r = i / CH, c = 4 * (i - r * CH);
    const bool ok = k0 + r < H && c0 + c < W;
    const T* sp = ok ? src + (long long)(k0 + r) * W + c0 + c : src;
    if constexpr (sizeof(T) == 4)
      cp_async16_zfill(d + r * kBN + c, sp, ok);
    else
      cp_async8_zfill(d + r * kBN + c, sp, ok);
  }
}

// x's raw slab at raw split into B's pieces at b (rows LDB apart, pieces
// PIECE apart; hi alone at 1 pass): a bf16 x widened, whose lo pieces are
// zero.
template <int THREADS, int PASSES, class T, int BK, int LDB, int PIECE>
__device__ __forceinline__ void split_raw(bf16* b, const void* raw) {
  constexpr int CH = kBN / 4, N = BK * CH;
  const T* r4 = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + threadIdx.x, r = i / CH, c = 4 * (i - r * CH);
    const float4 v = load4(r4 + r * kBN + c);
    uint2 h, l;
    split2(v.x, v.y, h.x, l.x);
    split2(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(b + r * LDB + c) = h;
    if constexpr (PASSES == 3)
      *reinterpret_cast<uint2*>(b + PIECE + r * LDB + c) = l;
  }
}

// A's fragments of the slab's 16-deep step kk from a k-major slab (BK rows
// of BM); piece 1: lo
template <class C>
__device__ __forceinline__ void frag_a_slab(unsigned (&a)[C::MT][4],
                                            const bf16* stage, int piece,
                                            int kk, int wm, int lane) {
  const bf16* s = stage + piece * C::A_PIECE + 16 * kk * C::LDA;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
    ldsm_x4_t(a[mt], s + ((lane & 7) + 8 * (lane >> 4)) * C::LDA + wm +
                         16 * mt + 8 * ((lane >> 3) & 1));
}

// A's fragments from a row-major strip (rows ``ld`` apart) at column k0
template <class C>
__device__ __forceinline__ void frag_a_rows(unsigned (&a)[C::MT][4],
                                            const bf16* s, int ld, int k0,
                                            int wm, int lane) {
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
    ldsm_x4(a[mt], s + (wm + 16 * mt + (lane & 15)) * ld + k0 +
                       8 * (lane >> 4));
}

// B's fragments from 16 rows of a slab (kBN wide)
template <class C>
__device__ __forceinline__ void frag_b(unsigned (&b)[C::NT / 2][4],
                                       const bf16* s, int wn, int lane) {
#pragma unroll
  for (int np = 0; np < C::NT / 2; ++np)
    ldsm_x4_t(b[np], s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDB + wn +
                         16 * np + 8 * (lane >> 4));
}

// A warp's accumulators: ah·bh in acc, each 16-deep step from zero added in
// f32 (by TwoSum at 3 passes), the small passes and those additions'
// errors in small: filtered_gemm_mma_kernel's sums.
template <class C, int PASSES>
struct Acc {
  float acc[C::MT][C::NT][4], small[PASSES == 3 ? C::MT : 1][C::NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = 0.0f;
          if (PASSES == 3) small[i][j][e] = 0.0f;
        }
  }
  __device__ __forceinline__ void step(const unsigned (&a)[C::MT][4],
                                       const unsigned (&b)[C::NT / 2][4]) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(s, a[i], b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (PASSES == 3)
            add_two_sum(acc[i][j][e], s[e], small[i][j][e]);
          else
            acc[i][j][e] += s[e];
        }
      }
  }
  __device__ __forceinline__ void step_small(
      const unsigned (&a)[C::MT][4], const unsigned (&b)[C::NT / 2][4]) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
        mma_bf16(small[PASSES == 3 ? i : 0][j], a[i], b[j / 2][2 * (j % 2)],
                 b[j / 2][2 * (j % 2) + 1]);
  }
  // The warp's sums (acc + small at 3 passes) in each_pair's order
  static constexpr int kValues = C::MT * 2 * C::NT * 2;
  __device__ __forceinline__ void sums(float (&v)[kValues]) const {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          const int k = ((i * 2 + h) * C::NT + j) * 2;
          v[k] = acc[i][j][2 * h];
          v[k + 1] = acc[i][j][2 * h + 1];
          if constexpr (PASSES == 3) {
            v[k] += small[i][j][2 * h];
            v[k + 1] += small[i][j][2 * h + 1];
          }
        }
  }
  // out(row, col, v0, v1) for each column pair of the warp's piece, rows
  // and columns within the block's BM × kBN tile, v[k], v[k + 1] of sums
  template <class Out>
  __device__ __forceinline__ static void each_pair(const float (&v)[kValues],
                                                   int wm, int wn, int lane,
                                                   Out out) {
    const int gr = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          const int k = ((i * 2 + h) * C::NT + j) * 2;
          out(wm + 16 * i + gr + 8 * h, wn + 8 * j + t2, v[k], v[k + 1]);
        }
  }
  template <class Out>
  __device__ __forceinline__ void each_pair(int wm, int wn, int lane,
                                            Out out) const {
    float v[kValues];
    sums(v);
    each_pair(v, wm, wn, lane, out);
  }
};

// One kBN-column piece of a strip's product over k16 16-deep steps, in
// C::kBK deep slabs through the ring of C::kStages: issue(stage, kt)
// issues slab kt's copies; with PREP, prep(stage) splits a slab's raw x
// into its B pieces one slab ahead of its products (the copies waited for
// one slab early, so the split's reads are complete); with A_SLAB A is the
// stage's k-major slab, else frag_a(a, step, piece) reads step's fragments
// from the strip. A slab's steps past k16 are skipped, so every element
// sums the 16-deep steps of a 16-deep walk.
template <class C, int PASSES, bool A_SLAB, bool PREP, class Issue,
          class Prep, class FragA>
__device__ __forceinline__ void k_loop(Acc<C, PASSES>& acc, bf16* ring,
                                       int k16, Issue issue, Prep prep,
                                       FragA frag_a) {
  constexpr int S = C::kStages, SUB = C::kBK / 16;
  static_assert(!PREP || S >= 3, "a split one slab ahead needs 3 stages");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * C::WM, wn = (warp & 3) * C::WN;
  const int nk = (k16 + SUB - 1) / SUB;
  acc.zero();
  __syncthreads();  // the ring's and the strip's last readers are done
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(ring + s * C::STAGE, s);
    afldm_filtered::cp_async_commit();
  }
  if constexpr (PREP) {
    afldm_filtered::cp_async_wait<S - 2>();
    __syncthreads();
    prep(ring);
  }
  for (int kt = 0; kt < nk; ++kt) {
    afldm_filtered::cp_async_wait<PREP ? S - 3 : S - 2>();
    __syncthreads();
    const int nxt = kt + S - 1;
    if (nxt < nk) issue(ring + (nxt % S) * C::STAGE, nxt);
    afldm_filtered::cp_async_commit();
    if constexpr (PREP)
      if (kt + 1 < nk) prep(ring + ((kt + 1) % S) * C::STAGE);
    const bf16* cur = ring + (kt % S) * C::STAGE;
#pragma unroll
    for (int kk = 0; kk < SUB; ++kk) {
      const int step = kt * SUB + kk;
      if (SUB > 1 && step >= k16) break;
      const bf16* b = cur + C::A_STAGE + 16 * kk * C::LDB;
      unsigned ah[C::MT][4], bh[C::NT / 2][4];
      if constexpr (A_SLAB)
        frag_a_slab<C>(ah, cur, 0, kk, wm, lane);
      else
        frag_a(ah, step, 0, wm, lane);
      frag_b<C>(bh, b, wn, lane);
      acc.step(ah, bh);
      if constexpr (PASSES == 3) {
        unsigned bl[C::NT / 2][4];
        frag_b<C>(bl, b + C::B_PIECE, wn, lane);
        acc.step_small(ah, bl);
        unsigned al[C::MT][4];
        if constexpr (A_SLAB)
          frag_a_slab<C>(al, cur, 1, kk, wm, lane);
        else
          frag_a(al, step, 1, wm, lane);
        acc.step_small(al, bh);
      }
    }
  }
}

// v0, v1 split into the pieces at q (its lo piece ``lo`` after it); hi
// alone at 1 pass
template <int PASSES>
__device__ __forceinline__ void store_pair(bf16* q, long long lo, float v0,
                                           float v1) {
  unsigned h, l;
  split2(v0, v1, h, l);
  *reinterpret_cast<unsigned*>(q) = h;
  if constexpr (PASSES == 3) *reinterpret_cast<unsigned*>(q + lo) = l;
}

// k_loop's prep and frag_a where there are none
struct NoPrep {
  __device__ __forceinline__ void operator()(bf16*) const {}
};
struct SlabA {};

// The launches' tiles, the quickest of those timed on an H100 at K1's
// shapes (PERF.md §6). The up launch: slabs 16 deep, 4 stages, x split one
// slab ahead; at 'high' 16 warps of 16 × 32 pieces, 128 registers a thread
// (8 warps of 32 × 32 took ~230 and ran slower), at 'default' 8 warps, two
// blocks an SM. The down launch: slabs 32 deep, 3 stages, 8 warps (16 at
// 'high' spilled and ran no quicker).
template <int PASSES, class T>
using UpCfg = Cfg<PASSES, kUpRows, 16, 4, sizeof(T), PASSES == 3 ? 4 : 2,
                  PASSES == 3 ? 1 : 2>;
template <int PASSES, int BM>
using DownCfg = Cfg<PASSES, BM, 32, 3, 0, 2, PASSES == 3 ? 1 : 2>;

// Products 1 and 2 for one kUpRows-row strip of the 2H side of one plane:
// hi[p][m0 …] = act(U_h[m0 …, :] · x[p] · U_wᵀ) into the scratch's pieces
// (plane p's hi piece at hs + p·4HW, rows 2W apart, its lo piece ``lo``
// after it). uh, uw: the split blobs of U_hᵀ (H × 2H) and U_wᵀ (W × 2W).
template <int PASSES, class T>
__global__ void __launch_bounds__(UpCfg<PASSES, T>::kThreads,
                                  UpCfg<PASSES, T>::kMinBlocks)
banded_up_kernel(const T* __restrict__ x, bf16* __restrict__ hs,
                 const bf16* __restrict__ uh, const bf16* __restrict__ uw,
                 int H, int W, long long lo, afldm_filtered::Activation act) {
  using C = UpCfg<PASSES, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* strip = reinterpret_cast<bf16*>(smem_raw);
  const int ld = mma_ld(W), wp = pad16(W);
  const int piece = kUpRows * ld;
  bf16* ring = strip + C::kPieces * piece;
  const int strips = (2 * H + kUpRows - 1) / kUpRows;
  const int p = blockIdx.x / strips, m0 = (blockIdx.x - p * strips) * kUpRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * C::WM, wn = (warp & 3) * C::WN;
  const T* xp = x + (long long)p * H * W;
  bf16* hp = hs + (long long)p * 4 * H * W;
  const long long ld_uh = mma_ld(2 * H), lo_uh = pad16(H) * ld_uh;
  const long long ld_uw = mma_ld(2 * W), lo_uw = pad16(W) * ld_uw;
  Acc<C, PASSES> acc;

  // t's strip = U_h's rows · x, kBN columns a piece, into the strip
  for (int n0 = 0; n0 < W; n0 += kBN) {
    const auto issue = [&](bf16* s, int kt) {
      slab_async<C::kThreads, C::kPieces, C::kBK, kUpRows, C::LDA,
                 C::A_PIECE>(
          s, uh, ld_uh, lo_uh, C::kBK * kt, H, m0, 2 * H);
      raw_async<C::kThreads, T, C::kBK>(s + C::A_STAGE + C::B_STAGE, xp, W,
                                        C::kBK * kt, H, n0);
    };
    const auto prep = [&](bf16* s) {
      split_raw<C::kThreads, PASSES, T, C::kBK, C::LDB, C::B_PIECE>(
          s + C::A_STAGE, s + C::A_STAGE + C::B_STAGE);
    };
    k_loop<C, PASSES, true, true>(acc, ring, pad16(H) / 16, issue, prep,
                                  SlabA{});
    acc.each_pair(wm, wn, lane, [&](int r, int c, float v0, float v1) {
      if (n0 + c < wp)
        store_pair<PASSES>(strip + r * ld + n0 + c, piece, v0, v1);
    });
  }

  // hi's strip = act(t · U_wᵀ), kBN columns a piece, to the scratch
  // through the ring, free once the piece's products are done, so that
  // the pieces leave in 16-byte rows
  bf16* const tile = ring;
  constexpr int TLD = kBN + 8, TP = kUpRows * TLD;
  static_assert(C::kPieces * TP <= C::kStages * C::STAGE, "tile in ring");
  for (int n0 = 0; n0 < 2 * W; n0 += kBN) {
    const auto issue = [&](bf16* s, int kt) {
      slab_async<C::kThreads, C::kPieces, C::kBK, kBN, C::LDB, C::B_PIECE>(
          s + C::A_STAGE, uw, ld_uw, lo_uw, C::kBK * kt, W, n0, 2 * W);
    };
    const auto frag_a = [&](unsigned (&a)[C::MT][4], int step, int pc,
                            int wm_, int ln) {
      frag_a_rows<C>(a, strip + pc * piece, ld, 16 * step, wm_, ln);
    };
    k_loop<C, PASSES, false, false>(acc, ring, wp / 16, issue, NoPrep{},
                                    frag_a);
    // act's case chosen once for the warp's values (Activation::map): taken
    // per element, its switch made the up launch markedly slower
    float v[Acc<C, PASSES>::kValues];
    acc.sums(v);
    act.map(v);
    __syncthreads();  // the last slab's readers are done with the ring
    Acc<C, PASSES>::each_pair(v, wm, wn, lane,
                              [&](int r, int c, float v0, float v1) {
      store_pair<PASSES>(tile + r * TLD + c, TP, v0, v1);
    });
    __syncthreads();
    for (int i = tid; i < C::kPieces * kUpRows * (kBN / 8);
         i += C::kThreads) {
      constexpr int TILE = kUpRows * (kBN / 8);
      const int pc = i / TILE, q = i - pc * TILE;
      const int r = q / (kBN / 8), c = 8 * (q - r * (kBN / 8));
      const int row = m0 + r, col = n0 + c;
      if (row < 2 * H && col < 2 * W)
        *reinterpret_cast<uint4*>(hp + pc * lo + (long long)row * 2 * W +
                                  col) =
            *reinterpret_cast<const uint4*>(tile + pc * TP + r * TLD + c);
    }
  }
}

// Products 3 and 4 for one BM-row strip of the H side of one plane:
// out[p][m0 …] = D_h[m0 …, :] · hi[p] · D_wᵀ, hi's pieces from the
// scratch (as the up launch wrote them). dh, dw: the split blobs of D_hᵀ
// (2H × H) and D_wᵀ (2W × W). out f32, or bf16 rounded once.
template <int PASSES, int BM, class T>
__global__ void __launch_bounds__(DownCfg<PASSES, BM>::kThreads,
                                  DownCfg<PASSES, BM>::kMinBlocks)
banded_down_kernel(const bf16* __restrict__ hs, T* __restrict__ out,
                   const bf16* __restrict__ dh, const bf16* __restrict__ dw,
                   int H, int W, long long lo) {
  using C = DownCfg<PASSES, BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* strip = reinterpret_cast<bf16*>(smem_raw);
  const int ld = mma_ld(2 * W), w2p = pad16(2 * W);
  const int piece = BM * ld;
  bf16* ring = strip + C::kPieces * piece;
  const int strips = (H + BM - 1) / BM;
  const int p = blockIdx.x / strips, m0 = (blockIdx.x - p * strips) * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * C::WM, wn = (warp & 3) * C::WN;
  const bf16* hp = hs + (long long)p * 4 * H * W;
  T* op = out + (long long)p * H * W;
  const long long ld_dh = mma_ld(H), lo_dh = pad16(2 * H) * ld_dh;
  const long long ld_dw = mma_ld(W), lo_dw = pad16(2 * W) * ld_dw;
  Acc<C, PASSES> acc;

  // lo's strip = D_h's rows · hi, kBN columns a piece, into the strip
  for (int n0 = 0; n0 < 2 * W; n0 += kBN) {
    const auto issue = [&](bf16* s, int kt) {
      slab_async<C::kThreads, C::kPieces, C::kBK, BM, C::LDA, C::A_PIECE>(
          s, dh, ld_dh, lo_dh, C::kBK * kt, 2 * H, m0, H);
      slab_async<C::kThreads, C::kPieces, C::kBK, kBN, C::LDB, C::B_PIECE>(
          s + C::A_STAGE, hp, 2 * W, lo, C::kBK * kt, 2 * H, n0, 2 * W);
    };
    k_loop<C, PASSES, true, false>(acc, ring, pad16(2 * H) / 16, issue,
                                   NoPrep{}, SlabA{});
    acc.each_pair(wm, wn, lane, [&](int r, int c, float v0, float v1) {
      if (n0 + c < w2p)
        store_pair<PASSES>(strip + r * ld + n0 + c, piece, v0, v1);
    });
  }

  // out's strip = lo · D_wᵀ, kBN columns a piece, to device memory
  // through the ring, free once the piece's products are done, so that it
  // leaves in rows of 4-element copies
  T* const tile = reinterpret_cast<T*>(ring);
  constexpr int TLD = kBN + 16 / sizeof(T);
  static_assert(BM * TLD * sizeof(T) <= 2 * C::kStages * C::STAGE,
                "tile in ring");
  for (int n0 = 0; n0 < W; n0 += kBN) {
    const auto issue = [&](bf16* s, int kt) {
      slab_async<C::kThreads, C::kPieces, C::kBK, kBN, C::LDB, C::B_PIECE>(
          s + C::A_STAGE, dw, ld_dw, lo_dw, C::kBK * kt, 2 * W, n0, W);
    };
    const auto frag_a = [&](unsigned (&a)[C::MT][4], int step, int pc,
                            int wm_, int ln) {
      frag_a_rows<C>(a, strip + pc * piece, ld, 16 * step, wm_, ln);
    };
    k_loop<C, PASSES, false, false>(acc, ring, w2p / 16, issue, NoPrep{},
                                    frag_a);
    __syncthreads();  // the last slab's readers are done with the ring
    acc.each_pair(wm, wn, lane, [&](int r, int c, float v0, float v1) {
      T* q = tile + r * TLD + c;
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
      else
        store2(q, v0, v1);
    });
    __syncthreads();
    using V = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;
    for (int i = tid; i < BM * (kBN / 4); i += C::kThreads) {
      const int r = i / (kBN / 4), c = 4 * (i - r * (kBN / 4));
      const int row = m0 + r, col = n0 + c;
      if (row < H && col < W)
        *reinterpret_cast<V*>(op + (long long)row * W + col) =
            *reinterpret_cast<const V*>(tile + r * TLD + c);
    }
  }
}

// The backward up launch's tile: K1's up launch's ring, in strips of BM
// (64 or 32) rows, 8 warps of (BM / 2) × 32 pieces; at 'default' two
// blocks an SM. (At 'high' 16 warps of 16 × 32, K1's up launch's, spill:
// the sums, their small parts and act′(pre) held at once pass the 128
// registers a thread of 16 warps.)
template <int PASSES, int BM, class T>
using BwdUpCfg = Cfg<PASSES, BM, 16, 4, sizeof(T), 2, PASSES == 3 ? 1 : 2>;

// K2's products 1 to 4 for one BM-row strip of the 2H side of one plane:
// m[p][m0 …] = act′(U_h[m0 …, :] · x[p] · U_wᵀ) ⊙ (D_hᵀ[m0 …, :] · g[p] ·
// D_w) into the scratch's pieces (plane p's hi piece at ms + p·4HW, rows 2W
// apart, its lo piece ``lo`` after it). uh, dh, uw, dw: the split blobs of
// U_hᵀ and D_h (H × 2H), U_wᵀ and D_w (W × 2W).
template <int PASSES, int BM, class T>
__global__ void __launch_bounds__(BwdUpCfg<PASSES, BM, T>::kThreads,
                                  BwdUpCfg<PASSES, BM, T>::kMinBlocks)
banded_bwd_up_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     bf16* __restrict__ ms, const bf16* __restrict__ uh,
                     const bf16* __restrict__ dh, const bf16* __restrict__ uw,
                     const bf16* __restrict__ dw, int H, int W, long long lo,
                     afldm_filtered::MulActGrad grad) {
  using C = BwdUpCfg<PASSES, BM, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = mma_ld(W), wp = pad16(W);
  const int piece = BM * ld;
  bf16* const ts = reinterpret_cast<bf16*>(smem_raw);  // t's strip, v's
  bf16* ring = ts + 2 * C::kPieces * piece;
  const int strips = (2 * H + BM - 1) / BM;
  const int p = blockIdx.x / strips, m0 = (blockIdx.x - p * strips) * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * C::WM, wn = (warp & 3) * C::WN;
  bf16* mp = ms + (long long)p * 4 * H * W;
  // the blobs' rows and pieces apart
  const int ld_h = mma_ld(2 * H), lo_h = pad16(H) * ld_h;
  const int ld_w = mma_ld(2 * W), lo_w = pad16(W) * ld_w;
  Acc<C, PASSES> acc;

  // t's strip = U_h's rows · x, then v's = D_hᵀ's rows · g, kBN columns a
  // piece, into their strips
  for (int i = 0; i < 2; ++i) {
    const bf16* a = i ? dh : uh;
    const T* src = (i ? g : x) + (long long)p * H * W;
    bf16* strip = ts + i * C::kPieces * piece;
    for (int n0 = 0; n0 < W; n0 += kBN) {
      const auto issue = [&](bf16* s, int kt) {
        slab_async<C::kThreads, C::kPieces, C::kBK, BM, C::LDA, C::A_PIECE>(
            s, a, ld_h, lo_h, C::kBK * kt, H, m0, 2 * H);
        raw_async<C::kThreads, T, C::kBK>(s + C::A_STAGE + C::B_STAGE, src,
                                          W, C::kBK * kt, H, n0);
      };
      const auto prep = [&](bf16* s) {
        split_raw<C::kThreads, PASSES, T, C::kBK, C::LDB, C::B_PIECE>(
            s + C::A_STAGE, s + C::A_STAGE + C::B_STAGE);
      };
      k_loop<C, PASSES, true, true>(acc, ring, pad16(H) / 16, issue, prep,
                                    SlabA{});
      acc.each_pair(wm, wn, lane, [&](int r, int c, float v0, float v1) {
        if (n0 + c < wp)
          store_pair<PASSES>(strip + r * ld + n0 + c, piece, v0, v1);
      });
    }
  }

  // one product of a strip (t's or v's) and an operator's kBN columns
  // from n0 (U_wᵀ's or D_w's), depth W
  const auto across = [&](const bf16* strip, const bf16* b, int n0) {
    const auto issue = [&](bf16* s, int kt) {
      slab_async<C::kThreads, C::kPieces, C::kBK, kBN, C::LDB, C::B_PIECE>(
          s + C::A_STAGE, b, ld_w, lo_w, C::kBK * kt, W, n0, 2 * W);
    };
    const auto frag_a = [&](unsigned (&fa)[C::MT][4], int step, int pc,
                            int wm_, int ln) {
      frag_a_rows<C>(fa, strip + pc * piece, ld, 16 * step, wm_, ln);
    };
    k_loop<C, PASSES, false, false>(acc, ring, wp / 16, issue, NoPrep{},
                                    frag_a);
  };

  // m's strip = act′(t · U_wᵀ) ⊙ (v · D_w), kBN columns a piece, to the
  // scratch through the ring, free once the piece's products are done, so
  // that the pieces leave in 16-byte rows
  bf16* const tile = ring;
  constexpr int TLD = kBN + 8, TP = BM * TLD;
  static_assert(C::kPieces * TP <= C::kStages * C::STAGE, "tile in ring");
  constexpr int NV = Acc<C, PASSES>::kValues;
  for (int n0 = 0; n0 < 2 * W; n0 += kBN) {
    // pre's sums give way to act′(pre) (the case chosen once for the
    // warp's values), then ds's accumulators take their registers
    float ag[NV];
    across(ts, uw, n0);
    acc.sums(ag);
    grad.grads(ag);
    across(ts + C::kPieces * piece, dw, n0);
    float m[NV];
    acc.sums(m);
#pragma unroll
    for (int k = 0; k < NV; ++k) m[k] = ag[k] * m[k];
    __syncthreads();  // the last slab's readers are done with the ring
    Acc<C, PASSES>::each_pair(m, wm, wn, lane,
                              [&](int r, int c, float v0, float v1) {
      store_pair<PASSES>(tile + r * TLD + c, TP, v0, v1);
    });
    __syncthreads();
    for (int i = tid; i < C::kPieces * BM * (kBN / 8); i += C::kThreads) {
      constexpr int TILE = BM * (kBN / 8);
      const int pc = i / TILE, q = i - pc * TILE;
      const int r = q / (kBN / 8), c = 8 * (q - r * (kBN / 8));
      const int row = m0 + r, col = n0 + c;
      if (row < 2 * H && col < 2 * W)
        *reinterpret_cast<uint4*>(mp + pc * lo + (long long)row * 2 * W +
                                  col) =
            *reinterpret_cast<const uint4*>(tile + pc * TP + r * TLD + c);
    }
  }
}

// Shared bytes of the up launch and of the down launch at ``down_rows``
template <int PASSES, class T>
size_t up_smem(int W) {
  return UpCfg<PASSES, T>::smem(mma_ld(W));
}
template <int PASSES, int BM>
size_t down_smem(int W) {
  return DownCfg<PASSES, BM>::smem(mma_ld(2 * W));
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int PASSES, int BM, class T>
int down(const bf16* hs, T* out, const bf16* dhT, const bf16* dwT,
         int nplanes, int H, int W, long long lo, cudaStream_t s) {
  const auto kernel = banded_down_kernel<PASSES, BM, T>;
  const size_t smem = down_smem<PASSES, BM>(W);
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  const long long blocks = (long long)nplanes * ((H + BM - 1) / BM);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, DownCfg<PASSES, BM>::kThreads, smem, s>>>(
      hs, out, dhT, dwT, H, W, lo);
  return (int)cudaGetLastError();
}

template <int PASSES, class T>
int banded_level(const T* x, T* out, bf16* hs, const bf16* uhT,
                 const bf16* uwT, const bf16* dhT, const bf16* dwT,
                 int nplanes, int H, int W, int down_rows, int act,
                 cudaStream_t s) {
  const auto up = banded_up_kernel<PASSES, T>;
  const size_t smem = up_smem<PASSES, T>(W);
  int err = set_smem((const void*)up, smem);
  if (err) return err;
  const long long blocks =
      (long long)nplanes * ((2 * H + kUpRows - 1) / kUpRows);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // hi's pieces: every plane's hi piece, then every plane's lo piece
  const long long lo = (long long)nplanes * 4 * H * W;
  up<<<(unsigned)blocks, UpCfg<PASSES, T>::kThreads, smem, s>>>(
      x, hs, uhT, uwT, H, W, lo, afldm_filtered::Activation{act});
  err = (int)cudaGetLastError();
  if (err) return err;
  if (down_rows == 64)
    return down<PASSES, 64>(hs, out, dhT, dwT, nplanes, H, W, lo, s);
  return down<PASSES, 32>(hs, out, dhT, dwT, nplanes, H, W, lo, s);
}

// The backward up launch at ``BM``-row strips; m's pieces ``lo`` apart
template <int PASSES, int BM, class T>
int bwd_up(const T* x, const T* g, bf16* ms, const bf16* uhT, const bf16* dh,
           const bf16* uwT, const bf16* dw, int nplanes, int H, int W,
           long long lo, int act, cudaStream_t s) {
  const auto kernel = banded_bwd_up_kernel<PASSES, BM, T>;
  const size_t smem = BwdUpCfg<PASSES, BM, T>::smem(mma_ld(W), 2);
  const int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  const long long blocks = (long long)nplanes * ((2 * H + BM - 1) / BM);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, BwdUpCfg<PASSES, BM, T>::kThreads, smem, s>>>(
      x, g, ms, uhT, dh, uwT, dw, H, W, lo, afldm_filtered::MulActGrad{act});
  return (int)cudaGetLastError();
}

// K2's chunk: the backward up launch, then products 5 and 6 as K1's down
// launch with U_h's blob (the k-major form of U_hᵀ) in D_hᵀ's place and
// U_w's in D_wᵀ's
template <int PASSES, class T>
int banded_bwd_level(const T* x, const T* g, T* dx, bf16* ms,
                     const bf16* uhT, const bf16* dh, const bf16* uwT,
                     const bf16* dw, const bf16* uw, const bf16* uh,
                     int nplanes, int H, int W, int up_rows, int down_rows,
                     int act, cudaStream_t s) {
  // m's pieces: every plane's hi piece, then every plane's lo piece
  const long long lo = (long long)nplanes * 4 * H * W;
  const int err =
      up_rows == 64
          ? bwd_up<PASSES, 64>(x, g, ms, uhT, dh, uwT, dw, nplanes, H, W, lo,
                               act, s)
          : bwd_up<PASSES, 32>(x, g, ms, uhT, dh, uwT, dw, nplanes, H, W, lo,
                               act, s);
  if (err) return err;
  if (down_rows == 64)
    return down<PASSES, 64>(ms, dx, uh, uw, nplanes, H, W, lo, s);
  return down<PASSES, 32>(ms, dx, uh, uw, nplanes, H, W, lo, s);
}

template <class T>
int banded_bwd_mma(const T* x, const T* g, T* dx, bf16* ms, const bf16* uhT,
                   const bf16* dh, const bf16* uwT, const bf16* dw,
                   const bf16* uw, const bf16* uh, int nplanes, int H, int W,
                   int up_rows, int down_rows, int passes, int act,
                   void* stream) {
  if (H % 4 || W % 4 || H < 4 || W < 4 || nplanes < 1 ||
      (up_rows != 64 && up_rows != 32) ||
      (down_rows != 64 && down_rows != 32) || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (passes == 3)
    return banded_bwd_level<3>(x, g, dx, ms, uhT, dh, uwT, dw, uw, uh,
                               nplanes, H, W, up_rows, down_rows, act, s);
  return banded_bwd_level<1>(x, g, dx, ms, uhT, dh, uwT, dw, uw, uh, nplanes,
                             H, W, up_rows, down_rows, act, s);
}

template <class T>
int banded_mma(const T* x, T* out, bf16* hs, const bf16* uhT,
               const bf16* uwT, const bf16* dhT, const bf16* dwT,
               int nplanes, int H, int W, int down_rows, int passes, int act,
               void* stream) {
  if (H % 4 || W % 4 || H < 4 || W < 4 || nplanes < 1 ||
      (down_rows != 64 && down_rows != 32) || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (passes == 3)
    return banded_level<3>(x, out, hs, uhT, uwT, dhT, dwT, nplanes, H, W,
                           down_rows, act, s);
  return banded_level<1>(x, out, hs, uhT, uwT, dhT, dwT, nplanes, H, W,
                         down_rows, act, s);
}

}  // namespace

// K1 at a reduced level on one chunk of ``nplanes`` planes: the up and the
// down launch on ``stream``. scratch: hi's bf16 pieces, 4·H·W a plane and
// piece (every plane's hi piece, then at 'high' every plane's lo piece).
// Operators: the split blobs (hi, lo pieces, zero-padded to pad16(rows) ×
// mma_ld(cols)) of uhT = U_hᵀ (H×2H), uwT = U_wᵀ (W×2W), dhT = D_hᵀ
// (2H×H), dwT = D_wᵀ (2W×W). down_rows: the down launch's strip, 64 or 32
// rows; passes: 3 ('high') or 1 ('default').
extern "C" int filtered_act_banded_bf16(const float* x, float* out,
                                        bf16* scratch, const bf16* uhT,
                                        const bf16* uwT, const bf16* dhT,
                                        const bf16* dwT, int nplanes, int H,
                                        int W, int down_rows, int passes,
                                        int act, void* stream) {
  return banded_mma(x, out, scratch, uhT, uwT, dhT, dwT, nplanes, H, W,
                    down_rows, passes, act, stream);
}

// K1 at a reduced level for a bf16 x: the same arguments, x and out bf16.
extern "C" int filtered_act_banded_bf16_xbf16(
    const bf16* x, bf16* out, bf16* scratch, const bf16* uhT,
    const bf16* uwT, const bf16* dhT, const bf16* dwT, int nplanes, int H,
    int W, int down_rows, int passes, int act, void* stream) {
  return banded_mma(x, out, scratch, uhT, uwT, dhT, dwT, nplanes, H, W,
                    down_rows, passes, act, stream);
}

// K2 at a reduced level on one chunk of ``nplanes`` planes: the backward
// up and the down launch on ``stream``. scratch: m's bf16 pieces, 4·H·W a
// plane and piece (every plane's hi piece, then at 'high' every plane's lo
// piece). Operators: the split blobs of uhT = U_hᵀ (H×2H), dh = D_h
// (H×2H), uwT = U_wᵀ (W×2W), dw = D_w (W×2W), uw = U_w (2W×W), uh = U_h
// (2H×H). up_rows, down_rows: the launches' strips, 64 or 32 rows; passes:
// 3 ('high') or 1 ('default').
extern "C" int filtered_act_banded_bwd_bf16(
    const float* x, const float* g, float* dx, bf16* scratch, const bf16* uhT,
    const bf16* dh, const bf16* uwT, const bf16* dw, const bf16* uw,
    const bf16* uh, int nplanes, int H, int W, int up_rows, int down_rows,
    int passes, int act, void* stream) {
  return banded_bwd_mma(x, g, dx, scratch, uhT, dh, uwT, dw, uw, uh, nplanes,
                        H, W, up_rows, down_rows, passes, act, stream);
}

// K2 at a reduced level for a bf16 x and g: the same arguments, x, g and dx
// bf16.
extern "C" int filtered_act_banded_bwd_bf16_xbf16(
    const bf16* x, const bf16* g, bf16* dx, bf16* scratch, const bf16* uhT,
    const bf16* dh, const bf16* uwT, const bf16* dw, const bf16* uw,
    const bf16* uh, int nplanes, int H, int W, int up_rows, int down_rows,
    int passes, int act, void* stream) {
  return banded_bwd_mma(x, g, dx, scratch, uhT, dh, uwT, dw, uw, uh, nplanes,
                        H, W, up_rows, down_rows, passes, act, stream);
}
