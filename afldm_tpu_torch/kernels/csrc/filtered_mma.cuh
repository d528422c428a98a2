// The bf16 tensor-core product of the filtered activation's reduced
// precision levels ("high", "default"), shared by the plane kernels (K5,
// K5b: filtered_plane_mma.cu), K1's and K2's fused launches
// (filtered_banded_mma.cu) and the banded chains' tiled GEMM
// (filtered_gemm.cuh).
//
// Replaces the reduced levels of afldm_tpu/ops/pallas_kernels.py::
// _precise_dot: every product a·b of those kernels runs as
//
//   high:     ah·bh + ah·bl + al·bh      (3 passes)
//   default:  ah·bh                      (1 pass)
//
// with hi = bf16_rne(a) and lo = bf16_rne(a - hi): the products of two
// bf16 values are exact, the sums f32 (the tensor core's accumulator). Each
// product's f32 result is split again before the product that reads it.
//
// Fragments: the warp-level mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32, each operand's 16×16 (A) or 16×16 (two B tiles of 16×8)
// fragment loaded from shared memory by one ldmatrix.x4: ``.trans`` for an
// operand stored k-major (row k holds the k-th term of every output row or
// column), plain for a row-major A whose rows run along k. A row of a
// piece is ``mma_ld(n)`` = pad16(n) + 8 bf16 long: 16-byte aligned for
// ldmatrix, and an odd multiple of 16 bytes, so the 8 rows of one 8×8
// matrix fall on 8 different 16-byte bank groups. Sides are zero-padded
// to multiples of 16 (the 4 and 8 px planes' K = 4 or 8): exact zeros add
// nothing, and every activation maps 0 to 0, so padded rows and columns of
// a result stay zero for the product that reads it.
//
// What bounds it: the products, 1 or 3 bf16 tensor-core passes each (at
// 3 passes also the f32 TwoSum after every 16-deep step, ~7 FP32
// instructions an element a step against 3 mma), and at small planes the
// zero padding to 16 and the shared-memory traffic of the fragments. The
// plane kernels walk strips (strip_product, middle_pair, middle_pair_bwd):
// a warp owns a 16-row strip of a result and up to 4 16-column blocks of
// it, so each A fragment feeds every block of the strip, and the middle
// pairs keep the 2x intermediate in registers between their products.
// Each f32 result stays in registers until it is split into the next
// product's operand. None uses wgmma nor TMA (later work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "filtered_tile.cuh"

namespace afldm_filtered {

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }
// the row stride, in bf16, of a piece of n columns
__host__ __device__ __forceinline__ int mma_ld(int n) { return pad16(n) + 8; }
// bf16 elements of one piece (hi or lo) of rows × cols
__host__ __device__ __forceinline__ int mma_piece(int rows, int cols) {
  return pad16(rows) * mma_ld(cols);
}

// A split operand of P planes in shared memory: plane p's hi piece at
// hi + p·ps, its lo piece ``lo`` elements after that, rows ``ld`` apart.
struct Piece {
  __nv_bfloat16* hi;
  int ld, lo, ps;
};
// the split buffer of rows × cols at ``base`` (plane stride ps)
__device__ __forceinline__ Piece piece(__nv_bfloat16* base, int rows,
                                       int cols, int ps) {
  return Piece{base, mma_ld(cols), pad16(rows) * mma_ld(cols), ps};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc += step with the rounding error of that f32 addition added to err
// (Knuth's TwoSum): the 3-pass products keep their main pass's running sum
// exact to within the small accumulator's own rounding.
__device__ __forceinline__ void add_two_sum(float& acc, float step,
                                            float& err) {
  const float s = acc + step, bb = s - acc;
  err += (acc - (s - bb)) + (step - bb);
  acc = s;
}

// c += a · b over one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 pieces of (v0, v1), round to nearest even; v0 in the low half
// (the lower address).
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Four consecutive floats split into two 8-byte pieces at hi[0..3] and
// lo[0..3] (8-byte aligned).
__device__ __forceinline__ void store_split4(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float4 v) {
  uint2 h, l;
  split2(v.x, v.y, h.x, l.x);
  split2(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// Calls f(row, col, v0, v1) for the two-column pairs of a warp's 16×16
// result tile at (r0, c0) held as two m16n8 accumulators.
template <class F>
__device__ __forceinline__ void for_pairs(int r0, int c0,
                                          const float (&acc)[2][4], int lane,
                                          F f) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(r0 + g + 8 * h, c0 + 8 * j + t2, acc[j][2 * h], acc[j][2 * h + 1]);
}

// -- the plane kernels' strips (filtered_plane_mma.cu) --------------------
//
// Each routine below computes every element with the sums of a 16×16 tile
// walk (the plane kernels' first bf16 form): 16-deep steps in ascending
// order, each step's ah·bh from zero added by TwoSum at 3 passes, the
// small passes ah·bl then al·bh in an accumulator of their own added once
// at the end. Where a product is computed with A and B swapped against
// that walk (its transposed result), the small passes are swapped too
// (kLoAFirst), so every element's sum is the walk's, bit for bit, whatever
// the strip's shape. The counts of 16-column blocks are template arguments
// (the plane kernels are built for each pad16(W) / 16 of 1 to
// kStripBlocks): with no branch between a strip's blocks, the compiler
// issues their loads and mma back to back, which hides their latency with
// the 8 to 16 warps an SM holds.

// the 16-column blocks of a K5 result at most (W <= 64)
constexpr int kStripBlocks = 4;

// One 16-deep step of a strip: acc[n] (+ small[n]) += A · B[n] for n < NB,
// A's fragments given (al read at 3 passes only), B[n] the k-major piece
// at b + 16·n (its lo piece ``blo`` elements after it). kLoAFirst takes
// the small passes as al·bh then ah·bl: the walk's order (ah·bl, al·bh)
// for the product computed with A and B swapped.
template <int PASSES, bool kLoAFirst, int NB>
__device__ __forceinline__ void strip_step(float (&acc)[NB][2][4],
                                           float (&small)[NB][2][4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const __nv_bfloat16* b, int blo) {
  unsigned bh[NB][4];
  float step[NB][2][4] = {};
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    ldsm_x4_t(bh[n], b + 16 * n);
    mma_bf16(step[n][0], ah, bh[n][0], bh[n][1]);
    mma_bf16(step[n][1], ah, bh[n][2], bh[n][3]);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (PASSES == 3)
          add_two_sum(acc[n][j][e], step[n][j][e], small[n][j][e]);
        else
          acc[n][j][e] += step[n][j][e];
      }
  if constexpr (PASSES == 3) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      unsigned bl[4];
      ldsm_x4_t(bl, b + blo + 16 * n);
      if constexpr (kLoAFirst) {
        mma_bf16(small[n][0], al, bh[n][0], bh[n][1]);
        mma_bf16(small[n][1], al, bh[n][2], bh[n][3]);
        mma_bf16(small[n][0], ah, bl[0], bl[1]);
        mma_bf16(small[n][1], ah, bl[2], bl[3]);
      } else {
        mma_bf16(small[n][0], ah, bl[0], bl[1]);
        mma_bf16(small[n][1], ah, bl[2], bl[3]);
        mma_bf16(small[n][0], al, bh[n][0], bh[n][1]);
        mma_bf16(small[n][1], al, bh[n][2], bh[n][3]);
      }
    }
  }
}

// acc += small over a strip's blocks (3 passes): the small passes added once
template <int NB>
__device__ __forceinline__ void add_small(float (&acc)[NB][2][4],
                                          const float (&small)[NB][2][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][j][e] += small[n][j][e];
}

// A strip's NB blocks at (r0, c0) of plane p split into the pieces of d:
// hi, and lo at 3 passes (1 pass stores hi alone).
template <int PASSES, int NB>
__device__ __forceinline__ void store_strip(const Piece& d, int p, int r0,
                                            int c0,
                                            const float (&acc)[NB][2][4],
                                            int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
    for_pairs(r0, c0 + 16 * n, acc[n], lane,
              [&](int r, int c, float v0, float v1) {
                unsigned h, l;
                split2(v0, v1, h, l);
                __nv_bfloat16* q = d.hi + p * d.ps + r * d.ld + c;
                *reinterpret_cast<unsigned*>(q) = h;
                if constexpr (PASSES == 3)
                  *reinterpret_cast<unsigned*>(q + d.lo) = l;
              });
}

// strip_product's items of one 16-row strip and NB 16-column blocks (of
// NW a strip), handed to out(p, r0, c0, acc, lane).
template <int PASSES, bool kLoAFirst, int NW, int NB, class Out>
__device__ __forceinline__ void strip_items(const Piece& A, const Piece& B,
                                            int P, int Mp, int Kp, Out out) {
  constexpr int cw = NW / NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, rs = Mp >> 4;
  for (int it = warp; it < P * rs * cw; it += warps) {
    const int s = it / cw, p = s / rs;
    const int r0 = 16 * (s - p * rs), c0 = 16 * NB * (it - s * cw);
    const __nv_bfloat16* ap = A.hi +
                              ((lane & 7) + 8 * (lane >> 4)) * A.ld + r0 +
                              8 * ((lane >> 3) & 1);
    const __nv_bfloat16* bp = B.hi + p * B.ps +
                              ((lane & 7) + 8 * ((lane >> 3) & 1)) * B.ld +
                              c0 + 8 * (lane >> 4);
    float acc[NB][2][4] = {}, small[NB][2][4] = {};
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      unsigned ah[4], al[4];
      ldsm_x4_t(ah, ap + k0 * A.ld);
      if constexpr (PASSES == 3) ldsm_x4_t(al, ap + A.lo + k0 * A.ld);
      strip_step<PASSES, kLoAFirst>(acc, small, ah, al, bp + k0 * B.ld,
                                    B.lo);
    }
    if constexpr (PASSES == 3) add_small(acc, small);
    out(p, r0, c0, acc, lane);
  }
}

// C[p] = A · B[p] for p < P over Mp × 16·NW (Mp a multiple of 16), depth
// Kp: A the operator, k-major (row k holds its k-th column), shared by
// the planes; B[p] k-major. A warp takes one 16-row strip and ``per``
// 16-column blocks at a time: every block of the strip, or the next
// smaller divisor of NW while that leaves warps idle; it reads each
// step's A fragment once for all of them, and hands them to out(p, r0,
// c0, acc, lane) (acc: float[per][2][4]).
template <int PASSES, bool kLoAFirst, int NW, class Out>
__device__ __forceinline__ void strip_product(const Piece& A, const Piece& B,
                                              int P, int Mp, int Kp,
                                              Out out) {
  const int strips = P * (Mp >> 4), warps = blockDim.x >> 5;
  if (NW == 1 || strips >= warps) {
    strip_items<PASSES, kLoAFirst, NW, NW>(A, B, P, Mp, Kp, out);
    return;
  }
  if constexpr (NW == 4) {
    if (2 * strips >= warps) {
      strip_items<PASSES, kLoAFirst, NW, 2>(A, B, P, Mp, Kp, out);
      return;
    }
  }
  strip_items<PASSES, kLoAFirst, NW, 1>(A, B, P, Mp, Kp, out);
}

// K5's middle pair over P planes of t (2H × 16·NW, row-major pieces; Hp2
// = pad16(2H), W2p = pad16(2W)), a warp a 16-row strip of the 2H side at a
// time:
//   hi = act(t · U_wᵀ)    (2H × 2W)  16 columns (a chunk) at a time
//   t₂ = hi · D_wᵀ        (2H × W)   each chunk one 16-deep step
// The strip's t fragments are read once and held (kHoldT; else read again
// for each chunk, where held they would not fit the block's registers);
// each chunk of hi is two m16n8 accumulators, which are the m16n8k16 A
// fragment of t₂'s step over that chunk once act.map has taken the
// activation of its 8 values and they are split, so hi never leaves the
// registers. t₂ is written over the strip of t it was made from, which no
// other warp reads. U_wᵀ (W × 2W) and D_wᵀ (2W × W) are k-major.
template <int PASSES, int NW, bool kHoldT, class Act>
__device__ __forceinline__ void middle_pair(const Piece& Uw, const Piece& Dw,
                                            const Piece& t, int P, int Hp2,
                                            int W2p, Act act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, rs = Hp2 >> 4;
  const int bro = (lane & 7) + 8 * ((lane >> 3) & 1), bco = 8 * (lane >> 4);
  for (int s = warp; s < P * rs; s += warps) {
    const int p = s / rs, i0 = 16 * (s - p * rs);
    // t's A fragments (row-major: ldmatrix without .trans)
    const __nv_bfloat16* tp = t.hi + p * t.ps + (i0 + bro) * t.ld + bco;
    unsigned th[NW][4], tl[NW][4];
    const auto load_t = [&] {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        ldsm_x4(th[k], tp + 16 * k);
        if constexpr (PASSES == 3) ldsm_x4(tl[k], tp + t.lo + 16 * k);
      }
    };
    if constexpr (kHoldT) load_t();
    const __nv_bfloat16* up = Uw.hi + bro * Uw.ld + bco;
    const __nv_bfloat16* dp = Dw.hi + bro * Dw.ld + bco;
    float acc[NW][2][4] = {}, small[NW][2][4] = {};
    const auto chunk = [&](int j0) {
      if constexpr (!kHoldT) load_t();
      float h[1][2][4] = {}, hs[1][2][4] = {};
#pragma unroll
      for (int k = 0; k < NW; ++k)
        strip_step<PASSES, true>(h, hs, th[k], tl[k],
                                 up + 16 * k * Uw.ld + j0, Uw.lo);
      if constexpr (PASSES == 3) add_small(h, hs);
      // value 2r, 2r + 1 go to register r of the A fragment: rows g (r
      // even) or g + 8, columns 2t, 2t + 1 of the chunk's first (r < 2) or
      // second 8
      float v[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[2 * r] = h[0][r >> 1][2 * (r & 1)];
        v[2 * r + 1] = h[0][r >> 1][2 * (r & 1) + 1];
      }
      act.map(v);
      unsigned ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split2(v[2 * r], v[2 * r + 1], ah[r], al[r]);
      strip_step<PASSES, false>(acc, small, ah, al, dp + j0 * Dw.ld, Dw.lo);
    };
    if constexpr (PASSES == 3) {
      // two chunks in flight: the next chunk's hi product (its small
      // passes a chain of 2·NW dependent mma) overlaps this one's t₂ step
#pragma unroll 2
      for (int j0 = 0; j0 < W2p; j0 += 16) chunk(j0);
      add_small(acc, small);
    } else {
      for (int j0 = 0; j0 < W2p; j0 += 16) chunk(j0);
    }
    __syncwarp();
    store_strip<PASSES>(t, p, i0, 0, acc, lane);
  }
}

// K5b's backward middle pair over P planes of t and v (2H × 16·NW each,
// row-major pieces; Hp2 = pad16(2H), W2p = pad16(2W)), a warp a 16-row
// strip of the 2H side at a time:
//   pre = t · U_wᵀ,  ds = v · D_w      (2H × 2W)  16 columns (a chunk) at
//                                                 a time, over the same rows
//   s  += (act′(pre) ⊙ ds) · U_w       (2H × W)   each chunk one 16-deep step
// middle_pair with two products in its first half: each chunk's pre and
// ds are two m16n8 accumulator pairs, act′(pre) ⊙ ds is taken in
// registers (grad.grads: the act's case once for the warp's 8 values), and
// the product, split, is the A fragment of s's step over that chunk, so
// neither pre nor m leaves the registers. The strip's t and v fragments are
// read once and held (kHold; else read again for each chunk, where held
// they would not fit the block's registers). s is written over the strip
// of t it was made from, which no other warp reads. U_wᵀ and D_w (W × 2W)
// and U_w (2W × W) are k-major.
template <int PASSES, int NW, bool kHold, class Grad>
__device__ __forceinline__ void middle_pair_bwd(const Piece& UwT,
                                                const Piece& Dw,
                                                const Piece& Uw, const Piece& t,
                                                const Piece& v, int P,
                                                int Hp2, int W2p, Grad grad) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, rs = Hp2 >> 4;
  const int bro = (lane & 7) + 8 * ((lane >> 3) & 1), bco = 8 * (lane >> 4);
  for (int s = warp; s < P * rs; s += warps) {
    const int p = s / rs, i0 = 16 * (s - p * rs);
    // t's and v's A fragments (row-major: ldmatrix without .trans)
    const __nv_bfloat16* tp = t.hi + p * t.ps + (i0 + bro) * t.ld + bco;
    const __nv_bfloat16* vp = v.hi + p * v.ps + (i0 + bro) * v.ld + bco;
    unsigned th[NW][4], tl[NW][4], vh[NW][4], vl[NW][4];
    // the k-th 16 columns of the strip's t (or v) fragments
    const auto load = [&](unsigned (&rh)[4], unsigned (&rl)[4],
                          const __nv_bfloat16* q, int lo, int k) {
      ldsm_x4(rh, q + 16 * k);
      if constexpr (PASSES == 3) ldsm_x4(rl, q + lo + 16 * k);
    };
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        load(th[k], tl[k], tp, t.lo, k);
        load(vh[k], vl[k], vp, v.lo, k);
      }
    }
    const __nv_bfloat16* up = UwT.hi + bro * UwT.ld + bco;
    const __nv_bfloat16* dp = Dw.hi + bro * Dw.ld + bco;
    const __nv_bfloat16* sp = Uw.hi + bro * Uw.ld + bco;
    float acc[NW][2][4] = {}, small[NW][2][4] = {};
    const auto chunk = [&](int j0) {
      float h[1][2][4] = {}, hs[1][2][4] = {};
      float d[1][2][4] = {}, ds[1][2][4] = {};
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if constexpr (!kHold) load(th[k], tl[k], tp, t.lo, k);
        strip_step<PASSES, true>(h, hs, th[k], tl[k],
                                 up + 16 * k * UwT.ld + j0, UwT.lo);
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if constexpr (!kHold) load(vh[k], vl[k], vp, v.lo, k);
        strip_step<PASSES, true>(d, ds, vh[k], vl[k],
                                 dp + 16 * k * Dw.ld + j0, Dw.lo);
      }
      if constexpr (PASSES == 3) {
        add_small(h, hs);
        add_small(d, ds);
      }
      // value 2r, 2r + 1 go to register r of the A fragment (middle_pair)
      float m[8], dv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m[2 * r] = h[0][r >> 1][2 * (r & 1)];
        m[2 * r + 1] = h[0][r >> 1][2 * (r & 1) + 1];
        dv[2 * r] = d[0][r >> 1][2 * (r & 1)];
        dv[2 * r + 1] = d[0][r >> 1][2 * (r & 1) + 1];
      }
      grad.grads(m);
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = m[e] * dv[e];
      unsigned ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split2(m[2 * r], m[2 * r + 1], ah[r], al[r]);
      strip_step<PASSES, false>(acc, small, ah, al, sp + j0 * Uw.ld, Uw.lo);
    };
    for (int j0 = 0; j0 < W2p; j0 += 16) chunk(j0);
    if constexpr (PASSES == 3) add_small(acc, small);
    __syncwarp();
    store_strip<PASSES>(t, p, i0, 0, acc, lane);
  }
}

// P row-major planes of rows × cols of T in shared memory (planes
// rows·cols apart) split into the pieces of dst, zero-padded to pad16(rows)
// × pad16(cols); hi alone at 1 pass (a bf16 plane's lo pieces are zero).
template <int PASSES, class T>
__device__ __forceinline__ void split_planes(const T* src, int P, int rows,
                                             int cols, const Piece& dst) {
  const int rp = pad16(rows), c4 = pad16(cols) / 4;
  for (int i = threadIdx.x; i < P * rp * c4; i += blockDim.x) {
    const int p = i / (rp * c4), q = i - p * rp * c4;
    const int r = q / c4, c = 4 * (q - r * c4);
    const float4 v = r < rows && c < cols
                         ? load4(src + (p * rows + r) * cols + c)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __nv_bfloat16* h = dst.hi + p * dst.ps + r * dst.ld + c;
    if constexpr (PASSES == 3) {
      store_split4(h, h + dst.lo, v);
    } else {
      uint2 hh, ll;
      split2(v.x, v.y, hh.x, ll.x);
      split2(v.z, v.w, hh.y, ll.y);
      *reinterpret_cast<uint2*>(h) = hh;
    }
  }
}

}  // namespace afldm_filtered
