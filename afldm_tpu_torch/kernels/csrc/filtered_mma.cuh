// The bf16 tensor-core product of the filtered activation's reduced
// precision levels ("high", "default"), shared by the plane kernels (K5,
// K5b: filtered_act.cu) and the banded chains' tiled GEMM (K1, K2:
// filtered_gemm.cuh).
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
// What bounds it: the products, 1 or 3 bf16 tensor-core passes each, and
// at small planes the zero padding to 16 and the shared-memory traffic of
// the fragments. This first version takes one 16×16 output tile a warp at
// a time, keeps each f32 result in registers until it is split into the
// next product's operand, and uses neither wgmma nor TMA (later work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "filtered_tile.cuh"

namespace afldm_filtered {

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }
// the row stride, in bf16, of a piece of n columns
__host__ __device__ __forceinline__ int mma_ld(int n) { return pad16(n) + 8; }
// bf16 elements of a split buffer (hi then lo) of rows × cols
__host__ __device__ __forceinline__ int mma_buf(int rows, int cols) {
  return 2 * pad16(rows) * mma_ld(cols);
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

// Stages P row-major f32 or bf16 planes of rows × cols (16-byte aligned,
// cols % 4 == 0, planes ``src_ps`` elements apart) into split pieces
// zero-padded to pad16(rows) × pad16(cols). Plain loads: the split needs
// the values in registers (a bf16 plane's lo pieces are zero).
template <class T>
__device__ __forceinline__ void stage_split(const T* __restrict__ src,
                                            long long src_ps, int P, int rows,
                                            int cols, Piece dst) {
  const int rp = pad16(rows), c4 = pad16(cols) / 4;
  for (int i = threadIdx.x; i < P * rp * c4; i += blockDim.x) {
    const int p = i / (rp * c4), q = i - p * rp * c4;
    const int r = q / c4, c = 4 * (q - r * c4);
    const float4 v =
        r < rows && c < cols
            ? load4(src + p * src_ps + (long long)r * cols + c)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __nv_bfloat16* h = dst.hi + p * dst.ps + r * dst.ld + c;
    store_split4(h, h + dst.lo, v);
  }
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

// acc = Yᵀ · X over a warp's 16×16 tile at (r0, c0) of plane p, depth Kp
// (a multiple of 16): Y is Kp × R k-major, X Kp × C k-major, both split.
// PASSES 3: ah·bh + (ah·bl + al·bh); 1: ah·bh. Each 16-deep step of ah·bh
// starts from zero and is added to acc in f32 (at 3 passes by TwoSum, its
// rounding error kept with the small passes, which sum in an accumulator of
// their own, added once at the end): every f32 result is split again, and
// at 'high' a last-bit change of it can move its bf16 lo piece by one lo
// ulp, so the sums are kept close to the exactly rounded one (an
// accumulator carried through the tensor core's own sums drifted by more
// than a bit, PERF.md).
template <int PASSES>
__device__ __forceinline__ void warp_tile(float (&acc)[2][4], const Piece& Y,
                                          const Piece& X, int p, int r0,
                                          int c0, int Kp, int lane) {
  const __nv_bfloat16* yh =
      Y.hi + p * Y.ps + ((lane & 7) + 8 * (lane >> 4)) * Y.ld + r0 +
      8 * ((lane >> 3) & 1);
  const __nv_bfloat16* xh =
      X.hi + p * X.ps + ((lane & 7) + 8 * ((lane >> 3) & 1)) * X.ld + c0 +
      8 * (lane >> 4);
  float small[2][4] = {};
  for (int k0 = 0; k0 < Kp; k0 += 16) {
    unsigned ah[4], bh[4];
    ldsm_x4_t(ah, yh + k0 * Y.ld);
    ldsm_x4_t(bh, xh + k0 * X.ld);
    float step[2][4] = {};
    mma_bf16(step[0], ah, bh[0], bh[1]);
    mma_bf16(step[1], ah, bh[2], bh[3]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (PASSES == 3)
          add_two_sum(acc[j][e], step[j][e], small[j][e]);
        else
          acc[j][e] += step[j][e];
      }
    if constexpr (PASSES == 3) {
      unsigned al[4], bl[4];
      ldsm_x4_t(bl, xh + X.lo + k0 * X.ld);
      mma_bf16(small[0], ah, bl[0], bl[1]);
      mma_bf16(small[1], ah, bl[2], bl[3]);
      ldsm_x4_t(al, yh + Y.lo + k0 * Y.ld);
      mma_bf16(small[0], al, bh[0], bh[1]);
      mma_bf16(small[1], al, bh[2], bh[3]);
    }
  }
  if constexpr (PASSES == 3) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
  }
}

// C[p] = Y[p]ᵀ · X[p] for p < P over Rp × Cp (multiples of 16), depth Kp;
// the warps of the block take the P planes' 16×16 tiles in turn and hand
// each to out(p, r0, c0, acc, lane).
template <int PASSES, class Out>
__device__ __forceinline__ void mma_product(const Piece& Y, const Piece& X,
                                            int P, int Rp, int Cp, int Kp,
                                            Out out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = Cp >> 4, tiles = (Rp >> 4) * nc;
  for (int t = warp; t < P * tiles; t += blockDim.x >> 5) {
    const int p = t / tiles, q = t - p * tiles;
    const int r0 = 16 * (q / nc), c0 = 16 * (q - (q / nc) * nc);
    float acc[2][4] = {};
    warp_tile<PASSES>(acc, Y, X, p, r0, c0, Kp, lane);
    out(p, r0, c0, acc, lane);
  }
}

// Two products of one shape over the same tiles, handed together to
// out(p, r0, c0, acc1, acc2, lane): K5b's pre-activation and cotangent,
// whose only use is act′(pre) ⊙ cotangent, so pre never needs storing.
template <int PASSES, class Out>
__device__ __forceinline__ void mma_product2(const Piece& Y1, const Piece& X1,
                                             const Piece& Y2, const Piece& X2,
                                             int P, int Rp, int Cp, int Kp,
                                             Out out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = Cp >> 4, tiles = (Rp >> 4) * nc;
  for (int t = warp; t < P * tiles; t += blockDim.x >> 5) {
    const int p = t / tiles, q = t - p * tiles;
    const int r0 = 16 * (q / nc), c0 = 16 * (q - (q / nc) * nc);
    float a1[2][4] = {}, a2[2][4] = {};
    warp_tile<PASSES>(a1, Y1, X1, p, r0, c0, Kp, lane);
    warp_tile<PASSES>(a2, Y2, X2, p, r0, c0, Kp, lane);
    out(p, r0, c0, a1, a2, lane);
  }
}

}  // namespace afldm_filtered
