// The register-tiled f32 product of the filtered activation's plane kernels
// (filtered_act.cu: K5 and its VJP K5b) and the 16-byte staging that feeds
// it.
//
// One routine serves every product of a plane (K5's four, K5b's six):
// every operand is stored k-major in shared memory (row k holds the k-th
// term of every output row or column), and
//
//   C[r][c] = epi( Σ_k Y[k][r] · X[k][c] )          C = Yᵀ · X
//
// so each step k reads a contiguous piece of row k of X and of Y. Thread
// (tr, tc) owns the TR × TC micro-tile of rows {4(tr + NR·a) + i} and
// columns {4(tc + NC·j) + i} (NR = R / TR, NC = C / TC threads along each
// side): at each k it reads TC/4 float4 of X and TR/4 float4 of Y and does
// TR·TC FMAs. Consecutive threads take consecutive tc, so the 8 lanes of a
// float4 phase read 8 different 16-byte chunks of one X row (128 bytes,
// conflict-free), read one chunk of Y (a same-address read, which costs
// the shared-memory pipe far less) and store 8 chunks of one C row. Only
// where NC < 8 does a phase reach several C rows, 4 rows apart; a row
// stride of 4 mod 8 floats puts two such rows on different bank halves
// (row_pad). An epilogue that reads C (Epi::kReadsC: K5b's act′(pre) ⊙
// product, written over the pre-activation) reads each float4 of C just
// before its owning thread writes it.
//
// The micro-tile is 8×4 or 4×4, picked per product by the wrapper's launch
// plans (ops/filtered_act.py::plane_plan, plane_bwd_plan). 8×4 reads two
// same-address Y chunks to one X chunk for 32 FMAs; on an H100 it was
// quicker than 8×8 (2 + 2 chunks for 64 FMAs, 64 accumulators) at K5's
// 64 px hiᵀ product and matched or beat 4×8 (2 X chunks to 1 Y)
// elsewhere. 4×4 is quicker where a product is too small to give every
// thread a larger tile, and serves results with 4 mod 8 rows (tᵀ of a
// 12×20 plane).
//
// The block walks P planes' tiles (plane strides sX, sY, sC; 0 for an
// operand shared by the planes); a thread takes tiles t, t + blockDim.x, …
//
// The arithmetic is exact f32 FMA, k ascending; no TF32, no tensor cores.
// The result C may be bf16 (the last product of a bf16 x's forward, its
// epilogue rounding each f32 sum once, to nearest even); the operands are
// f32 in shared memory whatever x's type (load4 widens a bf16 x as it is
// staged).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace afldm_filtered {

// Four consecutive elements of f32 or bf16 as a float4 (16- or 8-byte
// aligned); four bf16 (8-byte aligned) stored from four floats, rounded to
// nearest even. f32 results are stored in place, as float4 or float2.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// Two consecutive bf16 (4-byte aligned) from two floats.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A row of n floats padded to a stride of 4 mod 8 floats (16-byte aligned).
__host__ __device__ __forceinline__ int row_pad(int n) {
  return n % 8 == 0 ? n + 4 : n;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copy of n4 contiguous 16-byte chunks src → dst (both 16-byte
// aligned); the caller commits the group.
__device__ __forceinline__ void stage(float* dst, const float* src, int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
}

// C[p] = epi(Y[p]ᵀ · X[p]) for p < P: X[p] is K × C (row stride ldx), Y[p]
// K × R (ldy), C[p] R × C (ldc); all strides and bases multiples of 4
// elements. R % TR == 0 and C % TC == 0 (the caller checks). Where
// Epi::kReadsC, C[p] = epi(Y[p]ᵀ · X[p], C[p]) over C's old values (f32
// only); C must then not alias X or Y.
template <int TR, int TC, class Epi, class TOut>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ X, int ldx, int sX,
    const float* __restrict__ Y, int ldy, int sY,
    TOut* __restrict__ C, int ldc, long long sC,
    int P, int R, int Cn, int K, Epi epi) {
  static_assert(TR % 4 == 0 && TC % 4 == 0, "float4 micro-tiles");
  static_assert(!Epi::kReadsC || std::is_same<TOut, float>::value,
                "an epilogue that reads C takes an f32 C");
  const int nc = Cn / TC, nr = R / TR;
  const int tiles = nc * nr;
  for (int t = threadIdx.x; t < P * tiles; t += blockDim.x) {
    const int p = t / tiles;
    const int q = t - p * tiles;
    const int tr = q / nc, tc = q - tr * nc;
    const float* xp = X + p * sX + 4 * tc;
    const float* yp = Y + p * sY + 4 * tr;
    float acc[TR][TC];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < TC; ++b) acc[a][b] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 4) {  // K % 4 == 0
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* xr = xp + (k0 + kk) * ldx;
        const float* yr = yp + (k0 + kk) * ldy;
        float xv[TC], yv[TR];
#pragma unroll
        for (int j = 0; j < TC / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(xr + 4 * nc * j);
          xv[4 * j] = v.x;
          xv[4 * j + 1] = v.y;
          xv[4 * j + 2] = v.z;
          xv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TR / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(yr + 4 * nr * j);
          yv[4 * j] = v.x;
          yv[4 * j + 1] = v.y;
          yv[4 * j + 2] = v.z;
          yv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int b = 0; b < TC; ++b)
            acc[a][b] = fmaf(yv[a], xv[b], acc[a][b]);
      }
    }
    TOut* cp = C + p * sC;
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int row = 4 * (tr + nr * (a / 4)) + a % 4;
#pragma unroll
      for (int j = 0; j < TC / 4; ++j) {
        const int col = 4 * (tc + nc * j);
        if constexpr (Epi::kReadsC) {
          // this thread alone owns these four elements over the full
          // depth: no other thread reads or writes them during the product
          float4* c = reinterpret_cast<float4*>(cp + (long long)row * ldc +
                                                col);
          const float4 old = *c;
          *c = make_float4(epi(acc[a][4 * j], old.x),
                           epi(acc[a][4 * j + 1], old.y),
                           epi(acc[a][4 * j + 2], old.z),
                           epi(acc[a][4 * j + 3], old.w));
        } else if constexpr (std::is_same<TOut, float>::value) {
          // the f32 store written out: through store4 the compiler lost C's
          // __restrict__ and K5 ran 2 % slower on an H100 (kernel_check.py)
          *reinterpret_cast<float4*>(cp + (long long)row * ldc + col) =
              make_float4(epi(acc[a][4 * j]), epi(acc[a][4 * j + 1]),
                          epi(acc[a][4 * j + 2]), epi(acc[a][4 * j + 3]));
        } else {
          store4(cp + (long long)row * ldc + col, epi(acc[a][4 * j]),
                 epi(acc[a][4 * j + 1]), epi(acc[a][4 * j + 2]),
                 epi(acc[a][4 * j + 3]));
        }
      }
    }
  }
}

// tile_product with the 8×4 micro-tile, or 4×4 where ``small``; an 8×4
// tile needs R % 8 == 0.
template <class Epi, class TOut>
__device__ __forceinline__ void product(
    bool small, const float* X, int ldx, int sX, const float* Y, int ldy,
    int sY, TOut* C, int ldc, long long sC, int P, int R, int Cn, int K,
    Epi epi) {
  if (small)
    tile_product<4, 4>(X, ldx, sX, Y, ldy, sY, C, ldc, sC, P, R, Cn, K, epi);
  else
    tile_product<8, 4>(X, ldx, sX, Y, ldy, sY, C, ldc, sC, P, R, Cn, K, epi);
}

}  // namespace afldm_filtered
