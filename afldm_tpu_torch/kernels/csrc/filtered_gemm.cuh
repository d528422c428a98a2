// The batched, shared-memory-tiled f32 GEMM of the banded filtered
// activation and its backward (filtered_act.cu, K1 and K2):
//
//   C[b] = epi(A[b] · B[b])          for b < batch
//
// or, for an epilogue that declares kReadsC, C[b] = epi(A[b] · B[b], C[b])
// elementwise from C's old values (K2's act′(pre) ⊙ product, in place over
// the pre-activation).
//
// A is M×K, B K×N and C M×N, f32, with a row stride and a batch stride each
// (batch stride 0: one operand shared by every b). A arrives row-major, or
// k-major (stored K×M, its row stride the step between k rows) where it is a
// shared operator the host keeps transposed. M, N and K are multiples of 4;
// the edges need not be multiples of the block tile: loads past an edge
// fill zeros and stores past it are dropped.
//
// The classic design for this card's shared memory and registers. A block
// of 256 threads owns one BM×BN tile of C (128×128, or 64×64 for a launch
// that would fall short of a wave; the wrapper's plan chooses) over the
// full depth K, so no two blocks write one element and nothing is reduced
// across blocks; within the block one thread owns each element of C, which
// is what makes an epilogue that reads C and writes it back race-free. K is walked in slabs of 16: A's slab is stored k-major and
// B's row-major in shared memory, double-buffered, with the next slab's
// copy in flight during the current slab's products. B and a k-major A go
// through 16-byte cp.async; cp.async cannot transpose, so a row-major A is
// read into registers as float4 along k before the products and stored
// k-major after them. Each thread keeps a TM×TN register micro-tile (8×8,
// or 4×4 in the 64×64 tile) of rows {64·g + 4·ty + i} and columns
// {64·g + 4·tx + j}: at each k it reads TM/4 float4 of A and TN/4 of B for
// TM·TN FMAs (16 FMAs per float4 read at 8×8). A warp spans 4 ty × 8 tx, so
// a float4 phase of 8 lanes reads one 128-byte run of a B row and one
// same-address chunk of A.
//
// The arithmetic is exact f32 FMA, k ascending; no TF32, no tensor cores.
//
// Its bf16 tensor-core variant (filtered_gemm_mma_kernel, the reduced
// precision levels of the banded chains) keeps the block tiles, the grid
// and the epilogues, and runs the products on filtered_mma.cuh's
// fragments: each f32 operand is split into bf16 hi and lo pieces as it
// is stored into shared memory (A k-major where it arrives k-major, else
// row-major; B row-major), and each of the 8 warps (2 along M × 4 along N)
// owns a (BM/2) × (BN/4) piece of C in m16n8 accumulators, 1 or 3 passes
// at each 16-deep step. The slab is 16 deep, double-buffered through
// registers: the next slab's float4 loads are issued before the current
// slab's products and split into the other buffer after them.
//
// A bf16 x (the forward's bfloat16 activations) enters as one operand of
// the chain's first GEMM and its out leaves as the last GEMM's C: an
// operand read through registers (the f32 GEMM's row-major A, either of
// the bf16 variant's A and B) may be bf16, widened by load4; C may be bf16,
// each element rounded once in the epilogue (store4, store2). The scratch
// intermediates stay f32.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "filtered_mma.cuh"
#include "filtered_tile.cuh"

namespace afldm_filtered {

// 16-byte cp.async that fills zeros in place of reading where !valid (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

template <class TA = float, class TB = float, class TC = float>
struct GemmArgsT {
  const TA* A;
  long long lda, sA;
  const TB* B;
  long long ldb, sB;
  TC* C;
  long long ldc, sC;
  int M, N, K;
};
using GemmArgs = GemmArgsT<>;

constexpr int kGemmThreads = 256;
constexpr int kGemmBK = 16;

template <int BM, int BN, bool A_KMAJOR, class Epi, class TA, class TC>
__global__ void __launch_bounds__(kGemmThreads, 2)
filtered_gemm_kernel(GemmArgsT<TA, float, TC> g, Epi epi) {
  constexpr int BK = kGemmBK, T = kGemmThreads;
  constexpr int TM = BM / 16, TN = BN / 16;  // 16×16 threads
  constexpr int A_LOADS = BM * BK / 4 / T, B_LOADS = BN * BK / 4 / T;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 micro-tiles");
  static_assert(A_LOADS >= 1 && B_LOADS >= 1, "one float4 a thread");
  // cp.async copies a k-major A as it is: only a row-major A may be bf16
  static_assert(!A_KMAJOR || std::is_same<TA, float>::value, "A type");
  static_assert(!Epi::kReadsC || std::is_same<TC, float>::value, "C type");
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7);    // along N
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // along M
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long b = blockIdx.z;
  const TA* A = g.A + b * g.sA;
  const float* B = g.B + b * g.sB;
  TC* C = g.C + b * g.sC;
  const int M = g.M, N = g.N, K = g.K;

  // B's slab: BK rows of BN columns, 16-byte chunks along N
  auto load_b = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * T, kk = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < K && n < N;
      cp_async16_zfill(&Bs[buf][kk][c], ok ? B + k * g.ldb + n : B, ok);
    }
  };
  // a k-major A's slab: the same along M
  auto load_a_kmajor = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * T, kk = idx / (BM / 4), c = 4 * (idx % (BM / 4));
      const int k = k0 + kk, m = m0 + c;
      const bool ok = k < K && m < M;
      if constexpr (A_KMAJOR)
        cp_async16_zfill(&As[buf][kk][c], ok ? A + k * g.lda + m : A, ok);
    }
  };
  // a row-major A's slab, into registers: lane-consecutive rows, a float4
  // along k each, so that the k-major store below is conflict-free
  float4 a_reg[A_LOADS];
  auto fetch_a_rows = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * T, r = idx % BM, k = k0 + 4 * (idx / BM);
      const int m = m0 + r;
      a_reg[i] = m < M && k < K ? load4(A + m * g.lda + k)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store_a_rows = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * T, r = idx % BM, kk = 4 * (idx / BM);
      As[buf][kk][r] = a_reg[i].x;
      As[buf][kk + 1][r] = a_reg[i].y;
      As[buf][kk + 2][r] = a_reg[i].z;
      As[buf][kk + 3][r] = a_reg[i].w;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (A_KMAJOR) {
    load_a_kmajor(0, 0);
  } else {
    fetch_a_rows(0);
    store_a_rows(0);
  }
  load_b(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // the next slab in flight into the other buffer
      if (A_KMAJOR)
        load_a_kmajor(cur ^ 1, (kt + 1) * BK);
      else
        fetch_a_rows((kt + 1) * BK);
      load_b(cur ^ 1, (kt + 1) * BK);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][kk][64 * q + 4 * ty]);
        av[4 * q] = v.x;
        av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z;
        av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[cur][kk][64 * q + 4 * tx]);
        bv[4 * q] = v.x;
        bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z;
        bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      if (!A_KMAJOR) store_a_rows(cur ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int n = n0 + 64 * q + 4 * tx;
      if (n >= N) continue;  // N % 4 == 0: a chunk is all in or all out
      TC* c = C + (long long)m * g.ldc + n;
      if constexpr (Epi::kReadsC) {
        // this thread alone owns these four elements over the full depth:
        // no other thread reads or writes them during the launch
        float4* c4 = reinterpret_cast<float4*>(c);
        const float4 old = *c4;
        *c4 = make_float4(epi(acc[i][4 * q], old.x),
                          epi(acc[i][4 * q + 1], old.y),
                          epi(acc[i][4 * q + 2], old.z),
                          epi(acc[i][4 * q + 3], old.w));
      } else if constexpr (std::is_same<TC, float>::value) {
        *reinterpret_cast<float4*>(c) =
            make_float4(epi(acc[i][4 * q]), epi(acc[i][4 * q + 1]),
                        epi(acc[i][4 * q + 2]), epi(acc[i][4 * q + 3]));
      } else {
        store4(c, epi(acc[i][4 * q]), epi(acc[i][4 * q + 1]),
               epi(acc[i][4 * q + 2]), epi(acc[i][4 * q + 3]));
      }
    }
  }
}

// Launches C[b] = epi(A[b] · B[b]) (epi(A[b] · B[b], C[b]) where
// Epi::kReadsC) for b < batch on ``stream``, in 64×64 block tiles where
// ``small``, else 128×128. Returns the launch's CUDA error.
template <bool A_KMAJOR, class Epi, class TA, class TC>
int filtered_gemm(bool small, const GemmArgsT<TA, float, TC>& g, int batch,
                  Epi epi, cudaStream_t stream) {
  if (g.M % 4 || g.N % 4 || g.K % 4 || g.lda % 4 || g.ldb % 4 || g.ldc % 4 ||
      g.sA % 4 || g.sB % 4 || g.sC % 4 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int bm = small ? 64 : 128;
  const dim3 grid((g.N + bm - 1) / bm, (g.M + bm - 1) / bm, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (small)
    filtered_gemm_kernel<64, 64, A_KMAJOR, Epi, TA, TC>
        <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  else
    filtered_gemm_kernel<128, 128, A_KMAJOR, Epi, TA, TC>
        <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  return (int)cudaGetLastError();
}

// C[b] = epi(A[b] · B[b]) (epi(·, C[b]) where Epi::kReadsC) with each
// product a·b run as ah·bh + ah·bl + al·bh (PASSES 3) or ah·bh (PASSES 1)
// on bf16 tensor cores: the GEMM above at a reduced precision level.
template <int BM, int BN, bool A_KMAJOR, int PASSES, class Epi, class TA,
          class TB, class TC>
__global__ void __launch_bounds__(kGemmThreads)
filtered_gemm_mma_kernel(GemmArgsT<TA, TB, TC> g, Epi epi) {
  constexpr int BK = kGemmBK, T = kGemmThreads;
  constexpr int WM = BM / 2, WN = BN / 4;  // 2 × 4 warps
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int A_LOADS = BM * BK / 4 / T, B_LOADS = BN * BK / 4 / T;
  // A k-major: BK rows of BM; row-major: BM rows of BK. B: BK rows of BN.
  constexpr int LDA = A_KMAJOR ? BM + 8 : BK + 8;
  constexpr int A_PIECE = (A_KMAJOR ? BK : BM) * LDA, LDB = BN + 8;
  constexpr int B_PIECE = BK * LDB;
  static_assert(NT % 2 == 0 && A_LOADS >= 1 && B_LOADS >= 1, "tiles");
  static_assert(!Epi::kReadsC || std::is_same<TC, float>::value, "C type");
  __shared__ __align__(16) __nv_bfloat16 As[2][2 * A_PIECE];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][2 * B_PIECE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long b = blockIdx.z;
  const TA* A = g.A + b * g.sA;
  const TB* B = g.B + b * g.sB;
  TC* C = g.C + b * g.sC;
  const int M = g.M, N = g.N, K = g.K;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float4 ra[A_LOADS], rb[B_LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * T;
      if (A_KMAJOR) {
        const int k = k0 + idx / (BM / 4), m = m0 + 4 * (idx % (BM / 4));
        ra[i] = k < K && m < M ? load4(A + k * g.lda + m) : zero;
      } else {
        const int m = m0 + idx / (BK / 4), k = k0 + 4 * (idx % (BK / 4));
        ra[i] = m < M && k < K ? load4(A + m * g.lda + k) : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * T;
      const int k = k0 + idx / (BN / 4), n = n0 + 4 * (idx % (BN / 4));
      rb[i] = k < K && n < N ? load4(B + k * g.ldb + n) : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * T;
      const int off = A_KMAJOR
                          ? (idx / (BM / 4)) * LDA + 4 * (idx % (BM / 4))
                          : (idx / (BK / 4)) * LDA + 4 * (idx % (BK / 4));
      store_split4(&As[buf][off], &As[buf][A_PIECE + off], ra[i]);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * T;
      const int off = (idx / (BN / 4)) * LDB + 4 * (idx % (BN / 4));
      store_split4(&Bs[buf][off], &Bs[buf][B_PIECE + off], rb[i]);
    }
  };
  // the fragments of one piece of A (MT m16 tiles) and of B (NT n8 tiles)
  auto frag_a = [&](unsigned (&a)[MT][4], const __nv_bfloat16* As_) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (A_KMAJOR)
        ldsm_x4_t(a[mt], As_ + ((lane & 7) + 8 * (lane >> 4)) * LDA + wm +
                             16 * mt + 8 * ((lane >> 3) & 1));
      else
        ldsm_x4(a[mt], As_ + (wm + 16 * mt + (lane & 15)) * LDA +
                           8 * (lane >> 4));
    }
  };
  auto frag_b = [&](unsigned (&bf)[NT / 2][4], const __nv_bfloat16* Bs_) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldsm_x4_t(bf[np], Bs_ + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                            wn + 16 * np + 8 * (lane >> 4));
  };
  // ah·bh in acc, each 16-deep step from zero added in f32 (by TwoSum at 3
  // passes); the small passes and those additions' errors in an
  // accumulator of their own (filtered_mma.cuh::strip_step)
  float acc[MT][NT][4], small[PASSES == 3 ? MT : 1][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.0f;
        if (PASSES == 3) small[i][j][e] = 0.0f;
      }
  auto mma_step = [&](const unsigned (&a)[MT][4],
                      const unsigned (&bf)[NT / 2][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(step, a[i], bf[j / 2][2 * (j % 2)],
                 bf[j / 2][2 * (j % 2) + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (PASSES == 3)
            add_two_sum(acc[i][j][e], step[e], small[i][j][e]);
          else
            acc[i][j][e] += step[e];
        }
      }
  };
  auto mma_small = [&](const unsigned (&a)[MT][4],
                       const unsigned (&bf)[NT / 2][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16(small[PASSES == 3 ? i : 0][j], a[i],
                 bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
  };

  fetch(0);
  store(0);
  __syncthreads();
  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch((kt + 1) * BK);
    {
      unsigned ah[MT][4], bh[NT / 2][4];
      frag_a(ah, As[cur]);
      frag_b(bh, Bs[cur]);
      mma_step(ah, bh);
      if constexpr (PASSES == 3) {
        unsigned bl[NT / 2][4];
        frag_b(bl, Bs[cur] + B_PIECE);
        mma_small(ah, bl);
        unsigned al[MT][4];
        frag_a(al, As[cur] + A_PIECE);
        mma_small(al, bh);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

  const int gr = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + gr + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn + 8 * j + t2;
        if (n >= N) continue;  // N % 4 == 0, n even: a pair is all in or out
        TC* c = C + (long long)m * g.ldc + n;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (PASSES == 3) {
          v0 += small[i][j][2 * h];
          v1 += small[i][j][2 * h + 1];
        }
        if constexpr (Epi::kReadsC) {
          // this thread alone owns these two elements over the full depth
          float2* c2 = reinterpret_cast<float2*>(c);
          const float2 old = *c2;
          *c2 = make_float2(epi(v0, old.x), epi(v1, old.y));
        } else if constexpr (std::is_same<TC, float>::value) {
          *reinterpret_cast<float2*>(c) = make_float2(epi(v0), epi(v1));
        } else {
          store2(c, epi(v0), epi(v1));
        }
      }
    }
}

// Launches the bf16 variant of filtered_gemm at ``passes`` (1 or 3), in
// 64×64 block tiles where ``small``, else 128×128.
template <bool A_KMAJOR, class Epi, class TA, class TB, class TC>
int filtered_gemm_mma(bool small, int passes, const GemmArgsT<TA, TB, TC>& g,
                      int batch, Epi epi, cudaStream_t stream) {
  if (g.M % 4 || g.N % 4 || g.K % 4 || g.lda % 4 || g.ldb % 4 || g.ldc % 4 ||
      g.sA % 4 || g.sB % 4 || g.sC % 4 || batch < 1 || batch > 65535 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const int bm = small ? 64 : 128;
  const dim3 grid((g.N + bm - 1) / bm, (g.M + bm - 1) / bm, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (small && passes == 1)
    filtered_gemm_mma_kernel<64, 64, A_KMAJOR, 1, Epi, TA, TB, TC>
        <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  else if (small)
    filtered_gemm_mma_kernel<64, 64, A_KMAJOR, 3, Epi, TA, TB, TC>
        <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  else if (passes == 1)
    filtered_gemm_mma_kernel<128, 128, A_KMAJOR, 1, Epi, TA, TB, TC>
        <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  else
    filtered_gemm_mma_kernel<128, 128, A_KMAJOR, 3, Epi, TA, TB, TC>
        <<<grid, kGemmThreads, 0, stream>>>(g, epi);
  return (int)cudaGetLastError();
}

}  // namespace afldm_filtered
