// K5's and K5b's reduced precision levels ("high": 3 bf16 passes a
// product, "default": 1) for Hopper: the filtered activation of whole
// planes up to 64 px a side,
//
//   out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ      for every (n, c) plane
//
// in _forward's order, and its VJP for the cotangent g,
//
//   dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w
//
// in _bwd_rule's order (pre and the cotangent H side first, dx W side
// first), which at these levels decides which intermediates are split.
//
// Replaces the reduced levels of afldm_tpu/ops/pallas_kernels.py::_forward
// (K5) and of the kernel inside pallas_kernels.py::_bwd_rule (K5b): their
// _precise_dot products run as 3 or 1 bf16 tensor-core passes
// (filtered_mma.cuh), each f32 result split again before the product that
// reads it. The f32 kernels ('highest') are filtered_act.cu's.
//
// Both are persistent walks: a grid of at most (blocks an SM holds) × 132
// blocks, each walking groups of P planes (blockIdx.x, + gridDim.x, ...),
// the next group's raw planes in flight by 16-byte cp.async while the
// current group's products run, then split from shared memory into bf16
// pieces (filtered_mma.cuh::split_planes). The operators arrive as split
// blobs built once on the host (ops/filtered_act.py::_mma_blobs).
//   * K5 (filtered_act_plane_mma_kernel): the four operators' pieces
//     staged once for the whole walk; t = U_h·x by strips, the middle pair
//     hi = act(t·U_wᵀ), t₂ = hi·D_wᵀ fused per 16-row strip with hi in
//     registers (middle_pair), out = D_h·t₂ to device memory.
//   * K5b (filtered_act_plane_bwd_mma_kernel): six products, 18·S³
//     multiply-adds a plane of side S against 12·S³ for K5:
//       t  = U_h · x,  v = D_hᵀ · g             (2H × W)  depth H
//       pre = t · U_wᵀ, ds = v · D_w           (2H × 2W) depth W
//       s  = (act′(pre) ⊙ ds) · U_w             (2H × W)  depth 2W
//       dx = U_hᵀ · s                           (H × W)   depth 2H
//     t and v by strips into shared memory as split pieces; the backward
//     middle pair (middle_pair_bwd) takes pre and ds 16 columns at a time,
//     m = act′(pre) ⊙ ds in registers as the A fragment of s's next step,
//     so neither pre nor m (2H × 2W) takes shared memory, and s is written
//     over t; dx by strips to device memory. Where the six operators'
//     pieces fit beside the planes (every size at 'default', up to 48 px
//     at 'high') they are staged once for the walk ("resident"); where
//     they do not (64 px at 'high': 213 KB of operators), one operator
//     region holds in turn U_hᵀ and D_h, then U_wᵀ, D_w and U_w, then U_h
//     with the next group's raw x and g in flight beside it ("phased"):
//     the f32 K5b's staging, a phase's operators read from L2 before its
//     products.
//
// Every element's sums are those of a 16×16 tile walk over the same
// operands (filtered_mma.cuh: 16-deep steps ascending, the small passes
// swapped where a product's A and B swap against that walk), which is the
// order of the plane kernels' first bf16 form: K5's and K5b's outputs are
// that form's, bit for bit.
//
// What bounds them (PERF.md §6): at 'high' the TwoSum after every 16-deep
// step (~7 FP32 instructions an element a step against 3 mma) issued by
// one block an SM; at 'default' the shared-memory fragments (ldmatrix)
// and the epilogues (act, act′: an expf and a division an element). At 'default'
// two blocks an SM where shared memory holds them. Neither wgmma nor TMA
// (later work).
//
// bfloat16 activations (the ``_xbf16`` entries): x (and g) copied raw and
// widened as they are split (their lo pieces zero), the last product
// rounded once to bf16: out = bf16(f(f32(x))), as the TPU kernels do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "filtered_epi.cuh"
#include "filtered_mma.cuh"
#include "filtered_tile.cuh"

namespace {

using afldm_filtered::Activation;
using afldm_filtered::MulActGrad;

// Shared memory of a K5 bf16 block, in bf16 elements: the pieces of the
// four operators, resident for the block's whole walk; then for each of
// the P planes of an iteration x's pieces and t's (t₂ written over t), and
// the next iteration's P planes of x as they arrive (T, ``x_bytes`` an
// element). Each operand holds hi and lo pieces at 3 passes, hi alone at
// 1. No 2W × 2H buffer: hi lives in registers (middle_pair).
struct MmaPlaneLayout {
  int uh, uw, dw, dh, x, t, raw;
  __host__ __device__ MmaPlaneLayout(int H, int W, int passes, int x_bytes) {
    using afldm_filtered::mma_piece;
    const int pieces = passes == 3 ? 2 : 1;
    uh = pieces * mma_piece(H, 2 * H);
    uw = pieces * mma_piece(W, 2 * W);
    dw = pieces * mma_piece(2 * W, W);
    dh = pieces * mma_piece(2 * H, H);
    x = pieces * mma_piece(H, W);
    t = pieces * mma_piece(2 * H, W);
    raw = H * W * x_bytes / 2;
  }
  __host__ __device__ size_t bytes(int planes) const {
    return 2 * ((size_t)uh + uw + dw + dh + (size_t)planes * (x + t + raw));
  }
};

// cp.async of an operator's split blob (n bf16, a multiple of 8)
__device__ __forceinline__ void stage_blob(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int n) {
  afldm_filtered::stage(reinterpret_cast<float*>(dst),
                        reinterpret_cast<const float*>(src), n / 8);
}

// A product's result to device memory: rows < R and columns < C of P
// row-major R × C planes ``ps`` elements apart, f32 or bf16 (rounded to
// nearest even).
template <class T>
struct ToPlanes {
  T* out;
  int R, C;
  long long ps;
  __device__ __forceinline__ void operator()(int p, int r0, int c0,
                                             const float (&acc)[2][4],
                                             int lane) const {
    afldm_filtered::for_pairs(
        r0, c0, acc, lane, [&](int r, int c, float v0, float v1) {
          if (r >= R || c >= C) return;
          if constexpr (std::is_same<T, float>::value)
            *reinterpret_cast<float2*>(out + p * ps + (long long)r * C + c) =
                make_float2(v0, v1);
          else
            afldm_filtered::store2(out + p * ps + (long long)r * C + c, v0,
                                   v1);
        });
  }
};

// The planes [p0, p0 + P) of x (T) in flight to ``raw`` by 16-byte
// cp.async (a bf16 plane copied as it is, widened when it is split); the
// caller commits the group.
template <class T>
__device__ __forceinline__ void stage_planes(T* raw, const T* x,
                                             long long p0, int P,
                                             long long HW) {
  afldm_filtered::stage(reinterpret_cast<float*>(raw),
                        reinterpret_cast<const float*>(x + p0 * HW),
                        (int)(P * HW * (long long)sizeof(T) / 16));
}

// out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ at PASSES bf16 passes a product, a
// persistent block walking groups of ``ppi`` planes
// (blockIdx.x, + gridDim.x, ...), in _forward's order:
//   t   = U_h · x            (2H × W)   strip_product
//   hi  = act(t · U_wᵀ)      (2H × 2W)  middle_pair, in registers
//   t₂  = hi · D_wᵀ          (2H × W)   middle_pair, over t
//   out = D_h · t₂           (H × W)    strip_product, to device memory
// NW = pad16(W) / 16. The operators' pieces are staged once and stay; the
// next group's x arrives by cp.async while the current group's products
// run. Operators: the split blobs of U_hᵀ (H×2H), U_wᵀ (W×2W), D_wᵀ
// (2W×W), D_hᵀ (2H×H), each (hi, lo) × pad16(rows) × mma_ld(cols), of
// which 1 pass stages the hi half. 1 pass runs two blocks of 256 threads
// an SM (registers held to 128 a thread). 3 passes run one block an SM,
// as many threads as the strips' registers allow (ptxas: no spill): 256
// where W > 32 (up to 255 registers a thread; at 64 px the block also
// fills shared memory), 384 where W > 16 (168), else 512 (128).
constexpr int mma_plane_threads(int passes, int nw) {
  return passes == 1 || nw > 2 ? 256 : nw == 2 ? 384 : 512;
}
template <int PASSES, int NW, class T>
__global__ void __launch_bounds__(mma_plane_threads(PASSES, NW),
                                  PASSES == 1 ? 2 : 1)
filtered_act_plane_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                              const __nv_bfloat16* __restrict__ uhT,
                              const __nv_bfloat16* __restrict__ uwT,
                              const __nv_bfloat16* __restrict__ dwT,
                              const __nv_bfloat16* __restrict__ dhT,
                              int nplanes, int H, int W, int ppi, int act) {
  using namespace afldm_filtered;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const long long HW = (long long)H * W;
  const long long groups = (nplanes + ppi - 1) / ppi;
  const MmaPlaneLayout lay(H, W, PASSES, sizeof(T));
  __nv_bfloat16* uh = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* uw = uh + lay.uh;
  __nv_bfloat16* dw = uw + lay.uw;
  __nv_bfloat16* dh = dw + lay.dw;
  __nv_bfloat16* xs = dh + lay.dh;   // ppi × x's pieces
  __nv_bfloat16* ts = xs + ppi * lay.x;  // ppi × t's, then t₂'s
  T* raw = reinterpret_cast<T*>(ts + ppi * lay.t);  // ppi × x, arriving
  const Piece xp = piece(xs, H, W, lay.x), tp = piece(ts, 2 * H, W, lay.t);
  stage_blob(uh, uhT, lay.uh);
  stage_blob(uw, uwT, lay.uw);
  stage_blob(dw, dwT, lay.dw);
  stage_blob(dh, dhT, lay.dh);
  long long g = blockIdx.x;
  if (g < groups)
    stage_planes(raw, x, g * ppi, (int)min((long long)ppi, nplanes - g * ppi),
                 HW);
  cp_async_commit();
  for (; g < groups; g += gridDim.x) {
    const long long p0 = g * ppi;
    const int P = (int)min((long long)ppi, nplanes - p0);
    cp_async_wait<0>();
    __syncthreads();  // x arrived; the last group's products are done
    split_planes<PASSES>(raw, P, H, W, xp);
    __syncthreads();
    const long long next = g + gridDim.x;
    if (next < groups)  // in flight during this group's products
      stage_planes(raw, x, next * ppi,
                   (int)min((long long)ppi, nplanes - next * ppi), HW);
    cp_async_commit();
    // t = U_h · x                             (2H × W)
    strip_product<PASSES, true, NW>(
        piece(uh, H, 2 * H, 0), xp, P, pad16(2 * H), pad16(H),
        [&](int p, int r0, int c0, const auto& acc, int lane) {
          store_strip<PASSES>(tp, p, r0, c0, acc, lane);
        });
    __syncthreads();
    // t₂ = act(t · U_wᵀ) · D_wᵀ              (2H × W); over t
    // t's fragments held across the chunks but where the 16 registers
    // they take spill (ptxas): 1 pass 64 px wide, 3 passes 32 px wide
    middle_pair<PASSES, NW, PASSES == 3 ? NW != 2 : NW != 4>(
        piece(uw, W, 2 * W, 0), piece(dw, 2 * W, W, 0), tp, P, pad16(2 * H),
        pad16(2 * W), Activation{act});
    __syncthreads();
    // out = D_h · t₂                          (H × W), to device memory
    T* o = out + p0 * HW;
    strip_product<PASSES, false, NW>(
        piece(dh, 2 * H, H, 0), tp, P, pad16(H), pad16(2 * H),
        [&](int p, int r0, int c0, const auto& acc, int lane) {
          constexpr int NB = sizeof(acc) / sizeof(acc[0]);
#pragma unroll
          for (int n = 0; n < NB; ++n)
            ToPlanes<T>{o, H, W, HW}(p, r0, c0 + 16 * n, acc[n], lane);
        });
  }
}

// Shared memory of a K5b bf16 block, in bf16 elements, at ``passes``
// passes (hi and lo pieces of every operand at 3, hi alone at 1) for x and
// g of ``x_bytes`` an element. Per plane of an iteration: x's and g's
// pieces, t's (s written over t) and v's. Resident: the six operators'
// pieces staged once for the walk, and the next iteration's raw x and g
// after the planes. Phased: one operator region at the start, holding in
// turn U_hᵀ and D_h, then U_wᵀ, D_w and U_w, then U_h with the next
// iteration's raw x and g after it. No 2W × 2H buffer: pre and m live in
// registers (middle_pair_bwd).
struct MmaPlaneBwdLayout {
  int uhT, dh, uwT, dw, uw, uh, x, t, raw;
  __host__ __device__ MmaPlaneBwdLayout(int H, int W, int passes,
                                        int x_bytes) {
    using afldm_filtered::mma_piece;
    const int pieces = passes == 3 ? 2 : 1;
    uhT = dh = pieces * mma_piece(H, 2 * H);
    uwT = dw = pieces * mma_piece(W, 2 * W);
    uw = pieces * mma_piece(2 * W, W);
    uh = pieces * mma_piece(2 * H, H);
    x = pieces * mma_piece(H, W);
    t = pieces * mma_piece(2 * H, W);
    raw = H * W * x_bytes;  // x and g
  }
  __host__ __device__ static int imax(int a, int b) { return a > b ? a : b; }
  // the operators' elements: all six (resident), or the region (phased)
  __host__ __device__ int ops(int planes, bool resident) const {
    return resident ? uhT + dh + uwT + dw + uw + uh
                    : imax(imax(uhT + dh, uwT + dw + uw), uh + planes * raw);
  }
  __host__ __device__ size_t bytes(int planes, bool resident) const {
    return 2 * ((size_t)ops(planes, resident) +
                (size_t)planes * (2 * x + 2 * t + (resident ? raw : 0)));
  }
};

// Where K5b's middle pair holds t's and v's fragments across its chunks
// (ptxas: no spill): the strips of at most 32 px (NW <= 2).
__host__ __device__ constexpr bool mma_plane_bwd_hold(int nw) {
  return nw <= 2;
}

// dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w at PASSES
// bf16 passes a product, a persistent block walking groups of ``ppi``
// planes (blockIdx.x, + gridDim.x, ...), in _bwd_rule's order:
//   t  = U_h · x, v = D_hᵀ · g        (2H × W)  strip_product
//   m  = act′(t · U_wᵀ) ⊙ (v · D_w)   (2H × 2W) middle_pair_bwd, in registers
//   s  = m · U_w                      (2H × W)  middle_pair_bwd, over t
//   dx = U_hᵀ · s                     (H × W)   strip_product, to device
// NW = pad16(W) / 16, the threads K5's (mma_plane_threads). ``resident``
// (MmaPlaneBwdLayout): the operators staged once and the next group's x
// and g in flight during all of a group's products; else the operators
// staged before each phase and the next group's x and g in flight during
// dx's product. Operators: the split blobs of U_hᵀ (H×2H), D_h (H×2H),
// U_wᵀ (W×2W), D_w (W×2W), U_w (2W×W), U_h (2H×H), each (hi, lo) ×
// pad16(rows) × mma_ld(cols), of which 1 pass stages the hi half.
template <int PASSES, int NW, class T>
__global__ void __launch_bounds__(mma_plane_threads(PASSES, NW),
                                  PASSES == 1 ? 2 : 1)
filtered_act_plane_bwd_mma_kernel(const T* __restrict__ x,
                                  const T* __restrict__ g,
                                  T* __restrict__ dx,
                                  const __nv_bfloat16* __restrict__ uhT,
                                  const __nv_bfloat16* __restrict__ dh,
                                  const __nv_bfloat16* __restrict__ uwT,
                                  const __nv_bfloat16* __restrict__ dw,
                                  const __nv_bfloat16* __restrict__ uw,
                                  const __nv_bfloat16* __restrict__ uh,
                                  int nplanes, int H, int W, int ppi,
                                  int resident, int act) {
  using namespace afldm_filtered;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  // 32-bit counts (nplanes is an int, H, W <= 64), and no group count
  // kept: the walk's bounds are the launch's arguments, so that no counter
  // spills (ptxas)
  const int HW = H * W;
  const MmaPlaneBwdLayout lay(H, W, PASSES, sizeof(T));
  __nv_bfloat16* const ops = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* const xs = ops + lay.ops(ppi, resident);  // ppi × x's pieces
  __nv_bfloat16* const gs = xs + ppi * lay.x;   // ppi × g's
  __nv_bfloat16* const ts = gs + ppi * lay.x;   // ppi × t's, then s's
  __nv_bfloat16* const vs = ts + ppi * lay.t;   // ppi × v's
  // the operators, each in a place of its own (resident) or a phase's at
  // the start of the region; x and g as they arrive after the planes
  // (resident) or after U_h (phased)
  __nv_bfloat16* const o_dh = ops + lay.uhT;
  __nv_bfloat16* const o_uwT = resident ? o_dh + lay.dh : ops;
  __nv_bfloat16* const o_dw = o_uwT + lay.uwT;
  __nv_bfloat16* const o_uw = o_dw + lay.dw;
  __nv_bfloat16* const o_uh = resident ? o_uw + lay.uw : ops;
  T* const raw = reinterpret_cast<T*>(resident ? vs + ppi * lay.t
                                               : ops + lay.uh);
  const Piece xp = piece(xs, H, W, lay.x), gp = piece(gs, H, W, lay.x);
  const Piece tp = piece(ts, 2 * H, W, lay.t), vp = piece(vs, 2 * H, W, lay.t);
  // group q's x, then its g, in flight to raw (the caller commits)
  const auto fetch = [&](int q) {
    const int P = min(ppi, nplanes - q * ppi);
    stage_planes(raw, x, (long long)q * ppi, P, HW);
    stage_planes(raw + P * HW, g, (long long)q * ppi, P, HW);
  };
  if (resident) {
    stage_blob(ops, uhT, lay.uhT);
    stage_blob(o_dh, dh, lay.dh);
    stage_blob(o_uwT, uwT, lay.uwT);
    stage_blob(o_dw, dw, lay.dw);
    stage_blob(o_uw, uw, lay.uw);
    stage_blob(o_uh, uh, lay.uh);
  }
  int q = blockIdx.x;  // group q: planes [q·ppi, q·ppi + P)
  if ((long long)q * ppi < nplanes) fetch(q);
  cp_async_commit();
  for (; (long long)q * ppi < nplanes; q += gridDim.x) {
    const int next = q + gridDim.x, P = min(ppi, nplanes - q * ppi);
    cp_async_wait<0>();
    __syncthreads();  // x and g arrived; the last group's products are done
    split_planes<PASSES>(raw, P, H, W, xp);
    split_planes<PASSES>(raw + P * HW, P, H, W, gp);
    __syncthreads();
    if (resident) {
      if ((long long)next * ppi < nplanes) fetch(next);  // during the products
      cp_async_commit();
    } else {
      stage_blob(ops, uhT, lay.uhT);
      stage_blob(o_dh, dh, lay.dh);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // t = U_h · x, v = D_hᵀ · g                    (2H × W)
    strip_product<PASSES, true, NW>(
        piece(ops, H, 2 * H, 0), xp, P, pad16(2 * H), pad16(H),
        [&](int p, int r0, int c0, const auto& acc, int lane) {
          store_strip<PASSES>(tp, p, r0, c0, acc, lane);
        });
    strip_product<PASSES, true, NW>(
        piece(o_dh, H, 2 * H, 0), gp, P, pad16(2 * H), pad16(H),
        [&](int p, int r0, int c0, const auto& acc, int lane) {
          store_strip<PASSES>(vp, p, r0, c0, acc, lane);
        });
    __syncthreads();
    if (!resident) {
      stage_blob(o_uwT, uwT, lay.uwT);
      stage_blob(o_dw, dw, lay.dw);
      stage_blob(o_uw, uw, lay.uw);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // s = (act′(t · U_wᵀ) ⊙ (v · D_w)) · U_w       (2H × W); over t
    middle_pair_bwd<PASSES, NW, mma_plane_bwd_hold(NW)>(
        piece(o_uwT, W, 2 * W, 0), piece(o_dw, W, 2 * W, 0),
        piece(o_uw, 2 * W, W, 0), tp, vp, P, pad16(2 * H), pad16(2 * W),
        MulActGrad{act});
    __syncthreads();
    if (!resident) {
      stage_blob(o_uh, uh, lay.uh);
      cp_async_commit();
      if ((long long)next * ppi < nplanes) fetch(next);  // during dx's
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    // dx = U_hᵀ · s                                (H × W), to device memory
    T* o = dx + (long long)q * ppi * HW;
    strip_product<PASSES, false, NW>(
        piece(o_uh, 2 * H, H, 0), tp, P, pad16(H), pad16(2 * H),
        [&](int p, int r0, int c0, const auto& acc, int lane) {
          constexpr int NB = sizeof(acc) / sizeof(acc[0]);
#pragma unroll
          for (int n = 0; n < NB; ++n)
            ToPlanes<T>{o, H, W, HW}(p, r0, c0 + 16 * n, acc[n], lane);
        });
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}


// K5 at a reduced level (``passes`` bf16 passes a product): ``grid``
// persistent blocks walking groups of ``ppi`` planes; x and out of T.
template <class T>
int plane_bf16(const T* x, T* out, const __nv_bfloat16* uhT,
               const __nv_bfloat16* uwT, const __nv_bfloat16* dwT,
               const __nv_bfloat16* dhT, int nplanes, int H, int W, int ppi,
               int grid, int passes, int act, void* stream) {
  using afldm_filtered::kStripBlocks;
  if (H % 4 || W % 4 || W > 16 * kStripBlocks || ppi < 1 || grid < 1 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  // by passes and pad16(W) / 16
  void (*const kernels[2][kStripBlocks])(
      const T*, T*, const __nv_bfloat16*, const __nv_bfloat16*,
      const __nv_bfloat16*, const __nv_bfloat16*, int, int, int, int, int) = {
      {&filtered_act_plane_mma_kernel<1, 1, T>,
       &filtered_act_plane_mma_kernel<1, 2, T>,
       &filtered_act_plane_mma_kernel<1, 3, T>,
       &filtered_act_plane_mma_kernel<1, 4, T>},
      {&filtered_act_plane_mma_kernel<3, 1, T>,
       &filtered_act_plane_mma_kernel<3, 2, T>,
       &filtered_act_plane_mma_kernel<3, 3, T>,
       &filtered_act_plane_mma_kernel<3, 4, T>}};
  auto kernel = kernels[passes == 3][(W + 15) / 16 - 1];
  const size_t smem = MmaPlaneLayout(H, W, passes, sizeof(T)).bytes(ppi);
  const int err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, mma_plane_threads(passes, (W + 15) / 16), smem,
           (cudaStream_t)stream>>>(x, out, uhT, uwT, dwT, dhT, nplanes, H, W,
                                   ppi, act);
  return (int)cudaGetLastError();
}


// K5b at a reduced level (``passes`` bf16 passes a product): ``grid``
// persistent blocks walking groups of ``ppi`` planes, the operators
// ``resident`` (1) or phased (0); x, g and dx of T.
template <class T>
int plane_bwd_bf16(const T* x, const T* g, T* dx, const __nv_bfloat16* uhT,
                   const __nv_bfloat16* dh, const __nv_bfloat16* uwT,
                   const __nv_bfloat16* dw, const __nv_bfloat16* uw,
                   const __nv_bfloat16* uh, int nplanes, int H, int W,
                   int ppi, int grid, int resident, int passes, int act,
                   void* stream) {
  using afldm_filtered::kStripBlocks;
  if (H % 4 || W % 4 || W > 16 * kStripBlocks || ppi < 1 || grid < 1 ||
      (resident != 0 && resident != 1) || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  // by passes and pad16(W) / 16
  void (*const kernels[2][kStripBlocks])(
      const T*, const T*, T*, const __nv_bfloat16*, const __nv_bfloat16*,
      const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
      const __nv_bfloat16*, int, int, int, int, int, int) = {
      {&filtered_act_plane_bwd_mma_kernel<1, 1, T>,
       &filtered_act_plane_bwd_mma_kernel<1, 2, T>,
       &filtered_act_plane_bwd_mma_kernel<1, 3, T>,
       &filtered_act_plane_bwd_mma_kernel<1, 4, T>},
      {&filtered_act_plane_bwd_mma_kernel<3, 1, T>,
       &filtered_act_plane_bwd_mma_kernel<3, 2, T>,
       &filtered_act_plane_bwd_mma_kernel<3, 3, T>,
       &filtered_act_plane_bwd_mma_kernel<3, 4, T>}};
  auto kernel = kernels[passes == 3][(W + 15) / 16 - 1];
  const size_t smem =
      MmaPlaneBwdLayout(H, W, passes, sizeof(T)).bytes(ppi, resident);
  const int err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, mma_plane_threads(passes, (W + 15) / 16), smem,
           (cudaStream_t)stream>>>(x, g, dx, uhT, dh, uwT, dw, uw, uh,
                                   nplanes, H, W, ppi, resident, act);
  return (int)cudaGetLastError();
}

}  // namespace

// K5 at a reduced level: ``grid`` persistent blocks (mma_plane_threads),
// each walking groups of ``ppi`` planes; the operators' split blobs of U_hᵀ,
// U_wᵀ, D_wᵀ, D_hᵀ.
extern "C" int filtered_act_plane_bf16(
    const float* x, float* out, const __nv_bfloat16* uhT,
    const __nv_bfloat16* uwT, const __nv_bfloat16* dwT,
    const __nv_bfloat16* dhT, int nplanes, int H, int W, int ppi, int grid,
    int passes, int act, void* stream) {
  return plane_bf16(x, out, uhT, uwT, dwT, dhT, nplanes, H, W, ppi, grid,
                    passes, act, stream);
}

// K5 at a reduced level for a bf16 x: the same arguments, x and out bf16.
extern "C" int filtered_act_plane_bf16_xbf16(
    const __nv_bfloat16* x, __nv_bfloat16* out, const __nv_bfloat16* uhT,
    const __nv_bfloat16* uwT, const __nv_bfloat16* dwT,
    const __nv_bfloat16* dhT, int nplanes, int H, int W, int ppi, int grid,
    int passes, int act, void* stream) {
  return plane_bf16(x, out, uhT, uwT, dwT, dhT, nplanes, H, W, ppi, grid,
                    passes, act, stream);
}

// K5b at a reduced level: ``grid`` persistent blocks (mma_plane_threads),
// each walking groups of ``ppi`` planes, the operators resident or phased;
// the split blobs of U_hᵀ, D_h, U_wᵀ, D_w, U_w, U_h.
extern "C" int filtered_act_plane_bwd_bf16(
    const float* x, const float* g, float* dx, const __nv_bfloat16* uhT,
    const __nv_bfloat16* dh, const __nv_bfloat16* uwT,
    const __nv_bfloat16* dw, const __nv_bfloat16* uw,
    const __nv_bfloat16* uh, int nplanes, int H, int W, int ppi, int grid,
    int resident, int passes, int act, void* stream) {
  return plane_bwd_bf16(x, g, dx, uhT, dh, uwT, dw, uw, uh, nplanes, H, W,
                        ppi, grid, resident, passes, act, stream);
}

// K5b at a reduced level for a bf16 x and g: the same arguments, x, g and
// dx bf16.
extern "C" int filtered_act_plane_bwd_bf16_xbf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, __nv_bfloat16* dx,
    const __nv_bfloat16* uhT, const __nv_bfloat16* dh,
    const __nv_bfloat16* uwT, const __nv_bfloat16* dw,
    const __nv_bfloat16* uw, const __nv_bfloat16* uh, int nplanes, int H,
    int W, int ppi, int grid, int resident, int passes, int act,
    void* stream) {
  return plane_bwd_bf16(x, g, dx, uhT, dh, uwT, dw, uw, uh, nplanes, H, W,
                        ppi, grid, resident, passes, act, stream);
}
