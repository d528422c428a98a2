// Filtered activation (the alias-free "warped nonlinearity") for Hopper, f32.
//
//   out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ      for every (n, c) plane of NCHW x
//
// U (2N×N) is the ideal 2x upsampling operator and D (N×2N) the ideal
// low-pass + decimate operator, both dense circulant, built on the host
// (afldm_tpu_torch/ops/ideal_lpf.py) and passed in; the W-side operators
// arrive transposed (U_wᵀ: W×2W, D_wᵀ: 2W×W) so every product below reads
// row-major operands.
//
// and its VJP for whole planes,
//
//   dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w
//
// Replaces:
//   filtered_act_plane     <- afldm_tpu/ops/pallas_kernels.py::_forward (K5)
//   filtered_act_plane_bwd <- the kernel inside pallas_kernels.py::_bwd_rule
//                             (K5b)
//   filtered_act_banded    <- afldm_tpu/ops/pallas_kernels.py::_forward_spatial (K1)
//   filtered_act_banded_bwd <- afldm_tpu/ops/pallas_kernels.py::_bwd_spatial (K2)
//
// What bounds it on this card: arithmetic. A plane of side S costs
// 24·S³ FLOP (four products) against 8·S² bytes of input and output, so at
// 32-128 px it does 100-400 FLOP per byte, far above the f32 ridge of
// 67 TFLOP/s ÷ 3.35 TB/s ≈ 20. Without tensor cores (exact f32 is the
// parity default) the ceiling is the f32 FMA rate.
//
// What the design does about it: in K5 and K5b the 2H×2W intermediates
// never leave the SM, so device memory sees each input and output once; K1
// and K2 trade that for a grid that fills the card (below). The TPU's
// lane-multiple-of-128 and 10 MB VMEM rules do not apply here: the limit is
// the 227 KB of shared memory of a block.
//   * plane (H, W <= 64, K5): one block holds P whole planes and every
//     operand of its four products in shared memory: two operator buffers
//     (the next operator's 16-byte cp.async copy in flight during the
//     current product) and, per plane, the 2W×2H hiᵀ (x staged inside it,
//     which it outlives) and a 2H×W buffer. Every operand is stored k-major
//     so one routine, filtered_tile.cuh::tile_product, does all four
//     products with float4 reads into 8×4 or 4×4 register micro-tiles:
//       tᵀ  = (U_h · x)ᵀ        (W×2H)   from U_hᵀ and x
//       hiᵀ = act(t · U_wᵀ)ᵀ    (2W×2H)  from tᵀ and U_wᵀ, act in the epilogue
//       t   = hi · D_wᵀ         (2H×W)   from hiᵀ and D_wᵀ
//       out = D_h · t           (H×W)    from D_hᵀ and t, to device memory
//     P and each product's micro-tile come from the wrapper's launch plan
//     (ops/filtered_act.py::plane_plan): small planes are packed P to a
//     block so that every thread holds a full micro-tile, within two blocks
//     to an SM and a grid of at least one wave.
//   * banded (every H, W % 4 == 0 with max(H, W) > 64, K1): at 128 px the 2x
//     plane alone is 256 KB, over the limit, and one block a plane left
//     most of the 132 SMs idle (16 planes at 1024 px). K1 no longer walks
//     bands: a chunk of P planes runs as four launches of one tiled GEMM
//     (filtered_gemm.cuh), x viewed as (P·H) × W:
//       t = x · U_wᵀ              one GEMM, (P·H) × 2W, depth W
//       hi[p] = act(U_h · t[p])   batched over P, 2H × 2W, depth H
//       lo = hi · D_wᵀ            one GEMM, (P·2H) × W, depth 2W
//       out[p] = D_h · lo[p]      batched over P, H × W, depth 2H
//     Each block owns one output tile of one product over its full depth,
//     so the grid grows with the plane's area and no block sums into
//     another's output. The price is the intermediates in device memory:
//     t, lo (2·H·W floats a plane, one buffer) and hi (4·H·W), written and
//     read once, 64·H·W bytes a plane against 24·S³ FLOP, 0.375·S FLOP a
//     byte (48 at 128 px): still above the ridge, so the products bound it.
//     The wrapper chunks the planes so that one chunk's scratch stays under
//     a cap and picks each product's block tile (ops/filtered_act.py::
//     banded_plan).
//   * plane backward (H, W <= 64, K5b): six products per plane, 12H²W + 24HW²
//     FLOP (36·S³, 1.5x the forward), again arithmetic-bound. Like the JAX
//     rule it saves x, not the 4x pre-activation, and recomputes it. K5b is
//     K5's design with six products: the same routine, the same two
//     operator buffers (each operator's cp.async in flight during the
//     product before the one that reads it) and a launch plan of its own
//     (ops/filtered_act.py::plane_bwd_plan). Per plane: the 2W×2H preᵀ (x
//     staged inside it), one buffer for tᵀ, uᵀ and s in turn, and the
//     staged g (H×W); the H side first, as in K5:
//       tᵀ   = xᵀ · U_hᵀ                  (W×2H)   from x and U_hᵀ
//       preᵀ = U_w · tᵀ                   (2W×2H)  from U_wᵀ and tᵀ, over x
//       uᵀ   = gᵀ · D_h                   (W×2H)   from g and D_h, over tᵀ
//       mᵀ   = act′(preᵀ) ⊙ (D_wᵀ · uᵀ)   (2W×2H)  from D_w and uᵀ, over preᵀ
//       s    = m · U_w                    (2H×W)   from mᵀ and U_w, over uᵀ
//       dx   = U_hᵀ · s                   (H×W)    from U_h and s, to device
//     mᵀ is formed in the epilogue of its product, which reads the
//     pre-activation it overwrites (Epi::kReadsC; each element has one
//     owning thread), so the 2x cotangent is never stored. A plane takes
//     7·H·W floats and row padding: 30 KB at 32 px, 116 KB at 64 px, where
//     with the operator buffers' 64 KB a block holds one plane and an SM
//     one block.
//   * banded backward (the forward's sizes, K2): the six products of the
//     VJP, 16HW² + 20H²W FLOP a plane (36·S³). The TPU kernel holds the
//     2H×2W pre-activation and cotangent of a whole plane in VMEM (512 KB
//     at 128 px), more than a block's shared memory, and one block a plane
//     would leave most of the 132 SMs idle. K2 is K1's design with six
//     launches of the same GEMM a chunk of P planes, x and g viewed as
//     (P·H) × W, the W side first:
//       t = x · U_wᵀ                      one GEMM, (P·H) × 2W, depth W
//       pre[p] = U_h · t[p]               batched, 2H × 2W, depth H
//       v = g · D_w                       one GEMM, (P·H) × 2W, depth W
//       m[p] = act′(pre[p]) ⊙ (D_hᵀ·v[p]) batched, 2H × 2W, depth H
//       s = m · U_w                       one GEMM, (P·2H) × W, depth 2W
//       dx[p] = U_hᵀ · s[p]               batched, H × W, depth 2H
//     Like the JAX rule it saves x, not the pre-activation, and recomputes
//     it. m is formed in the fourth product's epilogue from the
//     pre-activation it overwrites (the GEMM's kReadsC form: each element
//     has one owning thread, so the read and the write race with nothing),
//     so the 2x cotangent is never stored. The scratch is K1's, 6·H·W
//     floats a plane: t, then v, then s in the first 2·H·W, pre and then m
//     in the next 4·H·W; 112·H·W bytes a plane of scratch traffic against
//     36·S³ FLOP, still above the ridge at 80 px and up.
//
// The reduced precision levels ("high": 3 bf16 passes a product,
// "default": 1; filtered_mma.cuh) run the same four functions on bf16
// tensor cores, each in its TPU kernel's product order, which at these
// levels decides which intermediates are split:
//   * K5 (filtered_act_plane_bf16), _forward's order: U_h then U_w up, D_w
//     then D_h down, the order of the f32 kernel above. Every operand is
//     split into bf16 pieces (hi and lo at 'high', hi alone at 'default'):
//     the operators once on the host (blobs already padded to the kernel's
//     layout, MmaPlaneLayout), x as it is staged, and each product's f32
//     result from the registers. Persistent blocks (at most the blocks an
//     SM holds × the SMs) stage the operators once and keep them (staged
//     for each plane they would be 143 KB read from L2 for a 64 px plane
//     whose x and out are 32 KB), the next group of planes' x in flight by
//     cp.async during the current group's products; t = U_h·x row-major,
//     and the middle pair hi = act(t·U_wᵀ), t₂ = hi·D_wᵀ fused per 16-row
//     strip of the 2H side, hi never leaving the registers
//     (filtered_mma.cuh::middle_pair), t₂ over t, so no 2W × 2H buffer
//     takes shared memory. At 'default' the block is half the size, two
//     an SM. Each element's sums are taken in the order of a 16×16 tile
//     walk (filtered_mma.cuh::warp_tile). P planes an iteration and the
//     grid come from ops/filtered_act.py::plane_mma_plan.
//   * K5b (filtered_act_plane_bwd_bf16), _bwd_rule's order: pre and the
//     cotangent D_hᵀ·g·D_w H side first, dx W side first, as the f32
//     kernel. The pre-activation is needed only as act′(pre): its product
//     and the cotangent's second product have one shape, so one warp
//     computes both over the same tile (mma_product2) and splits act′(pre)
//     ⊙ cotangent into mᵀ from registers; pre is never stored.
//   * K2 (filtered_act_banded_bwd_bf16), _bwd_spatial's order: H side
//     first in every filter pair (the f32 chain takes W first), as six
//     launches of the GEMM's bf16 variant (filtered_gemm.cuh), which splits
//     the f32 scratch intermediates as it loads them. The act′ ⊙ epilogue
//     stays f32. K1's level variants (filtered_act_banded_bf16) are two
//     fused launches of their own source, filtered_banded_mma.cu.
// Making them faster (wgmma, TMA) is later work.
//
// bfloat16 activations (the ``_xbf16`` entries): the forward kernels K5 and
// K1 at every level take a bf16 x and write a bf16 out, which is what the
// TPU kernels do for a bf16 x (cast to f32 inside, the products at the
// level, the result cast to x's dtype): out = bf16(f(f32(x))). Only the
// edges change. K5 widens x as it stages it (8-byte loads of 4 elements,
// plain loads and stores in place of the f32 kernel's cp.async, which
// cannot convert; at the reduced levels stage_split splits the widened
// values, whose lo pieces are zero) and its last product rounds each sum
// to bf16 in the epilogue; in K1 the chain's first product reads x as bf16
// and its last writes out as bf16, the scratch intermediates unchanged.
// Device memory sees half the bytes of x and out; the products are the
// same. The backward kernels K5b and K2 take a bf16 x and g and write a
// bf16 dx the same way at every level (the JAX _bwd_rule and _bwd_spatial
// cast x and g to f32 inside and write x's dtype): dx = bf16(vjp(f32(x),
// f32(g))). K5b widens x and g as it stages them (stage_split at the
// reduced levels) and rounds dx in its last product's epilogue; K2's first
// and third GEMMs read x and g as bf16 and its last writes dx as bf16, the
// scratch intermediates f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "filtered_epi.cuh"
#include "filtered_gemm.cuh"
#include "filtered_mma.cuh"
#include "filtered_tile.cuh"

namespace {

using afldm_filtered::act_grad;
using afldm_filtered::Activation;
using afldm_filtered::Identity;
using afldm_filtered::MulActGrad;

// Shared memory of a K5 block, in floats: two operator buffers, each the
// largest operator (2·max(H, W)²), then for each of the P planes the 2W×2H
// hiᵀ (x staged at its start, rows row_pad(2H)) and one buffer for tᵀ
// (W×2H) and then t (2H×W).
struct PlaneLayout {
  int op, big, small;
  __host__ __device__ PlaneLayout(int H, int W)
      : op(2 * (H > W ? H : W) * (H > W ? H : W)),
        big(2 * W * afldm_filtered::row_pad(2 * H)),
        small(W * afldm_filtered::row_pad(2 * H) >
                      2 * H * afldm_filtered::row_pad(W)
                  ? W * afldm_filtered::row_pad(2 * H)
                  : 2 * H * afldm_filtered::row_pad(W)) {}
  __host__ __device__ size_t floats(int ppb) const {
    return 2 * (size_t)op + (size_t)ppb * (big + small);
  }
};

// Shared memory of a K5b block, in floats: K5's, with big holding preᵀ and
// then mᵀ (x staged at its start) and small tᵀ, uᵀ and then s, and the
// staged g (H×W) a plane after them.
struct PlaneBwdLayout : PlaneLayout {
  int g;
  __host__ __device__ PlaneBwdLayout(int H, int W)
      : PlaneLayout(H, W), g(H * W) {}
  __host__ __device__ size_t floats(int ppb) const {
    return PlaneLayout::floats(ppb) + (size_t)ppb * g;
  }
};

// out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ for P planes a block of THREADS
// threads (256: two blocks an SM where shared memory allows; 512: one),
// every operand in shared memory; bit i of ``tiles`` set gives product i + 1
// 4×4 micro-tiles in place of 8×4 (filtered_tile.cuh::product).
// Operators, row-major as stored: uhT = U_hᵀ (H×2H), uwT = U_wᵀ (W×2W),
// dwT = D_wᵀ (2W×W), dhT = D_hᵀ (2H×H).
template <int THREADS, class T>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 1)
filtered_act_plane_kernel(const T* __restrict__ x, T* __restrict__ out,
                          const float* __restrict__ uhT,
                          const float* __restrict__ uwT,
                          const float* __restrict__ dwT,
                          const float* __restrict__ dhT,
                          int nplanes, int H, int W, int ppb, int tiles,
                          int act) {
  using namespace afldm_filtered;
  extern __shared__ __align__(16) float plane_smem[];
  const int HW = H * W;
  const long long p0 = (long long)blockIdx.x * ppb;
  const int P = (int)min((long long)ppb, nplanes - p0);
  const PlaneLayout lay(H, W);
  float* op0 = plane_smem;
  float* op1 = plane_smem + lay.op;
  float* big = op1 + lay.op;            // P × hiᵀ; x staged here first
  float* small = big + ppb * lay.big;   // P × tᵀ, then P × t
  const int ld2h = row_pad(2 * H), ldw = row_pad(W);
  // x and U_hᵀ, then U_wᵀ, in flight together (a bf16 x is widened by
  // plain loads and stores, which the first barrier orders)
  const T* xg = x + p0 * HW;
  const int c4 = HW / 4;
  for (int i = threadIdx.x; i < P * c4; i += blockDim.x) {
    const int p = i / c4, c = i - p * c4;
    if constexpr (std::is_same<T, float>::value)
      cp_async16(big + p * lay.big + 4 * c, xg + (long long)p * HW + 4 * c);
    else
      *reinterpret_cast<float4*>(big + p * lay.big + 4 * c) =
          load4(xg + (long long)p * HW + 4 * c);
  }
  stage(op0, uhT, H * H / 2);
  cp_async_commit();
  stage(op1, uwT, W * W / 2);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // tᵀ = (U_h · x)ᵀ = xᵀ · U_hᵀ            (W × 2H)
  product(tiles & 1, op0, 2 * H, 0, big, W, lay.big, small, ld2h, lay.small,
          P, W, 2 * H, H, Identity{});
  __syncthreads();
  stage(op0, dwT, W * W / 2);  // D_wᵀ in flight during the next product
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // hiᵀ = act(t · U_wᵀ)ᵀ = act(U_w · tᵀ)  (2W × 2H); overwrites the staged x
  product((tiles >> 1) & 1, small, ld2h, lay.small, op1, 2 * W, 0, big, ld2h,
          lay.big, P, 2 * W, 2 * H, W, Activation{act});
  __syncthreads();
  stage(op1, dhT, H * H / 2);  // D_hᵀ in flight during the next product
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // t = hi · D_wᵀ = (hiᵀ)ᵀ · D_wᵀ          (2H × W); over tᵀ
  product((tiles >> 2) & 1, op0, W, 0, big, ld2h, lay.big, small, ldw,
          lay.small, P, 2 * H, W, 2 * W, Identity{});
  cp_async_wait<0>();
  __syncthreads();
  // out = D_h · t = (D_hᵀ)ᵀ · t            (H × W), straight to device memory
  product((tiles >> 3) & 1, small, ldw, lay.small, op1, H, 0, out + p0 * HW,
          W, HW, P, H, W, 2 * H, Identity{});
}

// dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w for P planes a
// block of THREADS threads (as filtered_act_plane_kernel), every operand in
// shared memory; bit i of ``tiles`` set gives product i + 1 4×4
// micro-tiles in place of 8×4. Operators, row-major as stored: uhT = U_hᵀ
// (H×2H), uwT = U_wᵀ (W×2W), dh = D_h (H×2H), dw = D_w (W×2W), uw = U_w
// (2W×W), uh = U_h (2H×H): each the k-major form its product reads.
template <int THREADS, class T>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 1)
filtered_act_plane_bwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ g,
                              T* __restrict__ dx,
                              const float* __restrict__ uhT,
                              const float* __restrict__ uwT,
                              const float* __restrict__ dh,
                              const float* __restrict__ dw,
                              const float* __restrict__ uw,
                              const float* __restrict__ uh, int nplanes,
                              int H, int W, int ppb, int tiles, int act) {
  using namespace afldm_filtered;
  extern __shared__ __align__(16) float plane_smem[];
  const int HW = H * W;
  const long long p0 = (long long)blockIdx.x * ppb;
  const int P = (int)min((long long)ppb, nplanes - p0);
  const PlaneBwdLayout lay(H, W);
  float* op0 = plane_smem;
  float* op1 = plane_smem + lay.op;
  float* big = op1 + lay.op;             // P × preᵀ, then mᵀ; x staged first
  float* small = big + ppb * lay.big;    // P × tᵀ, then uᵀ, then s
  float* gs = small + ppb * lay.small;   // P × g
  const int ld2h = row_pad(2 * H), ldw = row_pad(W);
  // x, g and U_hᵀ, then U_wᵀ, in flight together (a bf16 x and g are
  // widened by plain loads and stores, which the first barrier orders)
  const T* xg = x + p0 * HW;
  const T* gg = g + p0 * HW;
  const int c4 = HW / 4;
  for (int i = threadIdx.x; i < P * c4; i += blockDim.x) {
    const int p = i / c4, c = i - p * c4;
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(big + p * lay.big + 4 * c, xg + (long long)p * HW + 4 * c);
      cp_async16(gs + p * lay.g + 4 * c, gg + (long long)p * HW + 4 * c);
    } else {
      *reinterpret_cast<float4*>(big + p * lay.big + 4 * c) =
          load4(xg + (long long)p * HW + 4 * c);
      *reinterpret_cast<float4*>(gs + p * lay.g + 4 * c) =
          load4(gg + (long long)p * HW + 4 * c);
    }
  }
  stage(op0, uhT, H * H / 2);
  cp_async_commit();
  stage(op1, uwT, W * W / 2);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // 1. tᵀ = xᵀ · U_hᵀ = (U_h · x)ᵀ             (W × 2H)
  product(tiles & 1, op0, 2 * H, 0, big, W, lay.big, small, ld2h, lay.small,
          P, W, 2 * H, H, Identity{});
  __syncthreads();
  stage(op0, dh, H * H / 2);  // D_h in flight during the next product
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // 2. preᵀ = U_w · tᵀ = (U_h · x · U_wᵀ)ᵀ      (2W × 2H); over the staged x
  product((tiles >> 1) & 1, small, ld2h, lay.small, op1, 2 * W, 0, big, ld2h,
          lay.big, P, 2 * W, 2 * H, W, Identity{});
  __syncthreads();
  stage(op1, dw, W * W / 2);  // D_w in flight during the next product
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // 3. uᵀ = gᵀ · D_h = (D_hᵀ · g)ᵀ              (W × 2H); over tᵀ
  product((tiles >> 2) & 1, op0, 2 * H, 0, gs, W, lay.g, small, ld2h,
          lay.small, P, W, 2 * H, H, Identity{});
  __syncthreads();
  stage(op0, uw, W * W / 2);  // U_w in flight during the next product
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // 4. mᵀ = act′(preᵀ) ⊙ (D_wᵀ · uᵀ)            (2W × 2H); in place over
  //    preᵀ, which the epilogue reads
  product((tiles >> 3) & 1, small, ld2h, lay.small, op1, 2 * W, 0, big, ld2h,
          lay.big, P, 2 * W, 2 * H, W, MulActGrad{act});
  __syncthreads();
  stage(op1, uh, H * H / 2);  // U_h in flight during the next product
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // 5. s = m · U_w = (mᵀ)ᵀ · U_w                (2H × W); over uᵀ
  product((tiles >> 4) & 1, op0, W, 0, big, ld2h, lay.big, small, ldw,
          lay.small, P, 2 * H, W, 2 * W, Identity{});
  cp_async_wait<0>();
  __syncthreads();
  // 6. dx = U_hᵀ · s = (U_h)ᵀ · s               (H × W), to device memory
  product((tiles >> 5) & 1, small, ldw, lay.small, op1, H, 0, dx + p0 * HW,
          W, HW, P, H, W, 2 * H, Identity{});
}

// -- the reduced precision levels on bf16 tensor cores ---------------------

// Shared memory of a K5b bf16 block, in bf16 elements: two operator
// buffers, each the largest operator's split blob; then for each of the P
// planes a big buffer (mᵀ, x and g staged in it), a small one (tᵀ and then
// s) and uᵀ.
struct MmaPlaneBwdLayout {
  int op, big, small, small2;
  __host__ __device__ MmaPlaneBwdLayout(int H, int W) {
    using afldm_filtered::mma_buf;
    const int a = mma_buf(H, 2 * H), b = mma_buf(W, 2 * W);
    const int c = mma_buf(2 * W, W), d = mma_buf(2 * H, H);
    op = imax(imax(a, b), imax(c, d));
    big = imax(mma_buf(2 * W, 2 * H), 2 * mma_buf(H, W));
    small = imax(mma_buf(W, 2 * H), mma_buf(2 * H, W));
    small2 = mma_buf(W, 2 * H);
  }
  __host__ __device__ static int imax(int a, int b) { return a > b ? a : b; }
  __host__ __device__ size_t bytes(int ppb) const {
    return 2 * (2 * (size_t)op + (size_t)ppb * (big + small + small2));
  }
};

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

// A product's result, epi applied, split into the pieces of the next
// product's operand (every row and column of the padded tile: the padding
// computes to zero).
template <class Epi>
struct ToPieces {
  afldm_filtered::Piece d;
  Epi epi;
  __device__ __forceinline__ void operator()(int p, int r0, int c0,
                                             const float (&acc)[2][4],
                                             int lane) const {
    afldm_filtered::for_pairs(
        r0, c0, acc, lane, [&](int r, int c, float v0, float v1) {
          unsigned h, l;
          afldm_filtered::split2(epi(v0), epi(v1), h, l);
          __nv_bfloat16* q = d.hi + p * d.ps + r * d.ld + c;
          *reinterpret_cast<unsigned*>(q) = h;
          *reinterpret_cast<unsigned*>(q + d.lo) = l;
        });
  }
};

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

// act′(pre) ⊙ the cotangent, split into mᵀ's pieces: K5b's fused product
struct MulActGradToPieces {
  afldm_filtered::Piece d;
  int act;
  __device__ __forceinline__ void operator()(int p, int r0, int c0,
                                             const float (&pre)[2][4],
                                             const float (&v)[2][4],
                                             int lane) const {
    float m[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[j][e] = act_grad(pre[j][e], act) * v[j][e];
    ToPieces<Identity>{d, Identity{}}(p, r0, c0, m, lane);
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

// dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w at PASSES
// bf16 passes a product, P planes a block of 256 threads, in _bwd_rule's
// order. Operators: the split blobs of U_hᵀ (H×2H), D_h (H×2H), U_wᵀ
// (W×2W), D_w (W×2W), U_w (2W×W), U_h (2H×H).
template <int PASSES, class T>
__global__ void __launch_bounds__(256)
filtered_act_plane_bwd_mma_kernel(const T* __restrict__ x,
                                  const T* __restrict__ g,
                                  T* __restrict__ dx,
                                  const __nv_bfloat16* __restrict__ uhT,
                                  const __nv_bfloat16* __restrict__ dh,
                                  const __nv_bfloat16* __restrict__ uwT,
                                  const __nv_bfloat16* __restrict__ dw,
                                  const __nv_bfloat16* __restrict__ uw,
                                  const __nv_bfloat16* __restrict__ uh,
                                  int nplanes, int H, int W, int ppb,
                                  int act) {
  using namespace afldm_filtered;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int HW = H * W;
  const long long p0 = (long long)blockIdx.x * ppb;
  const int P = (int)min((long long)ppb, nplanes - p0);
  const MmaPlaneBwdLayout lay(H, W);
  __nv_bfloat16* op0 = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* op1 = op0 + lay.op;
  __nv_bfloat16* big = op1 + lay.op;             // P × mᵀ; x, g staged first
  __nv_bfloat16* small = big + ppb * lay.big;    // P × tᵀ, then s
  __nv_bfloat16* small2 = small + ppb * lay.small;  // P × uᵀ
  __nv_bfloat16* gs = big + mma_buf(H, W);
  stage_blob(op0, uhT, mma_buf(H, 2 * H));
  stage_blob(op1, dh, mma_buf(H, 2 * H));
  cp_async_commit();
  stage_split(x + p0 * HW, HW, P, H, W, piece(big, H, W, lay.big));
  stage_split(g + p0 * HW, HW, P, H, W, piece(gs, H, W, lay.big));
  cp_async_wait<0>();
  __syncthreads();
  // tᵀ = xᵀ · U_hᵀ = (U_h · x)ᵀ             (W × 2H)
  mma_product<PASSES>(piece(big, H, W, lay.big), piece(op0, H, 2 * H, 0), P,
                      pad16(W), pad16(2 * H), pad16(H),
                      ToPieces<Identity>{piece(small, W, 2 * H, lay.small),
                                         Identity{}});
  // uᵀ = gᵀ · D_h = (D_hᵀ · g)ᵀ             (W × 2H)
  mma_product<PASSES>(piece(gs, H, W, lay.big), piece(op1, H, 2 * H, 0), P,
                      pad16(W), pad16(2 * H), pad16(H),
                      ToPieces<Identity>{piece(small2, W, 2 * H, lay.small2),
                                         Identity{}});
  __syncthreads();
  stage_blob(op0, uwT, mma_buf(W, 2 * W));
  stage_blob(op1, dw, mma_buf(W, 2 * W));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // mᵀ = act′(U_w · tᵀ) ⊙ (D_wᵀ · uᵀ)       (2W × 2H); over x and g
  mma_product2<PASSES>(piece(op0, W, 2 * W, 0),
                       piece(small, W, 2 * H, lay.small),
                       piece(op1, W, 2 * W, 0),
                       piece(small2, W, 2 * H, lay.small2), P, pad16(2 * W),
                       pad16(2 * H), pad16(W),
                       MulActGradToPieces{piece(big, 2 * W, 2 * H, lay.big),
                                          act});
  __syncthreads();
  stage_blob(op0, uw, mma_buf(2 * W, W));
  stage_blob(op1, uh, mma_buf(2 * H, H));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // s = m · U_w = (mᵀ)ᵀ · U_w               (2H × W); over tᵀ
  mma_product<PASSES>(piece(big, 2 * W, 2 * H, lay.big),
                      piece(op0, 2 * W, W, 0), P, pad16(2 * H), pad16(W),
                      pad16(2 * W),
                      ToPieces<Identity>{piece(small, 2 * H, W, lay.small),
                                         Identity{}});
  __syncthreads();
  // dx = U_hᵀ · s = (U_h)ᵀ · s              (H × W), to device memory
  mma_product<PASSES>(piece(op1, 2 * H, H, 0), piece(small, 2 * H, W, lay.small),
                      P, pad16(H), pad16(W), pad16(2 * H),
                      ToPlanes<T>{dx + p0 * HW, H, W, HW});
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// cudaErrorInvalidValue unless the plane kernels take (H, W, ppb, tiles,
// threads): ``rows`` holds the rows of the n products' results, and an
// 8×4 micro-tile (bit clear) needs them % 8 == 0.
int check_plane_args(int H, int W, int ppb, int tiles, int threads,
                     const int* rows, int n) {
  if (H % 4 || W % 4 || ppb < 1 || (threads != 256 && threads != 512))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if (!((tiles >> i) & 1) && rows[i] % 8) return (int)cudaErrorInvalidValue;
  return cudaSuccess;
}

// One launch of a plane kernel: ceil(nplanes / ppb) blocks of ``threads``
// with ``smem`` bytes of dynamic shared memory.
template <class... Params, class... Args>
int launch_planes(void (*kernel)(Params...), int threads, size_t smem,
                  int nplanes, int ppb, cudaStream_t stream, Args... args) {
  int err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(nplanes + ppb - 1) / ppb, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// K5 (f32 products) on P planes a block of ``threads``; x and out of T.
template <class T>
int plane_f32(const T* x, T* out, const float* uhT, const float* uwT,
              const float* dwT, const float* dhT, int nplanes, int H, int W,
              int ppb, int tiles, int threads, int act, void* stream) {
  // the rows of the products' results tᵀ, hiᵀ, t and out
  const int rows[4] = {W, 2 * W, 2 * H, H};
  const int err = check_plane_args(H, W, ppb, tiles, threads, rows, 4);
  if (err != cudaSuccess) return err;
  return launch_planes(threads == 256 ? &filtered_act_plane_kernel<256, T>
                                      : &filtered_act_plane_kernel<512, T>,
                       threads, PlaneLayout(H, W).floats(ppb) * sizeof(float),
                       nplanes, ppb, (cudaStream_t)stream, x, out, uhT, uwT,
                       dwT, dhT, nplanes, H, W, ppb, tiles, act);
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

// K1 (f32 products) on one chunk of P planes, four launches of the tiled
// GEMM; x and out of T (the first GEMM's A, the last GEMM's C).
template <class T>
int banded_f32(const T* x, T* out, float* scratch, const float* uwT,
               const float* uhT, const float* dwT, const float* dhT,
               int nplanes, int H, int W, int tiles, int act, void* stream) {
  using afldm_filtered::GemmArgs;
  using afldm_filtered::GemmArgsT;
  using afldm_filtered::filtered_gemm;
  if (H % 4 || W % 4 || nplanes < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long P = nplanes, HW = (long long)H * W;
  float* t = scratch;           // P × (H × 2W), then lo: P × (2H × W)
  float* hi = scratch + 2 * HW * P;  // P × (2H × 2W)
  // t = x · U_wᵀ, x viewed as (P·H) × W
  int err = filtered_gemm<false>(
      tiles & 1, GemmArgsT<T, float, float>{x, W, 0, uwT, 2 * W, 0, t, 2 * W,
                                            0, (int)(P * H), 2 * W, W},
      1, Identity{}, s);
  if (err) return err;
  // hi[p] = act(U_h · t[p]), U_h from its k-major form U_hᵀ
  err = filtered_gemm<true>(
      (tiles >> 1) & 1, GemmArgs{uhT, 2 * H, 0, t, 2 * W, 2 * HW, hi, 2 * W,
                                 4 * HW, 2 * H, 2 * W, H},
      nplanes, Activation{act}, s);
  if (err) return err;
  // lo = hi · D_wᵀ, hi viewed as (P·2H) × 2W; over t
  err = filtered_gemm<false>(
      (tiles >> 2) & 1, GemmArgs{hi, 2 * W, 0, dwT, W, 0, t, W, 0,
                                 (int)(P * 2 * H), W, 2 * W},
      1, Identity{}, s);
  if (err) return err;
  // out[p] = D_h · lo[p], D_h from its k-major form D_hᵀ
  return filtered_gemm<true>(
      (tiles >> 3) & 1, GemmArgsT<float, float, T>{dhT, H, 0, t, W, 2 * HW,
                                                   out, W, HW, H, W, 2 * H},
      nplanes, Identity{}, s);
}

// K5b (f32 products) on P planes a block of ``threads``; x, g and dx of T.
template <class T>
int plane_bwd_f32(const T* x, const T* g, T* dx, const float* uhT,
                  const float* uwT, const float* dh, const float* dw,
                  const float* uw, const float* uh, int nplanes, int H, int W,
                  int ppb, int tiles, int threads, int act, void* stream) {
  // the rows of the products' results tᵀ, preᵀ, uᵀ, mᵀ, s and dx
  const int rows[6] = {W, 2 * W, W, 2 * W, 2 * H, H};
  const int err = check_plane_args(H, W, ppb, tiles, threads, rows, 6);
  if (err != cudaSuccess) return err;
  return launch_planes(
      threads == 256 ? &filtered_act_plane_bwd_kernel<256, T>
                     : &filtered_act_plane_bwd_kernel<512, T>,
      threads, PlaneBwdLayout(H, W).floats(ppb) * sizeof(float), nplanes,
      ppb, (cudaStream_t)stream, x, g, dx, uhT, uwT, dh, dw, uw, uh, nplanes,
      H, W, ppb, tiles, act);
}

// K5b at a reduced level (``passes`` bf16 passes a product); x, g and dx of
// T.
template <class T>
int plane_bwd_bf16(const T* x, const T* g, T* dx, const __nv_bfloat16* uhT,
                   const __nv_bfloat16* dh, const __nv_bfloat16* uwT,
                   const __nv_bfloat16* dw, const __nv_bfloat16* uw,
                   const __nv_bfloat16* uh, int nplanes, int H, int W,
                   int ppb, int passes, int act, void* stream) {
  if (H % 4 || W % 4 || ppb < 1 || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  auto kernel = passes == 3 ? &filtered_act_plane_bwd_mma_kernel<3, T>
                            : &filtered_act_plane_bwd_mma_kernel<1, T>;
  return launch_planes(kernel, 256, MmaPlaneBwdLayout(H, W).bytes(ppb),
                       nplanes, ppb, (cudaStream_t)stream, x, g, dx, uhT, dh,
                       uwT, dw, uw, uh, nplanes, H, W, ppb, act);
}

// K2 (f32 products) on one chunk of P planes, six launches of the tiled
// GEMM; x and g of T (the first and third GEMMs' row-major A), dx of T (the
// last GEMM's C).
template <class T>
int banded_bwd_f32(const T* x, const T* g, T* dx, float* scratch,
                   const float* uwT, const float* uhT, const float* dw,
                   const float* dh, const float* uw, const float* uh,
                   int nplanes, int H, int W, int tiles, int act,
                   void* stream) {
  using afldm_filtered::GemmArgs;
  using afldm_filtered::GemmArgsT;
  using afldm_filtered::filtered_gemm;
  if (H % 4 || W % 4 || nplanes < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long P = nplanes, HW = (long long)H * W;
  float* t = scratch;                 // P × (H × 2W): t, then v; then s
  float* pre = scratch + 2 * HW * P;  // P × (2H × 2W): pre, then m
  // t = x · U_wᵀ, x viewed as (P·H) × W
  int err = filtered_gemm<false>(
      tiles & 1, GemmArgsT<T, float, float>{x, W, 0, uwT, 2 * W, 0, t, 2 * W,
                                            0, (int)(P * H), 2 * W, W},
      1, Identity{}, s);
  if (err) return err;
  // pre[p] = U_h · t[p], U_h from its k-major form U_hᵀ
  err = filtered_gemm<true>(
      (tiles >> 1) & 1, GemmArgs{uhT, 2 * H, 0, t, 2 * W, 2 * HW, pre, 2 * W,
                                 4 * HW, 2 * H, 2 * W, H},
      nplanes, Identity{}, s);
  if (err) return err;
  // v = g · D_w, g viewed as (P·H) × W; over t
  err = filtered_gemm<false>(
      (tiles >> 2) & 1, GemmArgsT<T, float, float>{g, W, 0, dw, 2 * W, 0, t,
                                                   2 * W, 0, (int)(P * H),
                                                   2 * W, W},
      1, Identity{}, s);
  if (err) return err;
  // m[p] = act′(pre[p]) ⊙ (D_hᵀ · v[p]), D_hᵀ from its k-major form D_h; in
  // place over pre
  err = filtered_gemm<true>(
      (tiles >> 3) & 1, GemmArgs{dh, 2 * H, 0, t, 2 * W, 2 * HW, pre, 2 * W,
                                 4 * HW, 2 * H, 2 * W, H},
      nplanes, MulActGrad{act}, s);
  if (err) return err;
  // s = m · U_w, m viewed as (P·2H) × 2W; over v
  err = filtered_gemm<false>(
      (tiles >> 4) & 1, GemmArgs{pre, 2 * W, 0, uw, W, 0, t, W, 0,
                                 (int)(P * 2 * H), W, 2 * W},
      1, Identity{}, s);
  if (err) return err;
  // dx[p] = U_hᵀ · s[p], U_hᵀ from its k-major form U_h
  return filtered_gemm<true>(
      (tiles >> 5) & 1, GemmArgsT<float, float, T>{uh, H, 0, t, W, 2 * HW, dx,
                                                   W, HW, H, W, 2 * H},
      nplanes, Identity{}, s);
}

// K2 at a reduced level, _bwd_spatial's order, as six launches of the
// GEMM's bf16 variant; x and g of T (the first and third GEMMs' B), dx of
// T (the last GEMM's C).
template <class T>
int banded_bwd_bf16(const T* x, const T* g, T* dx, float* scratch,
                    const float* uhT, const float* uwT, const float* dh,
                    const float* dw, const float* uh, const float* uw,
                    int nplanes, int H, int W, int tiles, int passes, int act,
                    void* stream) {
  using afldm_filtered::GemmArgs;
  using afldm_filtered::GemmArgsT;
  using afldm_filtered::filtered_gemm_mma;
  if (H % 4 || W % 4 || nplanes < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long P = nplanes, HW = (long long)H * W;
  float* t = scratch;                 // P × (2H × W): t, then v; then s
  float* pre = scratch + 2 * HW * P;  // P × (2H × 2W): pre, then m
  // t[p] = U_h · x[p]
  int err = filtered_gemm_mma<true>(
      tiles & 1, passes,
      GemmArgsT<float, T, float>{uhT, 2 * H, 0, x, W, HW, t, W, 2 * HW,
                                 2 * H, W, H},
      nplanes, Identity{}, s);
  if (err) return err;
  // pre = t · U_wᵀ, t viewed as (P·2H) × W
  err = filtered_gemm_mma<false>(
      (tiles >> 1) & 1, passes, GemmArgs{t, W, 0, uwT, 2 * W, 0, pre, 2 * W,
                                         0, (int)(P * 2 * H), 2 * W, W},
      1, Identity{}, s);
  if (err) return err;
  // v[p] = D_hᵀ · g[p], D_hᵀ from its k-major form D_h; over t
  err = filtered_gemm_mma<true>(
      (tiles >> 2) & 1, passes,
      GemmArgsT<float, T, float>{dh, 2 * H, 0, g, W, HW, t, W, 2 * HW,
                                 2 * H, W, H},
      nplanes, Identity{}, s);
  if (err) return err;
  // m = act′(pre) ⊙ (v · D_w), v viewed as (P·2H) × W; in place over pre
  err = filtered_gemm_mma<false>(
      (tiles >> 3) & 1, passes, GemmArgs{t, W, 0, dw, 2 * W, 0, pre, 2 * W,
                                         0, (int)(P * 2 * H), 2 * W, W},
      1, MulActGrad{act}, s);
  if (err) return err;
  // s[p] = U_hᵀ · m[p], U_hᵀ from its k-major form U_h; over v
  err = filtered_gemm_mma<true>(
      (tiles >> 4) & 1, passes, GemmArgs{uh, H, 0, pre, 2 * W, 4 * HW, t,
                                         2 * W, 2 * HW, H, 2 * W, 2 * H},
      nplanes, Identity{}, s);
  if (err) return err;
  // dx = s · U_w, s viewed as (P·H) × 2W
  return filtered_gemm_mma<false>(
      (tiles >> 5) & 1, passes,
      GemmArgsT<float, float, T>{t, 2 * W, 0, uw, W, 0, dx, W, 0,
                                 (int)(P * H), W, 2 * W},
      1, Identity{}, s);
}

}  // namespace

extern "C" int filtered_act_plane_f32(const float* x, float* out,
                                      const float* uhT, const float* uwT,
                                      const float* dwT, const float* dhT,
                                      int nplanes, int H, int W, int ppb,
                                      int tiles, int threads, int act,
                                      void* stream) {
  return plane_f32(x, out, uhT, uwT, dwT, dhT, nplanes, H, W, ppb, tiles,
                   threads, act, stream);
}

// K5 for a bf16 x: the same arguments, x and out bf16.
extern "C" int filtered_act_plane_f32_xbf16(
    const __nv_bfloat16* x, __nv_bfloat16* out, const float* uhT,
    const float* uwT, const float* dwT, const float* dhT, int nplanes, int H,
    int W, int ppb, int tiles, int threads, int act, void* stream) {
  return plane_f32(x, out, uhT, uwT, dwT, dhT, nplanes, H, W, ppb, tiles,
                   threads, act, stream);
}

// dx for P planes a block of ``threads`` (256 or 512); bit i of ``tiles``
// set gives product i + 1 4×4 micro-tiles. Operators as the kernel takes
// them: U_hᵀ, U_wᵀ, D_h, D_w, U_w, U_h, row-major.
extern "C" int filtered_act_plane_bwd_f32(
    const float* x, const float* g, float* dx, const float* uhT,
    const float* uwT, const float* dh, const float* dw, const float* uw,
    const float* uh, int nplanes, int H, int W, int ppb, int tiles,
    int threads, int act, void* stream) {
  return plane_bwd_f32(x, g, dx, uhT, uwT, dh, dw, uw, uh, nplanes, H, W,
                       ppb, tiles, threads, act, stream);
}

// K5b for a bf16 x and g: the same arguments, x, g and dx bf16.
extern "C" int filtered_act_plane_bwd_f32_xbf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, __nv_bfloat16* dx,
    const float* uhT, const float* uwT, const float* dh, const float* dw,
    const float* uw, const float* uh, int nplanes, int H, int W, int ppb,
    int tiles, int threads, int act, void* stream) {
  return plane_bwd_f32(x, g, dx, uhT, uwT, dh, dw, uw, uh, nplanes, H, W,
                       ppb, tiles, threads, act, stream);
}

// out = D_h · act(U_h · x · U_wᵀ) · D_wᵀ for P planes (one chunk), as four
// launches of the tiled GEMM; scratch holds 6·H·W floats a plane: t and
// then lo (2·H·W a plane), then hi (4·H·W). Bit i of ``tiles`` set gives
// product i + 1 the 64×64 block tile. Operators, row-major as stored:
// uwT = U_wᵀ (W×2W), uhT = U_hᵀ (H×2H), dwT = D_wᵀ (2W×W), dhT = D_hᵀ (2H×H).
extern "C" int filtered_act_banded_f32(const float* x, float* out,
                                       float* scratch, const float* uwT,
                                       const float* uhT, const float* dwT,
                                       const float* dhT, int nplanes, int H,
                                       int W, int tiles, int act,
                                       void* stream) {
  return banded_f32(x, out, scratch, uwT, uhT, dwT, dhT, nplanes, H, W,
                    tiles, act, stream);
}

// K1 for a bf16 x: the same arguments, x and out bf16 (scratch f32).
extern "C" int filtered_act_banded_f32_xbf16(
    const __nv_bfloat16* x, __nv_bfloat16* out, float* scratch,
    const float* uwT, const float* uhT, const float* dwT, const float* dhT,
    int nplanes, int H, int W, int tiles, int act, void* stream) {
  return banded_f32(x, out, scratch, uwT, uhT, dwT, dhT, nplanes, H, W,
                    tiles, act, stream);
}

// dx = U_hᵀ · [act′(U_h · x · U_wᵀ) ⊙ (D_hᵀ · g · D_w)] · U_w for P planes
// (one chunk), as six launches of the tiled GEMM; scratch holds 6·H·W
// floats a plane, as K1's: t, then v, then s (2·H·W a plane), then pre and
// m over it (4·H·W). Bit i of ``tiles`` set gives product i + 1 the 64×64
// block tile. Operators, row-major as stored: uwT = U_wᵀ (W×2W), uhT = U_hᵀ
// (H×2H), dw = D_w (W×2W), dh = D_h (H×2H), uw = U_w (2W×W), uh = U_h (2H×H).
extern "C" int filtered_act_banded_bwd_f32(
    const float* x, const float* g, float* dx, float* scratch,
    const float* uwT, const float* uhT, const float* dw, const float* dh,
    const float* uw, const float* uh, int nplanes, int H, int W, int tiles,
    int act, void* stream) {
  return banded_bwd_f32(x, g, dx, scratch, uwT, uhT, dw, dh, uw, uh, nplanes,
                        H, W, tiles, act, stream);
}

// K2 for a bf16 x and g: the same arguments, x, g and dx bf16 (scratch
// f32).
extern "C" int filtered_act_banded_bwd_f32_xbf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, __nv_bfloat16* dx,
    float* scratch, const float* uwT, const float* uhT, const float* dw,
    const float* dh, const float* uw, const float* uh, int nplanes, int H,
    int W, int tiles, int act, void* stream) {
  return banded_bwd_f32(x, g, dx, scratch, uwT, uhT, dw, dh, uw, uh, nplanes,
                        H, W, tiles, act, stream);
}

// One launch of the tiled GEMM alone, A row-major or k-major: its card
// tests' entry. C[b] = act(A[b] · B[b]) (act -1: the identity), or where
// ``mul_act_grad`` C[b] = act′(C[b]) ⊙ (A[b] · B[b]) over C's old values.
extern "C" int filtered_gemm_f32(const float* A, long long lda,
                                 long long sA, int a_kmajor, const float* B,
                                 long long ldb, long long sB, float* C,
                                 long long ldc, long long sC, int batch,
                                 int M, int N, int K, int small, int act,
                                 int mul_act_grad, void* stream) {
  using afldm_filtered::GemmArgs;
  using afldm_filtered::filtered_gemm;
  const GemmArgs g{A, lda, sA, B, ldb, sB, C, ldc, sC, M, N, K};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mul_act_grad)
    return a_kmajor
               ? filtered_gemm<true>(small, g, batch, MulActGrad{act}, s)
               : filtered_gemm<false>(small, g, batch, MulActGrad{act}, s);
  if (a_kmajor)
    return filtered_gemm<true>(small, g, batch, Activation{act}, s);
  return filtered_gemm<false>(small, g, batch, Activation{act}, s);
}

// -- the reduced precision levels' entries: ``passes`` 3 ("high") or 1
// ("default") bf16 passes a product ----------------------------------------

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

// K5b at a reduced level; the split blobs of U_hᵀ, D_h, U_wᵀ, D_w, U_w, U_h.
extern "C" int filtered_act_plane_bwd_bf16(
    const float* x, const float* g, float* dx, const __nv_bfloat16* uhT,
    const __nv_bfloat16* dh, const __nv_bfloat16* uwT,
    const __nv_bfloat16* dw, const __nv_bfloat16* uw,
    const __nv_bfloat16* uh, int nplanes, int H, int W, int ppb, int passes,
    int act, void* stream) {
  return plane_bwd_bf16(x, g, dx, uhT, dh, uwT, dw, uw, uh, nplanes, H, W,
                        ppb, passes, act, stream);
}

// K5b at a reduced level for a bf16 x and g: the same arguments, x, g and
// dx bf16.
extern "C" int filtered_act_plane_bwd_bf16_xbf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, __nv_bfloat16* dx,
    const __nv_bfloat16* uhT, const __nv_bfloat16* dh,
    const __nv_bfloat16* uwT, const __nv_bfloat16* dw,
    const __nv_bfloat16* uw, const __nv_bfloat16* uh, int nplanes, int H,
    int W, int ppb, int passes, int act, void* stream) {
  return plane_bwd_bf16(x, g, dx, uhT, dh, uwT, dw, uw, uh, nplanes, H, W,
                        ppb, passes, act, stream);
}

// K2 at a reduced level, _bwd_spatial's order, as six launches of the
// GEMM's bf16 variant; scratch as the f32 chain's: t, then v, then s
// (2·H·W a plane), then pre and m over it (4·H·W). Operators, row-major as
// stored: uhT = U_hᵀ (H×2H), uwT = U_wᵀ (W×2W), dh = D_h (H×2H), dw = D_w
// (W×2W), uh = U_h (2H×H), uw = U_w (2W×W).
extern "C" int filtered_act_banded_bwd_bf16(
    const float* x, const float* g, float* dx, float* scratch,
    const float* uhT, const float* uwT, const float* dh, const float* dw,
    const float* uh, const float* uw, int nplanes, int H, int W, int tiles,
    int passes, int act, void* stream) {
  return banded_bwd_bf16(x, g, dx, scratch, uhT, uwT, dh, dw, uh, uw,
                         nplanes, H, W, tiles, passes, act, stream);
}

// K2 at a reduced level for a bf16 x and g: the same arguments, x, g and dx
// bf16 (scratch f32).
extern "C" int filtered_act_banded_bwd_bf16_xbf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, __nv_bfloat16* dx,
    float* scratch, const float* uhT, const float* uwT, const float* dh,
    const float* dw, const float* uh, const float* uw, int nplanes, int H,
    int W, int tiles, int passes, int act, void* stream) {
  return banded_bwd_bf16(x, g, dx, scratch, uhT, uwT, dh, dw, uh, uw,
                         nplanes, H, W, tiles, passes, act, stream);
}

// One launch of the GEMM's bf16 variant alone (its card tests' entry): as
// filtered_gemm_f32, at ``passes`` bf16 passes a product.
extern "C" int filtered_gemm_bf16(const float* A, long long lda,
                                  long long sA, int a_kmajor, const float* B,
                                  long long ldb, long long sB, float* C,
                                  long long ldc, long long sC, int batch,
                                  int M, int N, int K, int small, int passes,
                                  int act, int mul_act_grad, void* stream) {
  using afldm_filtered::GemmArgs;
  using afldm_filtered::filtered_gemm_mma;
  const GemmArgs g{A, lda, sA, B, ldb, sB, C, ldc, sC, M, N, K};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mul_act_grad)
    return a_kmajor ? filtered_gemm_mma<true>(small, passes, g, batch,
                                              MulActGrad{act}, s)
                    : filtered_gemm_mma<false>(small, passes, g, batch,
                                               MulActGrad{act}, s);
  if (a_kmajor)
    return filtered_gemm_mma<true>(small, passes, g, batch, Activation{act},
                                   s);
  return filtered_gemm_mma<false>(small, passes, g, batch, Activation{act},
                                  s);
}
