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
// tensor cores, each in its TPU kernel's product order, in sources of
// their own: K5's and K5b's (filtered_act_plane_bf16,
// filtered_act_plane_bwd_bf16) as persistent walks of strips in
// filtered_plane_mma.cu, K1's and K2's (filtered_act_banded_bf16,
// filtered_act_banded_bwd_bf16) as two fused launches a chunk in
// filtered_banded_mma.cu. The GEMM's bf16 variant (filtered_gemm.cuh,
// filtered_gemm_bf16 below) stays as their products' yardstick: its chain
// gives K1's and K2's results bit for bit.
//
// bfloat16 activations (the ``_xbf16`` entries): the forward kernels K5 and
// K1 take a bf16 x and write a bf16 out, which is what the TPU kernels do
// for a bf16 x (cast to f32 inside, the products, the result cast to x's
// dtype): out = bf16(f(f32(x))). Only the edges change. K5 widens x as it
// stages it (8-byte loads of 4 elements, plain loads and stores in place
// of the f32 kernel's cp.async, which cannot convert) and its last product
// rounds each sum to bf16 in the epilogue; in K1 the chain's first product
// reads x as bf16 and its last writes out as bf16, the scratch
// intermediates unchanged. Device memory sees half the bytes of x and out;
// the products are the same. The backward kernels K5b and K2 take a bf16 x
// and g and write a bf16 dx the same way (the JAX _bwd_rule and
// _bwd_spatial cast x and g to f32 inside and write x's dtype): dx =
// bf16(vjp(f32(x), f32(g))). K5b widens x and g as it stages them and
// rounds dx in its last product's epilogue; K2's first and third GEMMs
// read x and g as bf16 and its last writes dx as bf16, the scratch
// intermediates f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "filtered_epi.cuh"
#include "filtered_gemm.cuh"
#include "filtered_mma.cuh"
#include "filtered_tile.cuh"

namespace {

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
