// Attribution probes of the flash-attention forward (K3), f32: two kernels
// with K3's grid and loads whose arithmetic is cut down, so that
// flash - dots_only is the online softmax's share of K3's time and
// stream_only is the share of its loads.
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
// K3 it rereads each K/V tile once per Q tile (Lq/64 times), so it measures
// what K3's load pattern costs, which is the point of the probe.
//
// What the design does: it is K3's (flash_fwd.cu) grid, block and loads,
// unchanged: one 256-thread block per (b·h, 64-row Q tile), each 64-row
// K/V tile staged in shared memory (rows padded to DP+1 floats), D
// zero-padded to DP in {32, 64, 128, 256}, q/k/v read through (b1, b2, row)
// strides (stride-0 K/V allowed). Four threads share a Q row and each keeps
// DP/4 of its accumulator in registers. The wrappers require Lq and Lk to
// be multiples of 64, so no row is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 per Q row
constexpr int kPLD = kBK + 1;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B2, Lq, Lk, D;
  long long qs1, qs2, qsl, ks1, ks2, ksl, vs1, vs2, vsl;
  int n_qtiles;
};

// Stages this block's Q tile; returns the (b, q0) it covers and sets the
// K/V base pointers.
template <int DP>
__device__ __forceinline__ void stage_q(const Args& a, float* Qs, int& b,
                                        int& q0, const float*& kb,
                                        const float*& vb) {
  constexpr int LD = DP + 1;
  b = blockIdx.x / a.n_qtiles;
  q0 = (blockIdx.x - b * a.n_qtiles) * kBQ;
  const int b1 = b / a.B2, b2 = b - b1 * a.B2;
  const float* qb = a.q + b1 * a.qs1 + b2 * a.qs2;
  kb = a.k + b1 * a.ks1 + b2 * a.ks2;
  vb = a.v + b1 * a.vs1 + b2 * a.vs2;
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    const int rr = i / DP, d = i - rr * DP;
    Qs[rr * LD + d] = d < a.D ? qb[(long long)(q0 + rr) * a.qsl + d] : 0.0f;
  }
}

template <int DP>
__device__ __forceinline__ void stage_kv(const Args& a, const float* kb,
                                         const float* vb, int k0, float* Ks,
                                         float* Vs) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < kBK * DP; i += kThreads) {
    const int rr = i / DP, d = i - rr * DP;
    const bool ok = d < a.D;
    Ks[rr * LD + d] = ok ? kb[(long long)(k0 + rr) * a.ksl + d] : 0.0f;
    Vs[rr * LD + d] = ok ? vb[(long long)(k0 + rr) * a.vsl + d] : 0.0f;
  }
}

template <int DP>
__device__ __forceinline__ void store_out(const Args& a, int b, int q0,
                                          const float* acc) {
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  float* ob = a.out + ((long long)b * a.Lq + q0 + r) * a.D;
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) {
    const int d = c4 + 4 * j;
    if (d < a.D) ob[d] = acc[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) dots_kernel(Args a) {
  constexpr int LD = DP + 1;
  constexpr int NACC = DP / 4;
  extern __shared__ float sm[];
  float* Qs = sm;                 // kBQ × LD
  float* Ks = Qs + kBQ * LD;      // kBK × LD
  float* Vs = Ks + kBK * LD;      // kBK × LD
  float* Ps = Vs + kBK * LD;      // kBQ × kPLD

  int b, q0;
  const float *kb, *vb;
  stage_q<DP>(a, Qs, b, q0, kb, vb);
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < a.Lk; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs are no longer read
    stage_kv<DP>(a, kb, vb, k0, Ks, Vs);
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.0f;
    for (int d = 0; d < DP; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j)
        s[j] = fmaf(qv, Ks[(c4 + 4 * j) * LD + d], s[j]);
    }
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) Ps[r * kPLD + c4 + 4 * j] = s[j];
    __syncwarp();  // a row's P is written and read by the same 4 lanes

    for (int kk = 0; kk < kBK; ++kk) {
      const float p = Ps[r * kPLD + kk];
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        acc[j] = fmaf(p, Vs[kk * LD + c4 + 4 * j], acc[j]);
    }
  }
  store_out<DP>(a, b, q0, acc);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) stream_kernel(Args a) {
  constexpr int LD = DP + 1;
  constexpr int NACC = DP / 4;
  extern __shared__ float sm[];
  float* Qs = sm;                 // kBQ × LD
  float* Ks = Qs + kBQ * LD;      // kBK × LD
  float* Vs = Ks + kBK * LD;      // kBK × LD
  float* Cs = Vs + kBK * LD;      // 2 × DP: the tile's column sums of k, v

  int b, q0;
  const float *kb, *vb;
  stage_q<DP>(a, Qs, b, q0, kb, vb);
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < a.Lk; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Cs are no longer read
    stage_kv<DP>(a, kb, vb, k0, Ks, Vs);
    __syncthreads();
    // one thread per column of k or of v sums the tile's 64 rows
    for (int c = threadIdx.x; c < 2 * DP; c += kThreads) {
      const float* src = c < DP ? Ks + c : Vs + (c - DP);
      float sum = 0.0f;
      for (int rr = 0; rr < kBK; ++rr) sum += src[rr * LD];
      Cs[c] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = c4 + 4 * j;
      acc[j] += Qs[r * LD + d] + Cs[d] + Cs[DP + d];
    }
  }
  store_out<DP>(a, b, q0, acc);
}

template <typename Kernel>
int go(Kernel kernel, const Args& a, int B1, size_t smem,
       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B1 * a.B2 * a.n_qtiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP, bool kDots>
int launch(const Args& a, int B1, cudaStream_t stream) {
  const size_t stage = (size_t)(kBQ + 2 * kBK) * (DP + 1);
  if constexpr (kDots)
    return go(dots_kernel<DP>, a, B1,
              (stage + (size_t)kBQ * kPLD) * sizeof(float), stream);
  else
    return go(stream_kernel<DP>, a, B1, (stage + 2 * DP) * sizeof(float),
              stream);
}

template <bool kDots>
int dispatch(const float* q, const float* k, const float* v, float* out,
             int B1, int B2, int Lq, int Lk, int D, long long qs1,
             long long qs2, long long qsl, long long ks1, long long ks2,
             long long ksl, long long vs1, long long vs2, long long vsl,
             void* stream) {
  if (Lq % kBQ != 0 || Lk % kBK != 0 || Lq == 0 || Lk == 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   out, B2,  Lq,  Lk,  D,   qs1,         qs2,
               qsl, ks1, ks2, ksl, vs1, vs2, vsl, Lq / kBQ};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<32, kDots>(a, B1, s);
  if (D <= 64) return launch<64, kDots>(a, B1, s);
  if (D <= 128) return launch<128, kDots>(a, B1, s);
  if (D <= 256) return launch<256, kDots>(a, B1, s);
  return (int)cudaErrorInvalidValue;
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
  return dispatch<true>(q, k, v, out, B1, B2, Lq, Lk, D, qs1, qs2, qsl, ks1,
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
  return dispatch<false>(q, k, v, out, B1, B2, Lq, Lk, D, qs1, qs2, qsl, ks1,
                         ks2, ksl, vs1, vs2, vsl, stream);
}
