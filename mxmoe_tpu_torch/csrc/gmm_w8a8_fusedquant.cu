// K14: int8 grouped GEMM with the per-token activation quant in the launch.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_fusedquant
// (body _gmm_q8_fused_kernel).
//
//   scale[r] = max(amax_k |x[r,k]|, 1e-8) / upper      (IEEE division, as K1)
//   q[r,k]   = rint(x[r,k] / scale[r])                 (half to even, int8)
//   out[r,n] = OutT( (float)(sum_k q[r,k] * w[e,k,n]) * scale[r] * s_b[e,n] )
//
// Bitwise K1 (act_quant.cu) followed by K2 (gmm_w8a8.cu): the same f32
// values, the same division and rounding, an exact int32 sum and K2's
// epilogue order. No --use_fast_math (the codes depend on IEEE division).
//
// Bound on the H100: weight bytes at decode and at a prefill chunk (as K2),
// operations at the headline's rows. Two bodies, chosen by the wrapper from
// M (ops/gmm_w8a8_fusedquant.py::fusedquant_schedule, no sync):
// * Decode (M <= 64): K2's m16 ring body and schedule (gmm_int8_tile.cuh,
//   gmm_int8_decode_kernel with InT bf16 / f32). A block takes the amax of
//   each of its 16 rows over all of K (a warp a row, from L2; every split of
//   K forms the same scale) while its first weight stages are in flight;
//   each k-tile's activations then come into registers two k-tiles ahead
//   and are quantized into the A stage, each value once a block; only
//   weight tiles go through the cp.async ring. Rows outside the block's
//   expert (most of a decode block's 16) are zeros without a division: a
//   zero over their tiny scale took IEEE division's slow path (0.077 against
//   0.049 device ms at qwen2_moe's decode gate_up on an H100). Quantizing a
//   split's whole k-range into shared memory first held 16 KB a block more
//   and took 0.063 (PERF.md).
// * Large M: one cooperative launch of the persistent wgmma body in two
//   phases. Every CTA first quantizes a share of the rows (a warp a row, K1's
//   arithmetic) into an int8 workspace and f32 scales; a grid barrier
//   follows (the CTAs are co-resident: the cooperative launch refuses a grid
//   the card cannot hold at once; the counter resets itself, its last
//   arriver zeroing it, so a captured launch can be replayed; a wait traps
//   after ~10 s); then the CTAs walk gmm_ws_body.cuh's items over the codes,
//   with the group sizes read on the device. The codes are quantized once
//   and fed by TMA like K2's, where a body that quantized in the walk would
//   redo every row for each of its n-tiles and double the A feed from L2,
//   the body's measured limit (PERF.md).
// Outside the bodies' domain (N % 16 != 0, weights not 16-byte aligned) the
// wrapper runs K1 + K2.

#include "gmm_int8_tile.cuh"
#include "gmm_ws_body.cuh"

namespace {

// the rows of this CTA's share (a warp a row) -> codes and scales, K1's
// arithmetic. A lane holds up to 8 chunks of 8 values: a row of K <= 2048
// is read once, a wider one twice (amax, then codes).
// the amax of a lane's chunks c0 + lane + 32 i of a row
template <typename InT, int kSeg>
__device__ __forceinline__ float fq_seg_amax(const Raw8<InT> (&r)[kSeg], int c0, int lane,
                                             int chunks, float amax) {
#pragma unroll
  for (int i = 0; i < kSeg; ++i)
    if (c0 + lane + 32 * i < chunks) {
      float v[8];
      r[i].values(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
  return amax;
}

template <typename InT, int kSeg>
__device__ __forceinline__ void fq_seg_load(Raw8<InT> (&r)[kSeg], const InT* xr, int c0,
                                            int lane, int chunks) {
#pragma unroll
  for (int i = 0; i < kSeg; ++i)
    if (c0 + lane + 32 * i < chunks) r[i].load(xr + 8 * (c0 + lane + 32 * i));
}

template <typename InT, int kSeg>
__device__ __forceinline__ void fq_seg_store(const Raw8<InT> (&r)[kSeg], int8_t* qr,
                                             int c0, int lane, int chunks, float s) {
#pragma unroll
  for (int i = 0; i < kSeg; ++i)
    if (c0 + lane + 32 * i < chunks) {
      float v[8];
      r[i].values(v);
      *reinterpret_cast<uint2*>(qr + 8 * (c0 + lane + 32 * i)) = fq_codes8(v, s);
    }
}

__device__ __forceinline__ float warp_amax(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// the rows of this CTA's share (a warp a row) -> codes and scales, K1's
// arithmetic. A lane holds up to 8 chunks of 8 values: a row of K <= 2048
// is read once, and the warp's next row is loaded while this one is
// quantized; a wider row is read twice (amax, then codes).
template <typename InT>
__device__ __forceinline__ void fq_quantize_rows(const InT* __restrict__ x,
                                                 int8_t* __restrict__ q,
                                                 float* __restrict__ scale, float upper,
                                                 int M, int K) {
  constexpr int kSeg = 8;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kWsThreads / 32);
  const int chunks = K / 8;
  int row = blockIdx.x * (kWsThreads / 32) + (threadIdx.x >> 5);
  if (chunks <= 32 * kSeg) {
    Raw8<InT> cur[kSeg], nxt[kSeg];
    if (row < M) fq_seg_load(cur, x + (size_t)row * K, 0, lane, chunks);
    for (; row < M; row += warps) {
      if (row + warps < M) fq_seg_load(nxt, x + (size_t)(row + warps) * K, 0, lane, chunks);
      const float s = fq_scale(warp_amax(fq_seg_amax(cur, 0, lane, chunks, 0.f)), upper);
      if (lane == 0) scale[row] = s;
      fq_seg_store(cur, q + (size_t)row * K, 0, lane, chunks, s);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) cur[i] = nxt[i];
    }
    return;
  }
  for (; row < M; row += warps) {
    const InT* xr = x + (size_t)row * K;
    Raw8<InT> r[kSeg];
    float amax = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += 32 * kSeg) {
      fq_seg_load(r, xr, c0, lane, chunks);
      amax = fq_seg_amax(r, c0, lane, chunks, amax);
    }
    const float s = fq_scale(warp_amax(amax), upper);
    if (lane == 0) scale[row] = s;
    for (int c0 = 0; c0 < chunks; c0 += 32 * kSeg) {
      fq_seg_load(r, xr, c0, lane, chunks);
      fq_seg_store(r, q + (size_t)row * K, c0, lane, chunks, s);
    }
  }
}

// every CTA of the grid reaches this point before any leaves it. bar[0]
// counts arrivals, bar[1] is the generation; the last arriver zeroes the
// count before it opens the next generation.
__device__ __forceinline__ void fq_grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen_p = bar + 1;
    const unsigned gen = *gen_p;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen_p == gen) {
        if (clock64() - t0 > (1ll << 35)) __trap();
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
gmm_fq_ws_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const InT* __restrict__ x,
                 int8_t* __restrict__ q, float* __restrict__ scale,
                 const float* __restrict__ s_b, const int* __restrict__ group_sizes,
                 OutT* __restrict__ out, unsigned* __restrict__ bar, float upper, int M,
                 int K, int N, int E) {
  extern __shared__ uint8_t fq_smem_raw[];
  fq_quantize_rows<InT>(x, q, scale, upper, M, K);
  fence_proxy_async_global();          // the codes, for the TMA reads below
  fq_grid_sync(bar);
  fence_proxy_async_global();
  ws_body<OutT, false>(fq_smem_raw, &map_a, &map_w, scale, s_b, out, M, K, N, E,
                       WsDeviceSizes{group_sizes});
}

template <typename InT, typename OutT>
cudaError_t launch_fq_ws(const void* x, const void* rhs, const float* s_b, const int* gs,
                         void* out, int8_t* q, float* scale, unsigned* bar, float upper,
                         int M, int K, int N, int E, cudaStream_t st) {
  CUtensorMap map_a, map_w;
  cudaError_t e = ws_encode_maps(q, rhs, false, M, K, N, E, &map_a, &map_w);
  if (e != cudaSuccess) return e;
  auto kernel = gmm_fq_ws_kernel<InT, OutT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kWsSmemBytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWsThreads,
                                                    kWsSmemBytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || sm_count() < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(sm_count());
  cfg.blockDim = dim3(kWsThreads);
  cfg.dynamicSmemBytes = kWsSmemBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, static_cast<const InT*>(x), q, scale,
                         s_b, gs, static_cast<OutT*>(out), bar, upper, M, K, N, E);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_fq_decode(const void* x, const int8_t* rhs, const float* s_b,
                             const int* gs, void* out, int* ws, int* tickets, float upper,
                             int M, int K, int N, int E, int grid_m, int splits,
                             int kt_per_split, cudaStream_t st) {
  dim3 grid((N + DBN - 1) / DBN, grid_m, splits);
  gmm_int8_decode_kernel<OutT, kInt8Stacked, false, InT><<<grid, kThreads, 0, st>>>(
      nullptr, nullptr, rhs, s_b, nullptr, gs, nullptr, nullptr, static_cast<OutT*>(out),
      ws, tickets, M, K, N, E, kt_per_split, static_cast<const InT*>(x), upper);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_fq(const void* x, const void* rhs, const float* s_b, const int* gs,
                      void* out, float upper, int M, int K, int N, int E, int bm,
                      int grid_m, int splits, int kt_per_split, int* ws, int* tickets,
                      int8_t* q, float* scale, unsigned* bar, cudaStream_t st) {
  if (M == 0) return cudaGetLastError();
  if (bm == DBM)
    return launch_fq_decode<InT, OutT>(x, static_cast<const int8_t*>(rhs), s_b, gs, out,
                                       ws, tickets, upper, M, K, N, E, grid_m, splits,
                                       kt_per_split, st);
  if (bm == WS_BM)
    return launch_fq_ws<InT, OutT>(x, rhs, s_b, gs, out, q, scale, bar, upper, M, K, N,
                                   E, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// schedule (ops/gmm_w8a8_fusedquant.py::fusedquant_schedule): bm 16 (the
// decode body: grid_m, splits, kt_per_split, and with splits > 1 the split-K
// workspace and zeroed tickets) or 128 (the cooperative wgmma body: q_ws
// [M, K] int8 and s_ws [M] f32 workspaces, and `barrier`, two uint32 zeroed
// once: a launch leaves the count at zero and advances the generation).
extern "C" int mxmoe_gmm_w8a8_fusedquant(const void* lhs, int lhs_is_bf16,
                                         const void* rhs, const void* s_b,
                                         const void* group_sizes, void* out,
                                         int out_is_bf16, float upper, int M, int K,
                                         int N, int E, int bm, int grid_m, int splits,
                                         int kt_per_split, void* ws, void* tickets,
                                         void* q_ws, void* s_ws, void* barrier,
                                         void* stream) {
  if (E <= 0 || E > kMaxExperts) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sb = static_cast<const float*>(s_b);
  const int* gs = static_cast<const int*>(group_sizes);
  int* w = static_cast<int*>(ws);
  int* tk = static_cast<int*>(tickets);
  int8_t* q = static_cast<int8_t*>(q_ws);
  float* sc = static_cast<float*>(s_ws);
  unsigned* bar = static_cast<unsigned*>(barrier);
  cudaError_t e;
  if (lhs_is_bf16)
    e = out_is_bf16
        ? launch_fq<__nv_bfloat16, __nv_bfloat16>(lhs, rhs, sb, gs, out, upper, M, K, N, E,
                                                  bm, grid_m, splits, kt_per_split, w, tk,
                                                  q, sc, bar, st)
        : launch_fq<__nv_bfloat16, float>(lhs, rhs, sb, gs, out, upper, M, K, N, E, bm,
                                          grid_m, splits, kt_per_split, w, tk, q, sc, bar,
                                          st);
  else
    e = out_is_bf16
        ? launch_fq<float, __nv_bfloat16>(lhs, rhs, sb, gs, out, upper, M, K, N, E, bm,
                                          grid_m, splits, kt_per_split, w, tk, q, sc, bar,
                                          st)
        : launch_fq<float, float>(lhs, rhs, sb, gs, out, upper, M, K, N, E, bm, grid_m,
                                  splits, kt_per_split, w, tk, q, sc, bar, st);
  return (int)e;
}
