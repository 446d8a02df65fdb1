// K8: grouped-scale (g128-class) int8 x int8 grouped GEMM over
// expert-sorted rows, with an optional asymmetric-weight zero-point term.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_grouped
// (_grouped_accum and its four bodies, with and without rhs_zp, k-blocked or
// not).
//
// The arithmetic and the walk over K are gmm_grouped_tile.cuh's. Three
// bodies, as the wrapper's schedule says (ops/gmm_w8a8_grouped.py::
// grouped_gmm_schedule with wgmma): at decode M gmm_grouped_decode_kernel
// (m16 x 64 tiles, a cp.async ring of raw weight tiles and fold operands,
// split-K at whole groups); above the decode rows the persistent wgmma body
// B of gmm_wq_body.cuh (bm 128, 128 x 128 items, inside its domain: gsize a
// multiple of 128 or all of K); the 32 x 128 prefill body grouped_tile_body
// elsewhere (shared with the flex form of gmm_mixed_packed). The int32
// group sums are exact and every body folds them in ascending group order,
// so all three give the same bits. This file feeds them int8-stored
// experts, rhs [E, K, N]. With E = 1 it is the dense product of a grouped /
// asymmetric shared expert; with G = 1 a per-channel product.
//
// Bound on the H100: weight bytes (codes; the f32 scales and zero points add
// 4 or 8 bytes per 128 codes and column), operations from a few thousand
// rows an expert on.

#include "gmm_grouped_tile.cuh"
#include "gmm_wq_body.cuh"

namespace {

template <typename OutT, bool kZp>
__global__ void __launch_bounds__(kThreads)
gmm_grouped_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
                   const int8_t* __restrict__ rhs, const float* __restrict__ s_b,
                   const float* __restrict__ zp,
                   const int* __restrict__ group_sizes, OutT* __restrict__ out,
                   int M, int K, int N, int E, int gsize) {
  __shared__ __align__(16) int8_t As[GA_TILE];
  __shared__ __align__(16) uint32_t Bs[B_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end

  if (!block_tile<GBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const size_t srow = (size_t)e * (K / gsize) * N;
  grouped_tile_body<OutT, kZp, false>(
      lhs, s_a, rhs + (size_t)e * K * N, false, s_b + srow,
      kZp ? zp + srow : nullptr, out, K, N, gsize, tile_info[1], tile_info[2],
      tile_info[3], blockIdx.x * BN, As, Bs);
}

// sc: bm GBM (the 32 x 128 body over grid_m logical m-tiles) or DBM (the
// decode kernel, grid_m x splits; ws / tickets when splits > 1)
template <typename OutT, bool kZp>
cudaError_t launch_grouped_typed(const int8_t* lhs, const float* s_a,
                                 const int8_t* rhs, const float* s_b,
                                 const float* zp, const int* gs, void* out, int M,
                                 int K, int N, int E, int gsize,
                                 const Int8Schedule& sc, cudaStream_t st) {
  if (M > 0) {
    OutT* o = static_cast<OutT*>(out);
    if (sc.bm == DBM) {
      dim3 grid((N + DBN - 1) / DBN, sc.grid_m, sc.splits);
      gmm_grouped_decode_kernel<OutT, kZp, false><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, nullptr, nullptr, o, sc.ws, sc.tickets, M, K,
          N, E, gsize, sc.kt_per_split);
    } else if (sc.bm == GBM) {
      dim3 grid((N + BN - 1) / BN, sc.grid_m);
      gmm_grouped_kernel<OutT, kZp><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, o, M, K, N, E, gsize);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_grouped(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                           const float* s_b, const float* zp, const int* gs,
                           void* out, int M, int K, int N, int E, int gsize,
                           const Int8Schedule& sc, cudaStream_t st) {
  return zp != nullptr
      ? launch_grouped_typed<OutT, true>(lhs, s_a, rhs, s_b, zp, gs, out, M, K, N,
                                         E, gsize, sc, st)
      : launch_grouped_typed<OutT, false>(lhs, s_a, rhs, s_b, zp, gs, out, M, K, N,
                                          E, gsize, sc, st);
}

}  // namespace

// zp may be null (symmetric weights: the row-sum term is compiled out); the
// schedule as mxmoe_gmm_w8a8's: bm, grid_m, splits, k-tiles per split,
// workspace, tickets
extern "C" int mxmoe_gmm_w8a8_grouped(const void* lhs, const void* s_a,
                                      const void* rhs, const void* s_b,
                                      const void* zp, const void* group_sizes,
                                      void* out, int out_is_bf16, int M, int K,
                                      int N, int E, int gsize, int bm, int grid_m,
                                      int splits, int kt_per_split, void* ws,
                                      void* tickets, void* stream) {
  if (bm == WQ_BM)
    return gmm_wq_launch<kWqGrouped, false>(nullptr, lhs, s_a, rhs, s_b, zp, nullptr,
                                            group_sizes, out, out_is_bf16, M, K, N, E,
                                            gsize, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const float* z = static_cast<const float*>(zp);
  const int* gs = static_cast<const int*>(group_sizes);
  const Int8Schedule sc{bm, grid_m, splits, kt_per_split, static_cast<int*>(ws),
                        static_cast<int*>(tickets)};
  cudaError_t err = out_is_bf16
      ? launch_grouped<__nv_bfloat16>(a, sa, b, sb, z, gs, out, M, K, N, E, gsize,
                                      sc, st)
      : launch_grouped<float>(a, sa, b, sb, z, gs, out, M, K, N, E, gsize, sc, st);
  return (int)err;
}
