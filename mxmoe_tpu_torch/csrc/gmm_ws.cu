// K15: the int8 grouped GEMMs K2 and K5 at large M, on wgmma, over the
// aligned layout whose group sizes the host knows.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:_gmm_ws_launch
// (schedule _ws_schedule, body _gmm_ws_kernel), reached through gmm_w8a8_ws
// and gmm_w4a8_packed_ws.
//
//   out[r, n] = OutT( ((float)(sum_k lhs[r,k] * w[e,k,n]) * s_a[r]) * s_b[e,n] )
//
// The body is gmm_ws_body.cuh's (the function, its bound, the walk, the
// rings and the B transform are described there), shared with K2 / K5
// above the decode rows and K14. Here the group sizes come by value in the
// launch parameters (at most 512, each a multiple of the layout's bm), so
// the walk reads them from the constant bank; rows of a group's last m-tile
// past its end are computed and not stored. The TPU kernel keeps an
// expert's weight block resident in VMEM over all of its group's m-tiles;
// here the same reuse comes from the 50 MB L2.

#include "gmm_ws_body.cuh"

namespace {

template <typename OutT, bool kPacked>
__global__ void __launch_bounds__(kWsThreads, 1)
gmm_ws_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_w,
              const float* __restrict__ s_a, const float* __restrict__ s_b,
              OutT* __restrict__ out, int M, int K, int N, int E,
              const __grid_constant__ WsSizes sizes) {
  extern __shared__ uint8_t ws_smem_raw[];
  ws_body<OutT, kPacked>(ws_smem_raw, &map_a, &map_w, s_a, s_b, out, M, K, N, E, sizes);
}

template <typename OutT, bool kPacked>
cudaError_t launch_ws(const CUtensorMap& map_a, const CUtensorMap& map_w,
                      const float* s_a, const float* s_b, void* out, int M, int K, int N,
                      int E, const WsSizes& sizes, int items, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gmm_ws_kernel<OutT, kPacked>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kWsSmemBytes);
  if (e != cudaSuccess) return e;
  const int grid = ws_grid(items);
  if (grid <= 0) return cudaErrorInvalidValue;
  gmm_ws_kernel<OutT, kPacked><<<grid, kWsThreads, kWsSmemBytes, st>>>(
      map_a, map_w, s_a, s_b, static_cast<OutT*>(out), M, K, N, E, sizes);
  return cudaGetLastError();
}

}  // namespace

// static_sizes: E host ints (at most 512), passed to the kernel by value.
// Needs K % 64 == 0, N % 16 == 0 and 16-byte aligned lhs / rhs (TMA).
extern "C" int mxmoe_gmm_ws(const void* lhs, const void* s_a, const void* rhs,
                            const void* s_b, const int* static_sizes, void* out,
                            int packed, int out_is_bf16, int M, int K, int N, int E,
                            void* stream) {
  if (E > kMaxWsGroups || E <= 0) return (int)cudaErrorInvalidValue;
  WsSizes sizes;
  int items = 0;
  const int nt = (N + WS_BN - 1) / WS_BN;
  for (int i = 0; i < E; ++i) {
    sizes.n[i] = static_sizes[i];
    items += (static_sizes[i] + WS_BM - 1) / WS_BM * nt;
  }
  for (int i = E; i < kMaxWsGroups; ++i) sizes.n[i] = 0;
  if (M == 0 || items == 0) return (int)cudaSuccess;
  CUtensorMap map_a, map_w;
  cudaError_t e = ws_encode_maps(lhs, rhs, packed != 0, M, K, N, E, &map_a, &map_w);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  if (packed)
    e = out_is_bf16
        ? launch_ws<__nv_bfloat16, true>(map_a, map_w, sa, sb, out, M, K, N, E, sizes, items, st)
        : launch_ws<float, true>(map_a, map_w, sa, sb, out, M, K, N, E, sizes, items, st);
  else
    e = out_is_bf16
        ? launch_ws<__nv_bfloat16, false>(map_a, map_w, sa, sb, out, M, K, N, E, sizes, items, st)
        : launch_ws<float, false>(map_a, map_w, sa, sb, out, M, K, N, E, sizes, items, st);
  return (int)e;
}
