// K4 and K4f: one-launch mixed-precision grouped GEMM over ragged per-expert
// storage, per channel (K4) and with per-k-group scales and zero points (K4f,
// the flex form).
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_mixed_packed:
// K4 its per-channel body (_gmm_mixed_packed_kernel with the per-group k-step
// metadata of make_mixed_metadata), K4f its flex bodies
// (_gmm_mixed_packed_flex_kernel and _gmm_mixed_packed_flex_straddle_kernel).
//
// rhs_cat [R, N] bytes holds, per expert and in K/2-row units, either ONE
// nibble-packed unit (pflags[e] != 0: signed 4-bit codes, halves layout) or
// TWO int8 units (a plain [K, N] int8 block); blk_offsets[e] is the expert's
// first unit. pflags and blk_offsets are device arrays read by each block.
// Same contract as K2 otherwise, and bitwise the same output as K2 on the
// int8-stored codes: the int32 sum is exact and the epilogue is K2's.
//
// Bound on the H100: weight bytes, and a packed expert streams half of
// K2's. The TPU kernel's host-built tile table is not carried over: each
// block walks group_sizes itself. Three bodies, by the wrapper's schedule
// (ops/gmm_w8a8.py::int8_gmm_schedule, ragged): at decode M the m16 tile
// of gmm_int8_tile.cuh (storage kRaggedMixed: a packed byte tile feeds two
// MMA k-steps, low nibbles against lhs columns [r0, r0+64), high nibbles
// against [K/2+r0, K/2+r0+64)); above the decode rows, inside the wgmma
// domain (K % 64 == 0, N % 16 == 0, 16-byte aligned operands), the
// persistent wgmma body of gmm_ws_body.cuh (K2's) over one 2D map of
// rhs_cat, its producer reading each group's flag and first byte row;
// elsewhere the 64 x 128 mma.sync tile.

//
// K4f: scales [M, G] / [E, G, N] and optional zero points, K8's arithmetic in
// K8's group order (gmm_grouped_tile.cuh), so bitwise K8's output on the
// int8-stored codes. The TPU kernel splits an int8 expert into two K/2 grid
// steps and needs a second int32 scratch when K/2 is no multiple of the group
// size; here a block walks logical k, an int8 expert's two units are one
// [K, N] block, and a packed expert's code row k is byte row k or k - K/2, so
// a group that spans the halves needs nothing of its own. Three bodies by
// the wrapper's schedule (ops/gmm_w8a8_grouped.py::grouped_gmm_schedule,
// mixed): at decode M the m16 x 64 ring kernel with split-K at whole groups
// (gmm_grouped_tile.cuh), which walks a packed expert's byte rows once, its
// high half's group sums held in shared memory until the low half is folded
// (the straddling group's low part is added to its held high part), or
// logical k where the hold does not fit; above the decode rows, inside the
// wgmma domain (also K % 128 == 0), K8's persistent wgmma body B
// (gmm_wq_body.cuh) over rhs_cat in half boxes; elsewhere the 32 x 128 body.
//
// rhs_rows (R): the rows of rhs_cat, which bound its TMA map.

#include "gmm_grouped_tile.cuh"
#include "gmm_wq_body.cuh"

namespace {

// K4 above the decode rows: the body over K4's ragged storage
template <typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
gmm_wsr_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, const float* __restrict__ s_a,
               const float* __restrict__ s_b, const int* __restrict__ group_sizes,
               const int* __restrict__ pflags, const int* __restrict__ blk,
               OutT* __restrict__ out, int M, int K, int N, int E) {
  extern __shared__ uint8_t wsr_smem_raw[];
  ws_body<OutT, false, WsDeviceSizes, true>(wsr_smem_raw, &map_a, &map_w, s_a, s_b, out, M,
                                            K, N, E, WsDeviceSizes{group_sizes},
                                            WsRagged{pflags, blk});
}

// K4's C entry point at bm == WS_BM: rhs_cat [R, N] in one 2D map of
// [32 byte rows x 256 columns] boxes (R = its rows). Needs K % 64 == 0, N %
// 16 == 0 and 16-byte aligned lhs / rhs_cat (TMA); pflags / blk_offsets
// int32 [E].
int gmm_wsr_launch(const void* lhs, const void* s_a, const void* rhs_cat, const void* s_b,
                   const void* group_sizes, const void* pflags, const void* blk_offsets,
                   void* out, int out_is_bf16, int M, int K, int N, int E, int R,
                   void* stream) {
  if (E <= 0 || E > kMaxExperts || K % 64 != 0 || R <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  CUtensorMap map_a, map_w;
  cudaError_t e = ws_encode_maps(lhs, rhs_cat, false, M, K, N, 1, &map_a, &map_w);
  if (e != cudaSuccess) return (int)e;
  const cuuint64_t w_dim[2] = {(cuuint64_t)N, (cuuint64_t)R};
  const cuuint64_t w_stride[1] = {(cuuint64_t)N};
  const cuuint32_t w_box[2] = {WS_BN, WS_QK};
  e = encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, rhs_cat, w_dim, w_stride, w_box,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return (int)e;
  const long long nt = (N + WS_BN - 1) / WS_BN;
  const int grid = ws_grid(((long long)(M + WS_BM - 1) / WS_BM + E) * nt);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const int* gs = static_cast<const int*>(group_sizes);
  const int* pf = static_cast<const int*>(pflags);
  const int* blk = static_cast<const int*>(blk_offsets);
  if (out_is_bf16) {
    e = cudaFuncSetAttribute(gmm_wsr_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWsSmemBytes);
    if (e != cudaSuccess) return (int)e;
    gmm_wsr_kernel<__nv_bfloat16><<<grid, kWsThreads, kWsSmemBytes, st>>>(
        map_a, map_w, sa, sb, gs, pf, blk, static_cast<__nv_bfloat16*>(out), M, K, N, E);
  } else {
    e = cudaFuncSetAttribute(gmm_wsr_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWsSmemBytes);
    if (e != cudaSuccess) return (int)e;
    gmm_wsr_kernel<float><<<grid, kWsThreads, kWsSmemBytes, st>>>(
        map_a, map_w, sa, sb, gs, pf, blk, static_cast<float*>(out), M, K, N, E);
  }
  return (int)cudaGetLastError();
}

template <typename OutT, bool kZp>
__global__ void __launch_bounds__(kThreads)
gmm_mixed_packed_flex_kernel(const int8_t* __restrict__ lhs,
                             const float* __restrict__ s_a,
                             const int8_t* __restrict__ rhs_cat,
                             const float* __restrict__ s_b,
                             const float* __restrict__ zp,
                             const int* __restrict__ group_sizes,
                             const int* __restrict__ pflags,
                             const int* __restrict__ blk_offsets,
                             OutT* __restrict__ out, int M, int K, int N, int E,
                             int gsize) {
  __shared__ __align__(16) int8_t As[GA_TILE];
  __shared__ __align__(16) uint32_t Bs[B_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end

  if (!block_tile<GBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const size_t srow = (size_t)e * (K / gsize) * N;
  grouped_tile_body<OutT, kZp, true>(
      lhs, s_a, rhs_cat + (size_t)blk_offsets[e] * (K / 2) * N, pflags[e] != 0,
      s_b + srow, kZp ? zp + srow : nullptr, out, K, N, gsize, tile_info[1],
      tile_info[2], tile_info[3], blockIdx.x * BN, As, Bs);
}

// sc: bm GBM (prefill body over grid_m logical m-tiles) or DBM (the decode
// kernel, grid_m x splits; ws / tickets when splits > 1)
template <typename OutT, bool kZp>
cudaError_t launch_flex_typed(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                              const float* s_b, const float* zp, const int* gs,
                              const int* pf, const int* blk, void* out, int M, int K,
                              int N, int E, int gsize, const Int8Schedule& sc,
                              cudaStream_t st) {
  if (M > 0) {
    OutT* o = static_cast<OutT*>(out);
    if (sc.bm == DBM) {
      dim3 grid((N + DBN - 1) / DBN, sc.grid_m, sc.splits);
      gmm_grouped_decode_kernel<OutT, kZp, true><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, pf, blk, o, sc.ws, sc.tickets, M, K, N, E,
          gsize, sc.kt_per_split);
    } else if (sc.bm == GBM) {
      dim3 grid((N + BN - 1) / BN, sc.grid_m);
      gmm_mixed_packed_flex_kernel<OutT, kZp><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, pf, blk, o, M, K, N, E, gsize);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_flex(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                        const float* s_b, const float* zp, const int* gs,
                        const int* pf, const int* blk, void* out, int M, int K,
                        int N, int E, int gsize, const Int8Schedule& sc,
                        cudaStream_t st) {
  return zp != nullptr
      ? launch_flex_typed<OutT, true>(lhs, s_a, rhs, s_b, zp, gs, pf, blk, out, M,
                                      K, N, E, gsize, sc, st)
      : launch_flex_typed<OutT, false>(lhs, s_a, rhs, s_b, zp, gs, pf, blk, out, M,
                                       K, N, E, gsize, sc, st);
}

}  // namespace

extern "C" int mxmoe_gmm_mixed_packed(const void* lhs, const void* s_a,
                                      const void* rhs_cat, const void* s_b,
                                      const void* group_sizes,
                                      const void* pflags,
                                      const void* blk_offsets, void* out,
                                      int out_is_bf16, int M, int K, int N,
                                      int E, int rhs_rows, int bm, int grid_m,
                                      int splits, int kt_per_split, void* ws,
                                      void* tickets, void* stream) {
  if (bm == WS_BM)
    return gmm_wsr_launch(lhs, s_a, rhs_cat, s_b, group_sizes, pflags, blk_offsets, out,
                          out_is_bf16, M, K, N, E, rhs_rows, stream);
  return gmm_int8_launch<kRaggedMixed>(lhs, s_a, rhs_cat, s_b, nullptr,
                                       group_sizes, pflags, blk_offsets, out,
                                       out_is_bf16, M, K, N, E, bm, grid_m,
                                       splits, kt_per_split, ws, tickets, stream);
}

// zp may be null (no asymmetric scheme: the row-sum term is compiled out);
// the schedule as mxmoe_gmm_mixed_packed's
extern "C" int mxmoe_gmm_mixed_packed_flex(const void* lhs, const void* s_a,
                                           const void* rhs_cat, const void* s_b,
                                           const void* zp,
                                           const void* group_sizes,
                                           const void* pflags,
                                           const void* blk_offsets, void* out,
                                           int out_is_bf16, int M, int K, int N,
                                           int E, int rhs_rows, int gsize, int bm,
                                           int grid_m, int splits, int kt_per_split,
                                           void* ws, void* tickets, void* stream) {
  if (bm == WQ_BM)
    return gmm_wq_launch<kWqGroupedRagged, false>(nullptr, lhs, s_a, rhs_cat, s_b, zp,
                                                  nullptr, group_sizes, out, out_is_bf16,
                                                  M, K, N, E, gsize, stream, pflags,
                                                  blk_offsets, rhs_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* b = static_cast<const int8_t*>(rhs_cat);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const float* z = static_cast<const float*>(zp);
  const int* gs = static_cast<const int*>(group_sizes);
  const int* pf = static_cast<const int*>(pflags);
  const int* blk = static_cast<const int*>(blk_offsets);
  const Int8Schedule sc{bm, grid_m, splits, kt_per_split, static_cast<int*>(ws),
                        static_cast<int*>(tickets)};
  cudaError_t err = out_is_bf16
      ? launch_flex<__nv_bfloat16>(a, sa, b, sb, z, gs, pf, blk, out, M, K, N, E,
                                   gsize, sc, st)
      : launch_flex<float>(a, sa, b, sb, z, gs, pf, blk, out, M, K, N, E, gsize, sc,
                           st);
  return (int)err;
}
