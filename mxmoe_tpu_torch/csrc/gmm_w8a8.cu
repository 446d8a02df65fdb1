// K2: int8 x int8 grouped GEMM over expert-sorted rows.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8
// (with its row-masked straddling tiles, _row_mask, and the logical-tile
// metadata of make_group_metadata).
//
//   out[r, n] = bf16( (float)(sum_k lhs[r,k] * rhs[e,k,n]) * s_a[r] * s_b[e,n] )
//
// for every row r of expert e's contiguous range (group_sizes on device).
// The int32 accumulation is exact, so the output equals the plain torch
// version bitwise: same f32 epilogue order ((acc * s_a) * s_b), same
// round-to-nearest-even bf16 conversion.
//
// Bound on the H100: weight bytes. Every expert a batch touches streams its
// K x N int8 weights once per m-tile (decode: 16 rows over <=16 experts is
// ~80 MB at gate_up width; prefill with 1024 rows touches all 60 experts,
// ~350 MB against ~12 GOP, still below the int8 ridge; the headline's 32762
// rows are bound by operations). Three bodies, chosen by the wrapper from
// the shapes (ops/gmm_w8a8.py::int8_gmm_schedule, bm): at decode rows one
// m16 row block, a cp.async ring of raw weight tiles and split-K (bm 16);
// above them the persistent wgmma body of gmm_ws_body.cuh over the group
// sizes in device memory (bm 128); outside that body's domain (N % 16 != 0,
// weights not 16-byte aligned) the 64 x 128 mma.sync tile (bm 64). The
// mma.sync bodies are gmm_int8_tile.cuh's (storage kInt8Stacked), shared
// with the packed-storage kernels. With E = 1 it is also the dense int8
// product of the real-quantized shared expert.

#include "gmm_int8_tile.cuh"
#include "gmm_ws_body.cuh"

extern "C" int mxmoe_gmm_w8a8(const void* lhs, const void* s_a,
                              const void* rhs, const void* s_b,
                              const void* group_sizes, void* out,
                              int out_is_bf16, int M, int K, int N, int E,
                              int bm, int grid_m, int splits, int kt_per_split,
                              void* ws, void* tickets, void* stream) {
  if (bm == WS_BM)
    return gmm_wsd_launch<false>(lhs, s_a, rhs, s_b, group_sizes, out,
                                 out_is_bf16, M, K, N, E, stream);
  return gmm_int8_launch<kInt8Stacked>(lhs, s_a, rhs, s_b, nullptr,
                                       group_sizes, nullptr, nullptr, out,
                                       out_is_bf16, M, K, N, E, bm, grid_m,
                                       splits, kt_per_split, ws, tickets, stream);
}
