// K9: int8 x int8 grouped GEMM with per-channel ASYMMETRIC weights.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_asym
// (_gmm_q8_asym_kernel: int32 accumulator and row-sum scratch carried over
// the k grid axis).
//
// Asymmetric codes are stored re-centred (w = q * s_w + zp, q signed), so
//
//   out[r, n] = OutT( (float)(sum_k a[r,k] * q[e,k,n]) * s_a[r] * s_w[e,n]
//                   + (float)(sum_k a[r,k])            * s_a[r] * zp[e,n] )
//
// Both sums are exact int32, and the epilogue rounds each product and the
// final sum separately (no FMA), so the output equals the plain torch
// version bitwise.
//
// Bound on the H100: weight bytes, as K2, operations from a few thousand
// rows an expert on. Three bodies, by the wrapper's schedule
// (ops/gmm_w8a8_asym.py::asym_gmm_schedule): at decode M and outside the
// wgmma domain gmm_int8_tile.cuh (storage kInt8Stacked) with kAsym set,
// the row sums taken from the A fragments each MMA step already holds in
// registers (the m16 tile with split-K, or the 64 x 128 tile); above the
// decode rows, inside the domain (N % 16 == 0, 16-byte aligned operands),
// K8's persistent wgmma body B of gmm_wq_body.cuh with one group (gsize =
// K) and the zero points, whose fold is this function in this order, so
// K9 is bitwise K8 with one group and zp.

#include "gmm_int8_tile.cuh"
#include "gmm_wq_body.cuh"

extern "C" int mxmoe_gmm_w8a8_asym(const void* lhs, const void* s_a,
                                   const void* rhs, const void* s_b,
                                   const void* zp, const void* group_sizes,
                                   void* out, int out_is_bf16, int M, int K,
                                   int N, int E, int bm, int grid_m, int splits,
                                   int kt_per_split, void* ws, void* tickets,
                                   void* stream) {
  if (bm == WQ_BM)
    return gmm_wq_launch<kWqGrouped, false>(nullptr, lhs, s_a, rhs, s_b, zp, nullptr,
                                            group_sizes, out, out_is_bf16, M, K, N, E, K,
                                            stream);
  return gmm_int8_launch<kInt8Stacked, true>(lhs, s_a, rhs, s_b, zp,
                                             group_sizes, nullptr, nullptr, out,
                                             out_is_bf16, M, K, N, E, bm, grid_m,
                                             splits, kt_per_split, ws, tickets,
                                             stream);
}
