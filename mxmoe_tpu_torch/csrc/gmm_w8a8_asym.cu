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
// Bound on the H100: weight bytes, as K2. The kernel is gmm_int8_tile.cuh
// (storage kInt8Stacked) with kAsym set: the row sums are taken from the A
// fragments each MMA step already holds in registers, so the zero-point
// term costs no pass over the activations and no second kernel.

#include "gmm_int8_tile.cuh"

extern "C" int mxmoe_gmm_w8a8_asym(const void* lhs, const void* s_a,
                                   const void* rhs, const void* s_b,
                                   const void* zp, const void* group_sizes,
                                   void* out, int out_is_bf16, int M, int K,
                                   int N, int E, int bm, int grid_m, int splits,
                                   int kt_per_split, void* ws, void* tickets,
                                   void* stream) {
  return gmm_int8_launch<kInt8Stacked, true>(lhs, s_a, rhs, s_b, zp,
                                             group_sizes, nullptr, nullptr, out,
                                             out_is_bf16, M, K, N, E, bm, grid_m,
                                             splits, kt_per_split, ws, tickets,
                                             stream);
}
