// K5: int8 activations x nibble-packed 4-bit weights, grouped over
// expert-sorted rows.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w4a8_packed
// (_gmm_q4p_kernel: VPU nibble unpack feeding the int8 MXU).
//
// rhs_packed [E, K/2, N] bytes, every expert in the halves layout (byte row
// r: code k = r in the low nibble, k = r + K/2 in the high nibble). Same
// contract and epilogue as K2; bitwise equal to K2 on the unpacked codes
// and to K4 on an all-packed ragged buffer.
//
// Bound on the H100: weight bytes, half of K2's for the same codes. K2's
// three bodies, chosen the same way: gmm_int8_tile.cuh with storage
// kPackedStacked (expert g starts at g * K/2 * N and every byte tile feeds
// two MMA k-steps) at decode rows and outside the wgmma domain (also K % 64
// != 0), the wgmma body of gmm_ws_body.cuh (packed: quarter boxes of low or
// high nibbles) above them.

#include "gmm_int8_tile.cuh"
#include "gmm_ws_body.cuh"

extern "C" int mxmoe_gmm_w4a8_packed(const void* lhs, const void* s_a,
                                     const void* rhs_packed, const void* s_b,
                                     const void* group_sizes, void* out,
                                     int out_is_bf16, int M, int K, int N,
                                     int E, int bm, int grid_m, int splits,
                                     int kt_per_split, void* ws, void* tickets,
                                     void* stream) {
  if (bm == WS_BM)
    return gmm_wsd_launch<true>(lhs, s_a, rhs_packed, s_b, group_sizes, out,
                                 out_is_bf16, M, K, N, E, stream);
  return gmm_int8_launch<kPackedStacked>(lhs, s_a, rhs_packed, s_b, nullptr,
                                         group_sizes, nullptr, nullptr, out,
                                         out_is_bf16, M, K, N, E, bm, grid_m,
                                         splits, kt_per_split, ws, tickets, stream);
}
