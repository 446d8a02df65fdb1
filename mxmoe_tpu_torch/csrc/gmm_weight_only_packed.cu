// K7: weight-only (a16) grouped GEMM over nibble-packed 4-bit weights.
//
// Replaces the Pallas kernel
// mxmoe_tpu/ops/pallas_gmm.py:gmm_weight_only_packed (_gmm_wqp_kernel: VPU
// nibble unpack and dequant ahead of the bf16 MXU dot).
//
// rhs_packed [E, K/2, N] bytes in the halves layout (byte row r: code k = r
// in the low nibble, k = r + K/2 in the high nibble, both signed 4-bit);
// scale and zp [E, K/gsize, N] f32 index the codes' own k, so the high
// nibble of byte row r takes group (K/2 + r) / gsize. Same contract as K6
// otherwise and bitwise K6's output on the unpacked codes (one walk over K
// for both storages).
//
// Bound on the H100: weight bytes, half of K6's codes plus the same scale and
// zp bytes. The kernel is gmm_weight_only_tile.cuh with packed storage (the
// schedule as K6's): the prefill body splits one byte tile in registers
// into the two code tiles of a step; the decode body reads one byte tile a
// pair and dequantizes its low and high nibbles for the two halves.

#include "gmm_weight_only_tile.cuh"

extern "C" int mxmoe_gmm_weight_only_packed(const void* lhs,
                                            const void* rhs_packed,
                                            const void* scale, const void* zp,
                                            const void* group_sizes, void* out,
                                            int out_is_bf16, int M, int K, int N,
                                            int E, int gsize, int bm, int grid_m,
                                            int splits, int kt_per_split, void* ws,
                                            void* tickets, void* stream) {
  return gmm_wo_launch<true>(lhs, rhs_packed, scale, zp, group_sizes, out,
                             out_is_bf16, M, K, N, E, gsize, bm, grid_m, splits,
                             kt_per_split, ws, tickets, stream);
}
