// K6: weight-only (a16) grouped GEMM: bf16 activations x integer-coded
// weights, dequantized in the kernel, over expert-sorted rows.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_weight_only
// (_gmm_wq_kernel: whole-K code tile dequantized on the VPU, one bf16 MXU
// dot).
//
// rhs_q [E, K, N] int8 holds w1..w8 codes in signed storage; scale and zp
// [E, K/gsize, N] f32 (zp zeros when symmetric; asymmetric codes are stored
// re-centred so that w = q * scale + zp holds exactly). With E = 1 it is the
// dense product of a weight-only shared expert.
//
// Bound on the H100: weight bytes at decode (one byte a code plus 8 bytes of
// scale and zp per gsize codes and column); at prefill still below the bf16
// ridge. The kernel is gmm_weight_only_tile.cuh with int8 storage; it walks
// K in the packed kernel's order so that K7 equals it bitwise.
// Later work: as K2 (cp.async / TMA pipelines, wgmma, a small-M schedule).

#include "gmm_weight_only_tile.cuh"

extern "C" int mxmoe_gmm_weight_only(const void* lhs, const void* rhs_q,
                                     const void* scale, const void* zp,
                                     const void* group_sizes, void* out,
                                     int out_is_bf16, int M, int K, int N, int E,
                                     int gsize, void* stream) {
  return gmm_wo_launch<false>(lhs, rhs_q, scale, zp, group_sizes, out,
                              out_is_bf16, M, K, N, E, gsize, stream);
}
