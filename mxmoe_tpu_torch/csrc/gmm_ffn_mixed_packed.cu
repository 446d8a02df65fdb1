// K13: the whole expert FFN in one launch over the ragged packed buffers.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_ffn_mixed_packed
// (body _gmm_ffn_packed_kernel): K12's function (gmm_ffn_w8a8.cu) with the
// weights in K4's storage, gate_up gu_cat [R1, 2N] and down down_cat [R2, H]:
// expert e starts at unit blk[e] (K/2 rows of gate_up, N/2 rows of down) and
// holds one nibble-packed unit (pf[e] = 1, halves layout; a packed down
// block is 704 byte rows at N 1408) or two int8 units. A packed byte tile
// feeds two MMA k-steps (the low nibbles against A columns r0.., the high
// against K/2 + r0..); the int32 sums are exact, so the output is bitwise
// K12's on the equivalent int8 codes. Kernel and schedule: gmm_ffn_tile.cuh.
//
// Bound on the H100: weight bytes at decode, as K12, with a packed expert
// streaming half its codes.

#include "gmm_ffn_tile.cuh"

extern "C" int mxmoe_gmm_ffn_mixed_packed(const void* lhs, const void* s_a,
                                          const void* gu_cat, const void* s_gu,
                                          const void* gu_pf, const void* gu_blk,
                                          const void* down_cat, const void* s_d,
                                          const void* d_pf, const void* d_blk,
                                          const void* group_sizes,
                                          const void* abits, void* out,
                                          int out_is_bf16, int M, int K, int N,
                                          int H, int E, void* stream) {
  return gmm_ffn_launch<kFfnRagged>(lhs, s_a, gu_cat, s_gu, gu_pf, gu_blk, down_cat,
                                    s_d, d_pf, d_blk, group_sizes, abits, out,
                                    out_is_bf16, M, K, N, H, E, stream);
}

// the clusters a launch's grid holds at widths N, H (bf16 out), or -(error)
extern "C" int mxmoe_gmm_ffn_mixed_packed_clusters(int N, int H) {
  return gmm_ffn_clusters<kFfnRagged>(N, H);
}
