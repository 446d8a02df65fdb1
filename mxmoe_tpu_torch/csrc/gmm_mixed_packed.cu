// K4: one-launch mixed-precision grouped GEMM over ragged per-expert storage.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_mixed_packed,
// per-channel form (_gmm_mixed_packed_kernel with the per-group k-step
// metadata of make_mixed_metadata). The grouped / asymmetric (flex) form of
// that function is not ported here.
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
// block walks group_sizes itself (gmm_int8_tile.cuh, storage kRaggedMixed),
// and a packed byte tile feeds two MMA k-steps (low nibbles against lhs
// columns [r0, r0+64), high nibbles against [K/2+r0, K/2+r0+64)).

#include "gmm_int8_tile.cuh"

extern "C" int mxmoe_gmm_mixed_packed(const void* lhs, const void* s_a,
                                      const void* rhs_cat, const void* s_b,
                                      const void* group_sizes,
                                      const void* pflags,
                                      const void* blk_offsets, void* out,
                                      int out_is_bf16, int M, int K, int N,
                                      int E, void* stream) {
  return gmm_int8_launch<kRaggedMixed>(lhs, s_a, rhs_cat, s_b, nullptr,
                                       group_sizes, pflags, blk_offsets, out,
                                       out_is_bf16, M, K, N, E, stream);
}
