// K12: the whole expert FFN in one launch over int8-stored experts.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_ffn_w8a8 (body
// _gmm_ffn_kernel): gate_up int8 dot -> (acc * s_a) * s_gu in f32 -> SwiGLU
// in f32 -> per-row requant at min(act_bits_down[e], 8) -> int8 down dot ->
// (acc * s_h) * s_d. Per-channel symmetric weights [E, K, 2N] / [E, N, H].
// Kernel, schedule and arithmetic: gmm_ffn_tile.cuh.
//
// Bound on the H100: weight bytes at decode (each live expert's K * 2N + N *
// H int8 codes, 8.65 MB at qwen2_moe widths, read once per m-tile; ~14 live
// experts at 16 routed rows). Against the two-launch path (K1, K2, SwiGLU, K1,
// K2) it drops three launches, the gate_up output's round trip through
// device memory in bf16 and that rounding: h stays f32 in the cluster's
// shared memory, and so does hq.

#include "gmm_ffn_tile.cuh"

extern "C" int mxmoe_gmm_ffn_w8a8(const void* lhs, const void* s_a,
                                  const void* gateup, const void* s_gu,
                                  const void* down, const void* s_d,
                                  const void* group_sizes, const void* abits,
                                  void* out, int out_is_bf16, int M, int K, int N,
                                  int H, int E, void* stream) {
  return gmm_ffn_launch<kFfnStacked>(lhs, s_a, gateup, s_gu, nullptr, nullptr, down,
                                     s_d, nullptr, nullptr, group_sizes, abits, out,
                                     out_is_bf16, M, K, N, H, E, stream);
}

extern "C" int mxmoe_gmm_ffn_smem_bytes(int N, int H) { return ffn_smem_bytes(N, H); }

// the CTAs of a cluster at width N (8 or 16), 0 where N is refused
extern "C" int mxmoe_gmm_ffn_cluster_size(int N) { return ffn_cluster(N); }

// the clusters a launch's grid holds at widths N, H (bf16 out), or -(error)
extern "C" int mxmoe_gmm_ffn_w8a8_clusters(int N, int H) {
  return gmm_ffn_clusters<kFfnStacked>(N, H);
}
