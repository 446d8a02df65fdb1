// K3q: fused KV-cache write + GQA decode attention over the stacked int8
// cache (per-vector f32 scales), and its read-only forms. The body is in
// decode_attention_tile.cuh.
//
// Replaces the Pallas kernels mxmoe_tpu/serving/decode_attention.py:
// decode_attention_update_stacked (int8 cache), decode_attention_stacked
// (int8 cache) and decode_attention_q8.

#include "decode_attention_tile.cuh"

// Every entry point takes the workspace ([B, n_kv, n_split, G, dv + 2] f32,
// n_split = cdiv(S, 4 * chunk) S-blocks) and the tickets ([B * n_kv] int32,
// zero) as the wrapper sized them.
extern "C" int mxmoe_decode_attention_update_q8(
    const void* q, const void* k_new, const void* v_new, int is_bf16,
    void* cache_k, void* cache_ks, void* cache_v, void* cache_vs,
    const void* lengths, const void* valid, void* out, void* ws, void* tickets,
    int layer, int B, int n_h, int n_kv, int S, int dk, int dv, int chunk,
    int n_split, float scale, void* stream) {
  const Args a{q, k_new, v_new, cache_k, cache_v, static_cast<float*>(cache_ks),
               static_cast<float*>(cache_vs), static_cast<const int*>(lengths),
               static_cast<const int*>(valid), out, static_cast<float*>(ws),
               static_cast<int*>(tickets), layer, B, n_h, n_kv, S, dk, dv, chunk,
               n_split, scale};
  return run<true, true>(a, is_bf16, stream);
}

// The read-only forms: no step vectors, no write. A per-layer cache is
// layer 0 of a one-layer stack (L = 1, layer = 0).

extern "C" int mxmoe_decode_attention_q8(
    const void* q, int is_bf16, void* cache_k, void* cache_ks, void* cache_v,
    void* cache_vs, const void* lengths, void* out, void* ws, void* tickets,
    int layer, int B, int n_h, int n_kv, int S, int dk, int dv, int chunk,
    int n_split, float scale, void* stream) {
  const Args a{q, nullptr, nullptr, cache_k, cache_v, static_cast<float*>(cache_ks),
               static_cast<float*>(cache_vs), static_cast<const int*>(lengths),
               nullptr, out, static_cast<float*>(ws), static_cast<int*>(tickets),
               layer, B, n_h, n_kv, S, dk, dv, chunk, n_split, scale};
  return run<true, false>(a, is_bf16, stream);
}
