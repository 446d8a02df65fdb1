"""DeepSeek-V2 (``model_type`` ``deepseek_v2``): multi-head latent attention
without a query LoRA (interleaved RoPE on the rope parts), leading dense
SwiGLU layers, greedy softmax top-k over the routed experts and the shared
experts as one wider SwiGLU."""

from __future__ import annotations

from benchmark.core.arch import Arch, require


def arch(c: dict) -> Arch:
    require(c.get("q_lora_rank") is None, "deepseek_v2: q_lora_rank must be null")
    rs = c.get("rope_scaling")
    # YaRN at factor 1 is plain RoPE: its interpolated and extrapolated
    # frequencies coincide, and yarn_get_mscale(1, .) = 1 leaves the softmax
    # scale at 1/sqrt(qk_nope + qk_rope).
    require(rs is None or (rs.get("type") == "yarn" and rs.get("factor") == 1),
            "deepseek_v2: the port has no YaRN; rope_scaling must be null or YaRN at factor 1")
    require(c.get("scoring_func", "softmax") == "softmax"
            and c.get("topk_method", "greedy") == "greedy"
            and c.get("n_group", 1) == 1 and c.get("moe_layer_freq", 1) == 1,
            "deepseek_v2: softmax greedy routing over every layer after the dense ones")
    return Arch(
        family="deepseek_v2", vocab=c["vocab_size"], hidden=c["hidden_size"],
        layers=c["num_hidden_layers"], heads=c["num_attention_heads"],
        kv_heads=c["num_key_value_heads"],
        head_dim=c["v_head_dim"],
        experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
        expert_n=c["moe_intermediate_size"],
        shared_n=c["n_shared_experts"] * c["moe_intermediate_size"],
        shared_gate=False, norm_topk=c["norm_topk_prob"],
        routed_scale=float(c["routed_scaling_factor"]),
        rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
        qkv_bias=bool(c["attention_bias"]), tie_embed=c["tie_word_embeddings"],
        attention="mla", kv_lora=c["kv_lora_rank"], qk_nope=c["qk_nope_head_dim"],
        qk_rope=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
        dense_layers=c["first_k_dense_replace"], dense_n=c["intermediate_size"])
