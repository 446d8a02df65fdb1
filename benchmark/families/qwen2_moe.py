"""Qwen1.5-MoE / Qwen2-MoE (``model_type`` ``qwen2_moe``): GQA with q/k/v
bias and half-split RoPE, softmax top-k routing over every layer's experts,
one shared expert behind a sigmoid gate."""

from __future__ import annotations

from benchmark.core.arch import Arch, require


def arch(c: dict) -> Arch:
    require(c.get("decoder_sparse_step", 1) == 1 and not c.get("mlp_only_layers"),
            "qwen2_moe: every layer must be an MoE layer")
    require(not c.get("use_sliding_window", False), "qwen2_moe: no sliding window")
    return Arch(
        family="qwen2_moe", vocab=c["vocab_size"], hidden=c["hidden_size"],
        layers=c["num_hidden_layers"], heads=c["num_attention_heads"],
        kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        experts=c["num_experts"], top_k=c["num_experts_per_tok"],
        expert_n=c["moe_intermediate_size"],
        shared_n=c["shared_expert_intermediate_size"], shared_gate=True,
        norm_topk=c["norm_topk_prob"], routed_scale=1.0,
        rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
        qkv_bias=True, tie_embed=c["tie_word_embeddings"])
