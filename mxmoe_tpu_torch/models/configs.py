"""Model architecture configs (framework-free copy of
``mxmoe_tpu/models/configs.py``; tests pin the two equal)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Architecture hyperparameters for a Qwen2-MoE/Mixtral-style decoder."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    # MoE
    num_experts: int
    top_k: int
    moe_intermediate_size: int
    shared_expert_intermediate_size: int = 0  # 0 = no shared expert (mixtral)
    norm_topk_prob: bool = False
    has_shared_expert_gate: bool = True       # qwen2_moe: sigmoid gate on shared expert
    routed_scaling_factor: float = 1.0        # ds2 multiplies topk weights
    # Attention
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = True               # qwen2_moe uses qkv bias
    tie_word_embeddings: bool = False
    # MLA (ds2): latent attention dims; attention_type selects the block
    attention_type: str = "gqa"               # 'gqa' | 'mla'
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # dense first layers (ds2)
    first_dense_layers: int = 0
    dense_intermediate_size: int = 0
    model_type: str = "qwen2_moe"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_dense_layers


QWEN2_MOE_A2_7B = MoEConfig(
    vocab_size=151936,
    hidden_size=2048,
    num_layers=24,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    num_experts=60,
    top_k=4,
    moe_intermediate_size=1408,
    shared_expert_intermediate_size=5632,
    norm_topk_prob=False,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    attention_bias=True,
    model_type="qwen2_moe",
)

MIXTRAL_8X7B = MoEConfig(
    vocab_size=32000,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    num_experts=8,
    top_k=2,
    moe_intermediate_size=14336,
    shared_expert_intermediate_size=0,
    norm_topk_prob=True,
    has_shared_expert_gate=False,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-5,
    attention_bias=False,
    model_type="mixtral",
)

QWEN2_MOE_57B = MoEConfig(
    vocab_size=151936,
    hidden_size=3584,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    num_experts=64,
    top_k=8,
    moe_intermediate_size=2560,
    shared_expert_intermediate_size=20480,
    norm_topk_prob=False,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    attention_bias=True,
    model_type="qwen2_moe",
)

DEEPSEEK_V2_LITE = MoEConfig(
    vocab_size=102400,
    hidden_size=2048,
    num_layers=27,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,                 # nominal; MLA dims below govern attention
    num_experts=64,
    top_k=6,
    moe_intermediate_size=1408,
    shared_expert_intermediate_size=2 * 1408,   # n_shared_experts = 2
    norm_topk_prob=False,
    has_shared_expert_gate=False,
    routed_scaling_factor=1.0,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    attention_bias=False,
    attention_type="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_dense_layers=1,
    dense_intermediate_size=10944,
    model_type="deepseek_v2",
)


def tiny_ds2(num_experts: int = 4, num_layers: int = 3) -> MoEConfig:
    """Tiny DeepSeek-V2-style config (MLA + 1 dense first layer)."""
    return MoEConfig(
        vocab_size=256,
        hidden_size=64,
        num_layers=num_layers,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        num_experts=num_experts,
        top_k=2,
        moe_intermediate_size=32,
        shared_expert_intermediate_size=32,
        norm_topk_prob=False,
        has_shared_expert_gate=False,
        routed_scaling_factor=1.0,
        rope_theta=10000.0,
        attention_bias=False,
        attention_type="mla",
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        first_dense_layers=1,
        dense_intermediate_size=128,
        model_type="deepseek_v2",
    )


def tiny_qwen2_moe(num_experts: int = 8, num_layers: int = 2) -> MoEConfig:
    """Small random-init config for tests (structure-identical to qwen2_moe)."""
    return MoEConfig(
        vocab_size=512,
        hidden_size=64,
        num_layers=num_layers,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        num_experts=num_experts,
        top_k=2,
        moe_intermediate_size=32,
        shared_expert_intermediate_size=64,
        norm_topk_prob=False,
        rope_theta=1_000_000.0,
        attention_bias=True,
        model_type="qwen2_moe",
    )


def tiny_mixtral(num_experts: int = 4, num_layers: int = 2) -> MoEConfig:
    return MoEConfig(
        vocab_size=512,
        hidden_size=64,
        num_layers=num_layers,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        num_experts=num_experts,
        top_k=2,
        moe_intermediate_size=48,
        shared_expert_intermediate_size=0,
        norm_topk_prob=True,
        has_shared_expert_gate=False,
        rms_norm_eps=1e-5,
        attention_bias=False,
        model_type="mixtral",
    )


def config_for(model_id: str) -> MoEConfig:
    table = {
        "qwen2_moe": QWEN2_MOE_A2_7B,
        "qwen2_moe_57b": QWEN2_MOE_57B,
        "mixtral": MIXTRAL_8X7B,
        "ds2": DEEPSEEK_V2_LITE,
    }
    if model_id not in table:
        raise KeyError(f"no MoEConfig for {model_id!r}")
    return table[model_id]
