"""Write a seeded random HF-schema checkpoint: the counterpart of
``tools/make_synth_ckpt.py`` for the port (no jax, no ``safetensors``
package).

  python -m mxmoe_tpu_torch.models.synth_ckpt --model qwen2_moe --out ckpt \\
      [--layers 2] [--seed 0] [--dtype bf16|f16]

The names are those ``models.hf_loader`` reads (qwen2_moe, qwen2_moe_57b,
mixtral; ds2 with MLA attention, dense first layer(s) and shared experts).
Matrices are N(0, 0.02) drawn in float32 by numpy's ``default_rng(seed)`` in
the tool's order, norms are ones; with ``dtype=torch.float16`` the shards
hold the tool's values bit for bit. One shard a layer plus one for the
embedding, final norm and head, so the memory in use is one layer's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..utils.safetensors_io import save_file


def _writer(out_dir: str, dtype):
    os.makedirs(out_dir, exist_ok=True)
    state = {"shard": 0, "bytes": 0}

    def write(sd: dict) -> str:
        state["shard"] += 1
        path = os.path.join(out_dir, f"model-{state['shard']:05d}.safetensors")
        state["bytes"] += save_file(sd, path)
        return path

    def cast(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dtype)

    return write, cast, state


def _rand(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32) * 0.02


def _head_shard(cfg, rng, cast) -> dict:
    h, v = cfg.hidden_size, cfg.vocab_size
    return {"model.embed_tokens.weight": cast(_rand(rng, (v, h))),
            "model.norm.weight": cast(np.ones((h,), np.float32)),
            "lm_head.weight": cast(_rand(rng, (v, h)))}


def _qwen2_moe_layer(cfg, i, rng, cast) -> dict:
    h = cfg.hidden_size
    p = f"model.layers.{i}"
    sd = {f"{p}.self_attn.q_proj.weight": cast(_rand(rng, (cfg.q_dim, h))),
          f"{p}.self_attn.k_proj.weight": cast(_rand(rng, (cfg.kv_dim, h))),
          f"{p}.self_attn.v_proj.weight": cast(_rand(rng, (cfg.kv_dim, h))),
          f"{p}.self_attn.o_proj.weight": cast(_rand(rng, (h, cfg.q_dim))),
          f"{p}.input_layernorm.weight": cast(np.ones((h,), np.float32)),
          f"{p}.post_attention_layernorm.weight": cast(np.ones((h,), np.float32))}
    if cfg.attention_bias:
        sd[f"{p}.self_attn.q_proj.bias"] = cast(_rand(rng, (cfg.q_dim,)))
        sd[f"{p}.self_attn.k_proj.bias"] = cast(_rand(rng, (cfg.kv_dim,)))
        sd[f"{p}.self_attn.v_proj.bias"] = cast(_rand(rng, (cfg.kv_dim,)))
    mixtral = cfg.model_type == "mixtral"
    mp = f"{p}.block_sparse_moe" if mixtral else f"{p}.mlp"
    sd[f"{mp}.gate.weight"] = cast(_rand(rng, (cfg.num_experts, h)))
    n = cfg.moe_intermediate_size
    names = ({"gate": "w1", "up": "w3", "down": "w2"} if mixtral
             else {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"})
    for e in range(cfg.num_experts):
        ep = f"{mp}.experts.{e}"
        sd[f"{ep}.{names['gate']}.weight"] = cast(_rand(rng, (n, h)))
        sd[f"{ep}.{names['up']}.weight"] = cast(_rand(rng, (n, h)))
        sd[f"{ep}.{names['down']}.weight"] = cast(_rand(rng, (h, n)))
    if cfg.shared_expert_intermediate_size > 0:
        ns = cfg.shared_expert_intermediate_size
        sp = f"{mp}.shared_expert"
        sd[f"{sp}.gate_proj.weight"] = cast(_rand(rng, (ns, h)))
        sd[f"{sp}.up_proj.weight"] = cast(_rand(rng, (ns, h)))
        sd[f"{sp}.down_proj.weight"] = cast(_rand(rng, (h, ns)))
        if cfg.has_shared_expert_gate:
            sd[f"{mp}.shared_expert_gate.weight"] = cast(_rand(rng, (1, h)))
    return sd


def _ds2_layer(cfg, i, rng, cast) -> dict:
    h = cfg.hidden_size
    d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = f"model.layers.{i}"
    a = f"{p}.self_attn"
    sd = {f"{a}.q_proj.weight": cast(_rand(rng, (cfg.num_heads * d_qk, h))),
          f"{a}.kv_a_proj_with_mqa.weight": cast(_rand(
              rng, (cfg.kv_lora_rank + cfg.qk_rope_head_dim, h))),
          f"{a}.kv_a_layernorm.weight": cast(np.ones((cfg.kv_lora_rank,), np.float32)),
          f"{a}.kv_b_proj.weight": cast(_rand(
              rng, (cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                    cfg.kv_lora_rank))),
          f"{a}.o_proj.weight": cast(_rand(rng, (h, cfg.num_heads * cfg.v_head_dim))),
          f"{p}.input_layernorm.weight": cast(np.ones((h,), np.float32)),
          f"{p}.post_attention_layernorm.weight": cast(np.ones((h,), np.float32))}
    mp = f"{p}.mlp"
    if i < cfg.first_dense_layers:
        n = cfg.dense_intermediate_size
        sd[f"{mp}.gate_proj.weight"] = cast(_rand(rng, (n, h)))
        sd[f"{mp}.up_proj.weight"] = cast(_rand(rng, (n, h)))
        sd[f"{mp}.down_proj.weight"] = cast(_rand(rng, (h, n)))
        return sd
    n = cfg.moe_intermediate_size
    sd[f"{mp}.gate.weight"] = cast(_rand(rng, (cfg.num_experts, h)))
    for e in range(cfg.num_experts):
        ep = f"{mp}.experts.{e}"
        sd[f"{ep}.gate_proj.weight"] = cast(_rand(rng, (n, h)))
        sd[f"{ep}.up_proj.weight"] = cast(_rand(rng, (n, h)))
        sd[f"{ep}.down_proj.weight"] = cast(_rand(rng, (h, n)))
    ns = cfg.shared_expert_intermediate_size
    sp = f"{mp}.shared_experts"
    sd[f"{sp}.gate_proj.weight"] = cast(_rand(rng, (ns, h)))
    sd[f"{sp}.up_proj.weight"] = cast(_rand(rng, (ns, h)))
    sd[f"{sp}.down_proj.weight"] = cast(_rand(rng, (h, ns)))
    return sd


def make_checkpoint(cfg, out_dir: str, seed: int = 0, dtype=torch.bfloat16,
                    verbose: bool = False) -> int:
    """Write ``cfg``'s checkpoint into ``out_dir``; returns the bytes written."""
    write, cast, state = _writer(out_dir, dtype)
    rng = np.random.default_rng(seed)
    write(_head_shard(cfg, rng, cast))
    layer = _ds2_layer if cfg.model_type == "deepseek_v2" else _qwen2_moe_layer
    for i in range(cfg.num_layers):
        path = write(layer(cfg, i, rng, cast))
        if verbose:
            print(f"layer {i}: {path}", flush=True)
    return state["bytes"]


def main(argv=None):
    from .configs import config_for

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f16"])
    args = ap.parse_args(argv)
    cfg = config_for(args.model)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}[args.dtype]
    nbytes = make_checkpoint(cfg, args.out, args.seed, dtype, verbose=True)
    print(f"checkpoint -> {args.out} ({cfg.num_layers} layers, {nbytes} bytes)")


if __name__ == "__main__":
    main()
