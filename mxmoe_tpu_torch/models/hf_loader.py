"""HF checkpoint -> the port's params (port of
``mxmoe_tpu/models/hf_loader.py``).

  * :func:`params_from_state_dict` - any mapping name -> tensor (HF
    [out, in] layout), e.g. a live ``transformers`` model's state dict or a
    directory of shards read lazily;
  * :func:`params_from_torch_model` - a live model (parity tests);
  * :func:`params_from_safetensors` - a directory of ``*.safetensors``
    shards, read through ``utils.safetensors_io`` (no ``safetensors``
    package needed; bf16 shards load as bf16).

The params are CPU tensors in the stacked [in, out] layout of
``models.model`` (the reference's ``as_numpy`` host form): the callers move
one layer at a time to the card (``models.convert``) or the whole model
(``serving.generate --ckpt``). Each key is staged in its checkpoint dtype and
converted to ``dtype`` once, so a bf16 checkpoint loaded as bf16 is never
widened.

Name schema (qwen2_moe / mixtral; ds2 in ``_ds2_params_from_state_dict``):
  model.layers.{i}.self_attn.{q,k,v,o}_proj.weight[.bias]
  model.layers.{i}.{input,post_attention}_layernorm.weight
  qwen2_moe: model.layers.{i}.mlp.gate.weight (router)
             model.layers.{i}.mlp.experts.{e}.{gate,up,down}_proj.weight
             model.layers.{i}.mlp.shared_expert.{gate,up,down}_proj.weight
             model.layers.{i}.mlp.shared_expert_gate.weight
  mixtral:   model.layers.{i}.block_sparse_moe.gate.weight
             model.layers.{i}.block_sparse_moe.experts.{e}.w{1,2,3}.weight
             (w1 = gate, w3 = up, w2 = down)
"""

from __future__ import annotations

from typing import Mapping

import torch

from .configs import MoEConfig


class _Stacker:
    """Write-in-place staging: one preallocated ``[L, ...]`` CPU buffer per
    key, in the checkpoint's dtype, filled layer by layer (no list of copies
    and no stack)."""

    def __init__(self, num_layers: int):
        self.L = num_layers
        self.buf: dict[str, torch.Tensor] = {}

    def _alloc(self, key, shape, dtype):
        if key not in self.buf:
            self.buf[key] = torch.empty(shape, dtype=dtype)
        return self.buf[key]

    def put(self, key: str, i: int, arr: torch.Tensor) -> None:
        self._alloc(key, (self.L, *arr.shape), arr.dtype)[i] = arr

    def put_halves(self, key: str, i: int, g: torch.Tensor, u: torch.Tensor) -> None:
        """Fused gate|up: the two halves written straight into [L, H, 2N]."""
        h, n = g.shape
        buf = self._alloc(key, (self.L, h, 2 * n), g.dtype)
        buf[i, :, :n] = g
        buf[i, :, n:] = u

    def put_expert_halves(self, key: str, i: int, e: int, num_experts: int,
                          g: torch.Tensor, u: torch.Tensor) -> None:
        h, n = g.shape
        buf = self._alloc(key, (self.L, num_experts, h, 2 * n), g.dtype)
        buf[i, e, :, :n] = g
        buf[i, e, :, n:] = u

    def put_expert(self, key: str, i: int, e: int, num_experts: int,
                   arr: torch.Tensor) -> None:
        self._alloc(key, (self.L, num_experts, *arr.shape), arr.dtype)[i, e] = arr

    def finish(self, dtype) -> dict:
        """Each staged key in ``dtype``, biggest first, each staged buffer
        freed as it converts (the crossover holds one key twice at most)."""
        out = {}
        for k in sorted(self.buf, key=lambda k: -self.buf[k].numel()):
            v = self.buf[k]
            out[k] = v if v.dtype == dtype else v.to(dtype)
            self.buf[k] = None
        return {k: out[k] for k in sorted(out)}


def _getter(sd):
    def get(name: str) -> torch.Tensor:
        v = sd[name]
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return get


def _head(params: dict, sd, cfg: MoEConfig, get, conv) -> None:
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = params["embed"].T
    else:
        params["lm_head"] = conv(get("lm_head.weight").T)


def params_from_state_dict(sd: Mapping, cfg: MoEConfig,
                           dtype=torch.float32) -> dict:
    """An HF state dict (tensors or numpy arrays, HF [out, in] layout) ->
    the stacked [in, out] params of ``models.model``, CPU tensors in
    ``dtype``."""
    if cfg.model_type == "deepseek_v2":
        return _ds2_params_from_state_dict(sd, cfg, dtype)
    get = _getter(sd)
    if cfg.model_type == "mixtral":
        moe_prefix = "block_sparse_moe"
        names = {"gate": "w1", "up": "w3", "down": "w2"}
    else:
        moe_prefix = "mlp"
        names = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}

    L, E = cfg.num_layers, cfg.num_experts
    st = _Stacker(L)
    for i in range(L):
        p = f"model.layers.{i}"
        st.put("wq", i, get(f"{p}.self_attn.q_proj.weight").T)
        st.put("wk", i, get(f"{p}.self_attn.k_proj.weight").T)
        st.put("wv", i, get(f"{p}.self_attn.v_proj.weight").T)
        st.put("wo", i, get(f"{p}.self_attn.o_proj.weight").T)
        if cfg.attention_bias:
            st.put("bq", i, get(f"{p}.self_attn.q_proj.bias"))
            st.put("bk", i, get(f"{p}.self_attn.k_proj.bias"))
            st.put("bv", i, get(f"{p}.self_attn.v_proj.bias"))
        st.put("input_norm", i, get(f"{p}.input_layernorm.weight"))
        st.put("post_attn_norm", i, get(f"{p}.post_attention_layernorm.weight"))
        st.put("router", i, get(f"{p}.{moe_prefix}.gate.weight").T)
        for e in range(E):
            ep = f"{p}.{moe_prefix}.experts.{e}"
            st.put_expert_halves("expert_gate_up", i, e, E,
                                 get(f"{ep}.{names['gate']}.weight").T,   # [H, N]
                                 get(f"{ep}.{names['up']}.weight").T)
            st.put_expert("expert_down", i, e, E,
                          get(f"{ep}.{names['down']}.weight").T)         # [N, H]
        if cfg.shared_expert_intermediate_size > 0:
            sp = f"{p}.mlp.shared_expert"
            st.put_halves("shared_gate_up", i, get(f"{sp}.gate_proj.weight").T,
                          get(f"{sp}.up_proj.weight").T)
            st.put("shared_down", i, get(f"{sp}.down_proj.weight").T)
            if cfg.has_shared_expert_gate:
                st.put("shared_gate", i, get(f"{p}.mlp.shared_expert_gate.weight").T)

    def conv(a):
        return a.to(dtype).contiguous()

    params = {"embed": conv(get("model.embed_tokens.weight")),
              "final_norm": conv(get("model.norm.weight"))}
    params["layers"] = st.finish(dtype)
    _head(params, sd, cfg, get, conv)
    return params


def _ds2_params_from_state_dict(sd, cfg: MoEConfig, dtype) -> dict:
    """DeepSeek-V2(-Lite) names: self_attn.{q_proj, kv_a_proj_with_mqa,
    kv_a_layernorm, kv_b_proj, o_proj}; a layer below ``first_dense_layers``
    has mlp.{gate,up,down}_proj (dense), the others mlp.gate (router),
    mlp.experts.{e}.* and mlp.shared_experts.*."""
    get = _getter(sd)
    L, E, D = cfg.num_layers, cfg.num_experts, cfg.first_dense_layers

    def put_common(st, j, i):
        p = f"model.layers.{i}.self_attn"
        st.put("wq", j, get(f"{p}.q_proj.weight").T)
        st.put("kv_a", j, get(f"{p}.kv_a_proj_with_mqa.weight").T)
        st.put("kv_a_norm", j, get(f"{p}.kv_a_layernorm.weight"))
        st.put("kv_b", j, get(f"{p}.kv_b_proj.weight").T)
        st.put("wo", j, get(f"{p}.o_proj.weight").T)
        q = f"model.layers.{i}"
        st.put("input_norm", j, get(f"{q}.input_layernorm.weight"))
        st.put("post_attn_norm", j, get(f"{q}.post_attention_layernorm.weight"))

    dense_st = _Stacker(D)
    for i in range(D):
        put_common(dense_st, i, i)
        p = f"model.layers.{i}.mlp"
        dense_st.put_halves("mlp_gate_up", i, get(f"{p}.gate_proj.weight").T,
                            get(f"{p}.up_proj.weight").T)
        dense_st.put("mlp_down", i, get(f"{p}.down_proj.weight").T)

    moe_st = _Stacker(L - D)
    for i in range(D, L):
        j = i - D
        put_common(moe_st, j, i)
        p = f"model.layers.{i}.mlp"
        moe_st.put("router", j, get(f"{p}.gate.weight").T)
        for e in range(E):
            ep = f"{p}.experts.{e}"
            moe_st.put_expert_halves("expert_gate_up", j, e, E,
                                     get(f"{ep}.gate_proj.weight").T,
                                     get(f"{ep}.up_proj.weight").T)
            moe_st.put_expert("expert_down", j, e, E, get(f"{ep}.down_proj.weight").T)
        moe_st.put_halves("shared_gate_up", j,
                          get(f"{p}.shared_experts.gate_proj.weight").T,
                          get(f"{p}.shared_experts.up_proj.weight").T)
        moe_st.put("shared_down", j, get(f"{p}.shared_experts.down_proj.weight").T)

    def conv(a):
        return a.to(dtype).contiguous()

    params = {"embed": conv(get("model.embed_tokens.weight")),
              "layers": moe_st.finish(dtype),
              "dense_layers": dense_st.finish(dtype),
              "final_norm": conv(get("model.norm.weight"))}
    _head(params, sd, cfg, get, conv)
    return params


def params_from_torch_model(torch_model, cfg: MoEConfig, dtype=torch.float32) -> dict:
    """A live ``transformers`` model -> params (parity tests)."""
    sd = {k: v.detach().to("cpu") for k, v in torch_model.state_dict().items()}
    return params_from_state_dict(sd, cfg, dtype)


def params_from_safetensors(ckpt_dir: str, cfg: MoEConfig,
                            dtype=torch.bfloat16) -> dict:
    """A directory of ``*.safetensors`` shards (with or without
    ``model.safetensors.index.json``) -> params, CPU tensors in ``dtype``."""
    from ..utils.safetensors_io import ShardedDir

    return params_from_state_dict(ShardedDir(ckpt_dir), cfg, dtype)
