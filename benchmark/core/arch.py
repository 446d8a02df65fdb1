"""A configuration's architecture in the benchmark's own terms.

``Arch`` holds the sizes that the weight generator, the plain reference and
the operation count read. Each model family maps its published
``config.json`` keys to it in ``families/<model_type>.py`` (``arch(cfg)``),
found by the configuration's ``model_type``; a new family adds such a file.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class Arch:
    family: str
    vocab: int
    hidden: int
    layers: int               # every decoder layer, dense first layers included
    heads: int
    kv_heads: int
    head_dim: int
    experts: int
    top_k: int
    expert_n: int             # a routed expert's intermediate width
    shared_n: int             # the shared expert(s)' intermediate width (0: none)
    shared_gate: bool         # sigmoid gate on the shared expert (qwen2_moe)
    norm_topk: bool
    routed_scale: float
    rope_theta: float
    eps: float
    qkv_bias: bool
    tie_embed: bool
    attention: str = "gqa"    # "gqa" | "mla"
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_dim: int = 0
    dense_layers: int = 0     # leading dense SwiGLU layers (deepseek_v2: 1)
    dense_n: int = 0

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers

    @property
    def qk_dim(self) -> int:
        """Width of a query / key head."""
        return self.qk_nope + self.qk_rope if self.attention == "mla" else self.head_dim

    @property
    def vo_dim(self) -> int:
        """Width of a value head."""
        return self.v_dim if self.attention == "mla" else self.head_dim


def arch_of(cfg: dict) -> Arch:
    """The ``Arch`` of a configuration file's contents, through
    ``families/<model_type>.py``."""
    family = cfg["model_type"]
    mod = importlib.import_module(f"benchmark.families.{family}")
    return mod.arch(cfg)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)
