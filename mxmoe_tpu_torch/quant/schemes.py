"""Quantization scheme grammar and config tree (framework-free copy of the
part of ``mxmoe_tpu/quant/schemes.py`` the serving slices read):
``QLinearConfig`` and ``parse_scheme``, the ``QLinearConfig -> QExpertConfig
-> QLayerConfig -> QModelConfig`` tree with the reference's JSON round trip,
the uniform builders, ``flex_family_info`` and the solver's storage-bits
table ``strategy_bits``."""

from __future__ import annotations

import dataclasses
import json
import os
import re

_SCHEME_RE = re.compile(
    r"^w(?P<w>\d+(?:\.\d+)?)a(?P<a>\d+(?:\.\d+)?)_g(?P<g>-?\d+)_(?P<sym>sym|asym)"
    r"(?P<suffix>(?:_[a-z0-9]+)*)$"
)


@dataclasses.dataclass(frozen=True, order=True)
class QLinearConfig:
    """Quantization scheme for one linear block (weight + activation).

    gsize == -1 means per-output-channel for weights / per-token for
    activations; otherwise groups of `gsize` along the reduction dim.
    """

    w_bits: float = 16
    w_gsize: int = -1
    w_sym: bool = False
    w_clip: "tuple[float, float] | str" = (1.0, 1.0)  # or "mse" (grid search)
    a_bits: float = 16
    a_gsize: int = -1
    a_sym: bool = True
    a_clip: tuple[float, float] = (1.0, 1.0)

    @property
    def scheme_name(self) -> str:
        """Canonical lowercase scheme string, e.g. ``w4a4_g-1_sym``."""
        return (
            f"w{_fmt_bits(self.w_bits)}a{_fmt_bits(self.a_bits)}"
            f"_g{self.w_gsize}_{'sym' if self.w_sym else 'asym'}"
        )

    def effective_wbits(self) -> float:
        """Average stored bits per weight element, scale overhead included: a
        grouped scheme adds a 16-bit scale and a 16-bit zero point a group
        (0.25 bits at g128)."""
        if self.w_bits >= 16:
            return 16.0
        if self.w_gsize == -1:
            return float(self.w_bits)
        return float(self.w_bits) + 32.0 / self.w_gsize

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # w_clip may be the "mse" sentinel (grid-searched clip)
        d["w_clip"] = (self.w_clip if isinstance(self.w_clip, str)
                       else list(self.w_clip))
        d["a_clip"] = list(self.a_clip)
        d["w_bits"] = _canon_bits(self.w_bits)
        d["a_bits"] = _canon_bits(self.a_bits)
        return d

    @staticmethod
    def from_dict(d: dict) -> "QLinearConfig":
        wc = d.get("w_clip", (1.0, 1.0))
        return QLinearConfig(
            w_bits=d.get("w_bits", 16),
            w_gsize=d.get("w_gsize", -1),
            w_sym=d.get("w_sym", False),
            w_clip=wc if isinstance(wc, str) else tuple(wc),
            a_bits=d.get("a_bits", 16),
            a_gsize=d.get("a_gsize", -1),
            a_sym=d.get("a_sym", True),
            a_clip=tuple(d.get("a_clip", (1.0, 1.0))),
        )


def _fmt_bits(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else str(b)


def _canon_bits(b: float):
    return int(b) if float(b).is_integer() else float(b)


def parse_scheme(name: str) -> QLinearConfig:
    """Parse ``w{W}a{A}_g{G}_{sym|asym}[_mse]`` into a QLinearConfig
    (weight and activation share the gsize/sym flags in this grammar)."""
    m = _SCHEME_RE.match(name.strip().lower())
    if not m:
        raise ValueError(f"Unparseable scheme string: {name!r}")
    w = float(m.group("w"))
    a = float(m.group("a"))
    g = int(m.group("g"))
    sym = m.group("sym") == "sym"
    w_clip = "mse" if "_mse" in (m.group("suffix") or "") else (1.0, 1.0)
    return QLinearConfig(
        w_bits=_canon_bits(w), w_gsize=g, w_sym=sym, w_clip=w_clip,
        a_bits=_canon_bits(a), a_gsize=g, a_sym=sym,
    )


# (storage wbits, abits) of the common schemes, the scale overhead of a
# 128-group included; any other scheme falls back to its own widths
_STRATEGY_BITS_TABLE: dict[str, tuple[float, float]] = {
    "w8a16_g-1": (8, 16),
    "w4a16_g-1": (4, 16),
    "w4a16_g128": (4.25, 16),
    "w3a16_g128": (3.25, 16),
    "w2a16_g128": (2.25, 16),
    "w1a16_g128": (1.25, 16),
    "w4a4_g-1": (4, 4),
    "w8a8_g-1": (8, 8),
    "w4a4_g128": (4.25, 4.25),
    "w8a8_g128": (8.25, 8.25),
    "w16a16_g-1": (16, 16),
}


def strategy_bits(scheme: str) -> tuple[float, float]:
    """(storage wbits, abits) for a scheme string, scale overhead included."""
    for k, v in _STRATEGY_BITS_TABLE.items():
        if scheme.startswith(k):
            return v
    cfg = parse_scheme(scheme)
    return (cfg.effective_wbits(), float(cfg.a_bits))


# --------------------------------------------------------------------------
# Config tree
# --------------------------------------------------------------------------

LINEAR_NAMES = ("gate", "up", "down")


@dataclasses.dataclass
class QExpertConfig:
    gate: QLinearConfig
    up: QLinearConfig
    down: QLinearConfig

    def qmap(self) -> dict[str, QLinearConfig]:
        return {"gate": self.gate, "up": self.up, "down": self.down}

    def to_dict(self) -> dict:
        return {k: v.to_dict() for k, v in self.qmap().items()}

    @staticmethod
    def from_dict(d: dict) -> "QExpertConfig":
        return QExpertConfig(
            gate=QLinearConfig.from_dict(d["gate"]),
            up=QLinearConfig.from_dict(d["up"]),
            down=QLinearConfig.from_dict(d["down"]),
        )


@dataclasses.dataclass
class QLayerConfig:
    """Per-expert schemes of one layer, keyed by the expert index as a
    string; index E (one past the routed experts) is the shared expert."""

    experts: dict[str, QExpertConfig]

    def to_dict(self) -> dict:
        return {"experts": {k: v.to_dict() for k, v in self.experts.items()}}

    @staticmethod
    def from_dict(d: dict) -> "QLayerConfig":
        return QLayerConfig(
            experts={k: QExpertConfig.from_dict(v) for k, v in d["experts"].items()}
        )


@dataclasses.dataclass
class QModelConfig:
    layers: dict[str, QLayerConfig]
    # per-layer (loss, time) record attached by the solver, a top-level
    # "LT" key in the JSON
    lt: dict[str, tuple[float, float]] | None = None

    def to_dict(self) -> dict:
        d = {k: v.to_dict() for k, v in self.layers.items()}
        if self.lt is not None:
            d["LT"] = {str(k): list(v) for k, v in self.lt.items()}
        return d

    def save(self, path) -> None:
        os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @staticmethod
    def from_dict(d: dict) -> "QModelConfig":
        d = dict(d)
        lt = d.pop("LT", None)
        layers = {k: QLayerConfig.from_dict(v) for k, v in d.items()}
        if lt is not None:
            lt = {str(k): tuple(v) for k, v in lt.items()}
        return QModelConfig(layers=layers, lt=lt)

    @staticmethod
    def load(path) -> "QModelConfig":
        with open(path) as f:
            return QModelConfig.from_dict(json.load(f))

    def all_weight_schemes(self) -> list[tuple[float, int, bool]]:
        """Distinct (w_bits, w_gsize, w_sym) triples."""
        out = set()
        for layer in self.layers.values():
            for expert in layer.experts.values():
                for cfg in expert.qmap().values():
                    out.add((cfg.w_bits, cfg.w_gsize, cfg.w_sym))
        return sorted(out)

    def all_schemes(self) -> list[str]:
        """Distinct full scheme names used anywhere in the model."""
        out = set()
        for layer in self.layers.values():
            for expert in layer.experts.values():
                for cfg in expert.qmap().values():
                    out.add(cfg.scheme_name)
        return sorted(out)

    def layer(self, idx: int) -> QLayerConfig:
        return self.layers[str(idx)]


def build_uniform_expert(cfg: QLinearConfig) -> QExpertConfig:
    return QExpertConfig(gate=cfg, up=cfg, down=cfg)


def build_uniform_layer(cfg: QLinearConfig, num_experts: int) -> QLayerConfig:
    return QLayerConfig(experts={str(i): build_uniform_expert(cfg)
                                 for i in range(num_experts)})


def build_uniform_model(cfg: QLinearConfig, num_layers: int,
                        num_experts: int) -> QModelConfig:
    return QModelConfig(layers={str(i): build_uniform_layer(cfg, num_experts)
                                for i in range(num_layers)})


def schemes_in_layer(layer_cfg: QLayerConfig) -> list[str]:
    out = set()
    for expert in layer_cfg.experts.values():
        for cfg in expert.qmap().values():
            out.add(cfg.scheme_name)
    return sorted(out)


def flex_family_info(qmodel_cfg: QModelConfig, num_layers: int,
                     num_experts: int, lin: str, kdim: int):
    """Scheme-set scan for one linear family ('gate' ties gate_up; 'down').

    Returns ``(any_flex, g_min, any_asym)``: a family is FLEX when any
    routed expert's scheme is grouped (w or a) or weight-asymmetric; the
    real mixed path then stores scales/zp at the family's finest group size
    ``g_min`` and the forward takes the grouped/flex kernels."""
    gsizes = set()
    any_flex = False
    any_asym = False
    for l in range(num_layers):
        lcfg = qmodel_cfg.layer(l)
        for ei in range(num_experts):
            c = lcfg.experts[str(ei)].qmap()[lin]
            if c.w_bits >= 16 and c.a_bits >= 16:
                continue
            if c.w_gsize != -1 and c.w_bits < 16:
                gsizes.add(c.w_gsize)
            if c.a_gsize != -1 and c.a_bits < 16:
                gsizes.add(c.a_gsize)
            if (c.w_gsize != -1 and c.w_bits < 16) or (
                    not c.w_sym and c.w_bits < 16) or (
                    c.a_gsize != -1 and c.a_bits < 16):
                any_flex = True
            if not c.w_sym and c.w_bits < 16:
                any_asym = True
    g_min = min(gsizes) if gsizes else kdim
    if any_flex:
        if not all(g == g_min for g in gsizes):
            raise ValueError(f"{lin}: one grouped size per linear family, got "
                             f"{sorted(gsizes)}")
        if kdim % g_min != 0:
            raise ValueError(f"{lin}: K={kdim} not divisible by gsize {g_min}")
    return any_flex, g_min, any_asym
