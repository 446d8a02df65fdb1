"""Per-expert gate and activation tracing (port of ``mxmoe_tpu/trace/gate.py``).

The float decoder runs layer by layer (``quant.calibrate.layer_forward_fp``),
one layer at a time copied to ``device`` (the card unless the caller asks for
the CPU); top-k is taken off each MoE layer's router logits and the
per-expert access frequency and combine-weight sums are accumulated. The
JSON (``dump_gate_trace``) is the ``moe-gate.json`` schema the solver and
the workload generator read, with ``first_dense_layers`` / ``dense_NK`` for
ds2's dense first layers.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..models.configs import MoEConfig
from ..models.layers import decoder_layer, make_rope_tables
from ..ops.dispatch import route_topk
from ..quant.calibrate import layer_forward_fp


@dataclasses.dataclass
class GateTrace:
    access_freq: np.ndarray   # [L, E] int64: top-k hits per expert
    weights_sum: np.ndarray   # [L, E] float64: sum of combine weights
    num_tokens: int
    num_samples: int
    topk: int
    nk: tuple[int, int]       # (moe_intermediate, hidden)
    num_shared_experts: int
    # ds2's dense first layers: their count and (dense_intermediate, hidden)
    first_dense_layers: int = 0
    dense_nk: tuple[int, int] | None = None

    def freq_probs(self) -> np.ndarray:
        tot = self.access_freq.sum(axis=1, keepdims=True)
        return self.access_freq / np.maximum(tot, 1)


def _percentile_stats(freq: np.ndarray) -> dict:
    qs = [0, 25, 50, 75, 90, 99, 100]
    return {f"p{q}": float(np.percentile(freq, q)) for q in qs}


def _embed_and_dense(params: dict, tokens: torch.Tensor, cfg: MoEConfig, device):
    """The embedded rows on ``device`` through the dense first layers, and
    the rope tables."""
    embed = params["embed"]
    toks = tokens.to(device=embed.device, dtype=torch.long)
    x = embed[toks.clamp(0, embed.shape[0] - 1)].to(device)
    cos, sin = make_rope_tables(cfg, torch.arange(toks.shape[1], device=device))
    if "dense_layers" in params:
        dls = params["dense_layers"]
        for dl in range(dls["input_norm"].shape[0]):
            dlp = {k: v[dl].to(device) for k, v in dls.items()}
            x = decoder_layer(x, dlp, cfg, cos, sin, dense_mlp=True)
    return x, cos, sin


def _moe_layers(params: dict, x, cos, sin, cfg: MoEConfig, backend: str, device):
    """Each MoE layer's (index, params on ``device``, MoE-block input [T, H]),
    the rows propagated through the float layers."""
    layers = params["layers"]
    for l in range(layers["router"].shape[0]):
        lp = {k: v[l].to(device) for k, v in layers.items()}
        x_next, x2d = layer_forward_fp(x, lp, cfg, cos, sin, backend)
        yield l, lp, x2d
        x = x_next


@torch.no_grad()
def trace_gate_stats(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                     backend: str = "ragged_dot", device="cuda") -> GateTrace:
    """Route ``tokens`` [B, S] through the float model -> each MoE layer's
    per-expert top-k hits and combine-weight sums. ``backend`` is
    ``ops.gmm``'s (``"pallas"``: K11 on a card)."""
    device = torch.device(device)
    b, s = tokens.shape
    x, cos, sin = _embed_and_dense(params, tokens, cfg, device)
    num_layers = params["layers"]["router"].shape[0]
    freq = np.zeros((num_layers, cfg.num_experts), np.int64)
    wsum = np.zeros((num_layers, cfg.num_experts), np.float64)
    for l, lp, x2d in _moe_layers(params, x, cos, sin, cfg, backend, device):
        routing = route_topk(x2d @ lp["router"], cfg.top_k, cfg.norm_topk_prob,
                             cfg.routed_scaling_factor)
        flat = routing.expert_ids.reshape(-1).long()
        freq[l] = torch.bincount(flat, minlength=cfg.num_experts).cpu().numpy()
        w = torch.zeros(cfg.num_experts, device=device).index_put_(
            (flat,), routing.weights.reshape(-1).float(), accumulate=True)
        wsum[l] = w.double().cpu().numpy()
    n_shared = (cfg.shared_expert_intermediate_size // cfg.moe_intermediate_size
                if cfg.shared_expert_intermediate_size > 0 else 0)
    return GateTrace(
        access_freq=freq, weights_sum=wsum, num_tokens=b * s, num_samples=b,
        topk=cfg.top_k, nk=(cfg.moe_intermediate_size, cfg.hidden_size),
        num_shared_experts=n_shared, first_dense_layers=cfg.first_dense_layers,
        dense_nk=((cfg.dense_intermediate_size, cfg.hidden_size)
                  if cfg.first_dense_layers else None))


def dump_gate_trace(trace: GateTrace, path: str) -> None:
    """The ``moe-gate.json`` schema."""
    num_layers = trace.access_freq.shape[0]
    data = {"topk": trace.topk, "NK": list(trace.nk), "num_layers": num_layers,
            "num_tokens": trace.num_tokens, "num_samples": trace.num_samples,
            "num_shared_experts": trace.num_shared_experts}
    if trace.first_dense_layers:
        data["first_dense_layers"] = trace.first_dense_layers
        data["dense_NK"] = list(trace.dense_nk)
    for i in range(num_layers):
        data[f"layer-{i}"] = {
            "access_freq": trace.access_freq[i].tolist(),
            "weights_sum": trace.weights_sum[i].tolist(),
            "percentile_stats": _percentile_stats(trace.access_freq[i])}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def load_gate_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_gate_heatmap(trace: GateTrace, path: str) -> bool:
    """Expert-access heatmap; False where matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(12, 6))
    im = ax.imshow(trace.freq_probs(), aspect="auto", cmap="viridis")
    ax.set_xlabel("expert")
    ax.set_ylabel("layer")
    fig.colorbar(im, ax=ax, label="routing probability")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


# ---------------------------------------------------------------------------
# activation tracing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ActivationTrace:
    """Per-layer distribution of |x| entering each MoE block."""

    amax: np.ndarray          # [L] max |x|
    channel_amax: np.ndarray  # [L, H] per-channel max |x| (the outlier map)
    percentiles: np.ndarray   # [L, len(qs)] of |x|
    qs: tuple = (50.0, 90.0, 99.0, 99.9, 100.0)


def _percentiles(a: torch.Tensor, qs) -> torch.Tensor:
    """numpy's default (linear) percentiles of a flat tensor, on its device
    and at any size (``torch.quantile`` refuses large inputs)."""
    v = a.reshape(-1).sort().values
    pos = torch.tensor(qs, dtype=torch.float64, device=v.device) / 100.0 * (v.numel() - 1)
    lo = pos.floor().long()
    hi = pos.ceil().long()
    frac = (pos - lo.double()).float()
    return v[lo] + (v[hi] - v[lo]) * frac


@torch.no_grad()
def trace_activation_stats(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                           backend: str = "ragged_dot", device="cuda") -> ActivationTrace:
    """|activation| statistics of each MoE block's input, reduced on the
    device: the outlier evidence for the Hadamard rotation."""
    device = torch.device(device)
    qs = (50.0, 90.0, 99.0, 99.9, 100.0)
    x, cos, sin = _embed_and_dense(params, tokens, cfg, device)
    num_layers = params["layers"]["router"].shape[0]
    amax = np.zeros(num_layers)
    ch = np.zeros((num_layers, cfg.hidden_size))
    pct = np.zeros((num_layers, len(qs)))
    for l, _, x2d in _moe_layers(params, x, cos, sin, cfg, backend, device):
        a = x2d.float().abs()
        amax[l] = float(a.max())
        ch[l] = a.amax(0).cpu().numpy()
        pct[l] = _percentiles(a, qs).cpu().numpy()
    return ActivationTrace(amax=amax, channel_amax=ch, percentiles=pct, qs=qs)


def plot_activation_outliers(trace: ActivationTrace, path: str) -> bool:
    """Channel-amax heatmap and |x| percentiles per layer; False where
    matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    im = ax1.imshow(np.log10(trace.channel_amax + 1e-9), aspect="auto", cmap="magma")
    ax1.set_xlabel("hidden channel")
    ax1.set_ylabel("layer")
    fig.colorbar(im, ax=ax1, label="log10 channel amax")
    for i, q in enumerate(trace.qs):
        ax2.plot(trace.percentiles[:, i], label=f"p{q}")
    ax2.set_xlabel("layer")
    ax2.set_ylabel("|activation|")
    ax2.set_yscale("log")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def _main(argv=None):
    import argparse

    from ..models import configs
    from ..models import model as model_mod
    from ..quant.data import get_calibration_tokens

    ap = argparse.ArgumentParser(description="gate tracing -> moe-gate.json")
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--ckpt", default=None,
                    help="HF safetensors dir (default: random weights, seed 0)")
    ap.add_argument("--dataset", default="auto")
    ap.add_argument("--nsamples", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--heatmap", action="store_true")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "ragged_dot"])
    ap.add_argument("--device", default="cuda", help="cpu | cuda | cuda:N")
    args = ap.parse_args(argv)

    cfg = configs.config_for(args.model)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        params = params_from_safetensors(args.ckpt, cfg)
    else:
        params = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                       dtype=torch.float32, device="cpu")
    tokens = get_calibration_tokens(args.nsamples, args.seqlen, args.dataset,
                                    vocab_size=cfg.vocab_size)
    trace = trace_gate_stats(params, tokens, cfg, backend=args.backend,
                             device=args.device)
    out = args.out or f"calib/gate/{args.model}/{args.dataset}/{args.seqlen}/moe-gate.json"
    dump_gate_trace(trace, out)
    if args.heatmap and not plot_gate_heatmap(trace, out.replace(".json", ".png")):
        print("no heatmap: matplotlib is not installed")
    print(f"gate trace -> {out}")


if __name__ == "__main__":
    _main()
