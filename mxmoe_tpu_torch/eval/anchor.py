"""Accuracy anchor: the co-design loop on a trained model (port of
``mxmoe_tpu/eval/anchor.py``).

No published checkpoint or dataset is in the repository, so the anchor
trains a small qwen2_moe-architecture model on the deterministic synthetic
Markov language of ``quant.data`` (learnable structure, Zipfian marginals),
then runs the pipeline on the trained weights:

    trace -> calibrate (rtn / gptq[-had]) -> MILP solve (mixed w5a5) ->
    fake-quant and real-execution perplexity

and records FP / uniform w8a8 / uniform w4a4 / solved-mixed perplexities.
Trained weights carry what makes quantization error meaningful (outlier
channels, expert specialization, heterogeneous per-expert losses).

  python -m mxmoe_tpu_torch.eval.anchor --steps 1200 --out out/anchor

Runs on the card (``--device cuda``, the default; ``--device cpu`` runs the
kernels' plain versions). Writes ``results.json`` and ``ACCURACY.md`` under
``--out`` (never at the repository root) and prints one JSON line per
measurement. Training: torch autograd over the dense expert execution, AdamW
with optax's ``warmup_cosine_decay_schedule`` step for step (the JAX
package's optimizer), a fresh stream of trajectories every step.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time

import numpy as np
import torch

from ..models import configs, model as model_mod
from ..models.layers import MoEImpl
from .evaluator import eval_ppl_tokens


def anchor_config(vocab: int = 2048) -> "configs.MoEConfig":
    """Small-but-real MoE: 4 layers x (16 routed + shared), GQA attention."""
    return dataclasses.replace(
        configs.tiny_qwen2_moe(num_experts=16, num_layers=4),
        vocab_size=vocab,
        hidden_size=256,
        num_heads=8,
        num_kv_heads=4,
        head_dim=32,
        top_k=4,
        moe_intermediate_size=128,
        shared_expert_intermediate_size=256,
    )


def _loss_fn(params, tokens, cfg, impl, aux_weight=0.01):
    """Next-token CE + switch-style load-balance aux (keeps experts alive, so
    per-expert calibration losses are heterogeneous)."""
    h = model_mod.forward_hidden(params, tokens, cfg, impl)
    logits = model_mod.head_logits(params, h, cfg)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    ce = -lp.gather(-1, tgt[..., None]).mean()

    # router balance: mean over layers of E * sum_e f_e p_e
    embed = params["embed"]
    x2d = embed[tokens.long().clamp(0, embed.shape[0] - 1)].reshape(-1, cfg.hidden_size)
    aux = 0.0
    routers = params["layers"]["router"]       # [L, H, E]
    for l in range(routers.shape[0]):
        probs = torch.softmax((x2d @ routers[l]).float(), dim=-1)
        top = probs.argmax(-1)
        f = torch.nn.functional.one_hot(top, cfg.num_experts).float().mean(0)
        p = probs.mean(0)
        aux = aux + cfg.num_experts * (f * p).sum()
    return ce + aux_weight * aux / routers.shape[0]


def warmup_cosine_lr(step: int, lr: float, warmup: int, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.05 * lr) at
    ``step`` (the update's index, from 0): linear from 0 to ``lr`` over
    ``warmup`` steps, then a cosine to 0.05 lr at ``steps``."""
    if step < warmup:
        return lr * step / warmup
    end = 0.05 * lr
    decay = max(steps - warmup, 1)
    cos = 0.5 * (1.0 + math.cos(math.pi * min(step - warmup, decay) / decay))
    return lr * ((1.0 - end / lr) * cos + end / lr)


def _leaves(tree: dict) -> list:
    return [t for v in tree.values()
            for t in (_leaves(v) if isinstance(v, dict) else [v])]


def make_optimizer(params: dict, lr: float, warmup: int, steps: int):
    """(AdamW, LambdaLR) over every leaf of ``params``: optax.adamw(schedule,
    weight_decay=0.01) with its defaults (b1 0.9, b2 0.999, eps 1e-8, decay
    on every leaf), the schedule of :func:`warmup_cosine_lr`."""
    opt = torch.optim.AdamW(_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: warmup_cosine_lr(i, lr, warmup, steps) / lr)
    return opt, sched


def train_anchor_model(cfg, steps: int = 1200, batch: int = 32, seqlen: int = 128,
                       lr: float = 3e-3, seed: int = 0, log_every: int = 200,
                       device="cuda"):
    """Train on the synthetic Markov corpus on ``device`` -> (params,
    final_loss)."""
    from ..quant.data import synthetic_markov_tokens

    device = torch.device(device)
    impl = MoEImpl(kind="dense")   # dense expert execution: clean gradients
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model_mod.init_params(cfg, gen, dtype=torch.float32, device=device)
    for t in _leaves(params):
        t.requires_grad_(True)
    opt, sched = make_optimizer(params, lr, min(100, max(1, steps // 10)), steps)
    loss = None
    for i in range(steps):
        # a fresh stream every step (step-dependent seed): a fixed pool of
        # samples is memorized within 2k steps
        toks = torch.as_tensor(synthetic_markov_tokens(
            nsamples=batch, seqlen=seqlen, vocab_size=cfg.vocab_size,
            seed=100_000 + i), dtype=torch.int32, device=device)
        loss = _loss_fn(params, toks, cfg, impl)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if log_every and (i + 1) % log_every == 0:
            print(json.dumps({"step": i + 1, "train_loss": float(loss.detach())}),
                  flush=True)
    for t in _leaves(params):
        t.requires_grad_(False)
    return params, float(loss.detach())


def run_anchor(
    steps: int = 1200,
    out_dir: str = "out/anchor",
    methods: tuple[str, ...] = ("rtn", "gptq-had"),
    wbits_target: float = 5.0,
    eval_windows: int = 64,
    seqlen: int = 128,
    backend: str = "ragged_dot",
    write_md: bool = True,
    device="cuda",
) -> dict:
    """The anchor's rows -> results (also written to ``out_dir``/results.json
    and, with ``write_md``, ``out_dir``/ACCURACY.md). ``backend`` is the
    float path's grouped product (``"pallas"``: K11 on the card)."""
    from ..quant.calibrate import calibrate_model
    from ..quant.data import synthetic_markov_tokens
    from ..quant.qparams import quantize_lm_head, quantize_model_experts_mixed
    from ..quant.quantizer import (quantize_model_experts_mixed_gptq,
                                   quantize_model_fake)
    from ..quant.schemes import build_uniform_model, parse_scheme
    from ..solver.bits_solver import solve_model
    from ..trace.gate import dump_gate_trace, load_gate_trace, trace_gate_stats
    from .evaluator import eval_ppl_decode

    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = anchor_config()
    impl = MoEImpl(kind="ragged", gmm_backend=backend)

    # trained-weights cache, keyed on steps, seqlen (weights trained at another
    # window length put RoPE positions out of distribution) and the config
    cfg_tag = hashlib.sha256(f"v1:{cfg}".encode()).hexdigest()[:10]
    ckpt = os.path.join(out_dir, f"anchor_params_s{steps}_l{seqlen}_{cfg_tag}.pt")
    train_s = None
    if os.path.exists(ckpt):
        saved = torch.load(ckpt, map_location=device, weights_only=True)
        params, train_loss = saved["params"], saved["train_loss"]
        print(json.dumps({"loaded_params": ckpt}), flush=True)
    else:
        t0 = time.perf_counter()
        params, train_loss = train_anchor_model(cfg, steps=steps, seqlen=seqlen,
                                                device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
        torch.save({"params": params, "train_loss": train_loss}, ckpt)

    # held-out eval and calibration sets: other seeds, the same language and
    # the training window length
    eval_toks = synthetic_markov_tokens(eval_windows, seqlen, cfg.vocab_size, seed=1234)
    calib_toks = torch.as_tensor(
        synthetic_markov_tokens(16, seqlen, cfg.vocab_size, seed=555),
        dtype=torch.int32, device=device)

    results = {"train_loss": train_loss, "steps": steps,
               "config": "4L x (16+shared) h256 top4 vocab2048",
               "corpus": "synthetic first-order Markov (branching 8)"}
    if train_s is not None:
        results["train_seconds"] = train_s
        print(json.dumps({"train_seconds": train_s, "train_loss": train_loss}),
              flush=True)

    def record(name, ppl):
        results[name] = round(float(ppl), 4)
        print(json.dumps({"metric": name, "ppl": results[name]}), flush=True)

    record("ppl_fp", eval_ppl_tokens(params, eval_toks, cfg, impl))

    # the unigram floor: ppl of the best constant predictor
    counts = np.bincount(eval_toks.reshape(-1), minlength=cfg.vocab_size) + 1.0
    p = counts / counts.sum()
    record("ppl_unigram_floor", float(np.exp(-np.sum(p * np.log(p)))))

    trace_path = os.path.join(out_dir, "moe-gate.json")
    dump_gate_trace(trace_gate_stats(params, calib_toks, cfg, backend=backend,
                                     device=device), trace_path)
    trace = load_gate_trace(trace_path)

    schemes = {s: parse_scheme(s) for s in ("w4a4_g-1_sym", "w8a8_g-1_sym")}
    e_tot = cfg.num_experts + 1    # + the shared pseudo-expert

    def fake(qc, method):
        return quantize_model_fake(params, cfg, qc, method=method,
                                   calib_tokens=calib_toks, backend=backend,
                                   device=device)

    for method in methods:
        for sname in ("w8a8_g-1_sym", "w4a4_g-1_sym"):
            uni = build_uniform_model(parse_scheme(sname), cfg.num_layers, e_tot)
            record(f"ppl_{sname.split('_')[0]}_{method}",
                   eval_ppl_tokens(fake(uni, method), eval_toks, cfg, impl))

        if method == "rtn":
            # the MSE clip search at the damaging width
            uni = build_uniform_model(parse_scheme("w4a4_g-1_sym_mse"),
                                      cfg.num_layers, e_tot)
            record("ppl_w4a4_rtn_mseclip",
                   eval_ppl_tokens(fake(uni, method), eval_toks, cfg, impl))

        # calibrate + solve the mixed allocation (the paper's w5a5 recipe)
        losses = calibrate_model(params, calib_toks, cfg, schemes, save_dir=out_dir,
                                 model_id="anchor", method=method, backend=backend,
                                 device=device, verbose=False)
        qcfg, _ = solve_model(losses, trace, batch=int(calib_toks.numel()),
                              num_layers=cfg.num_layers, wbits_target=wbits_target,
                              r=1.0)
        qcfg.save(os.path.join(out_dir, f"anchor_{method}_mixed.json"))
        record(f"ppl_mixed_w{wbits_target:g}_{method}",
               eval_ppl_tokens(fake(qcfg, method), eval_toks, cfg, impl))

        impl_real = MoEImpl(kind="ragged", quant="mixed")
        if method == "rtn":
            # the real-execution rows: the same configs through the quantized
            # kernels (K1, K2 / K4, packed w<=4 storage, the real int8 shared
            # expert); the decode row adds the int8 KV cache (K3q), the int8
            # lm_head and the serving decode step. RTN only: the real path
            # quantizes by RTN, so only the RTN fake rows compare.
            for label, qc in (
                ("w8a8", build_uniform_model(parse_scheme("w8a8_g-1_sym"),
                                             cfg.num_layers, e_tot)),
                ("w4a4", build_uniform_model(parse_scheme("w4a4_g-1_sym"),
                                             cfg.num_layers, e_tot)),
                (f"mixed_w{wbits_target:g}", qcfg),
            ):
                real = quantize_model_experts_mixed(params, cfg, qc, pack_w4=True)
                record(f"ppl_realexec_{label}",
                       eval_ppl_tokens(real, eval_toks, cfg, impl_real))
            real_h = quantize_lm_head(quantize_model_experts_mixed(params, cfg, qcfg))
            record(f"ppl_realexec_decode_mixed_w{wbits_target:g}",
                   eval_ppl_decode(real_h, eval_toks, cfg, impl_real, int8_kv=True))

        if method == "gptq-had":
            # GPTQ-had codes through the real kernels, packed storage
            real = quantize_model_experts_mixed_gptq(
                params, cfg, qcfg, calib_toks, backend=backend, pack_w4=True,
                hadamard=True, device=device)
            record(f"ppl_realexec_mixed_w{wbits_target:g}_gptq-had",
                   eval_ppl_tokens(real, eval_toks, cfg, impl_real))

    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if write_md:
        _write_md(results, os.path.join(out_dir, "ACCURACY.md"), wbits_target, methods)
    return results


def _write_md(res: dict, path: str, wt: float, methods) -> None:
    fp = res["ppl_fp"]

    def row(name):
        v = res.get(name)
        return f"{v} | {v - fp:+.3f}" if v is not None else "— | —"

    lines = [
        "# Accuracy anchor (trained-model quantization Δppl)",
        "",
        "No published checkpoint or dataset is in the repository, so the",
        "reference's WikiText-2 reproduction is replaced by the full pipeline",
        f"on a model trained on a synthetic Markov language ({res['config']},",
        f"{res['steps']} steps, final train loss {res['train_loss']:.3f}).",
        "Quantization sees trained weight structure (outliers, expert",
        "specialization), so Δppl is meaningful. Protocol:",
        "mxmoe_tpu_torch/eval/anchor.py; reference protocol",
        "mxmoe/quant/evaluator.py:23-57.",
        "",
        "| config | ppl | Δ vs FP |",
        "|---|---|---|",
        f"| FP (f32) | {fp} | — |",
        f"| unigram floor (no sequence model) | {res['ppl_unigram_floor']} | |",
    ]
    for m in methods:
        lines += [
            f"| uniform w8a8 ({m}) | {row(f'ppl_w8a8_{m}')} |",
            f"| uniform w4a4 ({m}) | {row(f'ppl_w4a4_{m}')} |",
            f"| **mixed w{wt:g} (ILP w4+w8, {m})** | {row(f'ppl_mixed_w{wt:g}_{m}')} |",
        ]
        if m == "rtn" and "ppl_w4a4_rtn_mseclip" in res:
            lines += ["| uniform w4a4 (rtn, MSE clip search) | "
                      f"{row('ppl_w4a4_rtn_mseclip')} |"]
    if "ppl_realexec_w8a8" in res:
        lines += [
            "",
            "Real-execution rows (the same configs through the quantized kernels,",
            "packed w<=4 storage and the real int8 shared expert; the decode row",
            "adds the int8 KV cache, the int8 lm_head and the serving decode step):",
            "",
            "| config (real execution) | ppl | Δ vs FP |",
            "|---|---|---|",
            f"| uniform w8a8, real kernels | {row('ppl_realexec_w8a8')} |",
            f"| uniform w4a4, real kernels | {row('ppl_realexec_w4a4')} |",
            f"| mixed w{wt:g}, real kernels + packed storage | "
            f"{row(f'ppl_realexec_mixed_w{wt:g}')} |",
            f"| mixed w{wt:g}, serving decode + int8 KV + int8 head | "
            f"{row(f'ppl_realexec_decode_mixed_w{wt:g}')} |",
        ]
        if f"ppl_realexec_mixed_w{wt:g}_gptq-had" in res:
            lines += [f"| mixed w{wt:g}, GPTQ-had codes, real kernels + packed | "
                      f"{row(f'ppl_realexec_mixed_w{wt:g}_gptq-had')} |"]
    lines += [
        "",
        "The reproduction criterion is the reference's qualitative claim",
        "(arXiv:2505.05799): the solved mixed allocation at the bit budget",
        "sits far below uniform-w4 damage, approaching uniform-w8, at ~w5",
        "average stored bits.",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--out", default="out/anchor")
    ap.add_argument("--methods", nargs="+", default=["rtn", "gptq-had"])
    ap.add_argument("--wbits", type=float, default=5.0)
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--seqlen", type=int, default=128)
    ap.add_argument("--backend", default="ragged_dot")
    ap.add_argument("--no-md", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu | cuda | cuda:N (default: cuda; cpu must be asked "
                         "for and runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    return run_anchor(steps=args.steps, out_dir=args.out, methods=tuple(args.methods),
                      wbits_target=args.wbits, eval_windows=args.windows,
                      seqlen=args.seqlen, backend=args.backend,
                      write_md=not args.no_md, device=args.device or "cuda")


if __name__ == "__main__":
    _main()
