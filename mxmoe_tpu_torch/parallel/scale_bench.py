"""Expert-parallel scaling benchmark: tokens/s against the number of ranks
(port of ``mxmoe_tpu/parallel/scale_bench.py``).

  python -m mxmoe_tpu_torch.parallel.scale_bench --devices 1 2 4 8 --tokens 4096

Weak scaling: the tokens a rank (or, ``--decode``, the slots a rank) stay
constant, so perfect scaling multiplies the aggregate tokens/s by the rank
count. Each count N runs the EP MoE layer (bf16 or, ``--quantized``, the
int8 dispatch) on N ranks over NCCL, one card each (``cuda:r``), timed with
CUDA events around whole steps (``bench/timing.py::event_ms``, the exchange
inside the window). A count above this machine's cards prints a row that says
so and is not run. One JSON line a row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch
import torch.distributed as dist


def _layer(cfg, gen, device, quantized: bool) -> dict:
    from ..models.model import init_params
    from ..quant.qparams import quantize_expert_weights
    from ..quant.schemes import QLinearConfig

    params = init_params(dataclasses.replace(cfg, num_layers=1), gen,
                         dtype=torch.bfloat16, device=device)
    lp = {k: v[0] for k, v in params["layers"].items()}
    if quantized:
        qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8)
        for prefix in ("expert_gate_up", "expert_down"):
            q = quantize_expert_weights(lp.pop(prefix), qc)
            lp[f"{prefix}_q"], lp[f"{prefix}_sc"] = q.q, q.scale
    return lp


def bench_ep_scaling(cfg, mesh, tokens_per_device: int = 2048,
                     quantized: bool = False, capacity_factor: float = 2.0,
                     device="cuda", transport: str = "direct") -> dict:
    """One row: the EP MoE layer over ``mesh``'s "expert" ranks, this
    rank's ``tokens_per_device`` rows, every rank drawing the same seeded
    weights and keeping its experts. A collective call: every rank runs it."""
    from ..bench.timing import event_ms
    from .ep import EPConfig, ep_comm, make_ep_moe_fn, make_ep_moe_quant_fn
    from .mesh import P, axis_index, axis_size, local_slice

    nd, me = axis_size(mesh, "expert"), axis_index(mesh, "expert")
    gen = torch.Generator(device=device).manual_seed(0)
    lp = _layer(cfg, gen, device, quantized)
    lp = {k: (local_slice(v, P("expert", None, None), mesh) if k.startswith("expert_")
              else v) for k, v in lp.items()}
    xgen = torch.Generator(device=device).manual_seed(1 + me)
    x = torch.randn((tokens_per_device, cfg.hidden_size), generator=xgen,
                    device=device).to(torch.bfloat16)
    ecfg = EPConfig(capacity_factor=capacity_factor, return_stats=True,
                    transport=transport)
    if quantized:
        fn = make_ep_moe_quant_fn(cfg, mesh, ecfg)
        args = (lp["router"], lp["expert_gate_up_q"], lp["expert_gate_up_sc"],
                lp["expert_down_q"], lp["expert_down_sc"])
    else:
        fn = make_ep_moe_fn(cfg, mesh, ecfg)
        args = (lp["router"], lp["expert_gate_up"], lp["expert_down"])
    _, drops = fn(x, *args)                   # untimed: the drop count
    dropped = int(ep_comm(mesh, ecfg).all_reduce_sum(drops)[0])
    ms = event_ms(lambda: fn(x, *args), reps=10, warmup=3)
    t = tokens_per_device * nd
    row = {"devices": nd, "tokens": t, "ms_per_step": ms,
           "tokens_per_s": t / (ms * 1e-3), "dropped_assignments": dropped,
           "drop_rate": dropped / (t * cfg.top_k), "quantized": quantized,
           "transport": transport}
    if nd == 1:
        # the same layer on one device without the EP block: what the
        # exchange, the buckets and the float32 combine cost at one rank
        from ..models.layers import MoEImpl, moe_ffn_ragged, moe_ffn_ragged_quant
        from ..quant.schemes import parse_scheme

        if quantized:
            impl = MoEImpl(quant=parse_scheme("w8a8_g-1_sym"))
            row["one_device_ms"] = event_ms(
                lambda: moe_ffn_ragged_quant(x, lp, cfg, impl), reps=10, warmup=3)
        else:
            row["one_device_ms"] = event_ms(
                lambda: moe_ffn_ragged(x, lp, cfg, MoEImpl()), reps=10, warmup=3)
    return row


def bench_decode_scaling(cfg, mesh, slots_per_device: int = 8, max_len: int = 256,
                         quantized: bool = True, steps: int = 32,
                         device="cuda", transport: str = "direct") -> dict:
    """One row of weak-scaling decode tokens/s: the cached serving step
    (attention, KV write, the EP MoE all-to-all) over ``mesh``'s ranks,
    ``slots_per_device`` slots a rank, ``steps`` greedy steps timed with CUDA
    events. A collective call."""
    from ..models.layers import MoEImpl
    from ..models.model import init_params
    from ..serving.decode import forward_cached
    from ..serving.kv_cache import init_kv_cache
    from .ep import EPConfig, make_ep_moe_block
    from .mesh import axis_size, shard_params
    from .sharded import ep_param_shardings

    nd = axis_size(mesh, "expert")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    impl = MoEImpl()
    if quantized:
        from ..quant.qparams import quantize_model_experts_uniform
        from ..quant.schemes import parse_scheme

        qc = parse_scheme("w8a8_g-1_sym")
        params = quantize_model_experts_uniform(params, qc)
        impl = MoEImpl(quant=qc)
    impl = dataclasses.replace(impl, ep_moe=make_ep_moe_block(
        cfg, mesh, quantized, EPConfig(capacity_factor=4.0, transport=transport)))
    params = shard_params(params, mesh, ep_param_shardings(params, mesh))
    cache = init_kv_cache(cfg, slots_per_device, max_len, torch.bfloat16, device)
    toks = torch.zeros((slots_per_device, 1), dtype=torch.int32, device=device)

    def run(toks, cache):
        for _ in range(steps):
            logits, cache = forward_cached(params, toks, cache, cfg, impl)
            toks = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return toks, cache

    with torch.inference_mode():
        toks, cache = run(toks, cache)                    # warm
        cache.lengths.zero_()
        torch.cuda.synchronize(device)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(toks, cache)
        b.record()
        b.synchronize()
    dt = a.elapsed_time(b) * 1e-3
    slots = slots_per_device * nd
    return {"devices": nd, "slots": slots, "decode_steps": steps,
            "tokens_per_s_decode": slots * steps / dt, "transport": transport}


def _rank_main(rank: int, args, cfg, nd: int, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    mesh = init_device_mesh("cuda", (nd,), mesh_dim_names=("expert",))
    row = bench_ep_scaling(cfg, mesh, args.tokens, args.quantized, device=device)
    rows = [row]
    if args.decode:
        rows.append(bench_decode_scaling(dataclasses.replace(cfg, num_layers=2),
                                         mesh, device=device))
    if rank == 0:
        with open(out, "w") as f:
            json.dump([{**r, "card": torch.cuda.get_device_name(device)} for r in rows], f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--tokens", type=int, default=2048, help="per rank")
    ap.add_argument("--experts", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--decode", action="store_true",
                    help="also run the serving-decode weak-scaling rows")
    args = ap.parse_args(argv)

    from ..models import configs
    from .multihost import spawn

    # head dim 64: a decode step's attention is K3, which takes dk >= 32
    heads = max(2, args.hidden // 64)
    cfg = dataclasses.replace(
        configs.tiny_qwen2_moe(num_experts=args.experts, num_layers=1),
        hidden_size=args.hidden, moe_intermediate_size=args.hidden // 2,
        shared_expert_intermediate_size=0, num_heads=heads, num_kv_heads=heads // 2,
        head_dim=64)
    cards = torch.cuda.device_count()
    base = {}
    with tempfile.TemporaryDirectory() as tmp:
        for nd in args.devices:
            if nd > cards:
                print(json.dumps({"devices": nd, "skipped":
                                  f"needs {nd} cards; this machine has {cards}"}))
                continue
            out = os.path.join(tmp, f"{nd}.json")
            spawn(_rank_main, nd, (args, cfg, nd, out), backend="nccl")
            with open(out) as f:
                for row in json.load(f):
                    key = "tokens_per_s" if "tokens_per_s" in row else "tokens_per_s_decode"
                    base.setdefault(key, row[key] / nd)
                    row["scaling_efficiency"] = row[key] / (base[key] * nd)
                    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
