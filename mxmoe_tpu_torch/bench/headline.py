"""Headline benchmark on one card: the qwen2_moe layer-10 bs8192 MoE FFN
GroupGEMM (the port's counterpart of the root ``bench.py``).

    python -m mxmoe_tpu_torch.bench.headline [--mode mixed|w8a8] [--bucketed] [--no-ws]

Workload: ``workloads.qwen2_moe_l10_bs8192``, the routed experts and the
shared expert, gate_up and down, with seeded random operands (uniform in
[-1, 1], bf16). The work is the nominal sum of 2MNK (no padding rows), and
TFLOPS is that over the median time, as in ``bench.py``. Arms:

- baseline: bf16, the routed rows through the stock grouped product
  (``torch._grouped_mm``, ``ops.gmm``'s ``"ragged_dot"`` arm) and a dense
  bf16 matmul for the shared expert;
- ``--mode w8a8``: K1 per-token act quant + K2 over the routed rows;
- ``--mode mixed`` (default): alternating w4 / w8 experts (even experts w4)
  in one launch: each expert's rows padded to a multiple of ``BM`` = 128
  (zero rows; the reference's default row tile), the w4 experts' codes in
  the 4-bit range of int8 storage, K1 with per-row bits, then K15
  ``gmm_w8a8_ws`` (``--no-ws``: K2 on the same layout);
- ``--bucketed``: the two-launch arm: the experts reordered w4 first, the w4
  bucket nibble-packed; K1 at 4 bits + K15 ``gmm_w4a8_packed_ws``, K1 at 8
  bits + K15 ``gmm_w8a8_ws`` (``--no-ws``: K5 + K2).

The quantized arms' shared expert: K1 + the stock int8 product
``torch._int_mm`` (the reference's is XLA's stock dot) and an f32 epilogue.

Timing: CUDA events around one call of an arm (both workloads), the L2
cache overwritten before each call, the two arms in turns, the median of
``REPEATS`` calls after warm-up. The reference's chained protocol, glitch
filter and baseline memo exist for its remote TPU and are not ported. The
bound is the workload's (``workload_bound``), one number for every arm of a
mode, from the H100's published peaks: max(bytes / 3.35 TB/s, sum 2MNK /
1979 TOP/s int8), the bytes being what the workload must move once in the
mode's storage; no intermediate of an arm counts (the reference's workload
roofline, ``bench.py``).

Prints ONE JSON line: ``metric``, ``value`` (TFLOPS), ``unit``,
``vs_baseline``, ``bound_tflops``, ``bound_kind`` (bytes | operations),
``samples``, the milliseconds of each arm (``ms``) and the card's name. It
needs a card: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from . import workloads
from ..ops import act_quant
from ..ops.gmm import gmm
from ..ops.gmm_w4a8_packed import gmm_w4a8_packed
from ..ops.gmm_w8a8 import gmm_w8a8
from ..ops.gmm_ws import gmm_w4a8_packed_ws, gmm_w8a8_ws
from ..quant.packing import pack_int4_halves

BM = 128            # the mixed arms' row alignment (the reference's BENCH_BM)
SEED = 42           # the operands' seed (the reference's PRNGKey)
WARMUP, REPEATS = 3, 15
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
METRICS = {"mixed": "qwen2_moe_l10_bs8192_moe_ffn_mixed_w4a4+w8a8_cuda",
           "w8a8": "qwen2_moe_l10_bs8192_moe_ffn_w8a8_cuda"}


def build_fp_operands(wl, gen, device, dtype=torch.bfloat16):
    """(lhs [M, K], rhs [E, K, N], group_sizes [E] int32, shared (lhs, rhs)
    or None), uniform in [-1, 1]."""
    def uniform(shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1).to(dtype)

    lhs = uniform((wl.m_total, wl.k))
    rhs = uniform((wl.num_experts, wl.k, wl.n))
    gs = torch.tensor(wl.group_sizes, dtype=torch.int32, device=device)
    shared = None
    if wl.shared_m:
        shared = (uniform((wl.shared_m, wl.shared_k)),
                  uniform((wl.shared_k, wl.shared_n)))
    return lhs, rhs, gs, shared


def _quantize_shared(shared, reciprocal: bool):
    """Per-channel int8 codes of the shared expert's weights. The reference
    divides by 127 op by op in the mixed helpers and under ``jit`` (a
    multiply by f32(1/127)) in the w8a8 one."""
    if shared is None:
        return None
    sw = shared[1].float()
    amax = sw.abs().amax(0, keepdim=True)
    ssc = (amax * torch.tensor(1.0 / 127.0, device=sw.device) if reciprocal
           else amax / 127.0)
    return shared[0], torch.round(sw / ssc).to(torch.int8), ssc


def quantize_weights(operands):
    """w8a8: per-channel int8 codes (the reference's ``_quantize_weights``,
    which runs under ``jit``: the scale multiplies by f32(1/127))."""
    out = []
    for lhs, rhs, gs, shared in operands:
        w = rhs.float()
        wsc = w.abs().amax(1, keepdim=True) * torch.tensor(1.0 / 127.0,
                                                           device=w.device)
        out.append((lhs, torch.round(w / wsc).to(torch.int8), wsc, gs,
                    _quantize_shared(shared, reciprocal=True)))
    return out


def _pad_rows(lhs, sizes, order, bm):
    """Rows of the experts in ``order``, each expert padded to a ``bm``
    multiple with zero rows (a padding row gathers row 0 and is multiplied
    by 0, as the reference does) -> (rows, padded sizes in that order)."""
    starts = np.concatenate([[0], np.cumsum(sizes)])
    padded = ((sizes[order] + bm - 1) // bm) * bm
    row_order = np.concatenate([
        np.concatenate([np.arange(starts[e], starts[e + 1]),
                        np.full(padded[i] - sizes[e], -1, np.int64)])
        for i, e in enumerate(order)])
    keep = torch.as_tensor(row_order >= 0, device=lhs.device)[:, None]
    idx = torch.as_tensor(np.maximum(row_order, 0), device=lhs.device)
    return lhs[idx] * keep.to(lhs.dtype), padded


def quantize_weights_mixed(operands, w4_masks, bm: int = BM):
    """The bucketed two-launch arm (the reference's
    ``_quantize_weights_mixed`` on its aligned layout): experts reordered w4
    first, rows padded per expert, w4 codes (scale max/7) nibble-packed, w8
    codes (max/127) int8."""
    out = []
    for (lhs, rhs, gs, shared), w4_mask in zip(operands, w4_masks):
        sizes = np.asarray(gs.tolist())
        w4_mask = np.asarray(w4_mask, bool)
        order = np.argsort(~w4_mask, kind="stable")        # w4 experts first
        n4 = int(w4_mask.sum())
        lhs_p, gs_p = _pad_rows(lhs, sizes, order, bm)
        w = rhs[torch.as_tensor(order, device=rhs.device)].float()
        w4, w8 = w[:n4], w[n4:]
        sc4 = w4.abs().amax(1, keepdim=True) / 7.0
        sc8 = w8.abs().amax(1, keepdim=True) / 127.0
        out.append(dict(
            lhs=lhs_p, m4=int(gs_p[:n4].sum()),
            q4p=pack_int4_halves(torch.round(w4 / sc4).to(torch.int8)), sc4=sc4,
            q8=torch.round(w8 / sc8).to(torch.int8), sc8=sc8,
            gs4=tuple(int(x) for x in gs_p[:n4]),
            gs8=tuple(int(x) for x in gs_p[n4:]),
            shared=_quantize_shared(shared, reciprocal=False)))
    return out


def quantize_weights_mixed_onelaunch(operands, w4_masks, bm: int = BM):
    """The one-launch arm (the reference's
    ``_quantize_weights_mixed_onelaunch`` on its aligned layout): rows padded
    per expert in expert order, every expert int8-stored (w4 experts' codes
    within +-7, scale max/7; w8 max/127) and each row's activation bits from
    its expert's scheme."""
    out = []
    for (lhs, rhs, gs, shared), w4_mask in zip(operands, w4_masks):
        sizes = np.asarray(gs.tolist())
        w4_mask = np.asarray(w4_mask, bool)
        lhs_p, padded = _pad_rows(lhs, sizes, np.arange(len(sizes)), bm)
        w = rhs.float()
        maxcode = torch.as_tensor(np.where(w4_mask, 7.0, 127.0), dtype=torch.float32,
                                  device=w.device)[:, None, None]
        wsc = w.abs().amax(1, keepdim=True) / maxcode
        out.append(dict(
            lhs=lhs_p, wq=torch.round(w / wsc).to(torch.int8), wsc=wsc,
            bits=torch.as_tensor(np.repeat(np.where(w4_mask, 4.0, 8.0), padded),
                                 dtype=torch.float32, device=w.device),
            gs=tuple(int(x) for x in padded),
            shared=_quantize_shared(shared, reciprocal=False)))
    return out


def workload_bytes(wls, mode: str) -> int:
    """The bytes the workload must move once in ``mode``'s storage: bf16
    activations read once, the weights and per-channel f32 scales of every
    expert with rows read once (the arms' even experts 4-bit, nibble-packed,
    in ``mixed``; all int8 in ``w8a8``), the shared expert's int8 weights and
    scales, bf16 outputs written once. No intermediate of an arm (the shared
    expert's int32 accumulator, act-quant codes) counts."""
    nbytes = 0
    for wl in wls:
        nbytes += 2 * wl.m_total * wl.k + 2 * wl.m_total * wl.n
        for e, rows in enumerate(wl.group_sizes):
            if rows > 0:
                w4 = mode == "mixed" and e % 2 == 0
                nbytes += wl.k * wl.n // (2 if w4 else 1) + 4 * wl.n
        if wl.shared_m:
            nbytes += (2 * wl.shared_m * wl.shared_k + wl.shared_k * wl.shared_n
                       + 4 * wl.shared_n + 2 * wl.shared_m * wl.shared_n)
    return nbytes


def workload_bound(wls, mode: str) -> tuple[float, str]:
    """(bound in TFLOPS on nominal sum 2MNK, "bytes" | "operations"): the
    larger of ``workload_bytes`` over the memory rate and sum 2MNK over the
    int8 dense peak. One number for every arm of a mode."""
    flops = sum(wl.flops for wl in wls)
    t_bytes = workload_bytes(wls, mode) / HBM_BYTES_PER_S
    t_ops = flops / INT8_OPS_PER_S
    return flops / max(t_bytes, t_ops) / 1e12, ("bytes" if t_bytes >= t_ops
                                                 else "operations")


def _shared_int8(sh):
    """The shared expert's int8 product: K1, the stock int8 matmul, the f32
    epilogue (acc * s_a) * s_w -> bf16."""
    x, swq, ssc = sh
    saq, sasc = act_quant.quantize_rows_uniform(x, 8)
    acc = torch._int_mm(saq, swq)
    return (acc.float() * sasc * ssc).to(torch.bfloat16)


def baseline_step(operands):
    """bf16: the stock grouped product + a dense matmul for the shared
    expert."""
    def step():
        outs = []
        for lhs, rhs, gs, shared in operands:
            outs.append(gmm(lhs, rhs, gs, backend="ragged_dot"))
            if shared is not None:
                outs.append(shared[0] @ shared[1])
        return outs
    return step


def w8a8_step(qoperands):
    """K1 + K2 over the routed rows, the shared expert's int8 product."""
    def step():
        outs = []
        for lhs, wq, wsc, gs, sh in qoperands:
            aq, asc = act_quant.quantize_rows_uniform(lhs, 8)
            outs.append(gmm_w8a8(aq, asc, wq, wsc, gs))
            if sh is not None:
                outs.append(_shared_int8(sh))
        return outs
    return step


def mixed_onelaunch_step(qmix, ws: bool = True):
    """K1 with per-row bits, then K15 (``ws``) or K2 on the aligned layout."""
    gs_dev = [torch.tensor(p["gs"], dtype=torch.int32, device=p["wq"].device)
              for p in qmix]

    def step():
        outs = []
        for p, gs in zip(qmix, gs_dev):
            aq, asc = act_quant.quantize_rows(p["lhs"], p["bits"])
            if ws:
                outs.append(gmm_w8a8_ws(aq, asc, p["wq"], p["wsc"], p["gs"], bm=BM))
            else:
                outs.append(gmm_w8a8(aq, asc, p["wq"], p["wsc"], gs))
            if p["shared"] is not None:
                outs.append(_shared_int8(p["shared"]))
        return outs
    return step


def mixed_bucketed_step(qmix, ws: bool = True):
    """Two buckets: K1 at 4 bits + packed K15 (or K5), K1 at 8 bits + K15
    (or K2)."""
    dev = qmix[0]["q8"].device
    gs_dev = [(torch.tensor(p["gs4"], dtype=torch.int32, device=dev),
               torch.tensor(p["gs8"], dtype=torch.int32, device=dev)) for p in qmix]

    def step():
        outs = []
        for p, (gs4, gs8) in zip(qmix, gs_dev):
            l4, l8 = p["lhs"][:p["m4"]], p["lhs"][p["m4"]:]
            aq4, asc4 = act_quant.quantize_rows_uniform(l4, 4)
            aq8, asc8 = act_quant.quantize_rows_uniform(l8, 8)
            if ws:
                o4 = gmm_w4a8_packed_ws(aq4, asc4, p["q4p"], p["sc4"], p["gs4"], bm=BM)
                o8 = gmm_w8a8_ws(aq8, asc8, p["q8"], p["sc8"], p["gs8"], bm=BM)
            else:
                o4 = gmm_w4a8_packed(aq4, asc4, p["q4p"], p["sc4"], gs4)
                o8 = gmm_w8a8(aq8, asc8, p["q8"], p["sc8"], gs8)
            outs += [o4, o8]
            if p["shared"] is not None:
                outs.append(_shared_int8(p["shared"]))
        return outs
    return step


_L2_FLUSH = []


def time_ms(fn) -> float:
    """Device time of one call (CUDA events), a buffer larger than the
    card's 50 MB L2 cache overwritten before it."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.int8, device="cuda"))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    _L2_FLUSH[0].zero_()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="mixed", choices=list(METRICS))
    ap.add_argument("--bucketed", action="store_true",
                    help="mixed: two launches (packed w4 bucket, w8 bucket)")
    ap.add_argument("--no-ws", action="store_true",
                    help="K2 / K5 instead of the weight-stationary K15")
    return ap


def make_arm(args, operands):
    """The measured arm's step and its name."""
    if args.mode == "w8a8":
        return w8a8_step(quantize_weights(operands)), "w8a8"
    masks = [np.arange(len(op[2])) % 2 == 0 for op in operands]
    ws = not args.no_ws
    if args.bucketed:
        step = mixed_bucketed_step(quantize_weights_mixed(operands, masks), ws)
    else:
        step = mixed_onelaunch_step(quantize_weights_mixed_onelaunch(operands, masks), ws)
    name = "mixed_" + ("bucketed" if args.bucketed else "onelaunch")
    return step, name + ("_ws" if ws else "_no_ws")


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("headline: no CUDA device; this benchmark measures the "
                         "card only")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wls = workloads.qwen2_moe_l10_bs8192()
    operands = [build_fp_operands(wl, gen, dev) for wl in wls]
    total_flops = sum(wl.flops for wl in wls)
    base = baseline_step(operands)
    ours, name = make_arm(args, operands)
    with torch.no_grad():
        for _ in range(WARMUP):
            base()
            ours()
        t_base, t_ours = [], []
        for i in range(REPEATS):            # in turns: A B B A ...
            for arm in ((base, ours) if i % 2 == 0 else (ours, base)):
                (t_base if arm is base else t_ours).append(time_ms(arm))
    base_ms, our_ms = statistics.median(t_base), statistics.median(t_ours)
    bound_tflops, bound_kind = workload_bound(wls, args.mode)
    tflops = total_flops / (our_ms * 1e-3) / 1e12
    res = {
        "metric": METRICS[args.mode],
        "value": tflops,
        "unit": "TFLOPS",
        "vs_baseline": base_ms / our_ms,
        "bound_tflops": bound_tflops,
        "bound_kind": bound_kind,
        "samples": REPEATS,
        "ms": {"baseline": base_ms, name: our_ms},
        "device": torch.cuda.get_device_name(dev),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
