"""Fit and validate ``OneLaunchPerfModel``'s effective rates on the card (the
port's counterpart of ``tools/tpu_onelaunch_fit.py``).

    python -m mxmoe_tpu_torch.solver.onelaunch_fit [--out PATH] [--reps 10]

Rates, each from the device time of the kernels one call launched
(``bench.timing.device_ms``, the L2 cache overwritten before each call):

    int8_tflops_eff  K4 (gmm_mixed_packed) over the headline layer's routed
                     rows (qwen2_moe layer 10, 8192 tokens, top-4; gate_up
                     and down), w4 / w8 experts alternating, w4 packed
    quant_gbps_eff   K1 (quantize_rows) on the same rows: a bf16 read and an
                     int8 write an element
    hbm_gbps_eff     K2 (gmm_w8a8) at decode M: one row for each of 60
                     experts (K 2048, N 1408), every expert's weights read once
    bf16_tflops_eff  K6 (gmm_weight_only) over the same rows and codes,
                     int8-stored, one scale group: the rate the weight-only
                     (a16) rows ride, which is the rate's meaning in the
                     reference (``tools/tpu_onelaunch_fit.py``); the model
                     prices every weight-only scheme, and w16a16, at it
    unpack_gops      K4 at decode M with 0 / 30 / 60 experts packed against
                     the same codes int8-stored, timed in turns for
                     UNPACK_ROUNDS rounds: the time the packed experts take
                     beyond what the model's halved weight bytes give, a
                     least-squares slope over the packed elements in each
                     round (``fit_unpack``); 0.0 (no term) with
                     ``unpack_resolved`` false when the median slope is not
                     above the rounds' spread
    launch_ms        the same decode GEMM split into 1 / 2 / 4 / 8 column
                     launches: the slope over launches, less the activation
                     re-read each extra launch makes

The fitted model is then held against a measured mixed step (K1 + K4 over
the routed rows, K1 + K2 with one group for the shared expert, both
workloads) at w4 fractions 0 / 0.5 / 1.0, and the miss is printed. The JSON
(``mxmoe_tpu_torch/perf/onelaunch_model.json`` by default) holds the rates,
``unpack_resolved``, the card's ``nvidia-smi`` name and power limit, and
each measurement.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from ..bench import timing, workloads
from .perf_model import ONELAUNCH_JSON, OneLaunchPerfModel

# the unpack fit: K4 at decode M with these shares of the experts packed,
# timed in turns for this many rounds
UNPACK_FRACS = (0.0, 0.5, 1.0)
UNPACK_ROUNDS = 5
RATE_KEYS = ("int8_tflops_eff", "quant_gbps_eff", "hbm_gbps_eff", "bf16_tflops_eff",
             "unpack_gops", "launch_ms")
# the decode GEMM of the HBM, unpack and launch fits
DEC_E, DEC_K, DEC_N = 60, 2048, 1408


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device) * 2 - 1


def _codes(w: torch.Tensor, bits: int):
    """Per-channel symmetric codes of one expert's [K, N] -> (int8 [K, N],
    f32 scales [1, N])."""
    upper = float((1 << (bits - 1)) - 1)
    sc = w.abs().amax(0, keepdim=True).clamp(min=1e-8) / upper
    return torch.round(w / sc).to(torch.int8), sc


class _MixedLayer:
    """One headline workload's routed experts (and shared expert) with the
    experts ``w4`` at 4 bits, the rest at 8: codes int8-stored and in the
    ragged packed buffer, and the rows' activation bits."""

    def __init__(self, wl, w4: np.ndarray, gen, device):
        from ..quant.packing import build_ragged_mixed

        e, k, n = wl.num_experts, wl.k, wl.n
        self.gs = torch.tensor(wl.group_sizes, dtype=torch.int32, device=device)
        self.lhs = _uniform(gen, (wl.m_total, k), device).to(torch.bfloat16)
        q = torch.empty((e, k, n), dtype=torch.int8, device=device)
        sc = torch.empty((e, 1, n), dtype=torch.float32, device=device)
        for ei in range(e):
            q[ei], sc[ei] = _codes(_uniform(gen, (k, n), device), 4 if w4[ei] else 8)
        self.q, self.sc = q, sc
        cat, blk = build_ragged_mixed(q, w4)
        self.cat = cat
        self.blk = torch.tensor(blk, dtype=torch.int32, device=device)
        self.pf = torch.tensor(w4.astype(np.int32), device=device)
        self.bits = torch.repeat_interleave(
            torch.tensor(np.where(w4, 4.0, 8.0), dtype=torch.float32, device=device),
            self.gs.long())
        self.shared = None
        if wl.shared_m:
            sq, ssc = _codes(_uniform(gen, (wl.shared_k, wl.shared_n), device), 8)
            self.shared = (_uniform(gen, (wl.shared_m, wl.shared_k), device)
                           .to(torch.bfloat16), sq[None], ssc[None])

    def quant(self):
        from ..ops.act_quant import quantize_rows

        return quantize_rows(self.lhs, self.bits)

    def routed(self, aq, asc):
        from ..ops.gmm_mixed_packed import gmm_mixed_packed

        return gmm_mixed_packed(aq, asc, self.cat, self.sc, self.gs, self.pf, self.blk)

    def shared_step(self):
        """The shared expert's K1 + K2 with one group (None without one)."""
        from ..ops.act_quant import quantize_rows_uniform
        from ..ops.gmm_w8a8 import gmm_w8a8

        if self.shared is None:
            return None
        sl, sq, ssc = self.shared
        one = torch.full((1,), sl.shape[0], dtype=torch.int32, device=sl.device)
        aq, asc = quantize_rows_uniform(sl, 8)
        return gmm_w8a8(aq, asc, sq, ssc, one)

    def step(self):
        """The mixed one-launch step of this workload: K1 + K4, and the shared
        expert's K1 + K2 with one group."""
        return self.routed(*self.quant()), self.shared_step()


def _headline(w4_of, gen, device) -> list:
    """The headline layer's two workloads, the experts ``w4_of(E)`` at 4 bits."""
    return [_MixedLayer(wl, w4_of(wl.num_experts), gen, device)
            for wl in workloads.qwen2_moe_l10_bs8192()]


def _decode_operands(gen, device, w4: np.ndarray | None = None):
    """The decode GEMM: one row for each of DEC_E experts, codes in the 4-bit
    range where ``w4`` says (all at 8 bits without it)."""
    from ..ops.act_quant import quantize_rows_uniform

    e, k, n = DEC_E, DEC_K, DEC_N
    w4 = np.zeros(e, bool) if w4 is None else w4
    q = torch.empty((e, k, n), dtype=torch.int8, device=device)
    sc = torch.empty((e, 1, n), dtype=torch.float32, device=device)
    for ei in range(e):
        q[ei], sc[ei] = _codes(_uniform(gen, (k, n), device), 4 if w4[ei] else 8)
    aq, asc = quantize_rows_uniform(_uniform(gen, (e, k), device).to(torch.bfloat16), 8)
    gs = torch.ones(e, dtype=torch.int32, device=device)
    return aq, asc, q, sc, gs


def fit_unpack(rounds: list) -> dict:
    """The unpack rate from rounds of K4 decode timings. Each round holds one
    row a w4 fraction (the first with nothing packed): ``packed_elems``,
    ``measured_ms`` and ``bytes_model_ms`` (the model's time for the
    weights' bytes). A round's slope is the least-squares slope of the time
    beyond the bytes model, over the packed elements, through the first
    row. The rate is resolved when the median slope stands above the
    slopes' spread (max - min); then ``unpack_gops`` = 1e-6 / median
    (Gelem/s), else 0.0: the slope lies inside the timing noise and the
    model takes no unpack term (the JAX package's 0.0). Returns the rate,
    ``resolved``, the slopes, their median and spread, and each fraction's
    median row with its residual against the median slope."""
    slopes = []
    for rows in rounds:
        r0 = rows[0]["measured_ms"] - rows[0]["bytes_model_ms"]
        xs = np.array([r["packed_elems"] for r in rows])
        ys = np.array([r["measured_ms"] - r["bytes_model_ms"] - r0 for r in rows])
        slopes.append(float((xs * ys).sum() / (xs * xs).sum()))
    med = float(np.median(slopes))
    spread = float(max(slopes) - min(slopes))
    resolved = med > spread
    rows = []
    for i, row in enumerate(rounds[0]):
        ms = float(np.median([rnd[i]["measured_ms"] for rnd in rounds]))
        rows.append({**row, "measured_ms": ms})
    r0 = rows[0]["measured_ms"] - rows[0]["bytes_model_ms"]
    for r in rows:
        r["residual_ms"] = (r["measured_ms"] - r["bytes_model_ms"] - r0
                            - med * r["packed_elems"])
    return {"unpack_gops": 1e-6 / med if resolved else 0.0, "resolved": resolved,
            "slopes_ms_per_elem": slopes, "slope_median": med, "slope_spread": spread,
            "rows": rows}


def fit_rates(device="cuda", reps: int = 10, verbose: bool = True) -> tuple[dict, dict]:
    """The five rates and the launch constant -> (rates, measurements)."""
    from ..ops.gmm_mixed_packed import gmm_mixed_packed
    from ..ops.gmm_w8a8 import gmm_w8a8
    from ..ops.gmm_weight_only import gmm_weight_only
    from ..quant.packing import build_ragged_mixed

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rates, meas = {}, {}

    def say(msg):
        if verbose:
            print(f"[onelaunch_fit] {msg}", flush=True)

    # K1 and K4 over the headline rows, w4 / w8 alternating
    layers = _headline(lambda e: np.arange(e) % 2 == 0, gen, device)
    q_ms = r_ms = q_bytes = flops = 0.0
    for lay in layers:
        aq, asc = lay.quant()
        q_ms += timing.device_ms(lay.quant, reps=reps)
        r_ms += timing.device_ms(lambda: lay.routed(aq, asc), reps=reps)
        m, k = lay.lhs.shape
        q_bytes += m * k * 3.0
        flops += 2.0 * m * k * lay.sc.shape[-1]
    rates["quant_gbps_eff"] = q_bytes / (q_ms * 1e-3) / 1e9
    rates["int8_tflops_eff"] = flops / (r_ms * 1e-3) / 1e12
    meas["k1_headline_ms"], meas["k4_headline_ms"] = q_ms, r_ms
    say(f"K1 {q_ms:.4f} ms -> {rates['quant_gbps_eff']:.1f} GB/s; K4 {r_ms:.4f} ms "
        f"-> {rates['int8_tflops_eff']:.1f} TOP/s")

    # K6 over the same rows and codes (bf16 activations, one scale group)
    b_ms = 0.0
    for lay in layers:
        zp = torch.zeros_like(lay.sc)
        b_ms += timing.device_ms(
            lambda: gmm_weight_only(lay.lhs, lay.q, lay.sc, zp, lay.gs, -1), reps=reps)
    rates["bf16_tflops_eff"] = flops / (b_ms * 1e-3) / 1e12
    meas["k6_headline_ms"] = b_ms
    say(f"K6 {b_ms:.4f} ms -> {rates['bf16_tflops_eff']:.1f} TFLOP/s")
    del layers

    # K2 at decode M: every expert's weights read once
    aq, asc, q, sc, gs = _decode_operands(gen, device)
    m, k, n = aq.shape[0], DEC_K, DEC_N
    d_ms = timing.device_ms(lambda: gmm_w8a8(aq, asc, q, sc, gs), reps=reps)
    d_bytes = DEC_E * k * n + m * k + 2.0 * m * n
    rates["hbm_gbps_eff"] = d_bytes / (d_ms * 1e-3) / 1e9
    meas["k2_decode_ms"] = d_ms
    say(f"K2 decode {d_ms:.4f} ms -> {rates['hbm_gbps_eff']:.1f} GB/s")

    # K4 at decode M: w4 fractions packed against int8-stored, same codes,
    # timed in turns for UNPACK_ROUNDS rounds
    model = OneLaunchPerfModel(k, **{key: rates[key] for key in
                                     ("int8_tflops_eff", "bf16_tflops_eff",
                                      "hbm_gbps_eff", "quant_gbps_eff")},
                               packed_w4=True, unpack_gops=0.0)
    cases = []
    for frac in UNPACK_FRACS:
        w4 = np.arange(DEC_E) < round(frac * DEC_E)
        aq, asc, q, sc, gs = _decode_operands(gen, device, w4)
        cat, blk = build_ragged_mixed(q, w4)
        blk = torch.tensor(blk, dtype=torch.int32, device=device)
        pf = torch.tensor(w4.astype(np.int32), device=device)
        # the model's K4 share (K1 is not in this call)
        pred = sum(model.problem_ms("w4a4_g-1_sym" if f else "w8a8_g-1_sym", 1, n)
                   - 1 * k * 3.0 / model.qbw * 1e3 for f in w4)
        cases.append((frac, float(w4.sum()) * k * n, pred,
                      functools.partial(gmm_mixed_packed, aq, asc, cat, sc, gs, pf, blk)))
    rounds = [[{"w4_frac": frac, "packed_elems": elems, "bytes_model_ms": pred,
                "measured_ms": timing.device_ms(fn, reps=reps)}
               for frac, elems, pred, fn in cases] for _ in range(UNPACK_ROUNDS)]
    del cases
    fit = fit_unpack(rounds)
    rates["unpack_gops"] = fit["unpack_gops"]
    meas["unpack_fit"] = fit
    say(f"K4 decode packed vs int8-stored, {UNPACK_ROUNDS} rounds: slope median "
        f"{fit['slope_median']:.3e} ms/elem, spread {fit['slope_spread']:.3e} -> "
        + (f"unpack {rates['unpack_gops']:.1f} Gelem/s" if fit["resolved"]
           else "not resolved at these shapes: no unpack term"))

    rates["launch_ms"], meas["launch_fit"] = fit_launch(rates, gen, device, reps)
    say(f"launch {rates['launch_ms'] * 1e3:.2f} us")
    return rates, meas


def fit_launch(rates: dict, gen, device, reps: int = 10) -> tuple[float, list]:
    """The per-launch constant: the decode GEMM's columns split into j
    launches (j = 1, 2, 4, 8; the weight bytes and operations do not change
    with j), the least-squares slope over j less the activations and scales
    each extra launch reads again."""
    from ..ops.gmm_w8a8 import gmm_w8a8

    aq, asc, q, sc, gs = _decode_operands(gen, device)
    m, k, n = aq.shape[0], DEC_K, 1024
    q, sc = q[..., :n], sc[..., :n]
    js = (1, 2, 4, 8)
    ts = []
    for j in js:
        nj = n // j
        parts = [(q[..., i * nj:(i + 1) * nj].contiguous(),
                  sc[..., i * nj:(i + 1) * nj].contiguous()) for i in range(j)]
        ts.append(timing.device_ms(
            lambda: [gmm_w8a8(aq, asc, qi, si, gs) for qi, si in parts], reps=reps))
    x, y = np.array(js, float), np.array(ts, float)
    slope = float(((x - x.mean()) * (y - y.mean())).sum() / ((x - x.mean()) ** 2).sum())
    reread_ms = (m * k + m * 4) / (rates["hbm_gbps_eff"] * 1e9) * 1e3
    return max(slope - reread_ms, 0.0), [{"launches": j, "ms": t} for j, t in zip(js, ts)]


def validate(rates: dict, device="cuda", reps: int = 10, verbose: bool = True) -> list:
    """The fitted model against the measured mixed step (both workloads,
    shared expert included) at w4 fractions 0 / 0.5 / 1.0 -> rows of
    measured and predicted ms, the step's and its shared expert's apart, and
    the miss in percent."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for frac in (0.0, 0.5, 1.0):
        layers = _headline(lambda e: np.arange(e) < round(frac * e), gen, device)
        meas = sum(timing.device_ms(lay.step, reps=reps) for lay in layers)
        meas_sh = sum(timing.device_ms(lay.shared_step, reps=reps) for lay in layers
                      if lay.shared is not None)
        pred = pred_sh = 0.0
        for lay in layers:
            k, n = lay.q.shape[1], lay.q.shape[2]
            model = OneLaunchPerfModel(k, packed_w4=True, **rates)
            pred += sum(model.problem_ms("w4a4_g-1_sym" if f else "w8a8_g-1_sym",
                                         int(m), n)
                        for m, f in zip(lay.gs.tolist(), lay.pf.tolist()))
            if lay.shared is not None:
                sl, sq, _ = lay.shared
                pred_sh += OneLaunchPerfModel(sq.shape[1], packed_w4=True, **rates
                                              ).problem_ms("w8a8_g-1_sym", sl.shape[0],
                                                           sq.shape[2])
        pred += pred_sh
        miss = (pred - meas) / meas * 100.0
        out.append({"w4_frac": frac, "measured_ms": meas, "predicted_ms": pred,
                    "miss_pct": miss, "shared_measured_ms": meas_sh,
                    "shared_predicted_ms": pred_sh,
                    "routed_miss_pct": ((pred - pred_sh) - (meas - meas_sh))
                    / (meas - meas_sh) * 100.0})
        if verbose:
            print(f"[onelaunch_fit] validate w4 {frac:.1f}: measured {meas:.4f} ms "
                  f"(shared expert {meas_sh:.4f}), predicted {pred:.4f} ms "
                  f"({pred_sh:.4f}), miss {miss:+.1f} % (routed "
                  f"{out[-1]['routed_miss_pct']:+.1f} %)", flush=True)
        del layers
    return out


def run(out_path: str | None = ONELAUNCH_JSON, device="cuda", reps: int = 10,
        verbose: bool = True) -> dict:
    """Fit, validate, and write the JSON (unless ``out_path`` is None) ->
    the record written."""
    from ..trace.profiler import card_line

    rates, meas = fit_rates(device, reps, verbose)
    rec = {**rates, "unpack_resolved": meas["unpack_fit"]["resolved"],
           "card": card_line(), "time": "device_ms", "measurements": meas,
           "validation": validate(rates, device, reps, verbose)}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="fit OneLaunchPerfModel on the card")
    ap.add_argument("--out", default=ONELAUNCH_JSON)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.out, args.device, args.reps)
    print(json.dumps({k: rec[k] for k in (*RATE_KEYS, "unpack_resolved", "card")}))
    print(f"one-launch fit -> {args.out}")


if __name__ == "__main__":
    _main()
