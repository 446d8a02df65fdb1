"""Bucketed against fused, for a layer that mixes weight-only and w x a
experts (port of ``mxmoe_tpu/bench/fused_ab.py``; the reference's Fused
mode runs heterogeneous schemes in one persistent kernel,
``hz_fused.cuh:14-127``). The same mixed layer runs as

  (a) bucketed: two launches over the pre-sorted buckets, K6
      (``gmm_weight_only``) on the weight-only rows and K2 (``gmm_w8a8``)
      on the w x a rows, their activations quantized by K1 in ``build_case``;
  (b) fused: one K10 (``gmm_mixed_wo_wxa``) launch with per-expert flags.

  python -m mxmoe_tpu_torch.bench.fused_ab [--ms 32768 2048 512]

One JSON line per (variant, M) with device ms (``bench.timing.device_ms``)
and event ms, then one with ``cross_check_max_abs``: K10's rows are bitwise
K6's and K2's, so anything but 0 raises. Runs on the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def make_case(lhs: torch.Tensor, wq: torch.Tensor, wsc: torch.Tensor, sizes,
              n_wo: int) -> dict:
    """The case of bf16 activations ``lhs`` [M, K], int8 weights ``wq`` [E, K,
    N] with per-channel scales ``wsc`` [E, 1, N], group sizes ``sizes`` and
    the first ``n_wo`` experts weight-only: the activations' 8-bit codes
    (K1), the flags and the group-size tensors."""
    from ..ops.act_quant import quantize_rows_uniform

    dev = lhs.device
    e = wq.shape[0]
    sizes = tuple(int(s) for s in sizes)
    aq, asc = quantize_rows_uniform(lhs, 8)

    def gs(s):
        return torch.tensor(s, dtype=torch.int32, device=dev)

    return dict(lhs=lhs, aq=aq, asc=asc, wq=wq, wsc=wsc, sizes=sizes, n_wo=n_wo,
                m_wo=sum(sizes[:n_wo]), gs=gs(sizes), gs_wo=gs(sizes[:n_wo]),
                gs_xa=gs(sizes[n_wo:]),
                flags=gs([1] * n_wo + [0] * (e - n_wo)))


def build_case(m_total: int, k: int = 2048, n: int = 2816, e: int = 60,
               seed: int = 42, device="cuda") -> dict:
    """A random grouped workload on ``device``, the first half of the experts
    weight-only, the rest w x a, sorted so the weight-only bucket's rows come
    first: bf16 activations and weights uniform in [-1, 1) from a generator
    seeded ``seed``, per-channel int8 weight codes; the group sizes are
    numpy's multinomial draw from ``seed``, the JAX package's."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lhs = (torch.rand((m_total, k), generator=gen, device=device) * 2 - 1).to(
        torch.bfloat16)
    w = torch.rand((e, k, n), generator=gen, device=device) * 2 - 1
    wsc = w.abs().amax(1, keepdim=True) / 127.0
    wq = torch.round(w / wsc).to(torch.int8)
    del w
    sizes = np.random.default_rng(seed).multinomial(m_total, np.ones(e) / e)
    return make_case(lhs, wq, wsc, sizes, e // 2)


def bucketed_step(c: dict) -> torch.Tensor:
    """(a) two launches on the pre-sorted buckets: K6, then K2."""
    from ..ops.gmm_w8a8 import gmm_w8a8
    from ..ops.gmm_weight_only import gmm_weight_only

    n_wo, m_wo = c["n_wo"], c["m_wo"]
    wsc_wo = c["wsc"][:n_wo]
    out_wo = gmm_weight_only(c["lhs"][:m_wo], c["wq"][:n_wo], wsc_wo,
                             torch.zeros_like(wsc_wo), c["gs_wo"], gsize=-1)
    out_xa = gmm_w8a8(c["aq"][m_wo:], c["asc"][m_wo:], c["wq"][n_wo:], c["wsc"][n_wo:],
                      c["gs_xa"])
    return torch.cat([out_wo, out_xa], dim=0)


def fused_step(c: dict) -> torch.Tensor:
    """(b) one K10 launch, per-expert flags."""
    from ..ops.gmm_mixed_wo_wxa import gmm_mixed_wo_wxa

    return gmm_mixed_wo_wxa(c["lhs"], c["aq"], c["asc"], c["wq"], c["wsc"], c["flags"],
                            c["gs"])


def main(argv=None) -> list[dict]:
    from .timing import device_ms, event_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--ms", type=int, nargs="+", default=[32768, 2048, 512])
    ap.add_argument("--experts", type=int, default=60)
    args = ap.parse_args(argv)

    lines = []

    def say(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    for m in args.ms:
        c = build_case(m, e=args.experts)
        k, n = c["wq"].shape[1:]
        flops = 2 * m * k * n
        outs = {}
        for name, step in (("bucketed", bucketed_step), ("fused", fused_step)):
            outs[name] = step(c)
            t = device_ms(lambda: step(c))
            say({"variant": name, "m": m, "ms": t, "event_ms": event_ms(lambda: step(c)),
                 "tflops": flops / (t * 1e-3) / 1e12})
        err = float((outs["bucketed"].float() - outs["fused"].float()).abs().max())
        say({"m": m, "cross_check_max_abs": err})
        if err != 0.0:
            raise AssertionError(f"fused_ab M {m}: K10 differs from K6 + K2 by {err}")
        del c, outs
    return lines


if __name__ == "__main__":
    main()
