"""Gate trace -> grouped-GEMM workload JSON (port of
``mxmoe_tpu/bench/workload_gen.py``, the reference's ``gen_workload.py``).

The file schema the reference's bench binary reads (``gen_workload.py:
93-103``): per layer, per expert, gate_up [freq x tokens x topk, 2N, K] and
down [the same rows, K, N], then the shared expert's rows, each problem
carrying its scheme (w_bits / a_bits / gsize / sym) from a qconfig JSON or a
uniform scheme string. The JSON is byte-equal to the JAX package's.

  python -m mxmoe_tpu_torch.bench.workload_gen --trace moe-gate.json \
      --tokens 8192 --layer 10 --qstr w4a4_g-1_sym --out wl.json
"""

from __future__ import annotations

import json
import os

from ..quant.schemes import QModelConfig, parse_scheme


def _qdict(w_bits, a_bits, gsize, sym):
    return {"w_bits": w_bits, "a_bits": a_bits, "gsize": gsize, "sym": sym}


def _scheme_to_qdict(qstr: str | None) -> dict:
    if qstr is None:
        return _qdict(16, 16, -1, True)
    c = parse_scheme(qstr)
    return _qdict(int(c.w_bits), int(c.a_bits), c.w_gsize, c.w_sym)


def generate_workload_from_gate_trace(
    trace: dict,
    num_total_tokens: int,
    layer_id: int,
    save_path: str | None = None,
    qconfig: QModelConfig | None = None,
    qstr: str | None = None,
) -> dict:
    """The layer's problem list from a loaded gate-trace JSON."""
    topk = trace["topk"]
    n, k = trace["NK"]
    num_shared = trace["num_shared_experts"]
    layer = trace[f"layer-{layer_id}"]
    freq = layer["access_freq"]
    total = sum(freq) or 1
    probs = [f / total for f in freq]

    def block_q(exp_idx: int, linear: str) -> dict:
        if qconfig is not None:
            c = qconfig.layer(layer_id).experts[str(exp_idx)].qmap()[linear]
            return _qdict(int(c.w_bits), int(c.a_bits), c.w_gsize, c.w_sym)
        return _scheme_to_qdict(qstr)

    shapes = {"gate_up": [], "down": []}
    for exp_idx, p in enumerate(probs):
        m = int(p * num_total_tokens * topk)
        shapes["gate_up"].append({"shape": [m, 2 * n, k], **block_q(exp_idx, "gate")})
        shapes["down"].append({"shape": [m, k, n], **block_q(exp_idx, "down")})
    if num_shared > 0:
        # the shared expert runs every token at full width (gen_workload.py:99-103)
        shapes["gate_up"].append({"shape": [num_total_tokens, 2 * n * num_shared, k],
                                  **_qdict(16, 16, -1, True)})
        shapes["down"].append({"shape": [num_total_tokens, k, n * num_shared],
                               **_qdict(16, 16, -1, True)})

    out = {"num_tokens": num_total_tokens, f"layer-{layer_id}": shapes}
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def workload_to_group_problem(layer_wl: dict, which: str = "gate_up"):
    """A workload layer dict -> (group sizes, k, n, schemes, shared). The
    routed problems share (N, K); a trailing wider shared-expert problem is
    split out."""
    probs = layer_wl[which]
    last_differs = len(probs) > 1 and (
        probs[-1]["shape"][1] != probs[0]["shape"][1]
        or probs[-1]["shape"][2] != probs[0]["shape"][2])
    routed = probs[:-1] if last_differs else probs
    shared = probs[len(routed):]
    ms = [p["shape"][0] for p in routed]
    n = routed[0]["shape"][1]
    k = routed[0]["shape"][2]
    schemes = [_qdict(p["w_bits"], p["a_bits"], p["gsize"], p["sym"]) for p in routed]
    return ms, k, n, schemes, shared


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", required=True)
    ap.add_argument("--tokens", type=int, default=8192)
    ap.add_argument("--layer", type=int, default=10)
    ap.add_argument("--qconfig", default=None)
    ap.add_argument("--qstr", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        trace = json.load(f)
    qc = QModelConfig.load(args.qconfig) if args.qconfig else None
    generate_workload_from_gate_trace(trace, args.tokens, args.layer, args.out,
                                      qconfig=qc, qstr=args.qstr)
    print(f"workload -> {args.out}")


if __name__ == "__main__":
    _main()
