"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests it served, drawn from the seed, with the longest in it, goes
through the configuration's plain reference (``reference/<name>.py``): the
prompt and the served tokens, teacher-forced, in float32. Each served
token's reference logit is compared with the reference's best at its
position; the widest gap is held against the cell's limit. Every finished
request must also have served exactly the tokens it asked for (no EOS).

The sample: the finished requests; the longest first (prompt
and served tokens), then the others in an order drawn from the seed, until
it holds ``min_requests`` and ``min_served`` served tokens, leaving out any
request that would take the reference past ``max_positions`` positions.

``--control`` puts the reference's control in the program's place: the
same prompts and tokens, read at the control's precision; at each position
the gap of the token the control puts first is held against the same limit.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .weights import subseed


def sample(requests, settings: dict, seed: int) -> list:
    pool = [s for s in requests if s.done]
    if not pool:
        return []
    size = [len(s.req.prompt) + len(s.tokens) for s in pool]
    first = int(np.argmax(size))
    rng = np.random.default_rng(subseed(seed, "check:sample"))
    order = [first] + [i for i in rng.permutation(len(pool)) if i != first]
    out, served, positions = [], 0, 0
    for i in order:
        if len(out) >= settings["min_requests"] and served >= settings["min_served"]:
            break
        if out and positions + size[i] > settings["max_positions"]:
            continue
        out.append(pool[i])
        served += len(pool[i].tokens)
        positions += size[i]
    return out


def widest_gaps(ref_rows, served, control_rows=None) -> float:
    """max over positions of (the reference's best logit - its logit of the
    served token), or of the token the control puts first."""
    worst = 0.0
    for i, toks in enumerate(served):
        ref = ref_rows[i]
        pick = (torch.tensor(toks, device=ref.device) if control_rows is None
                else control_rows[i].argmax(-1))
        gap = ref.max(-1).values - ref.gather(1, pick[:, None].long())[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def check(cell, arch, requests, seed: int, device, control: bool = False) -> dict:
    """-> {name: {"value", "at_least" | "at_most"}} of every number
    compared: the sample's sizes, the length errors and the widest gaps."""
    settings = cell.settings["check"]
    chosen = sample(requests, settings, seed)
    ref = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    seqs = [(s.req.prompt + s.tokens, len(s.req.prompt)) for s in chosen]
    variants = ("stated", "control") if control else ("stated",)
    rows = ref.served_logits(arch, cell.config["quant"], seed, seqs, variants, device)
    served = [s.tokens for s in chosen]
    limit = settings["widest_logit_gap"]
    out = {
        "requests_checked": {"value": len(chosen), "at_least": settings["min_requests"]},
        "served_tokens_checked": {"value": sum(len(t) for t in served),
                                  "at_least": settings["min_served"]},
        "length_errors": {"value": sum(1 for s in requests
                                       if s.done and len(s.tokens) != s.req.max_new),
                          "at_most": 0},
        "widest_logit_gap": {"value": widest_gaps(rows["stated"], served), "at_most": limit},
    }
    if control:
        out["control_widest_logit_gap"] = {
            "value": widest_gaps(rows["stated"], served, rows["control"]), "at_most": limit}
    return out


def passes(compared: dict, control: bool) -> bool:
    """Every count at least its minimum and every error and gap at most
    its limit; under ``--control`` the control's gap stands in for the
    program's."""
    skip = "widest_logit_gap" if control else "control_widest_logit_gap"
    for name, c in compared.items():
        if name == skip:
            continue
        if "at_least" in c and not c["value"] >= c["at_least"]:
            return False
        if "at_most" in c and (c["at_most"] is None or not c["value"] <= c["at_most"]):
            return False
    return True


def lines(compared: dict) -> list[str]:
    """One plain line a number compared, beside its limit."""
    out = []
    for name, c in compared.items():
        bound = ("at least", c["at_least"]) if "at_least" in c else ("at most", c["at_most"])
        out.append(f"{name} {c['value']!r} {bound[0]} {bound[1]!r}")
    return out
