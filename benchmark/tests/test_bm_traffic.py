"""The traffic generator: deterministic in the seed, the same sizes for
every seed (each cycle of the pool holds each stratified size once), a
stratified opening, every request fitting its slot."""

import json
import pathlib

import numpy as np
import pytest

from benchmark.core.traffic import Traffic

MIXES = pathlib.Path(__file__).resolve().parent.parent / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def _stream(t, n):
    return [t.next() for _ in range(n)]


@pytest.mark.parametrize("name", ["chat32"])
def test_same_seed_same_requests(name):
    a, b = Traffic(_mix(name), 2**31 + 17, 5000), Traffic(_mix(name), 2**31 + 17, 5000)
    ra, rb = a.opening() + _stream(a, 70), b.opening() + _stream(b, 70)
    assert [(r.prompt, r.max_new, r.in_flight) for r in ra] == \
        [(r.prompt, r.max_new, r.in_flight) for r in rb]


@pytest.mark.parametrize("name", ["chat32"])
def test_every_seed_serves_the_same_sizes(name):
    mix = _mix(name)
    n = mix["pool"]
    sizes = []
    for seed in (1, 2, 2**31 + 5):
        t = Traffic(mix, seed, 5000)
        t.next_index = n                      # past the opening's cycle
        reqs = _stream(t, 2 * n)
        cycles = [reqs[:n], reqs[n:]]
        sizes.append([(sorted(len(r.prompt) for r in c), sorted(r.max_new for r in c))
                      for c in cycles])
        orders = [[len(r.prompt) for r in c] for c in cycles]
        assert orders[0] != orders[1]         # each cycle in its own order
    assert sizes[0] == sizes[1] == sizes[2]
    lo, hi = mix["prompt_len"]["lo"], mix["prompt_len"]["hi"]
    assert min(sizes[0][0][0]) >= lo and max(sizes[0][0][0]) <= hi


def test_seeds_differ_in_order_and_tokens():
    mix = _mix("chat32")
    a, b = Traffic(mix, 1, 5000), Traffic(mix, 2, 5000)
    ra, rb = _stream(a, 40), _stream(b, 40)
    assert [len(r.prompt) for r in ra] != [len(r.prompt) for r in rb]
    assert ra[0].prompt[:8] != rb[0].prompt[:8]


@pytest.mark.parametrize("name", ["chat32"])
def test_opening_is_stratified_and_fits(name):
    mix = _mix(name)
    totals = []
    for seed in (3, 4, 2**31 + 9):
        t = Traffic(mix, seed, 5000)
        op = t.opening()
        assert len(op) == mix["slots"] and all(r.in_flight for r in op)
        assert all(r.max_new >= 2 for r in op)
        assert all(len(r.prompt) + r.max_new + 1 <= mix["max_len"] for r in op)
        # served + left = the stratified in-flight lengths, the same multiset every seed
        totals.append(sorted(len(r.prompt) - p + r.max_new
                             for r, p in zip(op, [t._sizes(i)[0] for i in range(len(op))])))
    assert totals[0] == totals[1] == totals[2]


def test_quantiles_are_log_uniform():
    t = Traffic(_mix("chat32"), 0, 5000)
    q = np.sort(t.prompt_q)
    assert q[0] >= 128 and q[-1] <= 1024
    assert abs(np.median(np.log(q)) - np.log(np.sqrt(128 * 1024))) < 0.05
