"""The check that decides ``correct``, at tiny size on the CPU: the program
passes; the control (the reference one precision step lower) fails; and a
run with the timed path broken underneath fails, once for each fault a
one-card serving cell can have (the exchange between cards has none here)."""

import dataclasses

import pytest
import torch

from benchmark.core import check
from benchmark.core.serve import Served
from benchmark.core.traffic import Request

from . import _tiny

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


@pytest.mark.parametrize("config", ["tiny_qwen", "tiny_ds2"])
@pytest.mark.parametrize("seed", SEEDS)
def test_program_passes_and_control_fails(tmp_path, config, seed):
    root, cell = _tiny.make_root(tmp_path, config)
    result, _ = _tiny.run_tiny(root, cell, seed=seed, seconds=1.0, control=True)
    c = result["compared"]
    limit = c["widest_logit_gap"]["at_most"]
    assert c["widest_logit_gap"]["value"] <= limit
    assert c["control_widest_logit_gap"]["value"] > limit
    assert result["correct"] is False            # under --control the control decides


def _broken_run(tmp_path, monkeypatch, patch):
    from mxmoe_tpu_torch.serving import graph

    patch(monkeypatch, graph)
    root, cell = _tiny.make_root(tmp_path)
    result, _ = _tiny.run_tiny(root, cell, seed=SEEDS[0], seconds=1.0)
    return result


def _state_unchanged(monkeypatch, graph):
    """A decode step that leaves the cache (and its lengths) as it found it."""
    real = graph.forward_cached

    def step(params, tokens, cache, cfg, impl, valid_lengths=None):
        if tokens.shape[1] != 1:
            return real(params, tokens, cache, cfg, impl, valid_lengths=valid_lengths)
        saved = {f.name: getattr(cache, f.name).clone() for f in dataclasses.fields(cache)}
        logits, new = real(params, tokens, cache, cfg, impl, valid_lengths=valid_lengths)
        for name, t in saved.items():
            getattr(cache, name).copy_(t)
        return logits, dataclasses.replace(new, lengths=saved["lengths"])

    monkeypatch.setattr(graph, "forward_cached", step)


def _half_batch(monkeypatch, graph):
    """The step's second half of the slots left out: they get the first
    half's tokens."""
    real = graph.sample_tokens

    def sample(logits, *a, **k):
        out = real(logits, *a, **k).clone()
        half = out.shape[0] // 2
        out[half: 2 * half] = out[:half]
        return out

    monkeypatch.setattr(graph, "sample_tokens", sample)


def _token_altered(monkeypatch, graph):
    """One token altered where it is produced, a slot in turn at each step."""
    real = graph.sample_tokens
    steps = [0]

    def sample(logits, *a, **k):
        out = real(logits, *a, **k).clone()
        i = steps[0] % out.shape[0]
        out[i] = (out[i] + 1) % logits.shape[-1]
        steps[0] += 1
        return out

    monkeypatch.setattr(graph, "sample_tokens", sample)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    result = _broken_run(tmp_path, monkeypatch, fault)
    assert result["correct"] is False
    c = result["compared"]
    assert c["widest_logit_gap"]["value"] > c["widest_logit_gap"]["at_most"]


def _served(n_prompt, n_tok, done=True):
    s = Served(Request([1] * n_prompt, n_tok), 0.0)
    s.tokens, s.done = [2] * n_tok, done
    return s


def test_sample_holds_the_longest_and_enough_tokens():
    reqs = [_served(10, 5), _served(40, 30), _served(12, 6), _served(8, 4), _served(9, 9)]
    settings = {"min_requests": 2, "min_served": 12, "max_positions": 1000}
    got = check.sample(reqs, settings, seed=3)
    assert got[0] is reqs[1]
    assert len(got) >= 2 and sum(len(s.tokens) for s in got) >= 12
    assert got == check.sample(reqs, settings, seed=3)


def test_sample_takes_only_finished_requests():
    reqs = [_served(10, 5, done=False), _served(40, 30, done=False), _served(12, 6)]
    got = check.sample(reqs, {"min_requests": 2, "min_served": 1, "max_positions": 100}, 1)
    assert got == [reqs[2]]
    assert check.sample(reqs[:2], {"min_requests": 1, "min_served": 1,
                                   "max_positions": 100}, 1) == []


def test_widest_gap_reads_the_served_and_the_control_token():
    ref = [torch.tensor([[0.0, 1.0, 0.5], [2.0, 0.0, 1.5]])]
    assert check.widest_gaps(ref, [[1, 0]]) == 0.0
    assert check.widest_gaps(ref, [[2, 1]]) == pytest.approx(2.0)
    control = [torch.tensor([[0.0, 0.0, 9.0], [0.0, 0.0, 9.0]])]
    assert check.widest_gaps(ref, [[1, 0]], control) == pytest.approx(0.5)
