"""The metric arithmetic on hand-worked cases: percentiles, the union of
device intervals and the idle share, the trace's per-range device time and
idle labels, and the model-operation count."""

import pytest

from benchmark.core import flops
from benchmark.core.arch import Arch
from benchmark.core.stats import covered, gaps, percentile, union
from benchmark.core.trace import Trace


def test_percentile_is_linear_between_ranks():
    assert percentile([], 90) is None
    assert percentile([5.0], 90) == 5.0
    assert percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == pytest.approx(9.1)
    assert percentile([10, 0, 20], 50) == 10
    assert percentile(range(101), 90) == 90


def test_union_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union(iv, 0.0, 5.0) == [(0.0, 2.0), (3.0, 4.0)]
    assert covered(iv, 0.0, 5.0) == pytest.approx(3.0)      # not 1 + 1.5 + 1 + 0.1
    assert covered(iv, 1.5, 3.5) == pytest.approx(1.0)      # clipped to the window
    assert gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def _trace():
    device = [(0.0, 1.0, "gmm_int8_decode_kernel<bf16>"), (0.5, 2.0, "decode_attn_kernel<bf16>"),
              (2.2, 2.3, "elementwise"), (3.0, 4.0, "gmm_wsr_kernel<bf16>"),
              (4.5, 4.6, "elementwise")]
    ranges = {"bm.window": [(0.0, 5.0)], "bm.step": [(0.0, 2.5)], "bm.submit": [(2.6, 4.2)]}
    return Trace((0.0, 5.0), device, ranges)


def test_idle_share_is_one_minus_the_union():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(3.2)
    assert 100 * (1 - tr.busy_s() / tr.window_s) == pytest.approx(36.0)


def test_device_time_inside_a_range_by_family():
    tr = _trace()
    assert tr.device_s_in("bm.step", [r"(^|::)gmm_\w*kernel"]) == pytest.approx(1.0)
    assert tr.device_s_in("bm.submit", [r"(^|::)gmm_\w*kernel"]) == pytest.approx(1.0)
    assert tr.device_s_in("bm.step", [r"(^|::)decode_attn\w*kernel"]) == pytest.approx(1.5)


def test_breakdown_labels_idle_time_by_the_host_range():
    bd = _trace().breakdown()
    assert bd["device_ops"][0] == ["decode_attn_kernel<bf16>", pytest.approx(1.5)]
    idle = dict(bd["idle_gaps"])
    # gaps: (2.0, 2.2) mid 2.1 -> in the step; (2.3, 3.0) mid 2.65 -> in
    # the submit; (4.0, 4.5) and (4.6, 5.0) -> between calls
    assert idle["host in step"] == pytest.approx(0.2)
    assert idle["host in submit"] == pytest.approx(0.7)
    assert idle["host in between calls"] == pytest.approx(0.5 + 0.4)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


TINY = Arch(family="qwen2_moe", vocab=10, hidden=4, layers=2, heads=2, kv_heads=1,
            head_dim=2, experts=3, top_k=2, expert_n=5, shared_n=6, shared_gate=True,
            norm_topk=False, routed_scale=1.0, rope_theta=1e4, eps=1e-6, qkv_bias=True,
            tie_embed=False)


def test_params_per_token_by_hand():
    attn = 4 * 4 + 4 * 2 + 4 * 2 + 4 * 4          # wq, wk, wv, wo
    moe = 4 * 3 + 2 * 3 * 4 * 5 + 3 * 4 * 6 + 4    # router, 2 experts, shared, its gate
    assert flops.params_per_token(TINY) == 2 * (attn + moe) + 4 * 10


def test_ops_per_key_and_a_prompt_sum():
    assert flops.ops_per_key(TINY) == 2 * 2 * 2 * (2 + 2)
    brute = sum(flops.token_ops(TINY, 1, i + 1) for i in range(5))
    assert flops.token_ops(TINY, 5, 5 * 6 // 2) == brute       # a submit span's keys


def test_mla_params_by_hand():
    a = Arch(family="deepseek_v2", vocab=10, hidden=4, layers=3, heads=2, kv_heads=2,
             head_dim=3, experts=4, top_k=2, expert_n=5, shared_n=5, shared_gate=False,
             norm_topk=False, routed_scale=1.0, rope_theta=1e4, eps=1e-6, qkv_bias=False,
             tie_embed=False, attention="mla", kv_lora=6, qk_nope=2, qk_rope=1, v_dim=3,
             dense_layers=1, dense_n=7)
    attn = 4 * 2 * 3 + 4 * (6 + 1) + 6 * 2 * (2 + 3) + 2 * 3 * 4
    moe = 4 * 4 + 2 * 3 * 4 * 5 + 3 * 4 * 5
    assert flops.params_per_token(a) == 3 * attn + 2 * moe + 3 * 4 * 7 + 4 * 10
    assert flops.ops_per_key(a) == 2 * 3 * 2 * (3 + 3)
