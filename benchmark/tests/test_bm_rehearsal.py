"""CPU rehearsals of whole runs at tiny size: the last line's shape, the
trace's keys, no module of JAX or of the JAX package loaded, and the
command refusing to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from . import _tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("config", ["tiny_qwen", "tiny_ds2"])
def test_last_line_has_the_contract_shape(tmp_path, config):
    root, cell = _tiny.make_root(tmp_path, config)
    result, lines = _tiny.run_tiny(root, cell, seed=2**31 + 3, seconds=0.6)
    line = json.loads(json.dumps(result))
    assert list(line)[: len(RESULT_KEYS)] == RESULT_KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"out_tok_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert lines[0].startswith("window ") and lines[-1].startswith("widest_logit_gap ")


def test_traced_line_has_busy_window_and_breakdown(tmp_path):
    root, cell = _tiny.make_root(tmp_path)
    result, _ = _tiny.run_tiny(root, cell, seed=21, seconds=0.6, trace=True)
    names = set(result["metrics"])
    assert {"admit_wait_p90_ms", "prefill_chunk_ms", "decode_step_ms", "step_mfu"} <= names
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["correct"] is True


def test_no_module_of_jax_or_the_jax_package(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import _tiny\n"
        "from benchmark.run import forbidden_modules\n"
        "root, cell = _tiny.make_root(%r)\n"
        "_tiny.run_tiny(root, cell, seed=4, seconds=0.3)\n"
        "assert 'mxmoe_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n") % (str(_tiny.REPO), str(tmp_path))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(_tiny.REPO), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark.run import forbidden_modules

    for name in ("mxmoe_tpu_torch.serving", "jaxtyping", "flaxen.x", "mxmoe_tpu.models",
                 "jax._src", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = forbidden_modules()
    assert {"mxmoe_tpu.models", "jax._src", "flax"} <= set(found)
    assert not {"mxmoe_tpu_torch.serving", "jaxtyping", "flaxen.x"} & set(found)


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "qwen2moe_mx48.chat32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=str(_tiny.REPO), timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
