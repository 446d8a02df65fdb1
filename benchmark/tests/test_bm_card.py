"""On a CUDA card: a short run of each cell, and the control at a cell's
own size (the check must pass for the program and fail for the control).
They skip where there is no card:

  python -m pytest benchmark/tests/test_bm_card.py -q
"""

import json
import subprocess
import sys

import pytest

from . import _tiny

CELLS = [w["name"] for w in json.loads((_tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seed, *extra):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "8", "--trace", "0", *extra],
                         capture_output=True, text=True, cwd=str(_tiny.REPO), timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    result = _run(cell, 2**31 + 77)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_at_the_cell_size(card, cell, seed):
    result = _run(cell, seed, "--control")
    c = result["compared"]
    assert c["widest_logit_gap"]["value"] <= c["widest_logit_gap"]["at_most"]
    assert result["correct"] is False
