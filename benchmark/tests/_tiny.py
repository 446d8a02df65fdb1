"""A checkout-like root holding a tiny cell, for CPU rehearsals of the
harness: the real metric readers and kernel families, a tiny configuration,
mix and cell settings from ``data/``, and a BENCHMARK.json whose metrics are
the real ones."""

from __future__ import annotations

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent
DATA = BENCH / "tests" / "data"


def make_root(tmp, config: str = "tiny_qwen", cell_settings: dict | None = None,
              mix: str = "tiny_chat") -> tuple:
    """-> (root, cell name) of a root with one tiny cell ``<config>.<mix>``."""
    root = pathlib.Path(tmp)
    b = root / "benchmark"
    for sub in ("metrics", "kernel_families"):
        shutil.copytree(BENCH / sub, b / sub)
    for sub in ("configs", "traffic", "workloads"):
        (b / sub).mkdir(parents=True)
    shutil.copy(DATA / f"{config}.json", b / "configs" / f"{config}.json")
    shutil.copy(DATA / f"{mix}.json", b / "traffic" / f"{mix}.json")
    cell = f"{config}.{mix}"
    settings = json.loads((DATA / "tiny_cell.json").read_text())
    settings.update(cell_settings or {})
    (b / "workloads" / f"{cell}.json").write_text(json.dumps(settings))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    end_to_end = [{**m, "workloads": [cell]} if "workloads" in m else m
                  for m in real["end_to_end"]]
    per_layer = [{**m, "workloads": [cell]} for m in real["per_layer"]]
    bench = {**real, "end_to_end": end_to_end,
             "configs": [{"name": config, "source": "test", "file": f"benchmark/configs/{config}.json",
                          "reduced": [], "why": "tiny"}],
             "workloads": [{"name": cell, "config": config, "traffic": mix, "chips": 1,
                            "why": "tiny"}],
             "per_layer": per_layer}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, cell


class Ticks:
    """A clock that advances ``step`` seconds at every reading: a CPU
    rehearsal's window then holds the same iterations at every run."""

    def __init__(self, step: float = 0.001):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def run_tiny(root, cell: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
             control: bool = False):
    """One CPU run of the tiny cell on a ``Ticks`` clock -> (result, lines)."""
    from benchmark.core import harness, spec

    clock = Ticks()
    return harness.run(spec.load(root, cell), seed, seconds, trace, "cpu", clock(),
                       control, clock)
