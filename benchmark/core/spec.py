"""``BENCHMARK.json`` and the files it names, found by name.

For a cell ``<config>.<traffic>`` the harness reads, under the checkout's
``benchmark/``: ``configs/<config>.json`` (the file the configuration entry
names), ``traffic/<traffic>.json``, ``workloads/<cell>.json`` (the cell's
own settings: its trace window and the limits of its check) and, for each
metric the cell reports, ``metrics/<metric>.py``. A later cell, mix,
configuration or metric is a new file and a new entry; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    name: str
    entry: dict               # the workloads entry of BENCHMARK.json
    config: dict              # configs/<config>.json
    traffic: dict             # traffic/<traffic>.json
    settings: dict            # workloads/<cell>.json
    end_to_end: list[dict]    # the end-to-end metrics this cell reports
    per_layer: list[dict]     # the per-layer metrics this cell reports

    @property
    def dir(self) -> pathlib.Path:
        return self.root / "benchmark"


def _read(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load(root, cell: str) -> Cell:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its files."""
    root = pathlib.Path(root)
    bench = _read(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = configs[entry["config"]]["file"]
    bdir = root / "benchmark"
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell, names)]
    return Cell(root, cell, entry, _read(root / cfg_file),
                _read(bdir / "traffic" / f"{entry['traffic']}.json"),
                _read(bdir / "workloads" / f"{cell}.json"), e2e, per_layer)


def reader(cell: Cell, metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    path = cell.dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_family(cell: Cell, family: str) -> dict:
    """``kernel_families/<family>.json``: {"patterns": [regex, ...], ...}."""
    return _read(cell.dir / "kernel_families" / f"{family}.json")
