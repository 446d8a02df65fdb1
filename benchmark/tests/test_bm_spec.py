"""BENCHMARK.json against the contract's shape, and the harness finding
every configuration, mix, cell, metric reader and kernel family by name: a
new cell is new files and a new entry, with no edit to a file that exists."""

import json
import pathlib
import re
import shutil

import pytest

from benchmark.core import spec
from benchmark.core.arch import arch_of

from . import _tiny

REPO = _tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51


def test_entries_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or c in mv["workloads"]
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = spec.load(REPO, cell)
    assert c.traffic["slots"] >= 1 and "check" in c.settings and "trace" in c.settings
    assert c.end_to_end and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(c, m["name"]))
    arch_of(c.config)
    for fam in ("gmm", "decode_attn"):
        assert spec.kernel_family(c, fam)["patterns"]


def test_catalog_keys_of_the_ds2_configuration():
    """Every published number is kept under its key, but what ``reduced``
    lists."""
    cfg = json.loads((REPO / "benchmark/configs/ds2lite_mx48.json").read_text())
    entry = next(c for c in BENCH["configs"] if c["name"] == "ds2lite_mx48")
    assert entry["reduced"] == ["max_position_embeddings", "rope_scaling"]
    assert cfg["num_hidden_layers"] == 27 and cfg["n_routed_experts"] == 64
    assert cfg["hidden_size"] == 2048 and cfg["kv_lora_rank"] == 512
    assert cfg["vocab_size"] == 102400 and cfg["moe_intermediate_size"] == 1408
    # rope_scaling is the published group but for its factor: no key inside
    # it, mscale_all_dim among them, is dropped or changed
    assert cfg["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 1,
                                   "mscale": 0.707, "mscale_all_dim": 0.707,
                                   "original_max_position_embeddings": 4096,
                                   "type": "yarn"}
    assert cfg["published"]["rope_scaling.factor"] == 40


@pytest.mark.parametrize("rope_scaling, runs", [
    (None, True),
    ({"type": "yarn", "factor": 1, "mscale_all_dim": 0.707}, True),
    ({"type": "yarn", "factor": 40, "mscale_all_dim": 0.707}, False),
    ({"type": "linear", "factor": 1}, False),
])
def test_ds2_runs_only_what_is_plain_rope(rope_scaling, runs):
    """The port has no YaRN: the family takes YaRN only at factor 1, where
    it is plain RoPE, and refuses a stretch it would silently drop."""
    cfg = json.loads((REPO / "benchmark/configs/ds2lite_mx48.json").read_text())
    cfg["rope_scaling"] = rope_scaling
    if runs:
        assert arch_of(cfg).family == "deepseek_v2"
    else:
        with pytest.raises(ValueError, match="YaRN"):
            arch_of(cfg)


def test_an_added_cell_needs_no_edit(tmp_path):
    root, cell = _tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    # a new mix and a new cell: two new files and one new entry
    mix = json.loads((root / "benchmark/traffic/tiny_chat.json").read_text())
    mix.update(slots=2, prompt_len={"dist": "loguniform", "lo": 16, "hi": 32})
    (root / "benchmark/traffic/tiny_pair.json").write_text(json.dumps(mix))
    new = "tiny_qwen.tiny_pair"
    shutil.copy(root / "benchmark/workloads" / f"{cell}.json",
                root / "benchmark/workloads" / f"{new}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": new, "config": "tiny_qwen", "traffic": "tiny_pair",
                               "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(new)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = _tiny.run_tiny(root, new, seed=5, seconds=0.5)
    assert result["metrics"]["out_tok_s"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data
