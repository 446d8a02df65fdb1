"""Port parity for the mesh Engine: the port's Engine(mesh) on 4 gloo ranks
(one pool for the file, ``_torch_dist_pool``) against the JAX package's
Engine(mesh) on 4 devices of its CPU mesh, same weights (the JAX package's
params, sliced per rank by the port's own ``shard_params`` /
``pad_expert_arrays`` / ``shard_ragged_mixed``) and prompts. Greedy tokens
are equal, as the JAX package's ``tests/test_serving_mesh.py`` holds its mesh
Engine to its one-device Engine; the capacity is the JAX tests' (E), so
nothing drops. Also ``submit_batch`` (one device and mesh) and
``generate --mesh 2 --device cpu`` against ``generate --device cpu``."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mxmoe_tpu.models import configs as jcfgs
from mxmoe_tpu.models import model as jmodel
from mxmoe_tpu.models.layers import MoEImpl as JImpl
from mxmoe_tpu.parallel.ep import EPConfig as JEPConfig
from mxmoe_tpu.quant import qparams as jq
from mxmoe_tpu.quant.schemes import (QExpertConfig, QLayerConfig, QModelConfig,
                                     parse_scheme)
from mxmoe_tpu.serving.engine import Engine as JEngine
from mxmoe_tpu.serving.engine import EngineConfig as JEngineConfig

import _torch_ep_tasks as tasks
from _torch_dist_pool import DistPool

WORLD = 4
TIMEOUT = 150.0
PROMPTS = [[3, 14, 15, 9, 2], [6, 5, 35, 8], [9, 7, 9], [31, 4, 1, 5, 9]]

# name -> (num_experts, layers, seed, schemes (None: w8a8 uniform), pack_w4,
#          whether the shared expert takes a scheme, max_len, max_new, impl
#          fields); the prefill chunk is 8 (the prompts fit one chunk)
CHUNK = 8
CASES = {
    "uniform": (8, 2, 0, None, False, False, 64, 8, {"quant": "w8a8_g-1_sym"}),
    "mixed": (8, 2, 9, ("w4a4_g-1_sym", "w8a8_g-1_sym"), False, False, 48, 6,
              {"quant": "mixed"}),
    "a16-mixed": (8, 2, 2, ("w4a16_g-1_sym", "w8a8_g-1_sym"), False, False, 32, 4,
                  {"quant": "mixed", "mixed_weight_only": True}),
    "packed-mixed": (8, 2, 12, ("w4a4_g-1_sym", "w8a8_g-1_sym"), True, False, 48, 6,
                     {"quant": "mixed"}),
    # index E = the shared expert, grouped asymmetric (K8 with one group)
    "flex": (8, 2, 21, ("w4a4_g16_asym", "w8a8_g-1_sym"), False, True, 48, 6,
             {"quant": "mixed"}),
    # non-divisible E: 6 experts over 4 ranks (phantoms to 8); and 60
    "e6": (6, 1, 7, ("w4a4_g-1_sym", "w8a8_g-1_sym"), False, False, 32, 4,
           {"quant": "mixed"}),
    "e60-packed": (60, 1, 7, ("w4a4_g-1_sym", "w8a8_g-1_sym"), True, False, 32, 4,
                   {"quant": "mixed"}),
}


def _spec(e, layers):
    return ("tiny_qwen2_moe", e, layers, {})


def _params(e, layers, seed, schemes, pack, shared):
    cfg = jcfgs.tiny_qwen2_moe(num_experts=e, num_layers=layers)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if schemes is None:
        return cfg, jq.quantize_model_experts_uniform(params, parse_scheme("w8a8_g-1_sym"))
    n = e + 1 if shared else e
    qm = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(i): QExpertConfig(*([parse_scheme(schemes[i % 2])] * 3)) for i in range(n)})
        for l in range(layers)})
    return cfg, jq.quantize_model_experts_mixed(params, cfg, qm, pack_w4=pack)


def _jax_impl(impl_kw):
    kw = dict(impl_kw)
    if kw.get("quant") not in (None, "mixed"):
        kw["quant"] = parse_scheme(kw["quant"])
    return JImpl(kind="ragged", interpret=True, **kw)


def _jax_engine(params, cfg, impl_kw, max_len, max_new, cap, batch=False):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), axis_names=("expert",))
    eng = JEngine(params, cfg, JEngineConfig(batch_slots=WORLD, max_len=max_len,
                                             prefill_chunk=CHUNK),
                  _jax_impl(impl_kw), mesh=mesh,
                  ep_cfg=JEPConfig(axis="expert", capacity_factor=cap))
    rids = (eng.submit_batch(PROMPTS, max_new_tokens=max_new) if batch
            else [eng.submit(p, max_new_tokens=max_new) for p in PROMPTS])
    eng.run_to_completion()
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def pool():
    p = DistPool(WORLD)
    yield p
    p.close()


@pytest.fixture(scope="module")
def references():
    """Each case's params (numpy) and the JAX Engine(mesh)'s tokens; for
    "batch", those of its submit_batch over the "mixed" case's params."""
    out = {}
    for name, (e, layers, seed, schemes, pack, shared, max_len, max_new,
               impl_kw) in CASES.items():
        cfg, params = _params(e, layers, seed, schemes, pack, shared)
        toks = _jax_engine(params, cfg, impl_kw, max_len, max_new, float(e))
        out[name] = (jax.tree_util.tree_map(np.asarray, params), toks)
        if name == "mixed":
            out["batch"] = _jax_engine(params, cfg, impl_kw, max_len, max_new,
                                       float(e), batch=True)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_engine_tokens_equal_jax(pool, references, name):
    e, layers, _, _, _, _, max_len, max_new, impl_kw = CASES[name]
    params, ref = references[name]
    got = pool.run(tasks.engine, WORLD, _spec(e, layers), params, impl_kw,
                   dict(batch_slots=WORLD, max_len=max_len, prefill_chunk=CHUNK),
                   PROMPTS, max_new, float(e), timeout=TIMEOUT)
    toks = [g[0] for g in got]
    assert all(t == toks[0] for t in toks), "ranks disagree on the tokens"
    assert toks[0] == ref, (toks[0], ref)
    # the cache is sharded over the slots, the experts over the ranks
    assert all(g[2] == 1 for g in got)
    assert all(g[3] == -(-e // WORLD) for g in got)


def test_mesh_engine_capacity_from_gate_trace(pool, references):
    """No EPConfig: the capacity factor comes from the gate frequencies
    (margin 1.5, at least 2.0), as the JAX Engine derives it."""
    from mxmoe_tpu.parallel.ep import capacity_factor_from_freq

    params, ref = references["uniform"]
    freq = np.array([8.0, 8, 1, 1, 1, 1, 1, 1])
    got = pool.run(tasks.engine, WORLD, _spec(8, 2), params, {"quant": "w8a8_g-1_sym"},
                   dict(batch_slots=WORLD, max_len=64, prefill_chunk=CHUNK), PROMPTS, 8,
                   None, False, freq,
                   timeout=TIMEOUT)
    assert got[0][1] == max(capacity_factor_from_freq(freq, WORLD, margin=1.5), 2.0)
    assert got[0][0] == ref


def test_packed_a16_mix_on_a_mesh_raises():
    import torch

    from mxmoe_tpu_torch.serving.engine import _mesh_setup

    lp = {"expert_gate_up_qcat": torch.zeros(1), "act_bits_gateup": torch.tensor([16.0]),
          "act_bits_down": torch.tensor([8.0])}

    class OneRank:
        mesh_dim_names = ("expert",)

        def size(self):
            return 1

    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.serving.engine import EngineConfig

    with pytest.raises(ValueError, match="PACKED a16"):
        _mesh_setup({"layers": lp}, configs.tiny_qwen2_moe(8, 1), EngineConfig(),
                    MoEImpl(quant="mixed"), OneRank(), None, None)


def test_submit_batch_one_device_equals_jax(references):
    """One device: the port's submit_batch gives the JAX Engine(mesh)'s
    submit_batch tokens (which, dropless, are one device's)."""
    import torch

    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    params, _ = references["mixed"]
    e, layers, _, _, _, _, max_len, max_new, _ = CASES["mixed"]
    eng = Engine(params_from_jax(params, "cpu"), configs.tiny_qwen2_moe(e, layers),
                 EngineConfig(batch_slots=WORLD, max_len=max_len, prefill_chunk=CHUNK),
                 MoEImpl(quant="mixed"))
    with torch.inference_mode():
        rids = eng.submit_batch(PROMPTS, max_new_tokens=max_new)
        eng.run_to_completion()
    assert [eng.result(r) for r in rids] == references["batch"]


def test_mesh_submit_batch_equals_jax(pool, references):
    params, _ = references["mixed"]
    e, layers, _, _, _, _, max_len, max_new, impl_kw = CASES["mixed"]
    got = pool.run(tasks.engine, WORLD, _spec(e, layers), params, impl_kw,
                   dict(batch_slots=WORLD, max_len=max_len, prefill_chunk=CHUNK),
                   PROMPTS, max_new, float(e), True, timeout=TIMEOUT)
    assert all(g[0] == references["batch"] for g in got)


def _generate_tokens(out: str) -> list:
    line = next(l for l in out.splitlines() if l.startswith("output tokens"))
    return [int(t) for t in line.split("[")[1].rstrip("]").split(",")]


def test_generate_mesh_cpu_equals_one_device():
    import contextlib
    import io

    from mxmoe_tpu_torch.serving import generate

    args = ["--model", "tiny", "--device", "cpu", "--max-new", "6",
            "--prompt", "3 14 15 9 2", "--slots", "2"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run([sys.executable, "-m", "mxmoe_tpu_torch.serving.generate",
                           *args, "--mesh", "2"], capture_output=True, text=True,
                          timeout=180, cwd=root, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 ranks (direct)" in proc.stdout
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        one = generate.main(args)
    assert _generate_tokens(proc.stdout) == one


def test_generate_capacity_factor_from_gate_trace(tmp_path):
    """``generate --gate-trace``: the worst layer's factor (the JAX CLI's
    margin 1.25), at least 2.0; without a trace, ``--capacity-factor``."""
    import argparse
    import json

    from mxmoe_tpu.parallel.ep import capacity_factor_from_freq
    from mxmoe_tpu_torch.serving import generate

    freqs = {"layer-0": [8, 8, 1, 1, 1, 1, 1, 1], "layer-1": [1, 1, 1, 1, 1, 1, 9, 9]}
    path = tmp_path / "moe-gate.json"
    path.write_text(json.dumps({k: {"access_freq": v} for k, v in freqs.items()}))
    args = argparse.Namespace(gate_trace=str(path), mesh=4, capacity_factor=8.0)
    want = max(max(capacity_factor_from_freq(v, 4) for v in freqs.values()), 2.0)
    assert generate._capacity_factor(args) == want > 2.0
    args.gate_trace = None
    assert generate._capacity_factor(args) == 8.0
