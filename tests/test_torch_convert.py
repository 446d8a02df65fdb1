"""The offline path of the port (``models/convert.py``, ``serving/generate.py
--artifact``) against the JAX package: the same HF shards through every
``convert`` branch give the same artifact (the JAX one through its orbax
``load_params`` and ``params_from_jax``), and the artifact serves the same
tokens through the port's ``Engine`` as through the JAX one.

RTN artifacts are bitwise: codes, ``_qcat`` / ``_blk`` / ``_pf``, scales and
zero points. GPTQ artifacts hold the GPTQ sweep's codes, equal to the
reference's but for ties (``test_torch_gptq.py``'s bound, 99.9 %), and their
float leaves within 1e-5 of the largest value.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import convert as jax_convert
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu.quant.hadamard import random_hadamard_matrix as jax_random_hadamard
from mxmoe_tpu.serving.engine import Engine as JaxEngine
from mxmoe_tpu.serving.engine import EngineConfig as JaxEngineConfig
from mxmoe_tpu_torch.models import configs, convert, model, synth_ckpt
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import hadamard as th
from mxmoe_tpu_torch.quant import schemes
from mxmoe_tpu_torch.serving import generate
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

CODE_AGREEMENT_MIN = 0.999
LOGIT_ATOL = 2e-2
CALIB = dict(calib_nsamples=2, calib_seqlen=32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Tiny qwen2_moe HF shards (f32) and the two packages' configs for it."""
    cfg_j = jax_configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    cfg_t = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    root = tmp_path_factory.mktemp("convert")
    synth_ckpt.make_checkpoint(cfg_t, str(root / "hf"), seed=11, dtype=torch.float32)
    return root, cfg_j, cfg_t


@pytest.fixture
def tiny(ckpt, monkeypatch):
    root, cfg_j, cfg_t = ckpt
    monkeypatch.setattr(jax_configs, "config_for", lambda m: cfg_j)
    monkeypatch.setattr(configs, "config_for", lambda m: cfg_t)
    return root, cfg_j, cfg_t


def _qmc(mod, e, layers, routed, shared):
    experts = {str(i): mod.QExpertConfig(*([mod.parse_scheme(routed[i % len(routed)])] * 3))
               for i in range(e)}
    if shared:
        experts[str(e)] = mod.QExpertConfig(*([mod.parse_scheme(shared)] * 3))
    return mod.QModelConfig(layers={str(l): mod.QLayerConfig(experts=dict(experts))
                                    for l in range(layers)})


MIXES = {"mixed": (("w4a4_g-1_sym", "w8a8_g-1_sym"), "w8a8_g-1_sym"),
         "flex": (("w4a4_g16_asym", "w8a8_g-1_sym"), "w8a8_g-1_sym"),
         "flex-fake-shared": (("w4a8_g16_sym", "w8a8_g-1_sym"), "w8a8_g16_asym")}


def _write_qconfig(root, name):
    path = str(root / f"{name}.json")
    routed, shared = MIXES[name]
    _qmc(schemes, 4, 2, routed, shared).save(path)
    assert (jax_schemes.QModelConfig.load(path).to_dict()
            == _qmc(jax_schemes, 4, 2, routed, shared).to_dict())
    return path


_CONVERTED = {}


def _both(root, cfg_t, tag, **kw):
    """Convert the shards with both packages -> (port artifact params on the
    CPU, the JAX artifact's params through orbax and params_from_jax, the
    two meta dicts, the artifacts' tag). A conversion with the same
    arguments earlier in the module is reused."""
    key = json.dumps(kw, sort_keys=True)
    if key not in _CONVERTED:
        jax_convert.convert(str(root / "hf"), "tiny", str(root / f"{tag}_jax"),
                            dtype=jnp.float32, **kw)
        convert.convert(str(root / "hf"), "tiny", str(root / f"{tag}_port"),
                        dtype=torch.float32, device="cpu", **kw)
        _CONVERTED[key] = tag
    tag = _CONVERTED[key]
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_convert.load_params(str(root / f"{tag}_jax"))), "cpu")
    got = convert.load_params(str(root / f"{tag}_port"), device="cpu")
    metas = [json.load(open(root / f"{tag}_{w}" / "mxmoe_meta.json"))
             for w in ("port", "jax")]
    return got, ref, metas, tag


def _compare(got, ref, gptq=False, path=""):
    assert sorted(got) == sorted(ref), path
    for k, r in ref.items():
        if isinstance(r, dict):
            _compare(got[k], r, gptq, f"{path}{k}.")
            continue
        g = got[k]
        assert g.dtype == r.dtype and g.shape == r.shape, (path + k, g.dtype, r.dtype)
        if not gptq or g.dtype == torch.int32 or "act_" in k:
            assert torch.equal(g, r), path + k
        elif g.dtype == torch.int8:
            d = (g.int() - r.int()).abs()
            assert float((d == 0).float().mean()) >= CODE_AGREEMENT_MIN, path + k
        else:
            scale = max(float(r.abs().max()), 1e-30)
            assert float((g - r).abs().max()) <= 1e-5 * scale, path + k


BRANCHES = {
    "float": dict(),
    "quant-w8a8": dict(quant="w8a8_g-1_sym"),
    "quant-w4a8-pack-int4": dict(quant="w4a8_g-1_sym", pack_int4=True),
    "quant-w4a16-g16-asym-pack-int4": dict(quant="w4a16_g16_asym", pack_int4=True),
    "qconfig-rtn-pack-w4": dict(qconfig="mixed"),
    "qconfig-rtn-no-pack": dict(qconfig="mixed", pack_w4=False),
    "qconfig-rtn-flex": dict(qconfig="flex"),
    "qconfig-gptq": dict(qconfig="mixed", method="gptq", **CALIB),
    "qconfig-gptq-flex-fake-shared": dict(qconfig="flex-fake-shared", method="gptq",
                                          **CALIB),
    "qconfig-gptq-had": dict(qconfig="flex", method="gptq-had", **CALIB),
    "layers-1": dict(quant="w8a8_g-1_sym", layers=1),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_convert_branch_vs_jax(tiny, branch, monkeypatch):
    root, cfg_j, cfg_t = tiny
    kw = dict(BRANCHES[branch])
    if "qconfig" in kw:
        kw["qconfig"] = _write_qconfig(root, kw["qconfig"])
    if kw.get("method") == "gptq-had":
        # the reference rotates by random_hadamard_matrix(H, PRNGKey(0)):
        # the port draws the same +-1 signs
        n = cfg_t.hidden_size
        q = np.asarray(jax_random_hadamard(n, jax.random.PRNGKey(0)), np.float64)
        signs = torch.from_numpy(np.sign(q[:, 0] / np.asarray(
            th.hadamard_matrix(n, torch.float64))[:, 0]).astype(np.float32))
        monkeypatch.setattr(th, "random_signs", lambda m, gen=None: signs)
    got, ref, (meta_t, meta_j), tag = _both(root, cfg_t, branch, **kw)
    _compare(got, ref, gptq=kw.get("method", "rtn") != "rtn")
    assert meta_t["dtype"] == "torch.float32"
    assert {k: v for k, v in meta_t.items() if k not in ("dtype", "bytes", "qconfig")} == \
        {k: v for k, v in meta_j.items() if k not in ("dtype", "qconfig")}
    files = os.listdir(root / f"{tag}_port")
    assert meta_t["bytes"] == sum(os.path.getsize(root / f"{tag}_port" / f)
                                  for f in files if f.endswith(".safetensors"))
    if branch == "qconfig-gptq-flex-fake-shared":
        # GPTQ fake-quantizes a grouped shared expert: float weights beside
        # its act bits
        assert "shared_gate_up_q" not in got["layers"]
        assert got["layers"]["act_bits_shared"].shape == (2, 2)


def test_convert_refusals_match_the_reference(tiny):
    root, _, _ = tiny
    for fn, kw in ((jax_convert.convert, dict(dtype=jnp.float32)),
                   (convert.convert, dict(dtype=torch.float32, device="cpu"))):
        with pytest.raises(ValueError, match="pack-int4"):
            fn(str(root / "hf"), "tiny", str(root / "refused"), quant="w4a4_g16_sym",
               pack_int4=True, **kw)
        with pytest.raises(ValueError, match="--method"):
            fn(str(root / "hf"), "tiny", str(root / "refused"), quant="w8a8_g-1_sym",
               method="gptq", **kw)


def _served_tokens(engine, prompts, n=6):
    rids = [engine.submit(p, max_new_tokens=n) for p in prompts]
    out = engine.run_to_completion(chunk=3)
    return [out[r] for r in rids]


@pytest.mark.parametrize("mix,method", [("mixed", "rtn"), ("mixed", "gptq"),
                                        ("flex-fake-shared", "gptq")])
def test_artifact_serves_like_the_reference(tiny, mix, method):
    """convert --qconfig -> the artifact loaded -> the full forward's logits
    within the mixed-slice bound of the JAX artifact's (the grouped GPTQ mix
    through its fake-quantized shared expert); the per-channel mixes'
    greedy tokens (RTN and GPTQ) through the port's Engine equal to the JAX
    Engine's on the JAX artifact. ``generate --artifact --device cpu`` serves
    the Engine's tokens."""
    root, cfg_j, cfg_t = tiny
    qconfig = _write_qconfig(root, mix)
    # the arguments of test_convert_branch_vs_jax's branch, so that its
    # conversions are reused (method="rtn" is the default)
    extra = dict(method=method, **CALIB) if method != "rtn" else {}
    _, _, _, tag = _both(root, cfg_t, f"serve-{mix}-{method}", qconfig=qconfig, **extra)
    params_j = jax_convert.load_params(str(root / f"{tag}_jax"))
    impl_j = JaxMoEImpl(kind="ragged", quant="mixed", interpret=True, decode_attn="xla")
    params_t, cfg_a, impl_t = generate.load_artifact(str(root / f"{tag}_port"), cfg_t,
                                                     torch.device("cpu"), "xla")
    assert cfg_a.num_layers == 2 and impl_t.quant == "mixed"
    toks = np.random.default_rng(2).integers(0, cfg_t.vocab_size, (2, 10))
    lj = np.asarray(jax_model.forward_logits(params_j, jnp.asarray(toks), cfg_j, impl_j))
    lt = model.forward_logits(params_t, torch.from_numpy(toks), cfg_t, impl_t)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=LOGIT_ATOL)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8]]
    kernels.reset_launch_counts()
    have = _served_tokens(Engine(params_t, cfg_a, EngineConfig(
        batch_slots=2, max_len=48, prefill_chunk=16, temperature=0.0), impl_t), prompts)
    assert all(n == 0 for n in kernels.launches.values())
    if mix == "mixed":
        want = _served_tokens(JaxEngine(params_j, cfg_j, JaxEngineConfig(
            batch_slots=2, max_len=48, prefill_chunk=16, temperature=0.0), impl_j),
            prompts)
        assert have == want
    out = generate.main(["--model", "tiny", "--artifact", str(root / f"{tag}_port"),
                         "--device", "cpu", "--prompt", "3 1 4 1 5", "--max-new", "6",
                         "--decode-attn", "xla", "--max-len", "48"])
    assert out == have[0]


def test_artifact_depth_and_mode_come_from_the_artifact(tiny):
    """A 1-layer artifact served with a 2-layer --layers config gets the
    artifact's depth; a uniform artifact's MoEImpl reads mxmoe_meta.json (an
    _asym name serves symmetric activations); a float artifact serves float."""
    root, cfg_j, cfg_t = tiny
    convert.convert(str(root / "hf"), "tiny", str(root / "asym1"), quant="w8a8_g-1_asym",
                    layers=1, dtype=torch.float32, device="cpu")
    _, cfg_a, impl = generate.load_artifact(str(root / "asym1"), cfg_t,
                                            torch.device("cpu"))
    assert cfg_a.num_layers == 1
    assert impl.quant == dataclasses.replace(schemes.parse_scheme("w8a8_g-1_asym"),
                                             a_sym=True)
    convert.convert(str(root / "hf"), "tiny", str(root / "fp"), dtype=torch.float32,
                    device="cpu")
    params, _, impl = generate.load_artifact(str(root / "fp"), cfg_t, torch.device("cpu"))
    assert impl.quant is None and params["layers"]["expert_gate_up"].dtype == torch.float32
    # the float artifact is the checkpoint, and --ckpt serves the same tokens
    out_a = generate.main(["--model", "tiny4", "--artifact", str(root / "fp"), "--device",
                           "cpu", "--max-new", "4", "--decode-attn", "xla"])
    out_c = generate.main(["--model", "tiny4", "--ckpt", str(root / "hf"), "--device",
                           "cpu", "--max-new", "4", "--decode-attn", "xla"])
    assert len(out_a) == 4 and out_c == out_a


def test_convert_cli(tiny):
    root, _, _ = tiny
    convert._main(["--ckpt", str(root / "hf"), "--model", "tiny", "--out",
                   str(root / "cli"), "--quant", "w4a8_g-1_sym", "--pack-int4",
                   "--device", "cpu"])
    meta = convert.load_meta(str(root / "cli"))
    assert meta["quant"] == "w4a8_g-1_sym" and meta["pack_int4"] and meta["layers"] == 2
    p = convert.load_params(str(root / "cli"), device="cpu")
    assert p["layers"]["expert_gate_up_q_packed"].dtype == torch.int8


def test_offline_modules_import_no_jax_safetensors_orbax_or_transformers():
    """The offline path's and the solve path's modules and chip_smoke.py
    import none of jax, the JAX package, safetensors, orbax or transformers
    (the tokenizer lookup imports transformers only when a checkpoint holds
    a tokenizer)."""
    import subprocess
    import sys

    mods = ["mxmoe_tpu_torch.utils.safetensors_io", "mxmoe_tpu_torch.models.hf_loader",
            "mxmoe_tpu_torch.models.convert", "mxmoe_tpu_torch.models.synth_ckpt",
            "mxmoe_tpu_torch.quant.data", "mxmoe_tpu_torch.quant.hadamard",
            "mxmoe_tpu_torch.quant.rotation", "mxmoe_tpu_torch.quant.gptq",
            "mxmoe_tpu_torch.quant.calibrate", "mxmoe_tpu_torch.quant.quantizer",
            "mxmoe_tpu_torch.serving.generate", "mxmoe_tpu_torch.trace.gate",
            "mxmoe_tpu_torch.trace.profiler", "mxmoe_tpu_torch.bench.kernels",
            "mxmoe_tpu_torch.bench.workloads", "mxmoe_tpu_torch.solver.perf_model",
            "mxmoe_tpu_torch.solver.bits_solver", "mxmoe_tpu_torch.solver.onelaunch_fit",
            "chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'mxmoe_tpu', 'safetensors', 'orbax',\n"
            "              'transformers'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
