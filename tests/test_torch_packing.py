"""Port parity: the nibble-packed and ragged mixed weight storage of
mxmoe_tpu_torch.quant.packing, the scheme config tree of
mxmoe_tpu_torch.quant.schemes and the pack step of
mxmoe_tpu_torch.models.convert against mxmoe_tpu.

Tolerances: none. Packed bytes, ragged buffers, block offsets, flags and the
config tree's JSON are exactly equal."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.quant import packing as jp
from mxmoe_tpu.quant import schemes as js
from mxmoe_tpu_torch.models.convert import pack_int4_experts
from mxmoe_tpu_torch.quant import packing as tp
from mxmoe_tpu_torch.quant import schemes as ts


def _codes4(rng, shape):
    return rng.integers(-8, 8, shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(6, 5), (3, 8, 16), (2, 3, 44, 12)])
def test_pack_unpack_int4_halves_bitwise(shape):
    q = _codes4(np.random.default_rng(sum(shape)), shape)
    ref = np.asarray(jp.pack_int4_halves(jnp.asarray(q)))
    got = tp.pack_int4_halves(torch.from_numpy(q))
    assert got.dtype == torch.int8 and got.shape[-2] == shape[-2] // 2
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tp.unpack_int4_halves(got)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jp.unpack_int4_halves(jnp.asarray(ref))))


@pytest.mark.parametrize("pflags", [[1, 0, 1, 1, 0], [0, 0, 0], [1, 1, 1, 1]])
def test_build_ragged_mixed_bitwise(pflags):
    rng = np.random.default_rng(len(pflags))
    e, k, n = len(pflags), 24, 10
    wq = np.stack([_codes4(rng, (k, n)) if f else
                   rng.integers(-127, 128, (k, n)).astype(np.int8) for f in pflags])
    ref_cat, ref_blk = jp.build_ragged_mixed(jnp.asarray(wq), pflags)
    cat, blk = tp.build_ragged_mixed(torch.from_numpy(wq), pflags)
    np.testing.assert_array_equal(cat.numpy(), np.asarray(ref_cat))
    assert list(blk) == [int(b) for b in ref_blk]
    assert cat.shape[0] == sum(k // 2 if f else k for f in pflags)


def test_pack_ragged_stack_pads_to_longest_layer():
    rng = np.random.default_rng(7)
    pf_all = [[1, 0, 1, 0], [1, 1, 1, 0], [0, 0, 1, 0]]     # 6, 5, 7 units
    e, k, n = 4, 16, 6
    q_layers = [np.stack([_codes4(rng, (k, n)) if f else
                          rng.integers(-127, 128, (k, n)).astype(np.int8)
                          for f in pf]) for pf in pf_all]
    ref = jp.pack_ragged_stack(q_layers, pf_all)
    got = tp.pack_ragged_stack((torch.from_numpy(q) for q in q_layers), pf_all)
    assert got[0].shape == (3, 7 * k // 2, n)
    for g, r, dt in zip(got, ref, (torch.int8, torch.int32, torch.int32)):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _mixed_tree(mod):
    s4, s8, sg = (mod.parse_scheme(s) for s in
                  ("w4a4_g-1_sym", "w8a8_g-1_sym", "w4a16_g64_asym"))
    layers = {}
    for l in range(2):
        experts = {str(e): mod.QExpertConfig(*([s4 if (e + l) % 2 else s8] * 3))
                   for e in range(4)}
        experts["4"] = mod.QExpertConfig(gate=s8, up=s8, down=sg)
        layers[str(l)] = mod.QLayerConfig(experts=experts)
    return mod.QModelConfig(layers=layers, lt={"0": (0.5, 1.25), "1": (0.1, 2.0)})


def test_qmodel_config_json_roundtrip_matches_reference(tmp_path):
    ref, got = _mixed_tree(js), _mixed_tree(ts)
    assert got.to_dict() == ref.to_dict()
    got.save(tmp_path / "q.json")
    ref.save(tmp_path / "ref.json")
    assert json.load(open(tmp_path / "q.json")) == json.load(open(tmp_path / "ref.json"))
    # each package loads the other's file
    back = ts.QModelConfig.load(tmp_path / "ref.json")
    assert back.to_dict() == js.QModelConfig.load(tmp_path / "q.json").to_dict()
    assert back.all_schemes() == ref.all_schemes()
    assert back.all_weight_schemes() == ref.all_weight_schemes()
    assert ts.schemes_in_layer(back.layer(0)) == js.schemes_in_layer(ref.layer(0))


def test_uniform_builders_and_flex_family_info_match_reference():
    for scheme in ("w8a8_g-1_sym", "w4a4_g128_sym", "w4a8_g-1_asym", "w4a16_g-1_sym"):
        ref = js.build_uniform_model(js.parse_scheme(scheme), 2, 3)
        got = ts.build_uniform_model(ts.parse_scheme(scheme), 2, 3)
        assert got.to_dict() == ref.to_dict()
        for lin, kdim in (("gate", 256), ("down", 384)):
            assert (ts.flex_family_info(got, 2, 3, lin, kdim)
                    == js.flex_family_info(ref, 2, 3, lin, kdim))
    # two grouped sizes in one family: both refuse (the reference asserts,
    # the port raises ValueError so the check survives python -O)
    bad = {str(e): s for e, s in enumerate(("w4a4_g64_sym", "w4a4_g128_sym"))}
    for mod, exc in ((js, AssertionError), (ts, ValueError)):
        qmc = mod.QModelConfig(layers={"0": mod.QLayerConfig(experts={
            e: mod.build_uniform_expert(mod.parse_scheme(s)) for e, s in bad.items()})})
        with pytest.raises(exc):
            mod.flex_family_info(qmc, 1, 2, "gate", 256)


def test_pack_int4_experts_matches_reference_pack_step():
    rng = np.random.default_rng(11)
    layers = {"expert_gate_up_q": _codes4(rng, (2, 3, 16, 12)),
              "expert_down_q": _codes4(rng, (2, 3, 6, 16)),
              "expert_gate_up_sc": rng.random((2, 3, 1, 12)).astype(np.float32)}
    got = pack_int4_experts(
        {"layers": {k: torch.from_numpy(v) for k, v in layers.items()}},
        ts.parse_scheme("w4a8_g-1_sym"))["layers"]
    assert sorted(got) == ["expert_down_q_packed", "expert_gate_up_q_packed",
                           "expert_gate_up_sc"]
    for name in ("expert_gate_up_q", "expert_down_q"):
        np.testing.assert_array_equal(
            got[name + "_packed"].numpy(),
            np.asarray(jp.pack_int4_halves(jnp.asarray(layers[name]))))
    params = {"layers": {k: torch.from_numpy(v) for k, v in layers.items()}}
    with pytest.raises(ValueError):
        pack_int4_experts(params, ts.parse_scheme("w8a8_g-1_sym"))
    with pytest.raises(ValueError):
        pack_int4_experts(params, ts.parse_scheme("w4a4_g128_sym"))
    # a weight-only scheme of at most 4 bits packs whatever its group size
    # and symmetry (K7 dequantizes with scale and zp per group)
    for scheme in ("w4a16_g-1_sym", "w4a16_g128_asym", "w3a16_g128_sym"):
        a16 = pack_int4_experts(params, ts.parse_scheme(scheme))["layers"]
        assert sorted(a16) == sorted(got)
        for name in a16:
            assert torch.equal(a16[name], got[name]), (scheme, name)
    with pytest.raises(ValueError):
        pack_int4_experts(params, ts.parse_scheme("w8a16_g-1_sym"))
