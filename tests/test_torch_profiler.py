"""The scheme -> kernel registry (``mxmoe_tpu_torch.bench.kernels``) and the
performance-table profiler (``trace.profiler``) on the CPU, where every
front end runs its kernel's plain version: each scheme's launcher against
the dequantized f32 oracle (``reference_output``), the schedule each scheme
names as its tile, the table's schema and its load round trip. The card's
times come from ``chip_smoke.py`` and the profiler CLI on the card.

Bound for the launchers: the outputs are bf16, so each element within half a
bf16 ulp of the f32 oracle, |d| <= 2^-8 |ref| + 1e-4 max|ref| (the int32 and
f32 sums are exact or of another order far below); the weight-only kernels
multiply bf16 weights (dequantized, then rounded once), which adds up to
2^-9 sum_k |a_k| |w_kn| to an output."""

import json

import numpy as np
import pytest
import torch

from mxmoe_tpu_torch.bench import kernels, workloads
from mxmoe_tpu_torch.solver import perf_model
from mxmoe_tpu_torch.trace import profiler

SCHEMES = {"w16a16_g-1_sym": "gmm_bf16", "w8a8_g-1_sym": "gmm_w8a8",
           "w8a8_g-1_asym": "gmm_w8a8_asym", "w4a4_g-1_sym_packed": "gmm_w4a8_packed",
           "w4a16_g-1_sym": "gmm_weight_only", "w4a16_g128_asym": "gmm_weight_only",
           "w4a16_g128_asym_packed": "gmm_weight_only_packed",
           "w4a4_g128_sym": "gmm_w8a8_grouped", "w4a4_g128_asym": "gmm_w8a8_grouped"}


def _abs_product(ops, scheme):
    """sum_k |a_k| |w_kn| of each output, over the dequantized weights."""
    from mxmoe_tpu_torch.quant.packing import (PackedTensor, dequantize_weight_kn,
                                               unpack_int4_halves)
    from mxmoe_tpu_torch.quant.schemes import parse_scheme

    c = parse_scheme(scheme.replace("_packed", ""))
    q = unpack_int4_halves(ops["rhs"]) if scheme.endswith("_packed") else ops["rhs"]
    k = q.shape[1]
    w = dequantize_weight_kn(PackedTensor(q, ops["rhs_sc"], ops["rhs_zp"], int(c.w_bits),
                                          k if c.w_gsize == -1 else c.w_gsize, c.w_sym))
    a = ops["lhs"].float().abs()
    out, r0 = torch.zeros((a.shape[0], w.shape[-1])), 0
    for e, size in enumerate(ops["gs"].tolist()):
        out[r0:r0 + size] = a[r0:r0 + size] @ w[e].abs()
        r0 += size
    return out


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_launcher_equals_reference_output(scheme):
    wl = workloads.synthetic_workload(4, 48, 2, 256, 128, seed=3)
    ops = kernels.build_operands(wl, scheme, device="cpu")
    assert kernels.kernel_of(scheme) == SCHEMES[scheme]
    out = kernels.make_launcher(scheme)(ops)
    ref = kernels.reference_output(ops, scheme)
    assert out.shape == ref.shape == (wl.m_total, wl.n) and out.dtype == torch.bfloat16
    d = (out.float() - ref).abs()
    bound = ref.abs() * 2.0 ** -8 + 1e-4 * ref.abs().max()
    if SCHEMES[scheme].startswith("gmm_weight_only"):
        bound = bound + 2.0 ** -9 * _abs_product(ops, scheme)
    assert (d <= bound).all(), float(d.max())


def test_scheme_tiles_name_the_kernels_schedules():
    k, n, e = 2048, 2816, 60
    big = workloads.synthetic_workload(e, 2048, 4, k, n).m_total
    want = {"w16a16_g-1_sym": "gmm_bf16.wgmma-bm128-bn256",
            "w8a8_g-1_sym": "gmm_w8a8.wgmma-bm128-bn256",
            "w4a4_g-1_sym_packed": "gmm_w4a8_packed.wgmma-bm128-bn256",
            "w8a8_g-1_asym": "gmm_w8a8_asym.wgmma-bm128-bn128",
            "w4a16_g128_asym": "gmm_weight_only.wgmma-bm128-bn256",
            "w4a16_g128_asym_packed": "gmm_weight_only_packed.wgmma-bm128-bn256",
            "w4a4_g128_sym": "gmm_w8a8_grouped.wgmma-bm128-bn128"}
    for s, name in want.items():
        assert repr(kernels.scheme_tile(s, big, k, n, e)) == name, s
    assert repr(kernels.scheme_tile("w8a8_g-1_sym", 16, k, n, e)) == \
        "gmm_w8a8.decode-bm16-bn64"


def test_performance_table_schema_and_round_trip(tmp_path):
    path = str(tmp_path / "table.json")
    schemes = ["w8a8_g-1_sym", "w4a16_g128_asym_packed", "w16a16_g-1_sym"]
    pm, fits = profiler.build_performance_table(
        schemes, k=256, n=128, num_experts=4, scales=(8, 16, 32), top_k=2,
        save_path=path, device="cpu", reps=2, verbose=False)
    raw = json.load(open(path))
    assert sorted(raw) == sorted(schemes + ["_meta"])
    meta = raw["_meta"]
    assert meta["card"] == "cpu" and meta["time"] == "host_ms"
    assert meta["scales"] == [8, 16, 32] and sorted(meta["fits"]) == sorted(schemes)
    for s in schemes:
        (name, tc), = raw[s].items()
        assert set(tc) == {"bm", "bn", "first_iter_cost", "inc"}
        assert name.startswith(kernels.kernel_of(s))
        assert len(fits[s]["residual_ms"]) == 3
    back = perf_model.load_perf_table(path)
    assert back.table == pm.table
    assert back.problem_ms("w8a8_g-1_sym", 100, 128) == pm.problem_ms("w8a8_g-1_sym", 100, 128)
    # the solver's fixed point takes the one tile a scheme has
    name, _ = back.bucket_tile("w8a8_g-1_sym", [(10, 128), (300, 128)])
    assert name == next(iter(raw["w8a8_g-1_sym"]))


def test_profiler_cli_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "t.json")
    profiler._main(["--schemes", "w4a4_g-1_sym", "--k", "128", "--n", "64",
                    "--experts", "3", "--reps", "1", "--device", "cpu", "--out", out])
    raw = json.load(open(out))
    assert "w4a4_g-1_sym" in raw and "_meta" in raw
    assert "performance table ->" in capsys.readouterr().out


def test_card_only_paths_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert profiler.card_line() == "cpu"
    wl = workloads.synthetic_workload(2, 8, 1, 64, 64)
    with pytest.raises(Exception):
        kernels.build_operands(wl, "w8a8_g-1_sym", device="cuda")
    assert np.isfinite(profiler.time_call(lambda: None, torch.device("cpu"), 2))
