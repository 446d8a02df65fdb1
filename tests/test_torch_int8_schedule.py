"""The int8 grouped GEMM's schedule (K2 / K4 / K5 / K9 share one body):
``int8_gmm_schedule`` at the decode shapes of the main path, and the
decode schedule's split-K order (``int8_split_k_plain``) bitwise the plain
versions of K2, K9, K5 and K4 (int32 sums are exact in any order)."""

import numpy as np
import pytest
import torch

from mxmoe_tpu_torch.ops import gmm_mixed_packed, gmm_w4a8_packed, gmm_w8a8, gmm_w8a8_asym
from mxmoe_tpu_torch.ops.gmm_w8a8 import (DECODE_M, K_TILE, SMS, int8_gmm_schedule,
                                          int8_split_k_plain)
from mxmoe_tpu_torch.quant.packing import (build_ragged_mixed, pack_int4_halves,
                                           unpack_int4_halves)

# (K, N) of the expert products on the main path: qwen2_moe routed gate_up /
# down (H 2048, N 1408), its shared expert (N 5632), ds2's routed and shared
# experts (N 1408, two shared experts N 2816)
ROUTED = [(2048, 2816), (1408, 2048)]
SHARED = [(2048, 11264), (5632, 2048), (2048, 5632), (2816, 2048)]


@pytest.mark.parametrize("m", [4, 16, 24])
@pytest.mark.parametrize("e", [60, 64])
def test_decode_schedule_fills_the_card_routed(m, e):
    for k, n in ROUTED:
        s = int8_gmm_schedule(m, k, n, e)
        assert s.bm == 16 and s.blocks >= 2 * SMS, (k, n, s)


@pytest.mark.parametrize("m", [4, 16, 24])
def test_decode_schedule_fills_the_card_one_group(m):
    for k, n in SHARED:
        s = int8_gmm_schedule(m, k, n, 1)
        assert s.bm == 16 and s.blocks >= 2 * SMS, (k, n, s)


@pytest.mark.parametrize("m,k,n,e,packed", [
    (4, 2048, 11264, 1, False), (4, 5632, 2048, 1, False), (4, 1408, 2048, 64, True),
    (1, 96, 48, 3, False), (64, 2048, 256, 1, True), (17, 1408, 2048, 60, False)])
def test_splits_cut_k_at_whole_k_tiles(m, k, n, e, packed):
    s = int8_gmm_schedule(m, k, n, e, packed)
    kw = k // 2 if packed else k
    k_tiles = -(-kw // K_TILE)
    bounds = [min(z * s.k_tiles_per_split, k_tiles) * K_TILE for z in range(s.splits + 1)]
    assert all(b % K_TILE == 0 for b in bounds[:-1])
    assert bounds[-1] >= kw and bounds[-2] < kw          # every split holds a k-tile
    assert s.ws_ints == (s.grid_n * s.grid_m * s.splits * (16 * 64 + 16)
                         if s.splits > 1 else 0)


def test_prefill_and_unaligned_take_the_64_row_tile():
    assert int8_gmm_schedule(DECODE_M + 1, 2048, 2816, 60).bm == 64
    assert int8_gmm_schedule(256, 2048, 2816, 60).grid_m == 4 + 59
    assert int8_gmm_schedule(16, 96, 40, 3).bm == 64          # N % 16 != 0
    assert int8_gmm_schedule(16, 2048, 2816, 60, aligned=False).bm == 64
    assert int8_gmm_schedule(16, 2048, 2816, 60).grid_m == 16  # bounded by M


def _operands(sizes, k, n, seed, w4=False):
    rng = np.random.default_rng(seed)
    m, e = sum(sizes), len(sizes)
    aq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    asc = torch.from_numpy(rng.uniform(0, 0.05, (m, 1)).astype(np.float32))
    hi = 8 if w4 else 128
    wq = torch.from_numpy(rng.integers(-hi + (not w4), hi, (e, k, n)).astype(np.int8))
    wsc = torch.from_numpy(rng.uniform(0, 0.01, (e, 1, n)).astype(np.float32))
    zp = torch.from_numpy(rng.uniform(-0.1, 0.1, (e, 1, n)).astype(np.float32))
    return aq, asc, wq, wsc, zp, torch.tensor(sizes, dtype=torch.int32)


SIZES = [5, 0, 19, 1, 0, 7]


@pytest.mark.parametrize("tps", [1, 2, 4, 8])
def test_split_k_bitwise_k2_and_k9_plain(tps):
    aq, asc, wq, wsc, zp, gs = _operands(SIZES, 512, 64, tps)
    got = int8_split_k_plain(aq, asc, lambda e: wq[e], wsc, gs, tps)
    assert torch.equal(got, gmm_w8a8.gmm_w8a8_plain(aq, asc, wq, wsc, gs))
    got = int8_split_k_plain(aq, asc, lambda e: wq[e], wsc, gs, tps, rhs_zp=zp,
                             out_dtype=torch.float32)
    assert torch.equal(got, gmm_w8a8_asym.gmm_w8a8_asym_plain(
        aq, asc, wq, wsc, zp, gs, out_dtype=torch.float32))


@pytest.mark.parametrize("tps", [1, 2, 4, 8])
def test_split_k_bitwise_k5_and_k4_plain(tps):
    aq, asc, wq, wsc, _, gs = _operands(SIZES, 1024, 64, 10 + tps, w4=True)
    packed = pack_int4_halves(wq)
    got = int8_split_k_plain(aq, asc, lambda e: unpack_int4_halves(packed[e]), wsc,
                             gs, tps, packed_of=lambda e: True)
    assert torch.equal(got, gmm_w4a8_packed.gmm_w4a8_packed_plain(aq, asc, packed,
                                                                  wsc, gs))
    pflags = [i % 2 for i in range(len(SIZES))]
    cat, blk = build_ragged_mixed(wq, pflags)
    got = int8_split_k_plain(aq, asc, lambda e: wq[e], wsc, gs, tps,
                             packed_of=lambda e: bool(pflags[e]))
    ref = gmm_mixed_packed.gmm_mixed_packed_plain(
        aq, asc, cat, wsc, gs, torch.tensor(pflags, dtype=torch.int32),
        torch.tensor(blk, dtype=torch.int32))
    assert torch.equal(got, ref)
