"""The whole-FFN kernels' decomposition (K12 ``gmm_ffn_w8a8``, K13
``gmm_ffn_mixed_packed``, ``csrc/gmm_ffn_tile.cuh``): a thread block cluster
of C CTAs per 32-row m-tile, CTA r computing the h columns of its share of
16-column units, the partial row amax merged by max, the codes gathered
into hq, and CTA r computing its share of the output columns.
``ffn_split_plain`` below writes that order of work in plain PyTorch; for
every cluster size it must give the plain versions' bits (the int32 sums are
exact, the f32 steps are per element, a max does not depend on order), at
row counts on the edges of the m16 / m32 fragments, with empty experts, a
tile that straddles two experts, down bits 4 / 6 / 8 and every packing of
K13's ragged storage. Once, at the reference test's set-up, it is held to
the JAX kernel in interpret mode with ``tests/test_torch_gmm_ffn.py``'s
tolerance (5e-3 absolute, at most 2 % of the outputs differing: XLA's and
torch's CPU sigmoid differ in the last bits). Small widths: K 128-256, N
128-256, H 128."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant.qparams import quantize_act_per_row_bits as jax_qrows
from mxmoe_tpu_torch.ops import gmm_ffn
from mxmoe_tpu_torch.ops.gmm_ffn import _ragged_block
from mxmoe_tpu_torch.ops.gmm_w8a8 import exact_int8_matmul
from mxmoe_tpu_torch.quant.packing import build_ragged_mixed
from mxmoe_tpu_torch.quant.qparams import _row_upper

# the kernels' constants (csrc/gmm_ffn_tile.cuh): rows of an m-tile, columns
# of a split unit (one 16-byte weight piece), CTAs of a cluster
FFN_BM, FFN_UNIT, FFN_C = 32, 16, 8
CLUSTERS = [1, 2, 4, 8]
# rows per expert: 1 / 16 (one m16 fragment), 17 / 32 (two), 33 / 64 (two
# tiles), empty experts; unaligned, so tiles straddle experts
EDGES = [1, 16, 0, 17, 32, 33, 64]


def ffn_column_split(cols: int, cluster: int) -> list[tuple[int, int]]:
    """The columns [c0, c1) of each CTA of a cluster, for ``cols`` h columns
    (gate_up) or output columns (down), as ``ffn_tile`` splits them: ``U =
    cdiv(cols, FFN_UNIT)`` units of 16 columns, CTA r taking units ``[r U //
    cluster, (r + 1) U // cluster)``; the last range ends at ``cols``. A CTA
    may own none."""
    units = -(-cols // FFN_UNIT)
    return [(r * units // cluster * FFN_UNIT,
             min((r + 1) * units // cluster * FFN_UNIT, cols)) for r in range(cluster)]


def ffn_split_plain(lhs_q, lhs_scale, gate_up_of, gu_scale, down_of, down_scale,
                    group_sizes, act_bits_down, out_dtype, cluster: int = FFN_C):
    """The kernels' decomposition of ``gmm_ffn.ffn_plain`` (same arguments):
    per expert, per 32-row m-tile (a tile that straddles two experts once
    per expert), CTA r of ``cluster`` computes the gate and up columns of its
    ``ffn_column_split`` share, exact int32 sums then ``(acc * s_a) *
    s_gu``; the partial row amax of each CTA's h slice, merged by max, gives
    the scale; each CTA's codes are gathered into the tile's hq; CTA r
    computes its share of the output columns. SwiGLU is evaluated on the
    assembled [rows, N] gate and up, as ``ffn_plain`` lays them out: torch's
    CPU sigmoid may round an element of a vector loop's body and of its
    scalar tail differently, the kernel's does not."""
    m = lhs_q.shape[0]
    n, h = gu_scale.shape[-1] // 2, down_scale.shape[-1]
    h_split, o_split = ffn_column_split(n, cluster), ffn_column_split(h, cluster)
    out = torch.zeros((m, h), dtype=out_dtype, device=lhs_q.device)
    bits = act_bits_down.tolist()
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        wgu, wd, sgu, sd = gate_up_of(e), down_of(e), gu_scale[e], down_scale[e]
        for m0 in range(start // FFN_BM * FFN_BM, end, FFN_BM):
            r0, r1 = max(m0, start), min(m0 + FFN_BM, end)
            a, sa = lhs_q[r0:r1], lhs_scale[r0:r1]
            gate = torch.empty((r1 - r0, n), dtype=torch.float32, device=a.device)
            up = torch.empty_like(gate)
            for c0, c1 in h_split:                     # 1. gate_up, CTA by CTA
                for dst, off in ((gate, 0), (up, n)):
                    acc = exact_int8_matmul(a, wgu[:, off + c0: off + c1])
                    dst[:, c0:c1] = acc.float() * sa * sgu[:, off + c0: off + c1]
            hf = gate * torch.sigmoid(gate) * up
            partial = torch.stack([hf[:, c0:c1].abs().amax(-1) if c1 > c0
                                   else torch.zeros(r1 - r0, device=a.device)
                                   for c0, c1 in h_split])
            upper = _row_upper(torch.full((r1 - r0,), float(bits[e]), device=a.device))
            scale = (torch.clamp(partial.amax(0), min=1e-8) / upper)[:, None]
            hq = torch.cat([torch.round(hf[:, c0:c1] / scale)         # 2. codes,
                            for c0, c1 in h_split], dim=1).to(torch.int8)  # gathered
            for c0, c1 in o_split:                     # 3. down, CTA by CTA
                res = exact_int8_matmul(hq, wd[:, c0:c1]).float() * scale * sd[:, c0:c1]
                out[r0:r1, c0:c1] = res.to(out_dtype)
        start += size
    return out


def _operands(sizes, k, n, h, seed, tail=8):
    rng = np.random.default_rng(seed)
    e, m = len(sizes), sum(sizes) + tail
    aq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    asc = torch.from_numpy((rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32))
    wgu = torch.from_numpy(rng.integers(-127, 128, (e, k, 2 * n), dtype=np.int8))
    sgu = torch.from_numpy((rng.random((e, 1, 2 * n)) * 2e-4 + 1e-5).astype(np.float32))
    wd = torch.from_numpy(rng.integers(-127, 128, (e, n, h), dtype=np.int8))
    sd = torch.from_numpy((rng.random((e, 1, h)) * 2e-3 + 1e-5).astype(np.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    bits = torch.tensor([(4, 6, 8)[i % 3] for i in range(e)], dtype=torch.int32)
    return aq, asc, wgu, sgu, wd, sd, gs, bits


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("sizes,k,n,h", [(EDGES, 256, 256, 128),
                                         ([5, 0, 40, 64], 128, 128, 128),
                                         ([0, 0, 3], 256, 192, 128)])
def test_split_plain_is_k12_plain(cluster, sizes, k, n, h):
    aq, asc, wgu, sgu, wd, sd, gs, bits = _operands(sizes, k, n, h, seed=k + n + cluster)
    for out_dtype in (torch.float32, torch.bfloat16):
        ref = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits, out_dtype)
        got = ffn_split_plain(aq, asc, lambda e: wgu[e], sgu, lambda e: wd[e], sd, gs,
                              bits, out_dtype, cluster=cluster)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("packing", ["none", "alternating", "all"])
def test_split_plain_is_k13_plain(cluster, packing):
    sizes, k, n, h = EDGES, 256, 128, 128
    aq, asc, wgu, sgu, wd, sd, gs, bits = _operands(sizes, k, n, h, seed=3 + cluster)
    e = len(sizes)
    pf = {"none": [0] * e, "alternating": [int(i % 2 == 0) for i in range(e)],
          "all": [1] * e}[packing]
    pfb = torch.tensor(pf, dtype=torch.bool)[:, None, None]
    wgu = torch.where(pfb, wgu.clamp(-8, 7), wgu)
    wd = torch.where(pfb, wd.clamp(-8, 7), wd)
    gu_cat, gu_blk = build_ragged_mixed(wgu, pf)
    d_cat, d_blk = build_ragged_mixed(wd, pf)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    ref = gmm_ffn.gmm_ffn_mixed_packed_plain(aq, asc, gu_cat, sgu, i32(pf), i32(gu_blk),
                                             d_cat, sd, i32(pf), i32(d_blk), gs, bits)
    got = ffn_split_plain(aq, asc, _ragged_block(gu_cat, pf, gu_blk, k), sgu,
                          _ragged_block(d_cat, pf, d_blk, n), sd, gs, bits,
                          torch.bfloat16, cluster=cluster)
    k12 = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits)
    assert torch.equal(got, ref) and torch.equal(got, k12)


@pytest.mark.parametrize("rows", [1, 16, 17, 32, 33, 64])
def test_split_plain_one_expert_row_counts(rows):
    """One live expert among empty ones, its rows on each fragment edge, at
    the port's cluster size; the rows past it stay zero."""
    sizes = [0, rows, 0]
    aq, asc, wgu, sgu, wd, sd, gs, bits = _operands(sizes, 128, 256, 128, seed=rows)
    ref = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits)
    got = ffn_split_plain(aq, asc, lambda e: wgu[e], sgu, lambda e: wd[e], sd, gs, bits,
                          torch.bfloat16)
    assert torch.equal(got, ref) and bool(got[rows:].eq(0).all())


def test_split_plain_vs_jax_kernel():
    """The reference test's set-up (5 experts, K = N = H = 256, sizes
    64/0/32/64/32, down bits 4/8/8/4/6), the JAX kernel in interpret mode."""
    e, k, nh, hout = 5, 256, 256, 256
    sizes, bits_down = [64, 0, 32, 64, 32], [4, 8, 8, 4, 6]
    m = sum(sizes) + 32
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k)).astype(np.float32)

    def qw(w):
        sc = (np.abs(w).max(axis=1, keepdims=True) / np.float32(127.0)).astype(np.float32)
        return np.round(w / sc).astype(np.int8), sc

    wgu_q, wgu_sc = qw((rng.standard_normal((e, k, 2 * nh)) * 0.05).astype(np.float32))
    wd_q, wd_sc = qw((rng.standard_normal((e, nh, hout)) * 0.05).astype(np.float32))
    aq, asc = (np.array(v) for v in jax_qrows(jnp.asarray(x), jnp.full((m,), 8.0)))
    ref = np.asarray(pallas_gmm.gmm_ffn_w8a8(
        jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wgu_q), jnp.asarray(wgu_sc),
        jnp.asarray(wd_q), jnp.asarray(wd_sc), jnp.asarray(sizes, jnp.int32),
        act_bits_down=jnp.asarray(bits_down, jnp.int32), bm=32, out_dtype=jnp.float32,
        interpret=True))
    t = [torch.from_numpy(v) for v in (aq, asc, wgu_q, wgu_sc, wd_q, wd_sc)]
    got = ffn_split_plain(t[0], t[1], lambda g: t[2][g], t[3], lambda g: t[4][g], t[5],
                          torch.tensor(sizes, dtype=torch.int32),
                          torch.tensor(bits_down, dtype=torch.int32), torch.float32)
    rows = sum(sizes)
    diff = np.abs(got[:rows].numpy() - ref[:rows])
    assert diff.max() <= 5e-3, diff.max()
    assert (diff != 0).mean() < 0.02, (diff != 0).mean()


@pytest.mark.parametrize("cols,cluster", [(1408, 8), (2048, 8), (1408, 16), (2048, 16),
                                          (64, 8), (132, 8), (256, 4)])
def test_column_split(cols, cluster):
    """The split at the serving widths (qwen2_moe / ds2 N 1408 and H 2048)
    and at the edges: every range starts on a 16-column unit, the ranges
    tile [0, cols) in CTA order, their widths differ by at most one unit,
    and a CTA may own none. Plain ints: nothing reaches a device."""
    split = ffn_column_split(cols, cluster)
    assert len(split) == cluster and split[0][0] == 0 and split[-1][1] == cols
    assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
    assert all(c0 % FFN_UNIT == 0 and c1 >= c0 for c0, c1 in split)
    widths = [-(-(c1 - c0) // FFN_UNIT) for c0, c1 in split]
    assert max(widths) - min(widths) <= 1
    assert all(isinstance(c, int) for rng in split for c in rng)


def test_column_split_at_the_decode_widths():
    """qwen2_moe at the kernels' cluster size: 176 h columns (11 units) and
    256 output columns a CTA."""
    assert {c1 - c0 for c0, c1 in ffn_column_split(1408, FFN_C)} == {176}
    assert {c1 - c0 for c0, c1 in ffn_column_split(2048, FFN_C)} == {256}
