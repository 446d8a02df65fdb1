"""Port parity: mxmoe_tpu_torch.serving.decode_attention (the plain versions
of K3 and of the read-only forms) against the JAX Pallas kernels
(interpret): decode_attention_update_stacked, then decode_attention_stacked,
decode_attention and decode_attention_q8.

Tolerances: the caches after the write are bitwise equal (one f32 -> bf16
round of the same value). The f32 output agrees to rtol = atol = 2e-5:
the JAX kernel's online softmax over 64-position blocks and the plain
version's single softmax sum in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.serving import decode_attention as jax_da
from mxmoe_tpu.serving.decode_attention import (
    decode_attention_update_stacked as jax_update)
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.serving import decode_attention as da
from mxmoe_tpu_torch.serving.decode_attention import decode_attention_update_stacked


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("lengths,valid", [
    ([0, 70, 128, 127], [1, 1, 1, 1]),       # empty, mid, full, last position
    ([5, 64, 128, 0], [0, 1, 0, 1]),         # masked writes, block boundary
])
def test_decode_update_stacked_vs_jax(lengths, valid):
    rng = np.random.default_rng(sum(lengths))
    nl, b, n_kv, groups, hd, s_max, layer = 2, 4, 2, 2, 128, 128, 1
    n_h = n_kv * groups
    q = rng.standard_normal((b, n_h, hd)).astype(np.float32)
    kn = rng.standard_normal((b, n_kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, n_kv, hd)).astype(np.float32)
    ck = _bf16(rng.standard_normal((nl, b, n_kv, s_max, hd)))
    cv = _bf16(rng.standard_normal((nl, b, n_kv, s_max, hd)))
    lens = np.asarray(lengths, np.int32)
    val = np.asarray(valid, np.int32)

    out_j, (ck_j, cv_j) = jax_update(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(ck, jnp.bfloat16), None, jnp.asarray(cv, jnp.bfloat16),
        None, jnp.asarray(lens), jnp.int32(layer), valid=jnp.asarray(val),
        block_s=64, interpret=True)

    ck_t = torch.from_numpy(ck).to(torch.bfloat16)
    cv_t = torch.from_numpy(cv).to(torch.bfloat16)
    kernels.reset_launch_counts()
    out_t, (ck_r, cv_r) = decode_attention_update_stacked(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        ck_t, None, cv_t, None, torch.from_numpy(lens), layer,
        valid=torch.from_numpy(val))
    assert ck_r is ck_t and cv_r is cv_t                  # written in place
    assert kernels.launches["decode_attention_update_stacked"] == 0

    np.testing.assert_array_equal(ck_t.float().numpy(),
                                  np.asarray(ck_j.astype(jnp.float32)))
    np.testing.assert_array_equal(cv_t.float().numpy(),
                                  np.asarray(cv_j.astype(jnp.float32)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The read-only forms (decode_attention_stacked, decode_attention,
# decode_attention_q8): their plain versions against the JAX kernels in
# interpret mode, at the shapes of tests/test_decode_attention.py (GQA,
# MLA-style dk != dv, S ragged against the block) plus lengths 0 and >= S.
# Tolerance rtol = atol = 2e-5 (bf16 cache) and 2e-4 (int8 cache, scores
# scaled by ~1e-2-wide k-scales), as the reference's own tests: the same
# f32 online softmax against one softmax sum, in other orders. Positions
# past a slot's length carry inf scales in the int8 cases: both sides mask
# them to 0 after the v-scale multiply.


def _inf_past_length(sc, lengths):
    """Scales [.., B, n_kv, S] with inf at every position past a slot's
    attended range (min(length, S-1))."""
    s_max = sc.shape[-1]
    pos = np.arange(s_max)
    keep = pos[None, :] <= np.minimum(lengths, s_max - 1)[:, None]        # [B, S]
    keep = keep[:, None, :]                                              # [B, 1, S]
    return np.where(keep, sc, np.inf).astype(np.float32)


@pytest.mark.parametrize("n_h,n_kv,dk,dv,s_max,block_s", [
    (8, 2, 32, 32, 128, 64),      # GQA
    (4, 4, 40, 24, 96, 96),       # MLA-style: dk != dv, no grouping
    (8, 8, 32, 32, 200, 64),      # ragged s_max vs block
])
@pytest.mark.parametrize("edge", [False, True])
def test_decode_attention_plain_vs_jax(n_h, n_kv, dk, dv, s_max, block_s, edge):
    rng = np.random.default_rng(dk * s_max + edge)
    b = 4
    q = rng.standard_normal((b, n_h, dk)).astype(np.float32)
    ck = _bf16(rng.standard_normal((b, n_kv, s_max, dk)))
    cv = _bf16(rng.standard_normal((b, n_kv, s_max, dv)))
    # the reference's last block of a ragged S reads past the cache (NaN in
    # interpret mode) and leaks it through 0 * v: its lengths stay within
    # the whole blocks there
    last = (s_max // block_s) * block_s - 1
    lens = (np.asarray([0, last, s_max // 3, 1], np.int32) if edge
            else rng.integers(0, s_max - 1, b).astype(np.int32))
    if edge and s_max % block_s == 0:
        lens[3] = s_max + 5                           # past the end: all S
    want = jax_da.decode_attention(
        jnp.asarray(q), jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16),
        jnp.asarray(lens), block_s=block_s, interpret=True)
    kernels.reset_launch_counts()
    got = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(ck).to(torch.bfloat16),
        torch.from_numpy(cv).to(torch.bfloat16), torch.from_numpy(lens),
        block_s=block_s)
    assert kernels.launches["decode_attention"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lengths", [None, [0, 159, 160, 300]])
def test_decode_attention_q8_plain_vs_jax(lengths):
    rng = np.random.default_rng(11)
    b, n_h, n_kv, hd, s_max = 4, 8, 2, 32, 160
    q = rng.standard_normal((b, n_h, hd)).astype(np.float32)
    ckq = rng.integers(-127, 128, (b, n_kv, s_max, hd)).astype(np.int8)
    cvq = rng.integers(-127, 128, (b, n_kv, s_max, hd)).astype(np.int8)
    lens = (rng.integers(1, s_max - 1, b) if lengths is None
            else np.asarray(lengths)).astype(np.int32)
    cks = _inf_past_length(rng.uniform(1e-3, 3e-2, (b, n_kv, s_max)), lens)
    cvs = _inf_past_length(rng.uniform(1e-3, 3e-2, (b, n_kv, s_max)), lens)
    block_s = 32 if lengths is not None else 64       # 160 = 5 x 32: no ragged tail
    want = jax_da.decode_attention_q8(
        jnp.asarray(q), jnp.asarray(ckq), jnp.asarray(cks), jnp.asarray(cvq),
        jnp.asarray(cvs), jnp.asarray(lens), block_s=block_s, interpret=True)
    got = da.decode_attention_q8(
        torch.from_numpy(q), torch.from_numpy(ckq), torch.from_numpy(cks),
        torch.from_numpy(cvq), torch.from_numpy(cvs), torch.from_numpy(lens))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths", [None, [0, 191, 192, 400]])
def test_decode_attention_stacked_plain_vs_jax(quant, lengths):
    rng = np.random.default_rng(3 + quant)
    nl, b, n_h, n_kv, hd, s_max = 3, 4, 8, 2, 32, 192
    q = rng.standard_normal((b, n_h, hd)).astype(np.float32)
    lens = (rng.integers(0, s_max - 1, b) if lengths is None
            else np.asarray(lengths)).astype(np.int32)
    if quant:
        ck = rng.integers(-127, 128, (nl, b, n_kv, s_max, hd)).astype(np.int8)
        cv = rng.integers(-127, 128, (nl, b, n_kv, s_max, hd)).astype(np.int8)
        ks = _inf_past_length(rng.uniform(1e-3, 3e-2, (nl, b, n_kv, s_max)), lens)
        vs = _inf_past_length(rng.uniform(1e-3, 3e-2, (nl, b, n_kv, s_max)), lens)
        jc = [jnp.asarray(ck), jnp.asarray(ks), jnp.asarray(cv), jnp.asarray(vs)]
        tc = [torch.from_numpy(a) for a in (ck, ks, cv, vs)]
        tol = 2e-4
    else:
        ck = _bf16(rng.standard_normal((nl, b, n_kv, s_max, hd)))
        cv = _bf16(rng.standard_normal((nl, b, n_kv, s_max, hd)))
        jc = [jnp.asarray(ck, jnp.bfloat16), None, jnp.asarray(cv, jnp.bfloat16), None]
        tc = [torch.from_numpy(ck).to(torch.bfloat16), None,
              torch.from_numpy(cv).to(torch.bfloat16), None]
        tol = 2e-5
    before = [None if t is None else t.clone() for t in tc]
    for layer in (0, 2):
        want, _ = jax_da.decode_attention_stacked(
            jnp.asarray(q), *jc, jnp.asarray(lens), jnp.int32(layer), block_s=64,
            interpret=True)
        got, caches = da.decode_attention_stacked(
            torch.from_numpy(q), *tc, torch.from_numpy(lens), layer, block_s=64)
        assert all(c is t for c, t in zip(caches, [t for t in tc if t is not None]))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    for t, t0 in zip(tc, before):                        # read-only
        assert t is None or torch.equal(t, t0)


def test_per_layer_forms_refuse_a_stacked_cache_like_the_reference():
    """The reference's per-layer kernels take 4D caches only (their block
    specs are 4D): a 5D cache raises there, and here."""
    q = np.ones((2, 4, 32), np.float32)
    c5 = np.ones((3, 2, 2, 64, 32), np.float32)
    s5 = np.ones((3, 2, 2, 64), np.float32)
    lens = np.asarray([3, 5], np.int32)
    with pytest.raises((ValueError, TypeError)):
        jax_da.decode_attention(jnp.asarray(q), jnp.asarray(c5), jnp.asarray(c5),
                                jnp.asarray(lens), block_s=32, interpret=True)
    with pytest.raises((ValueError, TypeError)):
        jax_da.decode_attention_q8(jnp.asarray(q), jnp.asarray(c5, jnp.int8),
                                   jnp.asarray(s5), jnp.asarray(c5, jnp.int8),
                                   jnp.asarray(s5), jnp.asarray(lens), block_s=32,
                                   interpret=True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="per-layer"):
        da.decode_attention(t(q), t(c5), t(c5), t(lens))
    with pytest.raises(ValueError, match="per-layer"):
        da.decode_attention_q8(t(q), t(c5).to(torch.int8), t(s5),
                               t(c5).to(torch.int8), t(s5), t(lens))


def test_read_only_stacked_equals_the_update_after_its_write():
    """On the cache that the update form has just written, the read-only
    form with the same q gives the update's output (the plain versions
    share one body; on the card the kernels do, see chip_smoke.py)."""
    rng = np.random.default_rng(5)
    nl, b, n_kv, g, hd, s_max, layer = 2, 4, 2, 2, 64, 96, 1
    q = torch.from_numpy(rng.standard_normal((b, n_kv * g, hd)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((b, n_kv, hd)).astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((b, n_kv, hd)).astype(np.float32))
    lens = torch.tensor([0, 40, s_max, 95], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    for quant in (False, True):
        if quant:
            caches = [torch.from_numpy(rng.integers(-127, 128, (nl, b, n_kv, s_max, hd))
                                       .astype(np.int8)),
                      torch.rand((nl, b, n_kv, s_max)) * 0.02 + 1e-3]
            caches = [caches[0], caches[1], caches[0].clone(), caches[1].clone()]
        else:
            c = torch.randn((nl, b, n_kv, s_max, hd)).to(torch.bfloat16)
            caches = [c, None, c.clone(), None]
        out, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lens, layer,
                                                    valid=valid)
        again, _ = da.decode_attention_stacked(q, *caches, lens, layer)
        assert torch.equal(out, again)
