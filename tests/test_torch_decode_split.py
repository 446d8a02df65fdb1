"""The decode-attention kernels' order of work (K3 / K3q and the read-only
forms): S cut into chunks of ``chunk`` positions, each an online softmax over
16-position tiles, the chunks' partials merged four at a time (a block's),
then the blocks' in order
(``decode_attention_split_plain``), held against the full-softmax plain
version and against the JAX Pallas kernel (interpret mode).

Tolerance: K3_REL_BOUND = 1e-5 of each slot's max|out| (the bound the card
gates hold the kernels to, there per slot and in the output dtype); against
the JAX kernel rtol = atol = 2e-5, as ``test_torch_decode_attention.py``
(the same f32 online softmax in other orders). Lengths sit at the chunk
edges (0, chunk - 1, chunk, chunk + 1), at S - 1, S and past S."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.serving.decode_attention import (
    decode_attention_update_stacked as jax_update)
from mxmoe_tpu_torch.serving import decode_attention as da

K3_REL_BOUND = 1e-5
S_MAX = 300


def _lengths(chunk):
    return torch.tensor([0, chunk - 1, chunk, chunk + 1, S_MAX - 1, S_MAX,
                         S_MAX + 5], dtype=torch.int32)


def _operands(rng, b, n_kv, g, dk, dv, quant):
    q = torch.from_numpy(rng.standard_normal((b, n_kv * g, dk)).astype(np.float32))
    if quant:
        keys = torch.from_numpy(rng.integers(-127, 128, (b, n_kv, S_MAX, dk))
                                .astype(np.float32))
        vals = torch.from_numpy(rng.integers(-127, 128, (b, n_kv, S_MAX, dv))
                                .astype(np.float32))
        k_sc = torch.from_numpy(rng.uniform(1e-3, 3e-2, (b, n_kv, S_MAX))
                                .astype(np.float32))
        v_sc = torch.from_numpy(rng.uniform(1e-3, 3e-2, (b, n_kv, S_MAX))
                                .astype(np.float32))
        return q, keys, vals, k_sc, v_sc
    keys = torch.from_numpy(rng.standard_normal((b, n_kv, S_MAX, dk))
                            .astype(np.float32)).to(torch.bfloat16).float()
    vals = torch.from_numpy(rng.standard_normal((b, n_kv, S_MAX, dv))
                            .astype(np.float32)).to(torch.bfloat16).float()
    return q, keys, vals, None, None


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("groups,dk", [(1, 256), (4, 128), (7, 128)])
def test_split_merge_within_k3_bound_of_the_full_softmax(chunk, quant, groups, dk):
    rng = np.random.default_rng(chunk + 7 * groups + dk + quant)
    lengths = _lengths(chunk)
    q, keys, vals, k_sc, v_sc = _operands(rng, lengths.numel(), 2, groups, dk,
                                          128, quant)
    scale = 1.0 / dk ** 0.5
    got = da.decode_attention_split_plain(q, keys, vals, k_sc, v_sc, lengths,
                                          scale, chunk=chunk)
    ref = da._plain_attention(q, keys, vals, k_sc, v_sc, lengths, scale)
    slot_scale = ref.abs().flatten(1).amax(1)
    err = (got - ref).abs().flatten(1).amax(1)
    assert bool((err <= K3_REL_BOUND * slot_scale).all()), (err / slot_scale).tolist()


def test_schedule_sizes_the_workspace_by_chunk():
    sch = da.decode_attn_schedule(4, 16, 16, 2048, 128)
    # one S-block of four warp chunks: at S 2048, 16 blocks a (slot, kv head)
    assert sch["chunk"] == da.DA_CHUNK and sch["n_split"] == 2048 // (4 * da.DA_CHUNK)
    assert sch["ws_floats"] == 4 * 16 * sch["n_split"] * 130
    assert sch["tickets"] == 4 * 16
    assert sch["blocks"] == 16 * 4 * sch["n_split"]


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("groups", [1, 4])
def test_split_merge_against_the_jax_kernel(chunk, groups):
    """The JAX kernel writes the step's row, then attends; the emulation
    attends the cache that write leaves (the same row, rounded to bf16)."""
    rng = np.random.default_rng(chunk * groups)
    nl, b, n_kv, hd, s_max, layer = 2, 4, 2, 128, 128, 1
    n_h = n_kv * groups
    q = rng.standard_normal((b, n_h, hd)).astype(np.float32)
    kn = rng.standard_normal((b, n_kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, n_kv, hd)).astype(np.float32)
    ck = _bf16(rng.standard_normal((nl, b, n_kv, s_max, hd)))
    cv = _bf16(rng.standard_normal((nl, b, n_kv, s_max, hd)))
    lens = np.asarray([0, chunk - 1, chunk + 1, s_max], np.int32)
    val = np.ones((b,), np.int32)
    out_j, (ck_j, cv_j) = jax_update(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(ck, jnp.bfloat16), None, jnp.asarray(cv, jnp.bfloat16),
        None, jnp.asarray(lens), jnp.int32(layer), valid=jnp.asarray(val),
        block_s=64, interpret=True)
    keys = torch.from_numpy(np.array(ck_j.astype(jnp.float32))[layer])
    vals = torch.from_numpy(np.array(cv_j.astype(jnp.float32))[layer])
    got = da.decode_attention_split_plain(torch.from_numpy(q), keys, vals, None,
                                          None, torch.from_numpy(lens),
                                          1.0 / hd ** 0.5, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j), rtol=2e-5, atol=2e-5)
