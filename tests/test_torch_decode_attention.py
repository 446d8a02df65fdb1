"""Port parity: mxmoe_tpu_torch.serving.decode_attention (kernel K3's plain
version) against the JAX Pallas decode_attention_update_stacked (interpret).

Tolerances: the caches after the write are bitwise equal (one f32 -> bf16
round of the same value). The f32 output agrees to rtol = atol = 2e-5:
the JAX kernel's online softmax over 64-position blocks and the plain
version's single softmax sum in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.serving.decode_attention import (
    decode_attention_update_stacked as jax_update)
from mxmoe_tpu_torch.ops import kernels
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
