"""Port parity: mxmoe_tpu_torch.ops.act_quant (kernel K1's plain version)
against the JAX Pallas kernel (interpret mode) and the XLA reference.

Tolerance: none — codes and scales are bitwise equal (same IEEE division,
round-half-even, exact integer clip range)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops.act_quant import quantize_rows as jax_quantize_rows
from mxmoe_tpu.ops.act_quant import quantize_rows_uniform as jax_rows_uniform
from mxmoe_tpu.quant.qparams import quantize_act_per_row_bits as jax_per_row_bits
from mxmoe_tpu_torch.ops import act_quant, kernels
from mxmoe_tpu_torch.quant.qparams import (quantize_act_per_row_bits,
                                           quantize_act_per_token)


def _bf16_pair(x32: np.ndarray):
    """The same bf16 values as a jax array and a torch tensor."""
    xj = jnp.asarray(x32, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    return xj, xt


@pytest.mark.parametrize("m,k,gain", [(37, 64, 1.0), (77, 256, 1.0),
                                      (45, 128, 1.0 + 1e-3 * 0.37)])
def test_quantize_rows_bitwise_vs_jax(m, k, gain):
    rng = np.random.default_rng(m)
    xj, xt = _bf16_pair(rng.standard_normal((m, k)) * 3.0)
    bits = rng.choice([4.0, 8.0, 16.0], m).astype(np.float32)
    q_j, s_j = jax_quantize_rows(xj, jnp.asarray(bits), gain=gain, bm=32,
                                 interpret=True)
    q_t, s_t = act_quant.quantize_rows(xt, torch.from_numpy(bits), gain=gain)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # and the XLA reference / the port's qparams counterpart
    if gain == 1.0:
        q_r, s_r = jax_per_row_bits(xj, jnp.asarray(bits))
        q_p, s_p = quantize_act_per_row_bits(xt, torch.from_numpy(bits))
        np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(q_p.numpy(), q_t.numpy())


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rows_uniform_bitwise_vs_jax(bits):
    rng = np.random.default_rng(10 + bits)
    xj, xt = _bf16_pair(rng.standard_normal((50, 96)))
    q_j, s_j = jax_rows_uniform(xj, bits, interpret=True)
    q_t, s_t = act_quant.quantize_rows_uniform(xt, bits)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    q_p, s_p = quantize_act_per_token(xt, bits)
    np.testing.assert_array_equal(q_p.numpy(), q_t.numpy())
    np.testing.assert_array_equal(s_p.numpy(), s_t.numpy())


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launch_counts()
    x = torch.randn(8, 32)
    act_quant.quantize_rows_uniform(x, 8)
    assert kernels.launches["quantize_rows"] == 0


@pytest.mark.parametrize("m,k", [(9, 77), (6, 1003),          # K % 8 != 0
                                 (3, 5632), (2, 20480)])      # the wide rows
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_quantize_rows_bitwise_vs_jax_at_every_row_width(m, k, dtype):
    """The widths each of K1's three bodies takes (single elements when K %
    8 != 0; a block a row past 8 KB): the port's plain version bitwise the
    JAX kernel, with mixed bits and a gain."""
    rng = np.random.default_rng(k + m)
    x32 = rng.standard_normal((m, k)) * 2.0
    if dtype == "bf16":
        xj, xt = _bf16_pair(x32)
    else:
        xj, xt = jnp.asarray(x32, jnp.float32), torch.from_numpy(x32.astype(np.float32))
    bits = rng.choice([4.0, 8.0, 16.0], m).astype(np.float32)
    gain = 1.0 + 3.7e-4
    q_j, s_j = jax_quantize_rows(xj, jnp.asarray(bits), gain=gain, bm=32, interpret=True)
    q_t, s_t = act_quant.quantize_rows(xt, torch.from_numpy(bits), gain=gain)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
