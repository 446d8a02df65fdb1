"""Port parity: the float grouped matmul front end ``ops.gmm.gmm`` and the
plain version of K11 (``gmm_bf16``) against the JAX package:
``pallas_gmm.gmm`` in interpret mode, ``gmm_dense_reference`` and the stock
``ragged_dot`` arm.

Tolerances (f32 operands, |out| ~ sqrt(K)): both packages accumulate in f32
and differ only in the order of the K-term sum, so every comparison holds to
atol = K * 2^-24 * max_r sum_k |lhs||rhs| (the kernel's own stated bound,
``ops.gmm.error_over_bound``), far inside the reference tests' 2e-2. bf16
operands: the f32 sums round once to bf16, so within one bf16 ulp of the
reference element. Rows of empty experts do not exist; a one-row expert is
its row times its matrix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import gmm as jax_gmm
from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu_torch.ops import gmm as tg
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax

T = torch.from_numpy

CASES = [
    ([40, 0, 56, 8, 72, 80], 128, 256),
    ([0, 1, 0, 63, 0, 64], 128, 128),            # zero-size and one-row groups
    ([1, 0, 0, 3, 0, 0, 2, 1], 256, 128),        # decode-like
    ([130, 62], 96, 128),
]


def _operands(seed, sizes, k, n):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32),
            np.asarray(sizes, np.int32))


def _atol(lhs, rhs, gs):
    """K * 2^-24 * the largest sum_k |lhs||rhs| of any row and column."""
    mag = tg.gmm_bf16_plain(T(np.abs(lhs)), T(np.abs(rhs)), T(gs))
    return lhs.shape[1] * 2.0 ** -24 * float(mag.max())


@pytest.mark.parametrize("sizes,k,n", CASES)
@pytest.mark.parametrize("backend", ["ragged_dot", "dense", "pallas"])
def test_gmm_f32_vs_jax(sizes, k, n, backend):
    lhs, rhs, gs = _operands(k + n, sizes, k, n)
    refs = {
        "pallas": pallas_gmm.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs),
                                 bm=32, bn=128, interpret=True),
        "dense": jax_gmm.gmm_dense_reference(jnp.asarray(lhs), jnp.asarray(rhs),
                                             jnp.asarray(gs)),
        "ragged_dot": jax_gmm.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs)),
    }
    kernels.reset_launch_counts()
    got = tg.gmm(T(lhs), T(rhs), T(gs), backend=backend)
    assert kernels.launches["gmm_bf16"] == 0              # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (sum(sizes), n)
    atol = _atol(lhs, rhs, gs)
    for name, ref in refs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol,
                                   err_msg=name)
    _, ratio = tg.error_over_bound(got, T(lhs), T(rhs), T(gs))
    assert ratio <= 1.0


@pytest.mark.parametrize("sizes,k,n", CASES[:2])
def test_gmm_bf16_operands_vs_jax(sizes, k, n):
    lhs, rhs, gs = _operands(k * n, sizes, k, n)
    lj, rj = jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16)
    ref = np.asarray(pallas_gmm.gmm(lj, rj, jnp.asarray(gs), bm=32, bn=128,
                                    interpret=True).astype(jnp.float32))
    lt, rt = params_from_jax(np.asarray(lj), "cpu"), params_from_jax(np.asarray(rj), "cpu")
    got = tg.gmm_bf16(lt, rt, T(gs))
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()
    assert torch.equal(got, tg.gmm(lt, rt, T(gs), backend="pallas"))
    # an f32 output of bf16 operands keeps the f32 sum
    wide = tg.gmm_bf16(lt, rt, T(gs), out_dtype=torch.float32)
    _, ratio = tg.error_over_bound(wide, lt, rt, T(gs))
    assert wide.dtype == torch.float32 and ratio <= 1.0


def test_gmm_rejects_unknown_backend_and_bound_sees_a_dropped_term():
    lhs, rhs, gs = _operands(0, [3, 0, 5], 64, 32)
    with pytest.raises(ValueError, match="unknown gmm backend"):
        tg.gmm(T(lhs), T(rhs), T(gs), backend="xla")
    got = tg.gmm_bf16(T(lhs), T(rhs), T(gs))
    short = rhs.copy()
    short[:, -1] = 0.0
    _, ratio = tg.error_over_bound(got, T(lhs), T(short), T(gs))
    assert ratio > 1.0
