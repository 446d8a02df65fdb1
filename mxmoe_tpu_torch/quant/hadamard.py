"""Hadamard transforms for QuaRot-style rotation, constructed (port of
``mxmoe_tpu/quant/hadamard.py``).

The non-power-of-two factors come from Paley's constructions and Sylvester
doubling (numpy, exact +-1 integers, the reference's matrices entry for
entry); the power-of-two part runs as a fast Walsh-Hadamard transform. For
n = K * 2^a (K the smallest constructible factor, or 1), H_n = H_K (kron)
H_{2^a}: ``matmul_hadU`` applies it as an FWHT along the 2^a axis followed
by a K x K product. Every registered MoE width factors this way (qwen2_moe
1408 -> K 44, qwen2_moe_57b 2560 -> 20, mixtral 14336 -> 28).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n**0.5) + 1):
        if n % p == 0:
            return False
    return True


def _quadratic_residues(q: int) -> set[int]:
    return {(x * x) % q for x in range(1, q)}


def _paley_core(q: int) -> np.ndarray:
    """Jacobsthal matrix Q for GF(q), q prime: Q[i,j] = chi(i - j)."""
    res = _quadratic_residues(q)
    chi = np.zeros(q, dtype=np.int64)
    for d in range(1, q):
        chi[d] = 1 if d in res else -1
    idx = (np.arange(q)[:, None] - np.arange(q)[None, :]) % q
    return chi[idx]


def _paley_I(q: int) -> np.ndarray:
    """Hadamard matrix of order q+1 for prime q ≡ 3 (mod 4)."""
    Q = _paley_core(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    H[1:, 0] = -1
    return H


def _paley_II(q: int) -> np.ndarray:
    """Hadamard matrix of order 2(q+1) for prime q ≡ 1 (mod 4)."""
    Q = _paley_core(q)
    m = q + 1
    S = np.zeros((m, m), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    A = np.array([[1, 1], [1, -1]], dtype=np.int64)
    B = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    H = np.zeros((2 * m, 2 * m), dtype=np.int64)
    # Paley II assembly: H[2i:2i+2, 2j:2j+2] = A if S[i,j]==1, -A if
    # S[i,j]==-1, and B on the diagonal zeros of S.
    for i in range(m):
        for j in range(m):
            if S[i, j] == 1:
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = A
            elif S[i, j] == -1:
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = -A
            else:  # S[i,j] == 0 (diagonal)
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = B
    return H


@functools.lru_cache(maxsize=None)
def _construct_hadamard(m: int) -> np.ndarray | None:
    """Try to construct an order-m Hadamard matrix; None if we can't."""
    if m == 1:
        return np.ones((1, 1), dtype=np.int64)
    if m == 2:
        return np.array([[1, 1], [1, -1]], dtype=np.int64)
    if m % 4 != 0 and m != 2:
        return None
    if _is_prime(m - 1) and (m - 1) % 4 == 3:
        return _paley_I(m - 1)
    if m % 2 == 0:
        q = m // 2 - 1
        if _is_prime(q) and q % 4 == 1:
            return _paley_II(q)
        half = _construct_hadamard(m // 2)
        if half is not None:
            return np.kron(np.array([[1, 1], [1, -1]], dtype=np.int64), half)
    return None


@functools.lru_cache(maxsize=None)
def get_had_factor(n: int) -> tuple[np.ndarray | None, int]:
    """Pick the decomposition n = K * 2^a (analog of ``get_hadK``,
    reference ``hadamard_utils.py:5-59``).

    Returns (H_K as int64 ndarray or None when K == 1, K). Chooses the
    *smallest* constructible K (fewer matmul FLOPs, more FWHT stages),
    unlike the reference whose K is fixed by its hard-coded table.
    """
    if _is_pow2(n):
        return None, 1
    odd = n
    a = 0
    while odd % 2 == 0:
        odd //= 2
        a += 1
    for j in range(a + 1):
        k = odd << j
        if k == 1:
            continue
        H = _construct_hadamard(k)
        if H is not None and _is_pow2(n // k):
            return H, k
    raise NotImplementedError(
        f"No Paley/Sylvester Hadamard factorization found for n={n}. "
        f"(Williamson-only orders such as 52/156/172 are not supported; "
        f"they are not needed for any registered MoE model.)"
    )


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along ``axis`` (length a
    power of two): log2(n) stages of paired add / subtract."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"fwht length {n} not a power of two")
    shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*shape[:-1], n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(shape)
        h *= 2
    return x.movedim(-1, axis)


def hadamard_matrix(n: int, dtype=torch.float32, normalized: bool = True,
                    device="cpu") -> torch.Tensor:
    """Dense Hadamard matrix of order n, orthogonal when ``normalized``
    (H @ H.T = I), built in float64 and rounded once to ``dtype``."""
    hk, k = get_had_factor(n)
    pow2 = n // k
    h2 = np.array([[1.0]])
    while h2.shape[0] < pow2:
        h2 = np.kron(np.array([[1, 1], [1, -1]], dtype=np.float64), h2)
    hk_f = np.ones((1, 1)) if hk is None else hk.astype(np.float64)
    H = np.kron(hk_f, h2)
    if normalized:
        H = H / np.sqrt(n)
    return torch.from_numpy(H).to(device=device, dtype=dtype)


def matmul_hadU(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """x @ H_n (/ sqrt(n)) on the last axis without forming H_n: the FWHT
    along the power-of-two part, then the K-factor product; in float32, the
    result in ``x``'s dtype (the online rotation of the down projection's
    input)."""
    n = x.shape[-1]
    hk, k = get_had_factor(n)
    pow2 = n // k
    xf = x.float()
    if k == 1:
        out = fwht(xf)
    else:
        xr = fwht(xf.reshape(*x.shape[:-1], k, pow2), axis=-1)
        hk_t = torch.from_numpy(hk.astype(np.float32)).to(x.device)
        out = torch.einsum("ij,...jp->...ip", hk_t, xr).reshape(*x.shape[:-1], n)
    if normalize:
        out = out / float(np.sqrt(float(n)))
    return out.to(x.dtype)


def random_signs(n: int, gen: torch.Generator | None = None) -> torch.Tensor:
    """A random +-1 vector [n] (float32) from ``gen`` (a CPU generator)."""
    bits = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int64)
    return (bits * 2 - 1).to(torch.float32)


def random_hadamard_matrix(n: int, gen: torch.Generator | None = None,
                           dtype=torch.float32, signs: torch.Tensor | None = None,
                           device="cpu") -> torch.Tensor:
    """Randomized orthogonal Hadamard Q = diag(signs) @ H_n (QuaRot's
    randomization). ``signs`` (+-1 [n]) is drawn from ``gen`` unless the
    caller hands it in, e.g. the vector the reference drew."""
    H = hadamard_matrix(n, dtype=torch.float32, device=device)
    if signs is None:
        signs = random_signs(n, gen)
    return (signs.to(device=device, dtype=torch.float32)[:, None] * H).to(dtype)
