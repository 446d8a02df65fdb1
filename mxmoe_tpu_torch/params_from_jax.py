"""JAX param pytree -> the port's params, unchanged.

Takes the JAX package's nested dict with leaves as numpy arrays (callers
convert with ``np.asarray``; bf16 leaves arrive with numpy dtype name
``bfloat16``) and returns the same dict of torch tensors on ``device``:
floats keep their dtype (bf16/f32); int8 codes (stacked, nibble-packed or
the ragged ``_qcat`` buffer), int32 metadata (``_blk`` / ``_pf``) and f32
scales, zero points, ``act_bits_*`` / ``act_gsize_*`` and the ``shared_wo``
marker are copied bit for bit. ``kv_cache_from_jax``
does the same for a ``KVCache`` / ``QuantKVCache``. No jax import: the bf16
bytes are reinterpreted through int16.
"""

from __future__ import annotations

import numpy as np
import torch

from .serving.kv_cache import KVCache, QuantKVCache


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dict (or a single array) of numpy arrays -> torch tensors on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def kv_cache_from_jax(cache, device="cuda"):
    """The JAX package's ``KVCache`` / ``QuantKVCache`` (a named tuple whose
    leaves convert with ``np.asarray``) -> the port's cache of the same kind,
    on ``device``."""
    fields = cache._asdict()
    cls = QuantKVCache if "k_q" in fields else KVCache
    return cls(**{k: _to_tensor(np.asarray(v), device) for k, v in fields.items()})
