"""A dispatch mode that raises on every op whose result the host must read,
for the port's checks that a CUDA graph's body reads nothing on the host
(the body runs eagerly on the CPU, under the guard). Imports torch and the
port only, so that the ranks of ``_torch_dist_pool`` can use it too."""

from __future__ import annotations

import importlib
import pkgutil

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose result the host reads (or whose output shape depends on data):
# a CUDA graph cannot hold them. ``multinomial`` checks its probabilities on
# the host inside its own kernel, below what a dispatch mode sees
HOST_READS = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
              "masked_select", "lift_fresh", "lift_fresh_copy", "_unique2",
              "unique_dim", "unique_consecutive", "bincount", "equal",
              "is_nonzero", "multinomial"}
# ops that read a boolean index on the host
BOOL_INDEXED = {"index", "index_put", "index_put_", "_index_put_impl_"}


class HostReadGuard(TorchDispatchMode):
    """Raises on every op in ``HOST_READS``, on boolean indexing and on
    ``repeat_interleave`` without an output size, except while ``exempt``."""

    exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.exempt:
            name = func.overloadpacket.__name__
            bad = name in HOST_READS
            if name in BOOL_INDEXED:
                idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
                bad = any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                          for t in idx)
            if name == "repeat_interleave" and kwargs.get("output_size") is None:
                bad = True
            if bad:
                raise AssertionError(f"host read in the decode step: {func}")
        return func(*args, **kwargs)


def exempt_plain_versions(guard: HostReadGuard, setattr_) -> None:
    """Every kernel's plain version (``*_plain`` of the ops modules and the
    decode attention) runs with the guard off; ``setattr_(module, name,
    value)`` installs the wrappers (``monkeypatch.setattr``, or one that
    records what it replaced)."""
    from mxmoe_tpu_torch import ops

    mods = [importlib.import_module(f"mxmoe_tpu_torch.ops.{m.name}")
            for m in pkgutil.iter_modules(ops.__path__)]
    mods.append(importlib.import_module("mxmoe_tpu_torch.serving.decode_attention"))
    for mod in mods:
        for name, fn in list(vars(mod).items()):
            if name.endswith("_plain") and callable(fn):
                def exempt(*a, _fn=fn, **kw):
                    guard.exempt += 1
                    try:
                        return _fn(*a, **kw)
                    finally:
                        guard.exempt -= 1
                setattr_(mod, name, exempt)
