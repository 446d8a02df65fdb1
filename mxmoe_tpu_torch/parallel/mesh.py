"""Mesh and sharding rules for the MoE decoder params (port of
``mxmoe_tpu/parallel/mesh.py``) on ``torch.distributed``.

The JAX package is single-controller: one program over a ``Mesh``, GSPMD
places each array by its ``PartitionSpec``. Here every rank is a process,
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
("data", "expert"), and a rank holds the local slices its specs name
(:func:`shard_params`). The specs are the JAX package's:

  expert_gate_up [L, E, H, 2N]  -> P(None, "expert", None, None)   (EP)
  expert_down    [L, E, N, H]   -> P(None, "expert", None, None)   (EP)
  wq/wk/wv       [L, H, D]      -> P(None, None, "expert")         (TP col)
  wo             [L, D, H]      -> P(None, "expert", None)         (TP row)
  shared_gate_up [L, H, 2Ns]    -> P(None, None, "expert")         (TP col)
  shared_down    [L, Ns, H]     -> P(None, "expert", None)         (TP row)
  embed / lm_head / norms / router -> replicated
  tokens [B, S]                 -> P("data", None)

The TP specs serve the JAX package's GSPMD dense forward only; the port has
no tensor-parallel forward, and expert parallelism takes
``parallel.sharded.ep_param_shardings`` (experts sharded, the rest
replicated). A mesh's ``device_type`` names the collective backend's
devices: "cuda" for NCCL, "cpu" for gloo (which the host-staged EP
transport rides with the tensors on the card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated), a
    mesh dim name or a tuple of names (sharded over their flattened
    product)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)


def make_mesh(n_devices: int | None = None, ep: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "expert") mesh over the first ``n_devices`` ranks of the
    process group (all of them by default). ``ep`` defaults to the largest
    of 8, 4, 2, 1 that divides n, as in the JAX package."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group "
                           "(parallel.multihost.initialize)")
    n = n_devices or dist.get_world_size()
    if ep is None:
        ep = next(c for c in (8, 4, 2, 1) if n % c == 0)
    if n % ep:
        raise ValueError(f"make_mesh: {n} ranks do not split into ep={ep}")
    if n == dist.get_world_size():
        return init_device_mesh(device_type, (n // ep, ep),
                                mesh_dim_names=("data", "expert"))
    ranks = torch.arange(n).reshape(n // ep, ep)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "expert"))


_LAYER_SPECS = {
    "wq": P(None, None, "expert"),
    "wk": P(None, None, "expert"),
    "wv": P(None, None, "expert"),
    "wo": P(None, "expert", None),
    "bq": P(None, "expert"),
    "bk": P(None, "expert"),
    "bv": P(None, "expert"),
    "input_norm": P(None, None),
    "post_attn_norm": P(None, None),
    "router": P(None, None, None),
    "expert_gate_up": P(None, "expert", None, None),
    "expert_down": P(None, "expert", None, None),
    "shared_gate_up": P(None, None, "expert"),
    "shared_down": P(None, "expert", None),
    "shared_gate": P(None, None, None),
}


def param_shardings(params: dict, mesh: DeviceMesh | None = None) -> dict:
    """The spec tree matching the float model's params (the JAX package's
    ``param_shardings``; ``mesh`` is not read: the specs name its dims)."""
    return {
        "embed": P(None, None),
        "layers": {k: _LAYER_SPECS[k] for k in params["layers"]},
        "final_norm": P(None),
        "lm_head": P(None, None),
    }


def data_sharding(mesh: DeviceMesh | None = None) -> P:
    return P("data", None)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """The number of shards along a mesh dim name or a tuple of names."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for name in names:
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def axis_index(mesh: DeviceMesh, axis) -> int:
    """This rank's shard index along ``axis`` (a tuple flattens row-major,
    the first name outermost, as a JAX axis tuple does)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    idx = 0
    for name in names:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(name)) \
            + mesh.get_local_rank(name)
    return idx


def local_slice(t: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a copy where any dim is
    split, so the global tensor can be freed; ``t`` itself where none is)."""
    out = t
    for dim, axis in enumerate(spec):
        n = 1 if axis is None else axis_size(mesh, axis)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {n} shards of {axis!r}")
        c = t.shape[dim] // n
        out = out.narrow(dim, axis_index(mesh, axis) * c, c)
    return out if out is t else out.clone()


def shard_params(params: dict, mesh: DeviceMesh, shardings: dict | None = None) -> dict:
    """The rank-local params: every leaf sliced by its spec
    (``param_shardings`` by default)."""
    specs = param_shardings(params, mesh) if shardings is None else shardings

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return local_slice(tree, spec, mesh)

    return walk(params, specs)
