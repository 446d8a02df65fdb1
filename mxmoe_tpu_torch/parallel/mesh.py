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

These specs are those of the JAX package's GSPMD forward
(``jax.jit(forward_logits)`` over its ``shard_params``), whose port is
``parallel.sharded.make_tp_forward``: each rank runs its heads, its block of
the shared expert's columns and rows and its E/ep experts on its "data"
block of the tokens, and sums the partial outputs over "expert" (GSPMD
inserts those sums itself). Expert parallelism takes
``parallel.sharded.ep_param_shardings`` instead (experts sharded, the rest
replicated). A mesh's ``device_type`` names the collective backend's
devices: "cuda" for NCCL, "cpu" for gloo (which the host-staged transport
rides with the tensors on the card).

Two cuts of the default layout are not contiguous blocks. A fused gate_up
matrix split by columns gives rank r gate block r followed by up block r
(``gate_up_slice``; the same number of bytes as a contiguous block, which
would give rank 0 every gate column at ep 2, while ``silu_mul`` halves the
columns it is given). An expert count that ``"expert"`` does not divide is
padded with never-routed phantom experts (``ep.pad_expert_arrays``, as the
EP paths do; the JAX package's ``device_put`` refuses the uneven split).
Heads that ``"expert"`` does not divide are refused by the forward
(``sharded.tp_local_config``), where GSPMD would pad the head shard.
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
    unknown = sorted(set(params) - {"embed", "layers", "final_norm", "lm_head"})
    unknown += sorted(set(params["layers"]) - set(_LAYER_SPECS))
    if unknown:
        raise KeyError(f"param_shardings: no spec for the keys {unknown}: the specs "
                       "cover the float GQA params, as the JAX package's do")
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


def gate_up_slice(t: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a fused gate_up matrix [..., 2N] whose last dim
    ``spec`` splits: gate block r (of the first N columns) followed by up
    block r (of the last N), each N/n wide, the layout ``silu_mul`` takes
    apart. Every other dim is cut as :func:`local_slice` cuts it."""
    n_cols = t.shape[-1] // 2
    halves = [local_slice(t.narrow(-1, i * n_cols, n_cols), spec, mesh) for i in (0, 1)]
    return torch.cat(halves, dim=-1)


def shard_params(params: dict, mesh: DeviceMesh, shardings: dict | None = None) -> dict:
    """The rank-local params: every leaf sliced by its spec
    (``param_shardings`` by default). A ``*gate_up`` leaf split by columns
    is cut by :func:`gate_up_slice` (gate block r, then up block r: the
    rank holds the bytes of its contiguous block's share, laid out so that
    its SwiGLU pairs gate column j with up column j). With the default
    specs, expert stacks whose E the "expert" size does not divide are
    padded with phantom experts first (module docstring)."""
    if shardings is None:
        specs = param_shardings(params, mesh)
        from .ep import pad_expert_arrays

        e = params["layers"]["router"].shape[-1]
        params = {**params, "layers": pad_expert_arrays(
            params["layers"], e, axis_size(mesh, "expert"))}
    else:
        specs = shardings

    def walk(tree, spec, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], k) for k, v in tree.items()}
        if name.endswith("gate_up") and spec[-1] is not None \
                and axis_size(mesh, spec[-1]) > 1:
            return gate_up_slice(tree, spec, mesh)
        return local_slice(tree, spec, mesh)

    return walk(params, specs)
