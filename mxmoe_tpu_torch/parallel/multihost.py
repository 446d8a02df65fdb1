"""Multi-host runtime: the process group and the (host, expert) mesh (port
of ``mxmoe_tpu/parallel/multihost.py``).

A job of several processes, one a device, joins ``torch.distributed`` from
its environment (``initialize``); :func:`host_expert_mesh` lays the ranks
out as [hosts, devices a host] with the host dim outer, and
:func:`make_multihost_ep_fn` runs the same capacity-bucketed EP all-to-all
over the flattened (host, expert) pair: host-major expert order, expert e on
flat shard e // ceil(E / (H * D)). Nothing on a machine tells a program of
a cluster: the launcher (``torchrun``, or :func:`spawn`) sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_WORLD_SIZE.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.configs import MoEConfig
from .ep import (EPConfig, ep_comm, make_ep_moe_mixed_fn, moe_ffn_ep,
                 moe_ffn_ep_quant)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join (or start) the process group. With every argument None the job
    comes from the environment (WORLD_SIZE, RANK, MASTER_ADDR/PORT), and a
    process with no WORLD_SIZE above 1 is a job of one: a no-op. Explicit
    arguments that fail raise. Idempotent. ``backend``: "nccl" on the card,
    "gloo" on the CPU (default: nccl where CUDA is available)."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init_method = "env://"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if world_size is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **kw)


def host_expert_mesh(axis_names: tuple[str, str] = ("host", "expert"),
                     n_hosts: int | None = None, device_type: str = "cuda"):
    """A [n_hosts, ranks a host] DeviceMesh, the host dim outer: each
    host's ranks are contiguous, so the inner dim is the ranks of one node
    (NVLink) and the outer crosses nodes. ``n_hosts`` defaults to
    WORLD_SIZE / LOCAL_WORLD_SIZE."""
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    return init_device_mesh(device_type, (n_hosts, world // n_hosts),
                            mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class MultihostEPConfig:
    host_axis: str = "host"
    expert_axis: str = "expert"
    capacity_factor: float = 2.0
    gmm_backend: str = "ragged_dot"
    quantized: bool = False
    mixed: bool = False        # per-expert schemes (moe_ffn_ep_mixed)
    packed: bool = False       # with mixed: per-shard packed ragged buffers
                               # (shard_ragged_mixed with ep = H * D)
    a_bits: int = 8
    return_stats: bool = False
    transport: str = "direct"

    @property
    def axis(self) -> tuple[str, str]:
        return (self.host_axis, self.expert_axis)


def make_multihost_ep_fn(cfg: MoEConfig, mesh, mh: MultihostEPConfig = MultihostEPConfig()):
    """The EP MoE block over the flattened (host, expert) pair: this rank's
    row block and expert slices in, its output rows out (the operands of
    ``parallel.ep``'s wrappers)."""
    ep_cfg = EPConfig(axis=mh.axis, capacity_factor=mh.capacity_factor,
                      gmm_backend=mh.gmm_backend, return_stats=mh.return_stats,
                      transport=mh.transport)
    if mh.packed and not mh.mixed:
        raise ValueError("MultihostEPConfig(packed=True) requires mixed=True (the "
                         "packed ragged layout is the mixed path's storage)")
    if mh.mixed:
        return make_ep_moe_mixed_fn(cfg, mesh, ep_cfg, packed=mh.packed)
    comm = ep_comm(mesh, ep_cfg)
    if mh.quantized:
        def fn(x_local, router, gq, gsc, dq, dsc):
            lp = {"router": router, "expert_gate_up_q": gq, "expert_gate_up_sc": gsc,
                  "expert_down_q": dq, "expert_down_sc": dsc}
            return moe_ffn_ep_quant(x_local, lp, cfg, ep_cfg, comm, mh.a_bits)
    else:
        def fn(x_local, router, gate_up, down):
            lp = {"router": router, "expert_gate_up": gate_up, "expert_down": down}
            return moe_ffn_ep(x_local, lp, cfg, ep_cfg, comm)
    return fn


def free_port() -> int:
    """A free TCP port on localhost for a job's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_entry(rank: int, fn, world: int, port: int, backend: str, args) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), backend: str = "gloo") -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (spawn start
    method) joined in one process group on localhost; raises if a rank
    fails. ``fn`` must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawn_entry, args=(fn, world, free_port(), backend, args),
                       nprocs=world, join=True, start_method="spawn")
