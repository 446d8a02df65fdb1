"""Multi-rank execution on torch.distributed (port of ``mxmoe_tpu/parallel``):
mesh and sharding rules, expert parallelism (capacity-bucketed all-to-all),
the expert-parallel, sequence-parallel and tensor-parallel forwards, the
(host, expert) group, ring attention and the scaling benchmark. Every rank
is a process; imports start nothing."""

from .ep import EPConfig, capacity_factor_from_freq  # noqa: F401
from .mesh import data_sharding, make_mesh, param_shardings  # noqa: F401
from .multihost import (MultihostEPConfig, host_expert_mesh,  # noqa: F401
                        initialize, make_multihost_ep_fn)
