"""A pool of worker processes joined in one gloo process group, for the
port's torch.distributed tests on the CPU.

One pool is spawned per test file (a module-scoped fixture); each test runs a
task on every rank with ``pool.run(fn, *args, timeout=...)``. ``fn`` is a
module-level function of an importable module (the workers start from a
fresh import, spawn start method) called as ``fn(rank, world, *args)``; its
return values come back in rank order. A task that raises on any rank, or
does not finish within its time limit, kills every worker (a rank stuck in
a collective would otherwise wait forever) and fails the test; the next
task starts a new pool. Workers import torch and the port only, never jax.
"""

from __future__ import annotations

import os
import queue
import sys
import time
import traceback

import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _worker(rank: int, world: int, port: int, tasks, results) -> None:
    sys.path[:0] = [ROOT, HERE]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method="env://", world_size=world,
                            rank=rank)
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(rank, world, *args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class DistPool:
    def __init__(self, world: int):
        self.world = world
        self._procs = []
        self._start()

    def _start(self) -> None:
        from mxmoe_tpu_torch.parallel.multihost import free_port

        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_worker,
                                   args=(r, self.world, port, self._tasks[r],
                                         self._results), daemon=True)
                       for r in range(self.world)]
        for p in self._procs:
            p.start()

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []

    def run(self, fn, *args, timeout: float = 120.0) -> list:
        """``fn(rank, world, *args)`` on every rank -> the results in rank
        order. Raises (after killing the pool) on a failure or at the time
        limit, which counts the workers' start for the first task."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args))
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < self.world:
            try:
                rank, ok, val = self._results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                dead = [p.exitcode for p in self._procs]
                self._kill()
                raise TimeoutError(f"{fn.__name__}: ranks {sorted(set(range(self.world)) - set(out))} "
                                   f"did not finish in {timeout} s (exit codes {dead})")
            if not ok:
                self._kill()
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{val}")
            out[rank] = val
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=20)
        self._kill()
