"""The compiled decode step, prefill chunk and teacher-forced step: one
CUDA graph each of the cached forward, replayed (the port's counterparts of
the reference's ``jax.jit(partial(forward_cached, ...), donate_argnums=2)``,
``mxmoe_tpu/serving/engine.py:242``, its jitted ``decode_scan``, its jitted
``_prefill_slot`` and ``submit_batch`` chunk, ``:240`` and ``:307``, and
``eval_ppl_decode``'s jitted ``window_nll``, ``mxmoe_tpu/eval/evaluator.py:232``).

Each graph holds, for one (params, config, MoEImpl, cache), its static
inputs and the cache itself, whose K/V and ``lengths`` are written in place
inside the graph:

- ``DecodeGraph``: the last tokens [B, 1] int32 and the active mask [B]; a
  replay runs one decode step (``forward_cached``, the new lengths copied
  into the cache's ``lengths``, ``sample_tokens``) and leaves its tokens in
  the static input, so replays chain on the device; ``run(n)`` replays n
  times (``decode.decode_scan``'s chunk). One graph a step was measured
  against one graph of a 16-step chunk and kept (PERF.md §5).
- ``PrefillGraph``: a chunk's tokens [B, P] and valid lengths [B]; a replay
  runs the chunk and leaves its logits [B, P, V] in ``logits``. A ragged
  last chunk replays the same graph: its length is data. Under expert
  parallelism, ``rows`` (the ranks' row counts) runs the chunk inside
  ``EPMoEBlock.rows``: one slot's chunk on the rank that owns it.
- ``TeacherForcedGraph``: ``eval_ppl_decode``'s step, the token and its
  target [b, 2] fed by one device copy a replay; a replay adds the target's
  negative log-probability to the on-device ``nll``.
- ``FollowGraph``: under expert parallelism, a rank's part of one slot's
  prefill chunk that another rank owns (``decode.forward_cached_follow``:
  every MoE layer's collectives with no rows of its own), inside
  ``EPMoEBlock.rows``, the ranks' row counts fixed at capture.

A graph whose ``MoEImpl.ep_moe`` is the expert-parallel block holds the
block's collectives (NCCL kernels on the communicator's stream, joined to
the capture stream by the block's waits). Every rank must then warm up,
capture and replay its graphs in the same order as the others, as it runs
the eager collectives: the mesh Engine makes the same calls on every rank.
NCCL's communicator waits, when the process group is destroyed, for every
graph that holds its kernels: ``release()`` frees a graph first.

Masks and lengths are data, not shape: arrivals and departures never
recapture.

On a card the first ``run`` warms the body up on a side stream with every
slot inactive (no cache write lands, the lengths stay, the state the body
advances is restored after it, the EP block's drop counter included: the
warm-up changes no state), so that the kernel library is loaded, the shared
tickets are grown, cuBLAS has its workspace and NCCL its communicator
before the capture; then it captures the body and replays it.
A failed capture or replay raises; there is no eager path beside it. On the
CPU (the caller's choice of device) the same body runs eagerly, as it does
on a card for a graph made with ``eager=True`` (the twin a replay is held
against).

Graphs that never replay at once may share one memory pool
(``torch.cuda.graph_pool_handle()``, the ``pool`` argument): each capture
takes only memory that no earlier graph's live output holds, so a replay
may overwrite the outputs of graphs captured after it. The owner reads each
graph's outputs before it replays another (an Engine's prefill logits
before its decode steps).

Launches are counted per replay: the capture's counts are taken out of
``kernels.launches`` (``kernels.recording_launches``) and added back at
every replay. ``kept_bytes`` / ``reserved_bytes``: the device memory a
capture left allocated (its live outputs) and the growth of the memory the
allocator reserved over it (a graph's share of a shared pool). A sampled
step (``temperature > 0``) draws from ``gen``, registered with the graph,
so replays advance it as eager steps would.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl
from ..ops import kernels
from .decode import forward_cached, forward_cached_follow, sample_tokens


_capture_streams: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every warm-up and capture on ``device`` runs on: one
    a device, as ``torch.cuda.graph``'s default capture stream, since cuBLAS
    keeps a workspace (32 MiB on this card) for every stream it has run on,
    for the life of the process."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _capture_streams:
        _capture_streams[key] = torch.cuda.Stream(device=device)
    return _capture_streams[key]


def capture(graph, body, stream=None, pool=None) -> dict:
    """Record ``body()`` into ``graph`` (``capture_begin`` / ``capture_end``)
    on ``stream``, in the memory pool ``pool`` (a fresh one when None) ->
    the kernel launches it recorded, which run only at replay
    (``kernels.recording_launches``)."""
    with kernels.recording_launches() as counts, torch.cuda.stream(stream):
        graph.capture_begin(*(() if pool is None else (pool,)))
        try:
            body()
        finally:
            graph.capture_end()
    return counts


class _Graphed:
    """The capture protocol the graphs share (module docstring). A subclass
    sets its static inputs, ``_body`` (the work of one replay) and
    ``_quiet`` (make the body land nothing; returns the function that
    restores the state the warm-up changed). ``warmup_s`` / ``capture_s`` /
    ``instantiate_s`` time the first replay's three stages (host clock,
    each ended by a synchronize); ``counts`` are one replay's launches.
    ``eager``: every run is the body itself, never captured."""

    def __init__(self, params: dict, cfg: MoEConfig, impl: MoEImpl, cache, pool=None,
                 eager: bool = False):
        self.params, self.cfg, self.impl, self.cache = params, cfg, impl, cache
        self.pool, self.eager = pool, eager
        self.graph = None
        self.counts: dict = {}
        self.warmup_s = self.capture_s = self.instantiate_s = None
        self.kept_bytes = self.reserved_bytes = None

    @property
    def device(self) -> torch.device:
        return self.cache.lengths.device

    def _body(self) -> None:
        raise NotImplementedError

    def _quiet(self):
        raise NotImplementedError

    def release(self) -> None:
        """Free the captured graph (the next ``run`` captures anew)."""
        self.graph = None

    def _generator(self) -> torch.Generator | None:
        """The generator the body draws from, registered with the graph."""
        return None

    def _replay(self) -> None:
        """One replay (capturing first), or the body itself on the CPU or
        with ``eager``."""
        if self.eager or self.device.type != "cuda":
            self._body()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        kernels.add_launches(self.counts)

    def _warmup(self):
        """Run the body once with nothing landing (``_quiet``), the EP
        block's drop counter held -> the function that restores what the
        run changed (call it once the run has ended)."""
        restore = contextlib.ExitStack()
        drops_kept = getattr(self.impl.ep_moe, "drops_kept", None)
        if drops_kept is not None:
            restore.enter_context(drops_kept())
        restore.callback(self._quiet())
        self._body()
        return restore.close

    def _capture(self) -> None:
        dev = self.device
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        allocated, reserved = (torch.cuda.memory_allocated(dev),
                               torch.cuda.memory_reserved(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):       # after what the caller enqueued
            restore = self._warmup()
        torch.cuda.synchronize(dev)
        restore()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self._generator() is not None:
            graph.register_generator_state(self._generator())
        self.counts = capture(graph, self._body, side, self.pool)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.warmup_s, self.capture_s = t1 - t0, t2 - t1
        self.instantiate_s = time.perf_counter() - t2
        self.kept_bytes = torch.cuda.memory_allocated(dev) - allocated
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph


class DecodeGraph(_Graphed):
    """The decode step of a slot batch over ``cache``, captured once (module
    docstring). ``load`` sets the static inputs; ``run(n)`` replays n times
    (or, on the CPU, runs the body n times) and returns the sampled tokens
    [B, n] int32, left on the device. ``logits`` holds the last step's
    logits [B, 1, V]."""

    def __init__(self, params: dict, cfg: MoEConfig, impl: MoEImpl, cache,
                 temperature: float = 0.0, top_k: int = 0,
                 gen: torch.Generator | None = None, pool=None):
        super().__init__(params, cfg, impl, cache, pool)
        self.temperature, self.top_k, self.gen = temperature, top_k, gen
        b, dev = cache.lengths.shape[0], cache.lengths.device
        self.tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self.valid = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.logits = None

    def load(self, tokens: torch.Tensor, valid: torch.Tensor) -> None:
        """Copy the last tokens [B] (or [B, 1]) and the active mask [B]
        into the static inputs."""
        self.tokens.copy_(tokens.reshape(self.tokens.shape))
        self.valid.copy_(valid)

    def _body(self) -> None:
        with torch.no_grad():
            logits, cache = forward_cached(self.params, self.tokens, self.cache,
                                           self.cfg, self.impl,
                                           valid_lengths=self.valid)
            self.cache.lengths.copy_(cache.lengths)
            nxt = sample_tokens(logits[:, -1], self.gen, self.temperature,
                                self.top_k)
            self.tokens.copy_(nxt[:, None])
        self.logits = logits

    def _generator(self) -> torch.Generator | None:
        return self.gen if self.temperature > 0.0 else None

    def _quiet(self):
        tokens, valid = self.tokens.clone(), self.valid.clone()
        gen = self._generator()
        state = gen.get_state() if gen is not None else None
        self.valid.zero_()          # every slot inactive: nothing lands

        def restore():
            self.tokens.copy_(tokens)
            self.valid.copy_(valid)
            if state is not None:
                gen.set_state(state)
            self.logits = None
        return restore

    def run(self, n: int = 1) -> torch.Tensor:
        out = torch.empty((self.tokens.shape[0], n), dtype=torch.int32,
                          device=self.tokens.device)
        for i in range(n):
            self._replay()
            out[:, i] = self.tokens[:, 0]
        return out


class PrefillGraph(_Graphed):
    """A prefill chunk [B, P] of a slot batch over ``cache``, captured once
    (module docstring): ``load`` sets the chunk's tokens [B, P] and valid
    lengths [B] (slots with 0 write nothing), ``run()`` replays it (or, on
    the CPU, runs its body) and returns the chunk's logits [B, P, V], the
    graph's static output (``logits``), valid until the next replay of a
    graph of its pool. The cache's ``lengths`` advance inside the graph.
    ``rows``: the ranks' row counts the chunk runs under (module
    docstring)."""

    def __init__(self, params: dict, cfg: MoEConfig, impl: MoEImpl, cache,
                 chunk: int, pool=None, rows=None):
        super().__init__(params, cfg, impl, cache, pool)
        self.rows = None if rows is None else list(rows)
        b, dev = cache.lengths.shape[0], cache.lengths.device
        self.tokens = torch.zeros((b, chunk), dtype=torch.int32, device=dev)
        self.valid = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.logits = None

    def load(self, tokens: torch.Tensor, valid: torch.Tensor) -> None:
        """Copy the chunk's tokens [B, P] and valid lengths [B] into the
        static inputs."""
        self.tokens.copy_(tokens)
        self.valid.copy_(valid)

    def _body(self) -> None:
        rows = (contextlib.nullcontext() if self.rows is None
                else self.impl.ep_moe.rows(self.rows))
        with torch.no_grad(), rows:
            logits, cache = forward_cached(self.params, self.tokens, self.cache,
                                           self.cfg, self.impl,
                                           valid_lengths=self.valid)
            self.cache.lengths.copy_(cache.lengths)
        self.logits = logits

    def _quiet(self):
        valid = self.valid.clone()
        self.valid.zero_()          # every slot inactive: nothing lands

        def restore():
            self.valid.copy_(valid)
            self.logits = None
        return restore

    def run(self) -> torch.Tensor:
        self._replay()
        return self.logits


class TeacherForcedGraph(_Graphed):
    """``eval_ppl_decode``'s step over ``cache`` (b windows, one position
    a step), captured once (module docstring): ``feed(pair)`` copies the
    windows' token and its target [b, 2] into the static input, ``run()``
    replays the step (or, on the CPU, runs its body): ``forward_cached`` on
    the token, ``log_softmax`` in f32, the target's negative log-probability
    summed into ``nll`` [] f32. ``reset()`` empties the cache and zeroes
    ``nll`` for the next batch of windows. ``eager``: every run is the body
    itself (module docstring)."""

    def __init__(self, params: dict, cfg: MoEConfig, impl: MoEImpl, cache, pool=None,
                 eager: bool = False):
        super().__init__(params, cfg, impl, cache, pool, eager)
        b, dev = cache.lengths.shape[0], cache.lengths.device
        self.pair = torch.zeros((b, 2), dtype=torch.int32, device=dev)
        self.valid = torch.ones((b,), dtype=torch.int32, device=dev)
        self.nll = torch.zeros((), dtype=torch.float32, device=dev)

    def feed(self, pair: torch.Tensor) -> None:
        self.pair.copy_(pair)

    def reset(self) -> None:
        for f in dataclasses.fields(self.cache):
            getattr(self.cache, f.name).zero_()
        self.nll.zero_()

    def _body(self) -> None:
        with torch.no_grad():
            logits, cache = forward_cached(self.params, self.pair[:, :1], self.cache,
                                           self.cfg, self.impl,
                                           valid_lengths=self.valid)
            self.cache.lengths.copy_(cache.lengths)
            lp = torch.log_softmax(logits[:, 0].float(), dim=-1)
            self.nll -= lp.gather(-1, self.pair[:, 1:].long()).sum()

    def _quiet(self):
        nll = self.nll.clone()
        self.valid.zero_()          # no window writes: nothing lands

        def restore():
            self.valid.fill_(1)
            self.nll.copy_(nll)
        return restore

    def run(self) -> None:
        self._replay()


class FollowGraph(_Graphed):
    """This rank's part of a prefill chunk that another rank owns under
    expert parallelism (module docstring): every MoE layer's EP block with
    no rows of its own, under ``impl.ep_moe.rows(rows)``, the ranks' row
    counts fixed at capture. ``run()`` replays it (or, on the CPU, runs its
    body); it has no output."""

    def __init__(self, params: dict, cfg: MoEConfig, impl: MoEImpl, rows,
                 pool=None):
        super().__init__(params, cfg, impl, None, pool)
        self.rows = list(rows)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def _body(self) -> None:
        with torch.no_grad(), self.impl.ep_moe.rows(self.rows):
            forward_cached_follow(self.params, self.cfg, self.impl)

    def _quiet(self):
        return lambda: None             # nothing lands: no rows, no cache

    def run(self) -> None:
        self._replay()
