"""The compiled decode step: one CUDA graph of the cached forward and the
sampler, replayed per step (the port's counterpart of the reference's
``jax.jit(partial(forward_cached, ...), donate_argnums=2)``,
``mxmoe_tpu/serving/engine.py:242``, and of its jitted ``decode_scan``).

A ``DecodeGraph`` holds, for one (params, config, MoEImpl, cache, sampling),
the step's static inputs: the last tokens [B, 1] int32, the active mask [B]
int32 and the cache itself, whose K/V and ``lengths`` are written in place
inside the graph. A replay runs one decode step (``forward_cached``, the
new lengths copied into the cache's ``lengths``, ``sample_tokens``) and
leaves its tokens in the static input, so replays chain on the device;
``run(n)`` replays n times (``decode.decode_scan``'s chunk). One graph a step
was measured against one graph of a 16-step chunk and kept (PERF.md §5).
The mask is data, not shape: arrivals and departures never recapture.

On a card the first ``run`` warms the step up on a side stream with every
slot inactive (no cache write lands, the lengths stay, the sampler's
generator is restored after it: the warm-up changes no state), so that the
kernel library is loaded, the shared tickets are grown and cuBLAS has its
workspace before the capture; then it captures the step and replays it.
A failed capture or replay raises; there is no eager path beside it. On the
CPU (the caller's choice of device) the same step body runs eagerly.

Launches are counted per replay: the capture's counts are taken out of
``kernels.launches`` (``kernels.recording_launches``) and added back at
every replay. A sampled step (``temperature > 0``) draws from ``gen``,
registered with the graph, so replays advance it as eager steps would.
"""

from __future__ import annotations

import time

import torch

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl
from ..ops import kernels
from .decode import forward_cached, sample_tokens


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


def capture(graph, body, stream=None) -> dict:
    """Record ``body()`` into ``graph`` (``capture_begin`` / ``capture_end``)
    on ``stream`` -> the kernel launches it recorded, which run only at
    replay (``kernels.recording_launches``)."""
    with kernels.recording_launches() as counts, torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            body()
        finally:
            graph.capture_end()
    return counts


class DecodeGraph:
    """The decode step of a slot batch over ``cache``, captured once (module
    docstring). ``load`` sets the static inputs; ``run(n)`` replays n times
    (or, on the CPU, runs the body n times) and returns the sampled tokens
    [B, n] int32, left on the device. ``logits`` holds the last step's
    logits [B, 1, V]. ``warmup_s`` / ``capture_s`` / ``instantiate_s`` time
    the first ``run``'s three stages (host clock, each ended by a
    synchronize); ``counts`` are one replay's launches."""

    def __init__(self, params: dict, cfg: MoEConfig, impl: MoEImpl, cache,
                 temperature: float = 0.0, top_k: int = 0,
                 gen: torch.Generator | None = None):
        self.params, self.cfg, self.impl, self.cache = params, cfg, impl, cache
        self.temperature, self.top_k, self.gen = temperature, top_k, gen
        b, dev = cache.lengths.shape[0], cache.lengths.device
        self.tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self.valid = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.logits = None
        self.graph = None
        self.counts: dict = {}
        self.warmup_s = self.capture_s = self.instantiate_s = None

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

    def run(self, n: int = 1) -> torch.Tensor:
        out = torch.empty((self.tokens.shape[0], n), dtype=torch.int32,
                          device=self.tokens.device)
        for i in range(n):
            if self.tokens.device.type != "cuda":
                self._body()
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                kernels.add_launches(self.counts)
            out[:, i] = self.tokens[:, 0]
        return out

    def _capture(self) -> None:
        dev = self.tokens.device
        sampled = self.temperature > 0.0 and self.gen is not None
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        tokens, valid = self.tokens.clone(), self.valid.clone()
        state = self.gen.get_state() if sampled else None
        with torch.cuda.stream(side):
            self.valid.zero_()          # every slot inactive: nothing lands
            self._body()
        torch.cuda.synchronize(dev)
        self.tokens.copy_(tokens)
        self.valid.copy_(valid)
        if sampled:
            self.gen.set_state(state)
        self.logits = None
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if sampled:
            graph.register_generator_state(self.gen)
        self.counts = capture(graph, self._body, side)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.warmup_s, self.capture_s = t1 - t0, t2 - t1
        self.instantiate_s = time.perf_counter() - t2
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph
