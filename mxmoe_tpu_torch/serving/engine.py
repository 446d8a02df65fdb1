"""Slot-based generation engine (port of ``mxmoe_tpu/serving/engine.py``:
``EngineConfig``, ``Engine`` with ``submit``, ``submit_batch``, ``step``,
``step_chunk``, ``run_to_completion``, ``result``, and its mesh mode).

A fixed pool of B slots over the cached forward: a request is prefilled
into a free slot in batch-1 chunks (or several at once, full width:
``submit_batch``), then all active slots decode together.
``EngineConfig.int8_kv`` serves from the int8 ``QuantKVCache``.

On one device every decode step (``step``, ``step_chunk``) replays one
CUDA graph of the cached forward and the sampler (``graph.DecodeGraph``,
the counterpart of the reference's jitted decode fn), captured at the first
decode step and reused for the Engine's life: the host's last tokens and
active mask are copied into its static inputs, and the cache (``self.cache``,
the same buffers for the Engine's life, ``lengths`` included) is written in
place. Arrivals never recapture: the active mask is data. Every prefill
chunk replays a graph too (``graph.PrefillGraph``, the counterpart of the
reference's jitted ``_prefill_slot`` and ``submit_batch`` chunk), a ragged
last chunk the same one (its length is data):

- ``submit`` (batch-1 chunks of one slot): one graph over a batch-1 staging
  cache, whatever the slot. The chunks are written there, then the positions
  they wrote are copied into the slot (known on the host: a chunk writes all
  its positions, a ragged one's padding too), so the slot's later positions
  keep what they held, as the eager chunks over the slot's view leave them.
  One graph and one staging slot instead of one graph a slot: a graph holds
  its cache's pointers, and each slot's graph would keep its own [1, P, V]
  f32 logits, 155 MB at qwen2_moe's vocabulary.
- ``submit_batch`` (full width): one graph over the Engine's cache.

The decode and prefill graphs share one memory pool: they never replay at
once, and the host reads a chunk's logits before the next replay. On the
CPU the same bodies run eagerly. ``EngineConfig.cuda_graphs=False`` runs
every chunk and step eagerly on the card too (the twin a graph is held
and timed against).

Mesh mode (``Engine(..., mesh=...)``, a 1-D DeviceMesh over the expert
axis, every rank a process running the same calls): the experts are sharded
over the ranks, the KV cache over the slots (rank r holds slots
[r B/ep, (r+1) B/ep) and allocates only those), and every cached step runs
the routed experts through the EP all-to-all (``parallel.ep``). Every rank
keeps the same host bookkeeping (requests, ``_host_len``, each slot's next
token gathered to all), so every decision is taken alike everywhere. A
slot's prefill runs on the rank that owns it; the other ranks take part in
its MoE blocks' collectives (``decode.forward_cached_follow``), the chunk's
rows spread over the ranks as the JAX package's row blocks are. The mesh
Engine prefills and decodes eagerly (``forward_cached`` a chunk or a step):
its forwards hold the EP block's collectives, which a graph does not
capture here (two ranks on one card exchange over the host-staged gloo
transport, a host round trip inside every MoE block).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl
from .decode import decode_scan, forward_cached, forward_cached_follow, sample_tokens
from .graph import DecodeGraph, PrefillGraph
from .kv_cache import init_kv_cache, init_quant_kv_cache


def _slice_slot_cache(cache, slot: int):
    """One slot's cache as a batch-1 cache of the same type: every K/V leaf
    carries the batch at axis 1, ``lengths`` at axis 0. The leaves are
    views, so a forward over the slice writes through to ``cache``."""
    return type(cache)(**{
        f.name: (getattr(cache, f.name)[slot:slot + 1] if f.name == "lengths"
                 else getattr(cache, f.name)[:, slot:slot + 1])
        for f in dataclasses.fields(cache)})


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4
    max_len: int = 1024
    prefill_chunk: int = 256
    temperature: float = 0.0
    top_k: int = 0
    eos_token: int | None = None
    int8_kv: bool = False        # int8 KV cache (QuantKVCache): half the
                                 # cache memory and read bandwidth
    seed: int = 0                # sampling generator seed
    cuda_graphs: bool = True     # one device: replay CUDA graphs of the
                                 # prefill chunks and decode steps (False:
                                 # eager, the twin they are held against)


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    generated: list = dataclasses.field(default_factory=list)
    max_new: int = 0


def _mesh_setup(params: dict, cfg: MoEConfig, ecfg: EngineConfig, impl: MoEImpl,
                mesh, ep_cfg, gate_freq):
    """The mesh Engine's params, impl and EP config (the JAX Engine's mesh
    branch): the storage picks the EP block, packed buffers are resharded
    per rank, phantom experts pad a non-divisible E, and the rank keeps its
    slices of the experts."""
    from ..parallel.ep import (EPConfig, capacity_factor_from_freq,
                               make_ep_moe_block, pad_expert_arrays)
    from ..parallel.mesh import shard_params
    from ..parallel.sharded import ep_param_shardings

    (axis,) = mesh.mesh_dim_names
    ep = mesh.size()
    if ecfg.batch_slots % ep:
        raise ValueError(f"mesh Engine: batch_slots {ecfg.batch_slots} is no "
                         f"multiple of the mesh size {ep}")
    if ep_cfg is None:
        cap = (capacity_factor_from_freq(gate_freq, ep, margin=1.5)
               if gate_freq is not None else 4.0)
        # decode batches are tiny (a few assignments a rank): keep the old
        # headroom so a step's variance cannot drop under a uniform trace
        ep_cfg = EPConfig(axis=axis, capacity_factor=max(cap, 2.0))
    lp = params["layers"]

    def max_bits():
        return max(float(lp["act_bits_gateup"].max()), float(lp["act_bits_down"].max()))

    if "expert_gate_up_qcat" in lp and "act_bits_gateup" in lp and max_bits() > 8:
        raise ValueError(
            "mesh serving of PACKED a16-containing mixes is unsupported (max act "
            f"bits {max_bits():g}): the packed ragged layout has no weight-only "
            "kernel; convert without --pack-int4 (int8-stored codes serve a16 "
            "mixes over the mesh through the wo path)")
    if "expert_gate_up_qcat" in lp:
        # the global ragged buffers -> one buffer a rank with local offsets
        from ..quant.packing import shard_ragged_mixed

        lp = dict(lp)
        for prefix, kdim in (("expert_gate_up", cfg.hidden_size),
                             ("expert_down", cfg.moe_intermediate_size)):
            cats, blks = [], []
            for l in range(lp[f"{prefix}_qcat"].shape[0]):
                c, b = shard_ragged_mixed(lp[f"{prefix}_qcat"][l],
                                          lp[f"{prefix}_blk"][l].cpu(),
                                          lp[f"{prefix}_pf"][l].cpu(), kdim, ep)
                cats.append(c)
                blks.append(b)
            r_max = max(c.shape[1] for c in cats)
            lp[f"{prefix}_qcat"] = torch.stack(
                [torch.nn.functional.pad(c, (0, 0, 0, r_max - c.shape[1]))
                 for c in cats])                                   # [L, ep, R, N]
            lp[f"{prefix}_blk"] = torch.tensor(blks, dtype=torch.int32,
                                               device=cats[0].device)
        quantized = "mixed-packed"
    elif "expert_gate_up_q" in lp and "act_bits_gateup" in lp:
        quantized = "mixed"
        if max_bits() > 8:
            # a16 experts: float rows over the exchange and K10 a rank;
            # mixed_weight_only so prefill and decode take the same kernels
            quantized = "mixed-wo"
            ep_cfg = dataclasses.replace(ep_cfg, wo_mix=True)
            impl = dataclasses.replace(impl, mixed_weight_only=True)
    else:
        quantized = "expert_gate_up_q" in lp
        qc = impl.quant
        if (quantized and ("expert_gate_up_q_packed" in lp or isinstance(qc, str)
                           or qc is None or not (qc.w_sym and qc.w_gsize == -1
                                                 and qc.a_bits == 8))) or (
                not quantized and "expert_gate_up" not in lp):
            raise ValueError(
                "mesh serving takes float experts, uniform per-channel symmetric "
                "w x a8 codes (int8-stored: the uniform EP block ships int8 rows "
                f"to K2) or a per-expert mix; got MoEImpl.quant={qc!r} over "
                f"{sorted(k for k in lp if k.startswith('expert_gate_up'))}")
    lp = pad_expert_arrays(lp, cfg.num_experts, ep)
    params = {**params, "layers": lp}
    block = make_ep_moe_block(cfg, mesh, quantized, ep_cfg)
    impl = dataclasses.replace(impl, ep_moe=block)
    params = shard_params(params, mesh, ep_param_shardings(params, mesh, quantized))
    return params, impl, ep_cfg, block


class Engine:
    """Minimal continuous-batching loop over the cached forward. The device
    is the params' device; the KV cache is allocated there.

    ``mesh``: serve over a 1-D DeviceMesh (module docstring); ``params`` are
    the global params, of which the rank keeps its slices. ``ep_cfg``: the EP
    block's config (capacity, transport); without it the capacity factor
    comes from ``gate_freq`` (a gate trace's per-expert access frequencies,
    margin 1.5), else 4.0, at least 2.0, and the transport is "direct".
    Assignments past capacity are dropped, and decode then parts from one
    device's."""

    def __init__(self, params: dict, cfg: MoEConfig,
                 ecfg: EngineConfig = EngineConfig(), impl: MoEImpl = MoEImpl(),
                 mesh=None, ep_cfg=None, gate_freq=None):
        self._block = None
        self.ep_cfg = None
        if mesh is not None:
            params, impl, self.ep_cfg, self._block = _mesh_setup(
                params, cfg, ecfg, impl, mesh, ep_cfg, gate_freq)
        self._mesh = mesh
        self._ep = 1 if mesh is None else self._block.comm.size
        self._rank = 0 if mesh is None else self._block.comm.index
        self._n_local = ecfg.batch_slots // self._ep
        self._slot0 = self._rank * self._n_local
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.impl = impl
        self.device = params["embed"].device
        self.cache = self._new_cache(self._n_local)
        self.slots = [_Slot() for _ in range(ecfg.batch_slots)]
        self.gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        # the captured decode step and prefill chunks (one device), their
        # shared memory pool and submit's batch-1 staging cache
        self._graphs = mesh is None and ecfg.cuda_graphs
        self._pool = (torch.cuda.graph_pool_handle()
                      if self._graphs and self.device.type == "cuda" else None)
        self._graph = None
        self._slot_prefill = None
        self._batch_prefill = None
        self._next_req = 0
        self._last_tokens = np.zeros((ecfg.batch_slots,), np.int32)
        self._results: dict[int, list[int]] = {}
        # host mirror of the per-slot cache lengths (min(len + valid, max_len)
        # is exactly reproducible), so stop decisions need no device read
        self._host_len = np.zeros((ecfg.batch_slots,), np.int64)

    def _new_cache(self, batch: int):
        """An empty KV cache of ``batch`` slots (int8 with ``int8_kv``)."""
        if self.ecfg.int8_kv:
            return init_quant_kv_cache(self.cfg, batch, self.ecfg.max_len, self.device)
        return init_kv_cache(self.cfg, batch, self.ecfg.max_len, torch.bfloat16,
                             self.device)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _active_mask(self) -> torch.Tensor:
        """This rank's slots' active flags [B/ep]."""
        return self._dev(self._local(np.asarray([int(s.active) for s in self.slots],
                                                np.int32)))

    def _local(self, a):
        """This rank's slots of a host array over all slots."""
        return a[self._slot0: self._slot0 + self._n_local]

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """This rank's per-slot rows [B/ep, ...] -> all slots' [B, ...] on
        the host (every rank gets them)."""
        if self._mesh is not None:
            t = self._block.comm.all_gather(t)
        return t.cpu().numpy()

    def _sample_first(self, last, owner: int) -> int:
        """The first token from the last prompt position's logits, sampled
        on the slot's rank and sent to all."""
        tok = (sample_tokens(last[None], self.gen, self.ecfg.temperature,
                             self.ecfg.top_k) if last is not None
               else torch.zeros((1,), dtype=torch.int32, device=self.device))
        if self._mesh is not None:
            tok = self._block.comm.broadcast(tok, owner)
        return int(tok[0])

    def dropped_assignments(self) -> int:
        """Assignments the EP blocks dropped so far, summed over the ranks
        (``EPConfig.return_stats``; 0 on one device)."""
        if self._block is None:
            return 0
        d = self._block.dropped
        d = torch.zeros((1,), dtype=torch.int32, device=self.device) if d is None else d
        return int(self._block.comm.all_reduce_sum(d.reshape(1))[0])

    # -- request management ------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 32) -> int:
        """Prefill a prompt into a free slot; returns the request id."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if not free:
            raise RuntimeError("no free slots (drain first)")
        slot = free[0]
        rid = self._next_req
        self._next_req += 1
        p = self.ecfg.prefill_chunk
        prompt = prompt[-(self.ecfg.max_len - max_new_tokens - 1):]
        owner, local = divmod(slot, self._n_local)
        mine = owner == self._rank
        # the chunk's rows all lie on the owner; the EP block spreads them
        counts = [p if r == owner else 0 for r in range(self._ep)]

        # batch-1 view of this slot (K/V views write through to the cache),
        # or on one device the staging graph's cache (module docstring)
        g = self._slot_graph() if self._graphs else None
        if mine:
            self.cache.lengths[local] = 0
            if g is not None:
                g.cache.lengths.zero_()
        self._host_len[slot] = 0
        last = None
        for off in range(0, len(prompt), p):
            piece = prompt[off: off + p]
            chunk = np.zeros((1, p), np.int32)
            chunk[0, : len(piece)] = piece
            valid = self._dev(np.asarray([len(piece)], np.int32))
            with (contextlib.nullcontext() if self._mesh is None
                  else self._block.rows(counts)):
                if not mine:
                    forward_cached_follow(self.params, self.cfg, self.impl)
                elif g is not None:
                    g.load(self._dev(chunk), valid)
                    last = g.run()[0, len(piece) - 1]
                else:
                    logits, c1 = forward_cached(
                        self.params, self._dev(chunk),
                        _slice_slot_cache(self.cache, local), self.cfg, self.impl,
                        valid_lengths=valid)
                    self.cache.lengths[local] = c1.lengths[0]
                    last = logits[0, len(piece) - 1]
            self._host_len[slot] = min(self._host_len[slot] + len(piece),
                                       self.ecfg.max_len)
        if g is not None:
            # a chunk writes all its P positions (a ragged one's padding too,
            # as the reference's scatter does): every written one is copied
            n = min(-(-len(prompt) // p) * p, self.ecfg.max_len)
            for f in dataclasses.fields(self.cache):
                dst, src = getattr(self.cache, f.name), getattr(g.cache, f.name)
                if f.name == "lengths":
                    dst[local:local + 1].copy_(src)
                else:
                    dst[:, local, :, :n].copy_(src[:, 0, :, :n])
        first_tok = self._sample_first(last, owner)
        st = self.slots[slot]
        st.active, st.request_id, st.max_new = True, rid, max_new_tokens
        st.generated = [first_tok]
        self._last_tokens[slot] = first_tok
        return rid

    def _slot_graph(self) -> PrefillGraph:
        """``submit``'s chunk graph over a batch-1 staging cache (made at the
        first call)."""
        if self._slot_prefill is None:
            self._slot_prefill = PrefillGraph(self.params, self.cfg, self.impl,
                                              self._new_cache(1),
                                              self.ecfg.prefill_chunk, self._pool)
        return self._slot_prefill

    def submit_batch(self, prompts: list[list[int]],
                     max_new_tokens: int = 32) -> list[int]:
        """Prefill several prompts in one full-width [B, P] chunked pass
        (one forward for concurrent arrivals instead of one each). Already
        active slots are safe: their cache writes are masked (valid 0).
        Returns the request ids in prompt order."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if len(free) < len(prompts):
            raise RuntimeError("not enough free slots (drain first)")
        p = self.ecfg.prefill_chunk
        b = self.ecfg.batch_slots
        assigned = free[: len(prompts)]
        prompts = [pr[-(self.ecfg.max_len - max_new_tokens - 1):] for pr in prompts]
        for slot in assigned:
            owner, local = divmod(slot, self._n_local)
            if owner == self._rank:
                self.cache.lengths[local] = 0
        self._host_len[assigned] = 0

        last = torch.zeros((self._n_local, self.cfg.vocab_size), device=self.device)
        for off in range(0, max(len(pr) for pr in prompts), p):
            chunk = np.zeros((b, p), np.int32)
            valid = np.zeros((b,), np.int32)
            for slot, pr in zip(assigned, prompts):
                piece = pr[off: off + p]
                chunk[slot, : len(piece)] = piece
                valid[slot] = len(piece)
            toks_d, valid_d = self._dev(self._local(chunk)), self._dev(self._local(valid))
            if self._graphs:
                if self._batch_prefill is None:
                    self._batch_prefill = PrefillGraph(self.params, self.cfg, self.impl,
                                                       self.cache, p, self._pool)
                self._batch_prefill.load(toks_d, valid_d)
                logits = self._batch_prefill.run()
            else:
                logits, c = forward_cached(self.params, toks_d, self.cache, self.cfg,
                                           self.impl, valid_lengths=valid_d)
                self.cache.lengths.copy_(c.lengths)
            for i, n_new in enumerate(self._local(valid)):
                if n_new > 0:
                    last[i] = logits[i, n_new - 1].float()
            for slot in range(b):
                self._host_len[slot] = min(self._host_len[slot] + int(valid[slot]),
                                           self.ecfg.max_len)
        first = self._gather(sample_tokens(last, self.gen, self.ecfg.temperature,
                                           self.ecfg.top_k))
        rids = []
        for slot in assigned:
            rid = self._next_req
            self._next_req += 1
            st = self.slots[slot]
            st.active, st.request_id, st.max_new = True, rid, max_new_tokens
            st.generated = [int(first[slot])]
            self._last_tokens[slot] = int(first[slot])
            rids.append(rid)
        return rids

    def _finish(self, st: _Slot) -> None:
        self._results[st.request_id] = st.generated
        st.active = False

    # -- decode loop -------------------------------------------------------
    def _decode(self, n: int) -> np.ndarray:
        """``n`` decode steps of every slot from the host's last tokens and
        active mask -> all slots' tokens [B, n] on the host (one read)."""
        last = self._dev(self._local(self._last_tokens))
        valid = self._active_mask()
        if not self._graphs:
            toks = []
            for _ in range(n):
                logits, c = forward_cached(self.params, last[:, None], self.cache,
                                           self.cfg, self.impl, valid_lengths=valid)
                self.cache.lengths.copy_(c.lengths)
                last = sample_tokens(logits[:, -1], self.gen, self.ecfg.temperature,
                                     self.ecfg.top_k)
                toks.append(last)
            return self._gather(torch.stack(toks, dim=1))
        if self._graph is None:
            self._graph = DecodeGraph(self.params, self.cfg, self.impl, self.cache,
                                      self.ecfg.temperature, self.ecfg.top_k,
                                      self.gen, self._pool)
        return self._gather(decode_scan(self._graph, last, n, valid))

    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        nxt = self._decode(1)[:, 0]
        for i in active:
            self._host_len[i] = min(self._host_len[i] + 1, self.ecfg.max_len)
            tok = int(nxt[i])
            st = self.slots[i]
            st.generated.append(tok)
            self._last_tokens[i] = tok
            if (len(st.generated) >= st.max_new
                    or (self.ecfg.eos_token is not None and tok == self.ecfg.eos_token)
                    or int(self._host_len[i]) >= self.ecfg.max_len - 1):
                self._finish(st)
        return sum(1 for s in self.slots if s.active)

    def step_chunk(self, n: int = 32) -> int:
        """``n`` decode steps for all active slots with one host read of the
        tokens (decode_scan). EOS / max_new trimming happens here; a slot's
        tokens past its stop point are discarded. Returns #active."""
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        n = min(n, max(1, min(s.max_new - len(s.generated)
                              for s in self.slots if s.active)))
        toks = self._decode(n)                                      # [B, n]
        for i in active:
            self._host_len[i] = min(self._host_len[i] + n, self.ecfg.max_len)
            st = self.slots[i]
            for t in toks[i]:
                tok = int(t)
                st.generated.append(tok)
                self._last_tokens[i] = tok
                if (len(st.generated) >= st.max_new
                        or (self.ecfg.eos_token is not None
                            and tok == self.ecfg.eos_token)):
                    self._finish(st)
                    break
            if st.active and int(self._host_len[i]) >= self.ecfg.max_len - 1:
                self._finish(st)
        return sum(1 for s in self.slots if s.active)

    def run_to_completion(self, max_steps: int = 10_000,
                          chunk: int = 0) -> dict[int, list[int]]:
        """``chunk > 1`` decodes in chunks (step_chunk)."""
        for _ in range(max_steps):
            n = self.step_chunk(chunk) if chunk > 1 else self.step()
            if n == 0:
                break
        return dict(self._results)

    def result(self, rid: int) -> list[int] | None:
        return self._results.get(rid)
