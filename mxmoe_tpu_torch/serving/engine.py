"""Slot-based generation engine on one device (port of
``mxmoe_tpu/serving/engine.py``: ``EngineConfig``, ``Engine`` with
``submit``, ``step``, ``step_chunk``, ``run_to_completion``, ``result``).

A fixed pool of B slots over the cached forward: a request is prefilled
into a free slot in batch-1 chunks, then all active slots decode together.
``EngineConfig.int8_kv`` serves from the int8 ``QuantKVCache``. Mesh /
expert-parallel serving and ``submit_batch`` are not ported yet (ROADMAP
queue A).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl
from .decode import decode_scan, forward_cached, sample_tokens
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


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    generated: list = dataclasses.field(default_factory=list)
    max_new: int = 0


class Engine:
    """Minimal continuous-batching loop over the cached forward. The device
    is the params' device; the KV cache is allocated there."""

    def __init__(self, params: dict, cfg: MoEConfig,
                 ecfg: EngineConfig = EngineConfig(), impl: MoEImpl = MoEImpl()):
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.impl = impl
        self.device = params["embed"].device
        if ecfg.int8_kv:
            self.cache = init_quant_kv_cache(cfg, ecfg.batch_slots,
                                             ecfg.max_len, self.device)
        else:
            self.cache = init_kv_cache(cfg, ecfg.batch_slots, ecfg.max_len,
                                       torch.bfloat16, self.device)
        self.slots = [_Slot() for _ in range(ecfg.batch_slots)]
        self.gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self._next_req = 0
        self._last_tokens = np.zeros((ecfg.batch_slots,), np.int32)
        self._results: dict[int, list[int]] = {}
        # host mirror of the per-slot cache lengths (min(len + valid, max_len)
        # is exactly reproducible), so stop decisions need no device read
        self._host_len = np.zeros((ecfg.batch_slots,), np.int64)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _active_mask(self) -> torch.Tensor:
        return self._dev(np.asarray([int(s.active) for s in self.slots], np.int32))

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

        # batch-1 view of this slot: K/V views write through to the cache
        self.cache.lengths[slot] = 0
        self._host_len[slot] = 0
        last = None
        for off in range(0, len(prompt), p):
            piece = prompt[off: off + p]
            chunk = np.zeros((1, p), np.int32)
            chunk[0, : len(piece)] = piece
            logits, c1 = forward_cached(
                self.params, self._dev(chunk),
                _slice_slot_cache(self.cache, slot), self.cfg, self.impl,
                valid_lengths=self._dev(np.asarray([len(piece)], np.int32)))
            self.cache.lengths[slot] = c1.lengths[0]
            last = logits[0, len(piece) - 1]
            self._host_len[slot] = min(self._host_len[slot] + len(piece),
                                       self.ecfg.max_len)
        first_tok = int(sample_tokens(last[None], self.gen,
                                      self.ecfg.temperature, self.ecfg.top_k)[0])
        st = self.slots[slot]
        st.active, st.request_id, st.max_new = True, rid, max_new_tokens
        st.generated = [first_tok]
        self._last_tokens[slot] = first_tok
        return rid

    def _finish(self, st: _Slot) -> None:
        self._results[st.request_id] = st.generated
        st.active = False

    # -- decode loop -------------------------------------------------------
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return 0
        logits, self.cache = forward_cached(
            self.params, self._dev(self._last_tokens[:, None]), self.cache,
            self.cfg, self.impl, valid_lengths=self._active_mask())
        nxt = sample_tokens(logits[:, -1], self.gen, self.ecfg.temperature,
                            self.ecfg.top_k).cpu().numpy()
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
        toks, self.cache = decode_scan(
            self.params, self._dev(self._last_tokens), self.cache, n, self.cfg,
            self.impl, valid=self._active_mask(),
            temperature=self.ecfg.temperature, top_k=self.ecfg.top_k,
            gen=self.gen)
        toks = toks.cpu().numpy()                                   # [B, n]
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
