"""The system under test: the port's ``Engine`` set up from the seeded
weights, and the closed serving loop the window drives.

Set-up: the benchmark draws each layer (``weights.draw``) on the device and
hands it to the program's own serving set-up, ``bench_serving.
quantize_for_serving`` with the configuration's ``serving`` arguments, one
MoE layer at a time, and stacks the layers in the program's parameter
layout. The Engine runs with ``cuda_graphs=True``.

The loop (the port has no admission of its own, so this is the harness's
policy): each iteration submits every waiting request into a free slot
through ``Engine.submit``, in issue order, then runs one ``Engine.step()``.
The loop is closed, with a client per slot: a client issues its next
request at the host time its previous one's last token reached the host.
Spans are kept in memory, on
the host clock; under ``--trace 1`` the profiler covers a steady sub-window
and the same calls are wrapped in ``record_function`` ranges named
``bm.*``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

from . import weights
from .arch import Arch
from .traffic import Request, Traffic


@dataclasses.dataclass
class Served:
    """One request as the harness saw it (host clock, seconds)."""
    req: Request
    issue_t: float
    admit_t: float | None = None     # Engine.submit began
    token_t: list = dataclasses.field(default_factory=list)   # each token reached the host
    rid: int | None = None
    slot: int | None = None
    tokens: list | None = None       # served tokens (at its end, or at the close)
    done: bool = False
    traced: bool = False             # its submit ran under the profiler


@dataclasses.dataclass
class Span:
    name: str                        # "submit" | "step"
    t0: float
    t1: float
    tokens: int                      # prompt tokens (submit) or active slots (step)
    keys: int                        # attention keys those tokens read
    chunks: int = 0                  # prefill chunks (submit)
    traced: bool = False


def port_config(a: Arch):
    """The port's ``MoEConfig`` of an ``Arch``."""
    from mxmoe_tpu_torch.models.configs import MoEConfig

    return MoEConfig(
        vocab_size=a.vocab, hidden_size=a.hidden, num_layers=a.layers,
        num_heads=a.heads, num_kv_heads=a.kv_heads, head_dim=a.head_dim,
        num_experts=a.experts, top_k=a.top_k, moe_intermediate_size=a.expert_n,
        shared_expert_intermediate_size=a.shared_n, norm_topk_prob=a.norm_topk,
        has_shared_expert_gate=a.shared_gate, routed_scaling_factor=a.routed_scale,
        rope_theta=a.rope_theta, rms_norm_eps=a.eps, attention_bias=a.qkv_bias,
        tie_word_embeddings=a.tie_embed, attention_type=a.attention,
        kv_lora_rank=a.kv_lora, qk_nope_head_dim=a.qk_nope,
        qk_rope_head_dim=a.qk_rope, v_head_dim=a.v_dim,
        first_dense_layers=a.dense_layers, dense_intermediate_size=a.dense_n,
        model_type=a.family)


def _stack_layer(stacks: dict, layer: dict, l: int, num: int) -> None:
    """Copy one layer's [1, ...] tensors into slot ``l`` of [num, ...]
    stacks (allocated at the first layer); a longer ragged buffer
    (``*_qcat``) grows its stack, a shorter one leaves zero rows."""
    for key, t in layer.items():
        st = stacks.get(key)
        if st is None:
            st = stacks[key] = torch.zeros((num, *t.shape[1:]), dtype=t.dtype,
                                           device=t.device)
        if t.dim() > 1 and t.shape[1] > st.shape[1]:
            st = stacks[key] = torch.nn.functional.pad(
                st, (0, 0) * (st.dim() - 2) + (0, t.shape[1] - st.shape[1]))
        st[l, :t.shape[1]] = t[0]


def build_engine(a: Arch, serving: dict, mix: dict, seed: int, device):
    """The program's params (quantized as ``serving`` says) and its Engine."""
    from mxmoe_tpu_torch.serving import bench_serving
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    cfg = port_config(a)
    one = dataclasses.replace(cfg, num_layers=cfg.first_dense_layers + 1)
    outer = weights.draw(a, seed, "outer", 0, device)
    params = dict(outer)
    if a.dense_layers:
        dense = [weights.draw(a, seed, "dense", l, device) for l in range(a.dense_layers)]
        params["dense_layers"] = {k: torch.stack([d[k] for d in dense]) for k in dense[0]}
        del dense
    stacks: dict = {}
    impl = None
    for l in range(a.moe_layers):
        raw = weights.draw(a, seed, "moe", l, device)
        q, impl = bench_serving.quantize_for_serving(
            {"layers": {k: v[None] for k, v in raw.items()}}, one,
            quant=serving["quant"], shared_quant=serving.get("shared_quant", True),
            fused_ffn=bench_serving.FUSED_FFN[serving.get("fused_ffn", "off")],
            decode_attn=serving.get("decode_attn", "auto"))
        _stack_layer(stacks, q["layers"], l, a.moe_layers)
        del raw, q
    params["layers"] = stacks
    ecfg = EngineConfig(batch_slots=int(mix["slots"]), max_len=int(mix["max_len"]),
                        prefill_chunk=int(serving.get("prefill_chunk", 256)),
                        int8_kv=bool(serving.get("int8_kv", False)), cuda_graphs=True)
    return Engine(params, cfg, ecfg, impl)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The serving loop over one Engine (module docstring)."""

    def __init__(self, engine, traffic: Traffic, clock=time.perf_counter):
        self.eng, self.traffic, self.clock = engine, traffic, clock
        self.chunk = engine.ecfg.prefill_chunk
        self.pending: collections.deque[Served] = collections.deque()
        self.active: dict[int, Served] = {}       # slot -> request
        self.requests: list[Served] = []
        self.spans: list[Span] = []
        self.tracing = False

    def _range(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def issue(self, req: Request, t: float) -> None:
        s = Served(req, t)
        self.requests.append(s)
        self.pending.append(s)

    def _slot_of(self, rid: int) -> int:
        return next(i for i, st in enumerate(self.eng.slots)
                    if st.active and st.request_id == rid)

    def _admit(self, s: Served) -> None:
        p = len(s.req.prompt)
        s.admit_t = self.clock()
        with self._range("bm.submit"):
            s.rid = self.eng.submit(s.req.prompt, s.req.max_new)
        t1 = self.clock()
        s.token_t.append(t1)
        s.traced = self.tracing
        s.slot = self._slot_of(s.rid)
        self.active[s.slot] = s
        self.spans.append(Span("submit", s.admit_t, t1, p, p * (p + 1) // 2,
                               -(-p // self.chunk), self.tracing))

    def _step(self) -> None:
        keys = sum(len(s.req.prompt) + len(s.token_t) for s in self.active.values())
        t0 = self.clock()
        with self._range("bm.step"):
            self.eng.step()
        t1 = self.clock()
        self.spans.append(Span("step", t0, t1, len(self.active), keys, 0, self.tracing))
        for slot, s in list(self.active.items()):
            s.token_t.append(t1)
            if not self.eng.slots[slot].active:
                s.tokens, s.done = list(self.eng.result(s.rid)), True
                del self.active[slot]
                self.issue(self.traffic.next(), t1)

    def iteration(self) -> None:
        """Admit every waiting request, in issue order, then one step."""
        while self.pending:
            self._admit(self.pending.popleft())
        if self.active:
            self._step()

    def close(self) -> None:
        """Take the tokens of the requests still in flight."""
        for slot, s in self.active.items():
            s.tokens = list(self.eng.slots[slot].generated)


def open_window(loop: Loop, warm_steps: int) -> None:
    """Fill every slot with what it holds when the window opens (one
    ``submit`` each), then ``warm_steps`` iterations (the decode step's
    capture among them)."""
    now = loop.clock()
    for req in loop.traffic.opening():
        loop.issue(req, now)
    for _ in range(warm_steps):
        loop.iteration()


def run_window(loop: Loop, seconds: float, trace: dict | None, device) -> dict:
    """Iterations until ``seconds`` have passed -> {"t0", "t1": the window
    on the host clock, "prof": the finished profiler or None, "traced": its
    [start, end] on the host clock}. With ``trace`` ({"start_s",
    "seconds"}) the profiler covers the iterations from the first that
    begins ``start_s`` into the window until ``seconds`` have passed."""
    prof = rng = None
    traced = None
    sync(device)
    t0 = loop.clock()
    while loop.clock() - t0 < seconds:
        if trace is not None and traced is None and loop.clock() - t0 >= trace["start_s"]:
            prof, rng = _start_profiler(device)
            loop.tracing = True
            traced = [loop.clock(), None]
        loop.iteration()
        if loop.tracing and loop.clock() - traced[0] >= trace["seconds"]:
            traced[1] = _stop_profiler(loop, prof, rng, device)
    if loop.tracing:
        traced[1] = _stop_profiler(loop, prof, rng, device)
    return {"t0": t0, "t1": loop.clock(), "prof": prof, "traced": traced}


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (the
    device tracer's initialisation, seconds long) falls in set-up."""
    prof, rng = _start_profiler(device)
    rng.__exit__(None, None, None)
    sync(device)
    prof.__exit__(None, None, None)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    rng = torch.profiler.record_function("bm.window")
    rng.__enter__()
    return prof, rng


def _stop_profiler(loop: Loop, prof, rng, device) -> float:
    rng.__exit__(None, None, None)
    sync(device)
    prof.__exit__(None, None, None)
    loop.tracing = False
    return loop.clock()
