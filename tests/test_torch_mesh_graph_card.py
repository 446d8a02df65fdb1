"""The compiled mesh Engine on the card (skipped without one): each test runs
a script in a subprocess of its own, with its own one-rank process group
(NCCL, or gloo for the host-staged transport) on localhost and a time limit,
so that a capture that hangs in a collective cannot stall the card run.
qwen2_moe at full width, 2 layers, mixed-packed experts + int8 KV cache,
through the mesh ``Engine``'s params and EP block (``Engine.params`` /
``Engine.impl``):

- a captured decode step (``graph.DecodeGraph``, the EP block's NCCL
  exchanges inside the graph) bitwise its eager twin over 8 steps: logits,
  tokens, every cache byte, and the drops the replays add to the block's
  buffer;
- the EP block, its shared expert run under its first exchange, bitwise
  the block written out synchronously (row blocks and ``rows``);
- a captured ``submit`` chunk (``graph.PrefillGraph`` over a one-slot
  staging cache under ``EPMoEBlock.rows``) bitwise its eager twin over two
  chunks, the second ragged;
- the captured mesh Engine bitwise the eager one (``cuda_graphs=False``):
  submits, a ``submit_batch`` and chunked decode;
- ``cuda_graphs=True`` over ``transport="host"`` raises; ``False`` serves.

Run on the card: ``python -m pytest tests/test_torch_mesh_graph_card.py
--noconftest -q``. Imports no JAX."""

import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

_SCRIPT = r'''
import dataclasses, functools, os, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import shared_expert_ffn
from mxmoe_tpu_torch.parallel.ep import EPConfig
from mxmoe_tpu_torch.parallel.multihost import free_port
from mxmoe_tpu_torch.serving import bench_serving, decode, graph, kv_cache
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

mode = sys.argv[1]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
host = mode == "host"
dist.init_process_group("gloo" if host else "nccl",
                        init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
mesh = DeviceMesh("cpu" if host else "cuda", [0], mesh_dim_names=("expert",))
cfg = dataclasses.replace(configs.config_for("qwen2_moe"), num_layers=2)
params, impl = bench_serving.init_for_serving(
    cfg, torch.Generator(device=dev).manual_seed(0),
    functools.partial(bench_serving.quantize_for_serving, quant="mixed-packed"), dev)


def fields_equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def main():
    if host:
        try:
            Engine(params, cfg, EngineConfig(batch_slots=2), impl, mesh=mesh,
                   ep_cfg=EPConfig(transport="host"))
            raised = False
        except ValueError as e:
            raised = "cannot hold" in str(e)
        eng = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=256, prefill_chunk=64,
                                               cuda_graphs=False), impl, mesh=mesh,
                     ep_cfg=EPConfig(transport="host"))
        rid = eng.submit(list(range(40)), max_new_tokens=4)
        return ["raised", raised, "served", len(eng.run_to_completion()[rid])]
    elif mode == "step":
        eng = Engine(params, cfg, EngineConfig(batch_slots=4, max_len=256, int8_kv=True),
                     impl, mesh=mesh, ep_cfg=EPConfig(capacity_factor=0.5,
                                                      return_stats=True))
        mp, mimpl, block = eng.params, eng.impl, eng._block
        cache = kv_cache.init_quant_kv_cache(cfg, 4, 256, device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (4, 200), generator=g, device=dev,
                               dtype=torch.int32)
        with torch.no_grad():
            _, c = decode.forward_cached(mp, prompt, cache, cfg, mimpl, valid_lengths=torch.tensor(
                [5, 200, 0, 77], dtype=torch.int32, device=dev))
        cache.lengths.copy_(c.lengths)
        twin = kv_cache.clone_cache(cache)
        tok = torch.randint(0, cfg.vocab_size, (4,), generator=g, device=dev, dtype=torch.int32)
        valid = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
        step = graph.DecodeGraph(mp, cfg, mimpl, cache)
        step.load(tok, valid)
        d0 = int(block.dropped[0])
        got = []
        for _ in range(8):
            toks = step.run()[:, 0].clone()
            got.append((toks, step.logits.clone()))
        d1 = int(block.dropped[0])
        last, same = tok[:, None], True
        with torch.no_grad():
            for toks, logits in got:
                lg, twin = decode.forward_cached(mp, last, twin, cfg, mimpl, valid_lengths=valid)
                nxt = decode.sample_tokens(lg[:, -1])
                same = same and torch.equal(lg, logits) and torch.equal(nxt, toks)
                last = nxt[:, None]
        d2 = int(block.dropped[0])
        torch.cuda.synchronize()
        out = ["captured", step.graph is not None, "bitwise", same,
               "cache", fields_equal(cache, twin), "drops", d1 - d0 == d2 - d1,
               "launches", sum(step.counts.values())]
        step.release()
        return out
    elif mode == "chunk":
        eng = Engine(params, cfg, EngineConfig(batch_slots=1, max_len=512, int8_kv=True),
                     impl, mesh=mesh, ep_cfg=EPConfig(capacity_factor=4.0))
        mp, mimpl, block = eng.params, eng.impl, eng._block
        staging = kv_cache.init_quant_kv_cache(cfg, 1, 512, device=dev)
        twin = kv_cache.clone_cache(staging)
        chunk = graph.PrefillGraph(mp, cfg, mimpl, staging, 256, rows=[256])
        g = torch.Generator(device=dev).manual_seed(2)
        same = True
        for n in (256, 100):
            toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=g, device=dev,
                                 dtype=torch.int32)
            v = torch.tensor([n], dtype=torch.int32, device=dev)
            chunk.load(toks, v)
            got = chunk.run().clone()
            with torch.no_grad(), block.rows([256]):
                want, out = decode.forward_cached(mp, toks, twin, cfg, mimpl, valid_lengths=v)
            twin.lengths.copy_(out.lengths)
            same = same and torch.equal(got, want) and fields_equal(staging, twin)
        torch.cuda.synchronize()
        out = ["captured", chunk.graph is not None, "bitwise", same,
               "lengths", staging.lengths.tolist()]
        chunk.release()
        return out
    elif mode == "block":
        eng = Engine(params, cfg, EngineConfig(batch_slots=4, max_len=256), impl,
                     mesh=mesh, ep_cfg=EPConfig(capacity_factor=4.0))
        block = eng._block
        lp = {k: v[0] for k, v in eng.params["layers"].items()}
        g = torch.Generator(device=dev).manual_seed(4)
        x = torch.randn((1, 256, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        x2d = x.reshape(-1, cfg.hidden_size)
        out = ["bitwise"]
        with torch.no_grad():
            for rows in (None, [256]):
                if rows is None:
                    y = block(x, lp, cfg)
                    routed = block._routed(x2d, lp)
                else:
                    with block.rows(rows):
                        y = block(x, lp, cfg)
                        send, recv = block._splits()
                    moved = block.comm.all_to_all(x2d, recv, send)
                    routed = block.comm.all_to_all(block._routed(moved, lp), send, recv)
                # the block before the overlap: every exchange waited for,
                # then the shared expert added
                ref = routed + shared_expert_ffn(x2d, lp, cfg)
                out.append(bool(torch.equal(y.reshape(ref.shape), ref)))
        torch.cuda.synchronize()
        return out
    else:
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 48, 513, 20)]
        engines = [Engine(params, cfg, EngineConfig(batch_slots=4, max_len=1024,
                                                    prefill_chunk=256, int8_kv=True,
                                                    cuda_graphs=cap), impl, mesh=mesh,
                          ep_cfg=EPConfig(capacity_factor=4.0, return_stats=True))
                   for cap in (True, False)]
        for p in prompts[:2]:
            for e in engines:
                e.submit(p, max_new_tokens=6)
        for e in engines:
            e.submit_batch(prompts[2:], max_new_tokens=6)
        same = fields_equal(engines[0].cache, engines[1].cache)
        outs = [e.run_to_completion(chunk=4) for e in engines]
        made = [engines[0]._graph, engines[0]._slot_prefill, engines[0]._batch_prefill]
        out = ["captured", all(m is not None and m.graph is not None for m in made),
               "bitwise", same and outs[0] == outs[1], "drops",
               engines[0].dropped_assignments() == engines[1].dropped_assignments()]
        for e in engines:
            e.close()
        return out


# the communicator waits, when it is destroyed, for every graph that holds
# NCCL kernels: main releases its graphs; on a failure the graphs may live on
# in the traceback, so the process ends without destroying the group
try:
    print(*main(), flush=True)
except BaseException:
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)
dist.destroy_process_group()
'''


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and NCCL run only there")
    return torch.device("cuda")


def _run(mode: str) -> list:
    from mxmoe_tpu_torch.ops import kernels

    kernels.lib()                               # built once, by this process
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    p = subprocess.run([sys.executable, "-c", _SCRIPT, mode], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    print(mode, p.returncode, p.stdout[-2000:], p.stderr[-2000:])
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.split()


def test_captured_mesh_step_is_its_eager_twin_bitwise(dev):
    out = _run("step")
    assert out[:8] == ["captured", "True", "bitwise", "True", "cache", "True",
                       "drops", "True"], out


def test_captured_mesh_submit_chunk_is_its_eager_twin_bitwise(dev):
    out = _run("chunk")
    assert out[:4] == ["captured", "True", "bitwise", "True"], out
    assert " ".join(out[5:]) == "[356]", out


def test_overlapped_block_is_the_synchronous_block_bitwise(dev):
    """The EP block with its shared expert run under the first exchange
    (the dispatch at the row blocks; the row move under ``rows``) against
    the block written out synchronously, at full width."""
    out = _run("block")
    assert out == ["bitwise", "True", "True"], out


def test_captured_mesh_engine_is_the_eager_mesh_engine(dev):
    out = _run("engine")
    assert out == ["captured", "True", "bitwise", "True", "drops", "True"], out


def test_graphs_over_the_host_transport_raise_on_the_card(dev):
    out = _run("host")
    assert out == ["raised", "True", "served", "4"], out
