"""Port parity for the evaluation modules (``mxmoe_tpu_torch.eval``:
``evaluator``, ``run``) against the JAX package's ``mxmoe_tpu.eval``, on a
tiny qwen2_moe whose params come from one numpy-seeded JAX init through
``params_from_jax``, and tokens drawn with numpy.

Tolerances: the float f32 perplexity rel 1e-4 (f32 matmuls and log-softmax
sums in other orders); real execution through the quantized kernels' plain
versions rel 5e-3 of JAX's (interpret mode), as the reference holds real
against fake-quant (``tests/test_real_exec.py``): an f32 sum in another order
can move an activation across a 4-bit code boundary; the packed storage's
ppl equal to the int8-stored one (the kernels' outputs are bitwise). The
decode perplexity: bf16 KV within 5e-3 and int8 KV + int8 head within 2e-2
of the forward ppl, the reference's bounds, and within the same of JAX's
decode ppl. loglikelihood rel 1e-4 with the same greedy flag."""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.eval import evaluator as jax_ev
from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.quant import qparams as jax_qparams
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu_torch.eval import evaluator, run
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import qparams, schemes


class WhitespaceTokenizer:
    """Deterministic word -> id tokenizer (``tests/test_eval_tasks.py``'s)."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, text):
        ids = [zlib.crc32(w.encode()) % (self.vocab_size - 1) + 1
               for w in text.split()]
        return {"input_ids": ids or [0]}


def _rows(task):
    """The fixture rows of ``tests/test_eval_tasks.py``, one list a schema."""
    if task == "piqa":
        return [{"goal": f"how to open a jar {i}", "sol1": "twist the lid",
                 "sol2": "stare at it", "label": i % 2} for i in range(5)]
    if task == "hellaswag":
        return [{"ctx": f"a person walks {i}",
                 "endings": ["into the room", "over the moon",
                             "through a wall", "backwards fast"],
                 "label": str(i % 4)} for i in range(5)]
    if task in ("arc_easy", "arc_challenge"):
        rows = [{"question": f"what is water {i}",
                 "choices": {"label": ["A", "B", "C"],
                             "text": ["a liquid", "a rock", "a bird"]},
                 "answerKey": "ABC"[i % 3]} for i in range(4)]
        rows.append({"question": "bad row",
                     "choices": {"label": ["A"], "text": ["x"]},
                     "answerKey": "Z"})  # unanswerable -> skipped
        return rows
    if task == "winogrande":
        return [{"sentence": f"the trophy {i} does not fit in _ because it is big",
                 "option1": "the case", "option2": "the shelf",
                 "answer": str(i % 2 + 1)} for i in range(5)]
    if task == "lambada_openai":
        return [{"text": f"the quick brown fox {i} jumps over the dog"}
                for i in range(5)]
    raise ValueError(task)


def _model(seed=0, e=8, layers=2):
    cfg_j = jax_configs.tiny_qwen2_moe(num_experts=e, num_layers=layers)
    cfg_t = configs.tiny_qwen2_moe(num_experts=e, num_layers=layers)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _tokens(cfg, n, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, s)).astype(np.int32)


def _mixed(pkg, e, layers):
    """Routed experts alternate w4a4 / w8a8, the shared expert (index E) w8a8."""
    s4, s8 = (pkg.parse_scheme(s) for s in ("w4a4_g-1_sym", "w8a8_g-1_sym"))
    return pkg.QModelConfig(layers={str(l): pkg.QLayerConfig(experts={
        **{str(i): pkg.QExpertConfig(*([(s4, s8)[i % 2]] * 3)) for i in range(e)},
        str(e): pkg.QExpertConfig(*([s8] * 3))}) for l in range(layers)})


def _rel(a, b):
    return abs(a - b) / b


@pytest.mark.parametrize("batch", [1, 3])
def test_eval_ppl_tokens_float_vs_jax(batch):
    cfg_j, cfg_t, params_j, params_t = _model(0)
    toks = _tokens(cfg_t, 5, 24, 1)          # 5 windows: a ragged last batch of 3
    ref = jax_ev.eval_ppl_tokens(params_j, toks, cfg_j, JaxMoEImpl(kind="ragged"))
    kernels.reset_launch_counts()
    got = evaluator.eval_ppl_tokens(params_t, toks, cfg_t, MoEImpl(kind="ragged"),
                                    batch=batch)
    assert _rel(got, ref) < 1e-4, (got, ref)
    assert all(n == 0 for n in kernels.launches.values())


@pytest.fixture(scope="module")
def real_exec():
    """The mixed model real-quantized in both packages, the windows, and the
    ppls the tests compare (computed once)."""
    cfg_j, cfg_t, params_j, params_t = _model(3)
    toks = _tokens(cfg_t, 4, 24, 4)
    e, layers = cfg_t.num_experts, cfg_t.num_layers
    real_j = jax_qparams.quantize_model_experts_mixed(params_j, cfg_j,
                                                      _mixed(jax_schemes, e, layers))
    impl_j = JaxMoEImpl(kind="ragged", quant="mixed", interpret=True)
    qm = _mixed(schemes, e, layers)
    real_t = qparams.quantize_model_experts_mixed(params_t, cfg_t, qm)
    packed_t = qparams.quantize_model_experts_mixed(params_t, cfg_t, qm, pack_w4=True)
    impl_t = MoEImpl(kind="ragged", quant="mixed")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, toks=toks, real_j=real_j, impl_j=impl_j,
                real_t=real_t, packed_t=packed_t, impl_t=impl_t,
                ppl_j=jax_ev.eval_ppl_tokens(real_j, toks, cfg_j, impl_j),
                ppl_t=evaluator.eval_ppl_tokens(real_t, toks, cfg_t, impl_t))


def test_real_exec_ppl_vs_jax_and_packed_equals_stored(real_exec):
    r = real_exec
    assert "shared_gate_up_q" in r["real_t"]["layers"]
    assert _rel(r["ppl_t"], r["ppl_j"]) < 5e-3, (r["ppl_t"], r["ppl_j"])
    assert "expert_gate_up_qcat" in r["packed_t"]["layers"]
    ppl_packed = evaluator.eval_ppl_tokens(r["packed_t"], r["toks"], r["cfg_t"],
                                           r["impl_t"])
    assert ppl_packed == r["ppl_t"]


@pytest.mark.parametrize("int8_kv", [False, True])
def test_eval_ppl_decode_vs_forward_and_jax(real_exec, int8_kv):
    r = real_exec
    bound = 2e-2 if int8_kv else 5e-3
    params_t, params_j = r["real_t"], r["real_j"]
    if int8_kv:
        params_t = qparams.quantize_lm_head(params_t)
        params_j = jax_qparams.quantize_lm_head(params_j)
    # batch 3 over 4 windows: the ragged last batch scores too
    got = evaluator.eval_ppl_decode(params_t, r["toks"], r["cfg_t"], r["impl_t"],
                                    int8_kv=int8_kv, batch=3)
    ref = jax_ev.eval_ppl_decode(params_j, r["toks"], r["cfg_j"], r["impl_j"],
                                 int8_kv=int8_kv, batch=4)
    assert _rel(got, r["ppl_t"]) < bound, (got, r["ppl_t"])
    assert _rel(got, ref) < bound, (got, ref)


def test_loglikelihood_vs_jax():
    cfg_j, cfg_t, params_j, params_t = _model(1, e=4, layers=1)
    ctx = np.array([1, 2, 3, 9, 4])
    logits = jax_model.forward_logits(params_j, jnp.asarray(ctx)[None], cfg_j,
                                      JaxMoEImpl(kind="dense"))
    nxt = int(jnp.argmax(logits[0, -1]))
    for cont in (np.array([nxt]), np.array([nxt, 5, 7]), np.array([(nxt + 7) % 256])):
        ll_j, greedy_j = jax_ev.loglikelihood(params_j, cfg_j, ctx, cont,
                                              JaxMoEImpl(kind="dense"))
        ll_t, greedy_t = evaluator.loglikelihood(params_t, cfg_t, ctx, cont,
                                                 MoEImpl(kind="dense"))
        assert _rel(ll_t, ll_j) < 1e-4 and greedy_t == greedy_j, (ll_t, ll_j)
    assert evaluator.loglikelihood(params_t, cfg_t, ctx, np.array([nxt]),
                                   MoEImpl(kind="dense"))[1]


@pytest.mark.parametrize("task", evaluator.ZERO_SHOT_TASKS)
def test_task_items_equal_the_reference(task):
    assert evaluator.task_items(task, _rows(task)) == jax_ev.task_items(task, _rows(task))
    with pytest.raises(ValueError):
        evaluator.task_items("nope", [])


def test_score_items_vs_jax():
    cfg_j, cfg_t, params_j, params_t = _model(0, e=4, layers=1)
    tok = WhitespaceTokenizer(cfg_t.vocab_size)
    for task in ("piqa", "winogrande", "hellaswag"):
        items = evaluator.task_items(task, _rows(task))
        acc_j = jax_ev.score_items(params_j, cfg_j, tok, items, JaxMoEImpl(kind="dense"),
                                   limit=3)
        acc_t = evaluator.score_items(params_t, cfg_t, tok, items,
                                      MoEImpl(kind="dense"), limit=3)
        assert acc_t == acc_j


def test_download_only_sources_raise():
    cfg_j, cfg_t, _, params_t = _model(0, e=4, layers=1)
    with pytest.raises(NotImplementedError, match="download"):
        evaluator.eval_ppl(params_t, cfg_t)
    with pytest.raises(NotImplementedError, match="download"):
        evaluator.eval_tasks(params_t, cfg_t, WhitespaceTokenizer(cfg_t.vocab_size))


@pytest.mark.parametrize("argv", [["--real-exec"],
                                  ["--real-exec", "--method", "none",
                                   "--qstr", "w8a8_g-1_sym"]])
def test_run_real_exec_needs_a_quant_config(argv, capsys):
    with pytest.raises(SystemExit) as err:
        run.main(argv)
    assert err.value.code == 2
    assert "--real-exec requires a quant config" in capsys.readouterr().err


def test_run_cli_fake_and_real_exec_agree(monkeypatch, tmp_path):
    """The CLI on the CPU at tiny width: the seeded model, RTN w8a8 by
    fake-quant and through the real kernels' plain versions, ppl within the
    reference's 5e-3 of each other; --out holds the printed result."""
    cfg = dataclasses.replace(configs.tiny_qwen2_moe(4, 2), vocab_size=512)
    monkeypatch.setattr(configs, "config_for", lambda m: cfg)
    common = ["--qstr", "w8a8_g-1_sym", "--seqlen", "16", "--nsamples", "2",
              "--device", "cpu"]
    fake = run.main(common)
    out = tmp_path / "r.json"
    real = run.main([*common, "--real-exec", "--out", str(out)])
    assert set(fake) == set(real) == {"synthetic_ppl"}
    assert np.isfinite(real["synthetic_ppl"])
    assert _rel(real["synthetic_ppl"], fake["synthetic_ppl"]) < 5e-3
    import json

    assert json.loads(out.read_text()) == real
