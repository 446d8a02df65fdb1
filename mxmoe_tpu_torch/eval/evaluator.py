"""Perplexity and zero-shot scoring of (quantized) models (port of
``mxmoe_tpu/eval/evaluator.py``; the reference's ``Evaluator.eval_ppl``,
``evaluator.py:23-57``: manual cross-entropy over windows, ppl = exp(sum
nll / N)).

The forward runs under ``torch.inference_mode`` on the device the params
live on: CUDA params launch the kernels their storage selects, CPU params
run the kernels' plain versions. ``eval_ppl`` reads WikiText-2 through a
download and raises here (no dataset is in the repository); the zero-shot
primitives (``loglikelihood``, ``task_items``, ``score_items``) take any
tokenizer callable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import model as model_mod
from ..models.configs import MoEConfig
from ..models.layers import MoEImpl


def _device_of(params: dict) -> torch.device:
    return params["embed"].device


def eval_ppl_tokens(
    params: dict,
    tokens: np.ndarray,        # [n_windows, seqlen]
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
    batch: int = 1,
) -> float:
    """Perplexity over pre-tokenized windows (next-token CE, f32 log-softmax),
    ``batch`` windows a forward."""
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                           device=_device_of(params))
    total_nll, total_tok = 0.0, 0
    with torch.inference_mode():
        for i in range(0, toks.shape[0], batch):
            chunk = toks[i: i + batch]
            logits = model_mod.forward_logits(params, chunk, cfg, impl)
            lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            total_nll -= float(lp.gather(-1, chunk[:, 1:].long()[..., None]).sum())
            total_tok += chunk[:, 1:].numel()
    return float(np.exp(total_nll / max(total_tok, 1)))


def eval_ppl(params: dict, cfg: MoEConfig, impl: MoEImpl = MoEImpl(),
             tokenizer=None, seqlen: int = 4096, nsamples: int | None = None,
             dataset: str = "wikitext2") -> float:
    """WikiText-2 test perplexity (the reference's protocol): the text comes
    through ``datasets.load_dataset``, a download, and the repository holds
    no copy, so this raises. Score local windows with
    :func:`eval_ppl_tokens`."""
    raise NotImplementedError(
        f"eval_ppl: the {dataset} test split is read through "
        "datasets.load_dataset, which needs a download; tokenize a local text "
        "(quant.data.tokens_from_text_file) and call eval_ppl_tokens")


def loglikelihood(
    params: dict,
    cfg: MoEConfig,
    context_tokens: np.ndarray,       # [T_ctx]
    continuation_tokens: np.ndarray,  # [T_cont]
    impl: MoEImpl = MoEImpl(),
) -> tuple[float, bool]:
    """(log p(continuation | context), greedy match): the primitive under
    lm-eval's zero-shot tasks (acc_norm protocol, ``evaluator.py:64-86``)."""
    dev = _device_of(params)
    toks = torch.as_tensor(np.concatenate([context_tokens, continuation_tokens]),
                           dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        logits = model_mod.forward_logits(params, toks, cfg, impl)
    lp = torch.log_softmax(logits[0, :-1].float(), dim=-1)
    start = len(context_tokens) - 1
    cont = torch.as_tensor(np.asarray(continuation_tokens), dtype=torch.long,
                           device=dev)
    sel = lp[start: start + len(continuation_tokens)]
    ll = sel.gather(-1, cont[:, None]).sum()
    greedy = bool((sel.argmax(-1) == cont).all())
    return float(ll), greedy


ZERO_SHOT_TASKS = ("piqa", "hellaswag", "arc_easy", "arc_challenge",
                   "winogrande", "lambada_openai")


def task_items(task: str, rows) -> list[tuple[str, list[str], int]]:
    """Raw dataset rows -> (context, choices, gold) items, per task schema."""
    if task == "piqa":
        return [(r["goal"], [r["sol1"], r["sol2"]], int(r["label"])) for r in rows]
    if task == "hellaswag":
        return [(r["ctx"], list(r["endings"]), int(r["label"])) for r in rows]
    if task in ("arc_easy", "arc_challenge"):
        items = []
        for r in rows:
            if r["answerKey"] not in r["choices"]["label"]:
                continue
            gold = r["choices"]["label"].index(r["answerKey"])
            items.append((r["question"], list(r["choices"]["text"]), gold))
        return items
    if task == "winogrande":
        items = []
        for r in rows:
            head, _, tail = r["sentence"].partition("_")
            items.append((head, [r["option1"] + tail, r["option2"] + tail],
                          int(r["answer"]) - 1))
        return items
    if task == "lambada_openai":
        return [(" ".join(r["text"].split()[:-1]), [" " + r["text"].split()[-1]], 0)
                for r in rows]
    raise ValueError(f"unknown zero-shot task: {task}")


def score_items(params, cfg, tokenizer, items, impl=MoEImpl(),
                limit: int | None = None) -> float:
    """acc_norm over (context, choices, gold) items: the choice with the
    highest length-normalized loglikelihood wins. ``tokenizer(text)`` returns
    a dict with ``input_ids``."""
    if limit:
        items = items[:limit]
    correct = 0
    for ctx, choices, gold in items:
        scores = []
        ctx_ids = np.asarray(tokenizer(ctx)["input_ids"])
        for ch in choices:
            cont_ids = np.asarray(tokenizer(" " + ch)["input_ids"])
            ll, _ = loglikelihood(params, cfg, ctx_ids, cont_ids, impl)
            scores.append(ll / max(len(cont_ids), 1))
        if int(np.argmax(scores)) == gold:
            correct += 1
    return correct / max(len(items), 1)


def eval_tasks(params: dict, cfg: MoEConfig, tokenizer,
               tasks: tuple[str, ...] = ZERO_SHOT_TASKS, impl: MoEImpl = MoEImpl(),
               limit: int | None = None) -> dict:
    """Zero-shot accuracy over lm-eval's tasks: their rows come through
    ``datasets.load_dataset``, a download, and the repository holds none, so
    this raises. Score local rows with ``task_items`` + :func:`score_items`."""
    raise NotImplementedError(
        f"eval_tasks: the rows of {list(tasks)} are read through "
        "datasets.load_dataset, which needs a download; build items with "
        "task_items from local rows and call score_items")


def eval_ppl_decode(
    params: dict,
    tokens: np.ndarray,        # [n_windows, seqlen]
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
    int8_kv: bool = False,
    batch: int = 8,
) -> float:
    """Teacher-forced perplexity through the serving decode path: one cached
    step a token (``serving.decode.forward_cached``: the cache write and the
    attention, K3 / K3q on the card, the quantized experts, the int8 lm_head
    when the params carry one), a bf16 or int8 KV cache for each batch of
    windows. Every window scores, a ragged last batch included, so the
    token set is the forward ppl's. The last position has no target, so its
    step is not taken. On a card each step is one replay of a CUDA graph
    (``decode_nll``)."""
    nll, n = decode_nll(params, tokens, cfg, impl, int8_kv, batch)
    return float(np.exp(nll / max(n, 1)))


def decode_nll(params: dict, tokens: np.ndarray, cfg: MoEConfig,
               impl: MoEImpl = MoEImpl(), int8_kv: bool = False, batch: int = 8,
               captured: bool = True) -> tuple[float, int]:
    """``eval_ppl_decode``'s summed negative log-likelihood and its token
    count. Each batch of windows runs the step
    (``serving.graph.TeacherForcedGraph``, the counterpart of the
    reference's jitted ``window_nll``) ``seqlen - 1`` times, each fed by one
    device copy of the token and its target; on a card each run is a
    replay, and a ragged last batch is a second graph of its own width, both
    in one memory pool. ``captured=False`` runs the same step body eagerly
    on any device (the twin a captured run is held against). Every batch
    empties its cache first; the host reads the nll once a batch."""
    from ..serving.graph import TeacherForcedGraph
    from ..serving.kv_cache import init_kv_cache, init_quant_kv_cache

    dev = _device_of(params)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32, device=dev)
    n_win, seqlen = toks.shape
    batch = min(batch, n_win)

    def make_cache(b):
        return (init_quant_kv_cache(cfg, b, seqlen, device=dev) if int8_kv
                else init_kv_cache(cfg, b, seqlen, torch.bfloat16, device=dev))

    pool = torch.cuda.graph_pool_handle() if captured and dev.type == "cuda" else None
    graphs: dict = {}            # windows a batch -> its step graph
    total_nll, total_tok = 0.0, 0
    with torch.inference_mode():
        for i in range(0, n_win, batch):
            chunk = toks[i: i + batch]
            b = chunk.shape[0]
            if b not in graphs:
                graphs[b] = TeacherForcedGraph(params, cfg, impl, make_cache(b), pool,
                                               eager=not captured)
            g = graphs[b]
            g.reset()
            for t in range(seqlen - 1):
                g.feed(chunk[:, t:t + 2])
                g.run()
            total_nll += float(g.nll)
            total_tok += b * (seqlen - 1)
    return total_nll, total_tok
