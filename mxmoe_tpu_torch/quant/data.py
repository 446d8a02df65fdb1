"""Calibration data (port of ``mxmoe_tpu/quant/data.py``: the synthetic,
Markov and local-text sources and ``get_calibration_tokens``).

Token ids come out [nsamples, seqlen] int32, drawn by numpy exactly as the
reference draws them (bitwise the same ids for the same seed);
``get_calibration_tokens`` returns them as a CPU torch tensor. The
reference's WikiText-2 / HumanEval-X loaders read ``datasets.load_dataset``,
which needs a download, and are not ported: with a tokenizer,
``get_calibration_tokens`` goes to a local text file (``MXMOE_CALIB_TEXT``)
and otherwise, as without one, to the seeded synthetic stream.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _crop_samples(ids: np.ndarray, nsamples: int, seqlen: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ids.shape[0] < seqlen + 1:
        reps = -(-(seqlen + 1) // ids.shape[0])
        ids = np.tile(ids, reps)
    starts = rng.integers(0, ids.shape[0] - seqlen, size=nsamples)
    return np.stack([ids[s: s + seqlen] for s in starts]).astype(np.int32)


def synthetic_tokens(nsamples: int, seqlen: int, vocab_size: int = 151936,
                     seed: int = 42) -> np.ndarray:
    """Zipf-distributed token stream with repeated short n-grams (bursty,
    long-tailed routing statistics without a dataset)."""
    rng = np.random.default_rng(seed)
    total = nsamples * seqlen
    base = rng.zipf(1.3, size=total).astype(np.int64) % (vocab_size - 4) + 4
    out = base.copy()
    pos = 0
    while pos < total - 64:
        if rng.random() < 0.15:
            span = int(rng.integers(4, 32))
            out[pos + span: pos + 2 * span] = out[pos: pos + span]
            pos += 2 * span
        else:
            pos += int(rng.integers(16, 64))
    return out.reshape(nsamples, seqlen).astype(np.int32)


def synthetic_markov_tokens(nsamples: int, seqlen: int, vocab_size: int = 2048,
                            seed: int = 7, branching: int = 8,
                            structure_seed: int = 1) -> np.ndarray:
    """A first-order Markov language with ``branching`` fixed successors per
    token (Dirichlet weights): learnable, unlike :func:`synthetic_tokens`.
    ``structure_seed`` fixes the language, ``seed`` the sampled paths."""
    lang = np.random.default_rng(structure_seed)
    succ = lang.integers(0, vocab_size, size=(vocab_size, branching))
    probs = lang.dirichlet(np.full(branching, 0.6), size=vocab_size)
    cdf = np.cumsum(probs, axis=1)

    rng = np.random.default_rng(seed)
    out = np.empty((nsamples, seqlen), np.int64)
    state = rng.integers(0, vocab_size, size=nsamples)
    for t in range(seqlen):
        u = rng.random((nsamples, 1))
        j = np.minimum((u > cdf[state]).sum(axis=1), branching - 1)
        state = succ[state, j]
        out[:, t] = state
    return out.astype(np.int32)


def tokens_from_text_file(path: str, tokenizer, nsamples: int, seqlen: int,
                          seed: int = 42) -> np.ndarray:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int64)
    return _crop_samples(ids, nsamples, seqlen, seed)


def get_calibration_tokens(nsamples: int, seqlen: int, dataset: str = "auto",
                           tokenizer=None, vocab_size: int = 151936,
                           seed: int = 42) -> torch.Tensor:
    """Best available calibration tokens -> int32 [nsamples, seqlen]: a local
    text file (``MXMOE_CALIB_TEXT``) through ``tokenizer``, else the seeded
    synthetic stream. ``dataset="wikitext2"`` asks for the download-only
    source and raises."""
    if dataset == "wikitext2":
        raise NotImplementedError(
            "WikiText-2 is read through datasets.load_dataset, which needs a "
            "download; set MXMOE_CALIB_TEXT to a local text file instead")
    path = os.environ.get("MXMOE_CALIB_TEXT")
    if path and tokenizer is not None and os.path.exists(path):
        ids = tokens_from_text_file(path, tokenizer, nsamples, seqlen, seed)
    else:
        ids = synthetic_tokens(nsamples, seqlen, vocab_size, seed)
    return torch.from_numpy(ids)
