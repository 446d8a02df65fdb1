"""The one traffic generator: a mix file of parameters (``traffic/<name>.json``)
and a seed -> requests.

Every seed serves the same sizes: the prompt and output lengths are a
fixed pool of ``pool`` stratified quantiles of their distributions, served
in cycles of ``pool`` requests; each cycle takes every size once, in an
order the seed draws for that cycle (prompts and outputs each on its own,
so the pairs differ). Only the order, the pairing and the token ids come
from the seed. Token ids are uniform over the vocabulary, drawn per request
from its own generator, so request ``i`` is the same whatever was drawn
before it.

Mix keys (the loop is closed: a client per slot sends its next request
when its previous one completes):
  slots       the Engine's slots (= clients).
  max_len     the Engine's positions a slot.
  prompt_len, output_len
              {"dist": "loguniform", "lo", "hi"} (integers, both ends in).
  pool        how many stratified sizes a run walks through.
The window opens on slots that each hold a request part-way through, as in
the closed loop's steady state: the slots' output lengths are stratified
quantiles of the pool's length-biased distribution (a request is in flight
in proportion to its length), the shares already served stratified over
(0, 1); the tokens served so far are appended to the prompt, the rest is
left to serve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .weights import subseed


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int
    in_flight: bool = False    # in a slot when the window opens


def _quantiles(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] != "loguniform":
        raise ValueError(f"length distribution {dist['dist']!r}: 'loguniform'")
    lo, hi = float(dist["lo"]), float(dist["hi"])
    x = lo * (hi / lo) ** u
    return np.clip(np.rint(x), dist["lo"], dist["hi"]).astype(np.int64)


class Traffic:
    """Requests of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.slots, self.max_len = int(mix["slots"]), int(mix["max_len"])
        self.pool = int(mix["pool"])
        self.prompt_q = _quantiles(mix["prompt_len"], self.pool)
        self.output_q = _quantiles(mix["output_len"], self.pool)
        self._cycles: dict[int, tuple] = {}
        self.next_index = 0
        for p in self.prompt_q:
            for o in self.output_q:
                if o < 1 or p + o + 1 > self.max_len:
                    raise ValueError(f"a prompt of {p} and {o} new tokens do not fit "
                                     f"max_len {self.max_len}")

    def _tokens(self, index: int, n: int) -> list[int]:
        rng = np.random.default_rng(subseed(self.seed, f"traffic:prompt:{index}"))
        return rng.integers(0, self.vocab, size=int(n)).tolist()

    def _sizes(self, index: int) -> tuple[int, int]:
        c, k = divmod(index, self.pool)
        if c not in self._cycles:
            rng = np.random.default_rng(subseed(self.seed, f"traffic:cycle:{c}"))
            self._cycles[c] = (rng.permutation(self.pool), rng.permutation(self.pool))
        pi, oi = self._cycles[c]
        return int(self.prompt_q[pi[k]]), int(self.output_q[oi[k]])

    def next(self) -> Request:
        """The next request of the stream."""
        i = self.next_index
        self.next_index += 1
        p, o = self._sizes(i)
        return Request(self._tokens(i, p), o)

    def opening(self) -> list[Request]:
        """What each slot holds when the window opens (module docstring)."""
        n = self.slots
        rng = np.random.default_rng(subseed(self.seed, "traffic:in_flight"))
        outs = np.sort(self.output_q).astype(np.float64)
        cdf = np.cumsum(outs) / outs.sum()
        u = (np.arange(n) + 0.5) / n
        lengths = outs[np.minimum(np.searchsorted(cdf, u), len(outs) - 1)]
        lengths = lengths[rng.permutation(n)].astype(np.int64)
        served = (rng.permutation(n) + 0.5) / n
        out = []
        for o, f in zip(lengths, served):
            i = self.next_index
            self.next_index += 1
            p, _ = self._sizes(i)
            left = max(2, int(round(o * (1.0 - f))))   # at least one step to run
            out.append(Request(self._tokens(i, p + int(o) - left), left, in_flight=True))
        return out
