"""Accuracy evaluation (port of ``mxmoe_tpu/eval``: the reference's
``mxmoe/quant/evaluator.py``)."""

from .evaluator import eval_ppl, eval_ppl_tokens  # noqa: F401
