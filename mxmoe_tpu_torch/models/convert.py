"""Storage conversion of quantized params (port of the pack step of
``mxmoe_tpu/models/convert.py``: a uniform ``w_bits <= 4`` scheme's int8
stored codes become nibble-packed ``expert_*_q_packed``, half the bytes,
served by ``ops.gmm_w4a8_packed``). Checkpoint and artifact I/O and the CLI
wait for the loader port (ROADMAP queue A).
"""

from __future__ import annotations

from ..quant.packing import pack_int4_halves
from ..quant.schemes import QLinearConfig


def pack_int4_experts(params: dict, qcfg: QLinearConfig) -> dict:
    """``expert_*_q`` [L, E, K, N] -> ``expert_*_q_packed`` [L, E, K/2, N]
    for params quantized uniformly with ``qcfg`` (``w_bits <= 4``).

    The packed w x a kernel assumes symmetric per-channel scales and never
    reads ``_zp``, so a quantized-activation scheme must be ``w_sym`` with
    ``g = -1``; packing a weight-only (a16) scheme needs
    ``gmm_weight_only_packed``, which is not ported."""
    if qcfg.w_bits > 4:
        raise ValueError(f"pack_int4_experts needs w_bits <= 4, got {qcfg.scheme_name}")
    if qcfg.a_bits >= 16:
        raise NotImplementedError(
            f"packed weight-only serving of {qcfg.scheme_name} needs "
            "gmm_weight_only_packed (ROADMAP queue B)")
    if not (qcfg.w_sym and qcfg.w_gsize == -1):
        raise ValueError(
            "packing a quantized-activation scheme requires symmetric "
            f"per-channel weights (w_sym, g=-1); got {qcfg.scheme_name}")
    layers = dict(params["layers"])
    for name in ("expert_gate_up_q", "expert_down_q"):
        layers[name + "_packed"] = pack_int4_halves(layers.pop(name))
    return {**params, "layers": layers}
