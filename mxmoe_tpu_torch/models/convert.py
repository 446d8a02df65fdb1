"""Storage conversion of quantized params (port of the pack step of
``mxmoe_tpu/models/convert.py``: a uniform ``w_bits <= 4`` scheme's int8
stored codes become nibble-packed ``expert_*_q_packed``, half the bytes,
served by ``ops.gmm_w4a8_packed`` (w x a) or ``ops.gmm_weight_only_packed``
(a16)). Checkpoint and artifact I/O and the CLI wait for the loader port
(ROADMAP queue A).
"""

from __future__ import annotations

import torch

from ..quant.packing import pack_int4_halves
from ..quant.schemes import QLinearConfig


def pack_int4_experts(params: dict, qcfg: QLinearConfig) -> dict:
    """``expert_*_q`` [L, E, K, N] -> ``expert_*_q_packed`` [L, E, K/2, N]
    for params quantized uniformly with ``qcfg`` (``w_bits <= 4``).

    The packed w x a kernel assumes symmetric per-channel scales and never
    reads ``_zp``, so a quantized-activation scheme must be ``w_sym`` with
    ``g = -1``. The packed weight-only kernel dequantizes with scale and zp
    per group, so any a16 scheme of at most 4 bits may pack."""
    if qcfg.w_bits > 4:
        raise ValueError(f"pack_int4_experts needs w_bits <= 4, got {qcfg.scheme_name}")
    if qcfg.a_bits < 16 and not (qcfg.w_sym and qcfg.w_gsize == -1):
        raise ValueError(
            "packing a quantized-activation scheme requires symmetric "
            f"per-channel weights (w_sym, g=-1); got {qcfg.scheme_name}")
    layers = dict(params["layers"])
    for name in ("expert_gate_up_q", "expert_down_q"):
        q = layers.pop(name)                          # [L, E, K, N]
        nl, e, k, n = q.shape
        packed = torch.empty((nl, e, k // 2, n), dtype=torch.int8, device=q.device)
        for l in range(nl):     # one layer's int32 working set at a time
            packed[l] = pack_int4_halves(q[l])
        layers[name + "_packed"] = packed
    return {**params, "layers": layers}
