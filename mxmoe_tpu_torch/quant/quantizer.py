"""The part of ``mxmoe_tpu/quant/quantizer.py`` the serving slices read:
``act_gsize_arrays``, the flex markers shared by the real-quantized params
(``qparams.quantize_model_experts_mixed``) and, once ported, the fake-quant
evaluation path. The fake-quant transforms themselves come with the
calibration port (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from .schemes import QModelConfig, flex_family_info


def act_gsize_arrays(qmodel_cfg: QModelConfig, cfg, num_layers: int,
                     device="cpu") -> dict:
    """Flex markers of a mixed model: per family ``act_gsize_gateup`` /
    ``act_gsize_down`` [L, E, G] f32 (each expert's ``a_gsize``, or -1 for
    per-token activations, replicated along the last axis so the group count
    G rides the array's shape). Emitted only for families whose scheme set
    is flex (grouped or asymmetric: ``schemes.flex_family_info``)."""
    out = {}
    e = cfg.num_experts
    for lin, key, kdim in (("gate", "act_gsize_gateup", cfg.hidden_size),
                           ("down", "act_gsize_down", cfg.moe_intermediate_size)):
        any_flex, g_min, _ = flex_family_info(qmodel_cfg, num_layers, e, lin, kdim)
        if not any_flex:
            continue
        ag = torch.full((num_layers, e, kdim // g_min), -1.0, dtype=torch.float32)
        for l in range(num_layers):
            lcfg = qmodel_cfg.layer(l)
            for ei in range(e):
                c = lcfg.experts[str(ei)].qmap()[lin]
                if c.a_gsize != -1 and c.a_bits < 16:
                    if c.a_gsize != g_min:
                        raise ValueError(f"{lin}: a_gsize {c.a_gsize} != the "
                                         f"family's group size {g_min}")
                    ag[l, ei, :] = float(c.a_gsize)
        out[key] = ag.to(device)
    return out
