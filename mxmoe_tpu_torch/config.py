"""Project-level registries: model topologies and artifact locations (port of
``mxmoe_tpu/config.py``, the reference's ``project_config.py:6-88``, with
repo-relative paths in place of its machine paths).

The artifact directories live under ``MXMOE_ARTIFACT_DIR``, by default the
repository's ``artifacts/`` (git-ignored); every pipeline stage writes a
resumable file there, the reference's file-as-interface design.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACT_DIR = pathlib.Path(os.environ.get("MXMOE_ARTIFACT_DIR", REPO_ROOT / "artifacts"))

GATE_TRACE_DIR = ARTIFACT_DIR / "gate"
CALIB_LOSS_DIR = ARTIFACT_DIR / "calib"
PERF_TABLE_DIR = ARTIFACT_DIR / "perf"
QCONFIG_DIR = ARTIFACT_DIR / "qconfigs"
WORKLOAD_DIR = ARTIFACT_DIR / "workloads"
BENCH_DIR = ARTIFACT_DIR / "bench"


@dataclasses.dataclass(frozen=True)
class MoEModelSpec:
    """Static topology of a supported MoE model family:
      qwen2_moe     = Qwen1.5-MoE-A2.7B   (24L, 60 experts + shared, top-4)
      qwen2_moe_57b = Qwen2-57B-A14B      (28L, 64 experts + shared, top-8)
      mixtral       = Mixtral-8x7B        (32L, 8 experts, top-2)
      ds2           = DeepSeek-V2-Lite    (27L, 64 + 2 shared, top-6, layer0 dense)
    """

    model_id: str
    hf_name: str
    num_layers: int
    num_experts: int
    top_k: int
    hidden_size: int            # K of the expert GEMMs
    moe_intermediate_size: int  # N of the expert GEMMs
    # the shared expert's width in units of moe_intermediate_size (the
    # reference's num_shared_experts: qwen2_moe's 5632 = 4 x 1408 -> 4)
    num_shared_experts: int
    first_dense_layers: int = 0  # ds2: layer 0 is a dense MLP


MODEL_REGISTRY: dict[str, MoEModelSpec] = {
    "qwen2_moe": MoEModelSpec(
        model_id="qwen2_moe", hf_name="Qwen/Qwen1.5-MoE-A2.7B", num_layers=24,
        num_experts=60, top_k=4, hidden_size=2048, moe_intermediate_size=1408,
        num_shared_experts=4),
    "qwen2_moe_57b": MoEModelSpec(
        model_id="qwen2_moe_57b", hf_name="Qwen/Qwen2-57B-A14B", num_layers=28,
        num_experts=64, top_k=8, hidden_size=3584, moe_intermediate_size=2560,
        num_shared_experts=8),
    "mixtral": MoEModelSpec(
        model_id="mixtral", hf_name="mistralai/Mixtral-8x7B-v0.1", num_layers=32,
        num_experts=8, top_k=2, hidden_size=4096, moe_intermediate_size=14336,
        num_shared_experts=0),
    "ds2": MoEModelSpec(
        model_id="ds2", hf_name="deepseek-ai/DeepSeek-V2-Lite", num_layers=27,
        num_experts=64, top_k=6, hidden_size=2048, moe_intermediate_size=1408,
        num_shared_experts=2, first_dense_layers=1),
}


def get_model_spec(model_id: str) -> MoEModelSpec:
    if model_id not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model id {model_id!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_id]
