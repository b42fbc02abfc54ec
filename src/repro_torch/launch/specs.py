"""Input shapes and the deployment numerics of a run.

A port of the first part of ``repro.launch.specs``: :class:`ShapeSpec`,
``SHAPES`` and :func:`dryrun_model_config`, field for field.  The rest
of the JAX module (sharding rules and ``ShapeDtypeStruct`` specs for the
dry run) comes with ROADMAP.md queue 1 item 11's dry-run step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "dryrun_model_config"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           long_context=True),
}


def dryrun_model_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Deployment numerics for ``shape``: bf16 parameters and compute,
    every layer group rematerialised in the backward of a training shape
    (``remat_policy="full"``), SOCKET scores in bf16 in chunks of 16384
    keys, and prefill attention in query chunks of 1024 above 4096
    tokens: every field the JAX function sets, set the same way."""
    sock = dataclasses.replace(cfg.socket, score_chunk=16384,
                               score_dtype="bfloat16")
    return cfg.replace(
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat_policy="full" if shape.kind == "train" else "none",
        attn_q_chunk=1024 if shape.seq_len > 4096 else 0,
        socket=sock,
    )
