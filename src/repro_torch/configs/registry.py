"""Architecture registry: ``--arch <id>`` resolution for the port.

The port serves the all-global-attention decoders of the SOCKET static
path and gemma3's 5:1 sliding-window (local) : global layout.  The JAX
package's other architectures need layers that later slices bring;
asking for one raises :class:`NotImplementedError` naming that slice.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_12B

# The paper evaluates SOCKET on Llama-3.1-8B-Instruct; this reference
# config carries the exact (P, L, tau) operating point of paper Tables
# 1/13 on the right head geometry.
LLAMA31_8B = ModelConfig(
    name="llama31-8b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(LayerSpec(kind="attn", attn_type="global", mlp="dense"),),
    num_groups=32,
    rope_theta=500_000.0,
    mlp_activation="swiglu",
    source="arXiv:2407.21783 (paper's eval model)",
)

ARCHITECTURES: Dict[str, ModelConfig] = {
    "stablelm-12b": STABLELM_12B,
    "llama31-8b": LLAMA31_8B,
    "gemma3-27b": GEMMA3_27B,
}

# Architectures of the JAX package that the port does not build yet, with
# the later slice (ROADMAP.md queue 1) that brings what each needs.
LATER: Dict[str, str] = {
    "minitron-8b": "the other-backends slice (further all-global configs)",
    "gemma-7b": "the other-backends slice (further all-global configs)",
    "mixtral-8x22b": "ROADMAP.md queue 1 item 7 (MoE layers)",
    "llama4-maverick-400b-a17b": "ROADMAP.md queue 1 item 7 (MoE layers)",
    "jamba-v0.1-52b": "ROADMAP.md queue 1 item 7 (Mamba and MoE layers)",
    "mamba2-780m": "ROADMAP.md queue 1 item 7 (Mamba layers)",
    "musicgen-medium": "the embeddings-input slice (audio frontend)",
    "internvl2-26b": "the embeddings-input slice (vision frontend)",
}


def get_config(name: str) -> ModelConfig:
    if name in ARCHITECTURES:
        return ARCHITECTURES[name]
    if name in LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it comes with "
            f"{LATER[name]}; ported: {sorted(ARCHITECTURES)}")
    raise KeyError(
        f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
