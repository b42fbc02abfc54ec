"""Architecture registry: ``--arch <id>`` resolution for the port.

The port serves the all-global-attention decoders (llama31-8b, the
paper's eval model; stablelm-12b; minitron-8b; gemma-7b, MHA at head dim
256), gemma3's 5:1 sliding-window (local) : global layout, the MoE
decoders (mixtral-8x22b on sliding-window layers, llama4-maverick's
interleaved dense/MoE layers), jamba's 1:7 attention : Mamba hybrid with
MoE, the attention-free mamba2, and the two embeddings-input models
(musicgen-medium over EnCodec frame embeddings, internvl2-26b's
InternLM2-20B decoder over vision patch embeddings), whose frontends are
stubs: they consume precomputed embeddings.  Every architecture of the
JAX package is registered; ``LATER`` is empty.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA_V01_52B
from repro_torch.configs.llama4_maverick_400b import CONFIG as \
    LLAMA4_MAVERICK
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
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
    "minitron-8b": MINITRON_8B,
    "gemma-7b": GEMMA_7B,
    "mixtral-8x22b": MIXTRAL_8X22B,
    "llama4-maverick-400b-a17b": LLAMA4_MAVERICK,
    "jamba-v0.1-52b": JAMBA_V01_52B,
    "mamba2-780m": MAMBA2_780M,
    "musicgen-medium": MUSICGEN_MEDIUM,
    "internvl2-26b": INTERNVL2_26B,
}

# Architectures of the JAX package that the port does not build yet, with
# the later slice (ROADMAP.md queue 1) that brings what each needs: none.
LATER: Dict[str, str] = {}


def get_config(name: str) -> ModelConfig:
    if name in ARCHITECTURES:
        return ARCHITECTURES[name]
    if name in LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it comes with "
            f"{LATER[name]}; ported: {sorted(ARCHITECTURES)}")
    raise KeyError(
        f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
