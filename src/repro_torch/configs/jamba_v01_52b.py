"""jamba-v0.1-52b — hybrid Mamba+attention MoE decoder.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536,
MoE 16 experts top-2.  [arXiv:2403.19887; hf].

Layout follows the Jamba block: period-8 pattern with attention at index 4
(1:7 attn:mamba ratio) and MoE replacing the dense MLP on every other
layer.  SOCKET applies only to the attention layers (which hold all of
Jamba's KV memory); Mamba layers decode from O(1) state.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def _layer(i: int) -> LayerSpec:
    kind = "attn" if i == 4 else "mamba"
    mlp = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(kind=kind, attn_type="global", mlp=mlp)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=tuple(_layer(i) for i in range(8)),
    num_groups=4,
    num_experts=16,
    num_experts_per_tok=2,
    moe_parallelism="ep",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    mlp_activation="swiglu",
    source="arXiv:2403.19887; hf",
)
