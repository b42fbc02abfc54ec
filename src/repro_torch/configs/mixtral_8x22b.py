"""mixtral-8x22b — sparse MoE decoder (8 experts, top-2) with SWA.

56L, d_model=6144, 48 heads (GQA kv=8), expert d_ff=16384, vocab=32768.
[arXiv:2401.04088; hf].

Every layer is a sliding-window (4096) attention layer with an MoE FFN;
``moe_parallelism='tp'`` is the JAX package's sharding choice (8 experts
do not divide its 16-way model axis) and changes nothing in the port.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec(kind="attn", attn_type="local", mlp="moe"),),
    num_groups=56,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_parallelism="tp",
    mlp_activation="swiglu",
    source="arXiv:2401.04088; hf",
)
