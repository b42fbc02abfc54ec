"""llama4-maverick-400b-a17b — interleaved-MoE decoder, 128 experts top-1.

48L, d_model=5120, 40 heads (GQA kv=8), expert d_ff=8192, vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  "Early fusion"
multimodality is out of backbone scope (text path only); MoE layers are
interleaved with dense layers (period-2 pattern, the Maverick design),
giving ~17B active of ~400B total parameters.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(
        LayerSpec(kind="attn", attn_type="global", mlp="dense"),
        LayerSpec(kind="attn", attn_type="global", mlp="moe"),
    ),
    num_groups=24,
    num_experts=128,
    num_experts_per_tok=1,
    moe_parallelism="ep",
    mlp_activation="swiglu",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
