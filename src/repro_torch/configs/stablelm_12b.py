"""stablelm-12b — plain dense GQA decoder.

40L, d_model=5120, 32 heads (GQA kv=8), d_ff=13824, vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; hf].
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,        # 5120 / 32
    d_ff=13824,
    vocab_size=100352,
    pattern=(LayerSpec(kind="attn", attn_type="global", mlp="dense"),),
    num_groups=40,
    mlp_activation="swiglu",
    qk_norm=True,
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)
