"""gemma-7b — dense decoder with GeGLU and wide head_dim=256.

28L, d_model=3072, 16 heads (kv=16 => MHA on 7b; MQA is the 2b variant),
d_ff=24576, vocab=256000.  [arXiv:2403.08295; hf].
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=(LayerSpec(kind="attn", attn_type="global", mlp="dense"),),
    num_groups=28,
    mlp_activation="geglu",
    source="arXiv:2403.08295; hf",
)
