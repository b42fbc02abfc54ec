"""minitron-8b — width/depth-pruned Nemotron-4.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
[arXiv:2407.14679; hf].
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    pattern=(LayerSpec(kind="attn", attn_type="global", mlp="dense"),),
    num_groups=32,
    mlp_activation="swiglu",
    source="arXiv:2407.14679; hf",
)
