"""internvl2-26b — VLM: InternViT-6B vision encoder + InternLM2-20B LLM.

Backbone (assignment scope): the InternLM2-20B language decoder —
48L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92553 (padded to
92672 for the 16-way vocab shard).  [arXiv:2404.16821; hf].

The InternViT frontend is a STUB per the assignment: ``input_specs()``
feeds precomputed patch embeddings (``input_mode='embeddings'``), so the
vision tower is represented by its output interface only.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    pattern=(LayerSpec(kind="attn", attn_type="global", mlp="dense"),),
    num_groups=48,
    mlp_activation="swiglu",
    input_mode="embeddings",
    source="arXiv:2404.16821; hf",
)
