"""musicgen-medium — decoder-only LM over EnCodec audio tokens.

48L, d_model=1536, 24 heads (GQA kv=24 => MHA), d_ff=6144, vocab=2048.
[arXiv:2306.05284; hf].  The EnCodec/conditioning frontend is a stub: the
model consumes precomputed frame embeddings (``input_mode='embeddings'``);
the LM head predicts the 2048-entry codebook.

Sharding note (DESIGN.md §7.3): 24 heads do not divide the 16-way model
axis — attention weights fall back to replication over "model" (MLP keeps
tensor parallelism; 6144 % 16 == 0).  ``logical_pad_heads=True`` pads to 32
heads for full TP (exact, zero-initialised pad heads) and is evaluated in
EXPERIMENTS.md §Perf.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,          # 1536 / 24
    d_ff=6144,
    vocab_size=2048,
    pattern=(LayerSpec(kind="attn", attn_type="global", mlp="dense"),),
    num_groups=48,
    mlp_activation="geglu",
    input_mode="embeddings",
    source="arXiv:2306.05284; hf",
)
