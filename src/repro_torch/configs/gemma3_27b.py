"""gemma3-27b — dense decoder with 5:1 local:global attention, 128k context.

62L, d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
[hf:google/gemma-3-1b-pt; unverified].

Layout: pattern = 5 sliding-window ("local") layers followed by 1 global
layer, repeated 10x (60 layers) + a 2-layer local remainder = 62 layers.
SOCKET applies to the *global* layers' KV caches; local layers are
already sparse by construction (window 1024): they decode from a ring of
``window`` slots.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", attn_type="local", mlp="dense")
_GLOBAL = LayerSpec(kind="attn", attn_type="global", mlp="dense")

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    num_groups=10,
    remainder=(_LOCAL, _LOCAL),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_activation="geglu",
    source="hf:google/gemma-3-1b-pt; unverified",
)
