"""mamba2-780m — attention-free SSD (state-space duality) decoder.

48L, d_model=1536, d_ff=0 (no separate MLP; the Mamba block is the whole
layer), vocab=50280 (padded to 50304), ssm_state=128.
[arXiv:2405.21060; unverified].

SOCKET does not apply: there are no keys and no KV cache to sparsify.
Decode is O(1) in context length: the continuous engine holds one state
row per decode slot and no pool blocks at all.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(kind="mamba", mlp="none"),),
    num_groups=48,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    attention_backend="dense",   # no attention layers; backend unused
    source="arXiv:2405.21060; unverified",
)
