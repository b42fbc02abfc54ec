"""Model configuration schema for the PyTorch port.

A copy of the parts of ``repro.configs.base`` that the SOCKET static
serving path reads: :class:`LayerSpec`, :class:`SocketSettings` and
:class:`ModelConfig` with ``smoke()``, ``replace()``, ``padded_vocab()``
and ``param_count()``.  Field names and defaults are the JAX package's,
so a config built here and one built there describe the same model.

Fields of layers the port does not run yet (MoE, Mamba, the serving
engine's pool, Quest) are left out; they come with the slices that port
those layers (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LayerSpec", "ModelConfig", "SocketSettings"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a pattern."""

    kind: str = "attn"          # "attn" | "mamba"
    attn_type: str = "global"   # "global" | "local"  (local = sliding window)
    mlp: str = "dense"          # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class SocketSettings:
    """SOCKET knobs carried inside the model config (deployment defaults
    follow paper Table 13: P=10, L=60, tau in [0.3, 0.5])."""

    num_planes: int = 10
    num_tables: int = 60
    tau: float = 0.4
    sparsity: float = 10.0
    sink_tokens: int = 128
    window_tokens: int = 128
    min_k: int = 16
    bits_storage: str = "packed"
    score_chunk: int = 0
    score_dtype: str = "float32"
    # "kvhead": per-q-head scores summed over the GQA group (paper-faithful)
    # "pooled": score once with the group-mean query
    # "qhead":  per-q-head selection (plain torch only)
    selection: str = "kvhead"
    # Kernel routing for the decode path (models.backends.socket): score
    # through kernels/socket_score (CUDA) and attend the selected subset
    # through kernels/flash_decode (Triton).  On CPU tensors both wrappers
    # run their plain PyTorch versions.
    use_score_kernel: bool = False
    use_flash_decode: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    # --- dimensions -----------------------------------------------------
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 4096
    vocab_size: int = 32000
    # --- layout ---------------------------------------------------------
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    num_groups: int = 1
    remainder: Tuple[LayerSpec, ...] = ()
    # --- attention ------------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int = 1024      # for attn_type == "local"
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    # q-chunked prefill attention: bounds the live (chunk, S) logits
    # buffer at long sequence lengths (0 = disabled).
    attn_q_chunk: int = 0
    # --- mlp ------------------------------------------------------------
    mlp_activation: str = "swiglu"  # "swiglu" | "geglu"
    # --- io -------------------------------------------------------------
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    # --- numerics ---------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # --- sparse attention (the paper's technique) --------------------------
    attention_backend: str = "socket"
    socket: SocketSettings = SocketSettings()
    # --- provenance ---------------------------------------------------------
    source: str = ""

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.num_groups + len(self.remainder)

    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        return self.pattern * self.num_groups + self.remainder

    @property
    def gqa_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def padded_vocab(self, multiple: int = 128) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def param_count(self) -> int:
        """Exact parameter count (embeddings included) of an attention +
        dense-MLP stack, the only layer kinds this port builds."""
        d, h, kv, hd, ff = (self.d_model, self.num_heads, self.num_kv_heads,
                            self.head_dim, self.d_ff)
        n = self.padded_vocab() * d
        if not self.tie_embeddings:
            n += d * self.padded_vocab()
        for spec in self.layer_specs:
            if spec.kind != "attn" or spec.mlp not in ("dense", "none"):
                raise NotImplementedError(
                    f"param_count of a {spec.kind}/{spec.mlp} layer: the "
                    "port counts attention + dense MLP layers only")
            n += d + d * (h + 2 * kv) * hd + h * hd * d
            if self.qk_norm:
                n += 2 * hd
            if spec.mlp == "dense":
                n += d + 3 * d * ff
        return n + d

    def smoke(self) -> "ModelConfig":
        """A drastically reduced config of the same family for CPU tests:
        the JAX package's ``smoke()`` for the fields this config has."""
        return self.replace(
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_groups=min(self.num_groups, 2),
            remainder=self.remainder[: min(len(self.remainder), 1)],
            sliding_window=32,
            socket=dataclasses.replace(
                self.socket, num_planes=6, num_tables=12, sink_tokens=4,
                window_tokens=4, min_k=8, sparsity=4.0),
        )
