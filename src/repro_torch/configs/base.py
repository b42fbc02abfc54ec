"""Model configuration schema for the PyTorch port.

A copy of the parts of ``repro.configs.base`` that the sparse serving
paths read: :class:`LayerSpec`, :class:`SocketSettings`,
:class:`QuestSettings` (the Quest baseline's page geometry),
:class:`ServingSettings` (the continuous engine's pool geometry),
:class:`LayerCachePlan` and :class:`ModelConfig` with ``smoke()``,
``replace()``, ``padded_vocab()``, ``param_count()``, ``validate()`` and
``cache_plan()``.  Field names and defaults are the JAX package's, so a
config built here and one built there describe the same model.

Fields of layers the port does not run yet (MoE, Mamba) are left out,
and cache plans resolve attention layers only (kind ``paged`` for global
layers, ``ring`` for sliding-window ones, each with the K/V page storage
mode ``serving.kv_dtype``); state plans come with the slice that ports
Mamba layers (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LayerSpec", "LayerCachePlan", "ModelConfig", "QuestSettings",
           "ServingSettings", "SocketSettings"]

# serving.kv_dtype vocabulary (models.backends.kvquant.KV_DTYPES)
_KV_DTYPES = ("auto", "bf16", "int8", "fp8")


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
    # through kernels/flash_decode (CUDA).  On CPU tensors both wrappers
    # run their plain PyTorch versions.
    use_score_kernel: bool = False
    use_flash_decode: bool = False
    # Route PagedView decode (the continuous engine) through the fused
    # kernels/paged_attention pass (CUDA): score + select + attend in one
    # sweep over the block table.  Contiguous callers keep the
    # socket_score + flash_decode pair.  Requires packed bits and
    # kvhead/pooled selection (validate() fails fast otherwise).
    use_paged_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class QuestSettings:
    """Quest baseline page geometry (models.backends.quest).

    ``page_size`` is the single source of truth for Quest's metadata
    granularity; it must divide ``ServingSettings.block_size`` so each
    paged-pool block carries whole min/max rows.
    """

    page_size: int = 16
    min_pages: int = 4
    # Route PagedView decode through the fused kernels/paged_attention
    # quest pass (CUDA): page-bound scoring from the kmin/kmax leaves +
    # page-granular radix select + attend in one sweep over the block
    # table.
    use_paged_kernel: bool = False
    # Under quantized K/V pages (serving.kv_dtype int8/fp8), compute the
    # kmin/kmax page stats from the dequantized keys the attend phase
    # reads back, so the per-page bounds stay sound (read by
    # backends.base.effective_keys; validate() requires it whenever the
    # quest backend runs on quantized pages).
    stats_from_quantized: bool = True


@dataclasses.dataclass(frozen=True)
class LayerCachePlan:
    """How the continuous engine caches ONE layer.

    * ``kind == "paged"`` (global attention) — the decode backend's cache
      leaves live in pool pages, the request block table is consumed
      linearly.
    * ``kind == "ring"`` (sliding-window attention) — K/V pages addressed
      circularly through the first ``ring_blocks`` block-table entries.

    ``kv_dtype`` is the layer's K/V page storage mode, resolved from
    ``ServingSettings.kv_dtype`` (``"auto"``, ``"bf16"``, or quantized
    ``"int8"``/``"fp8"`` pages with per-row scale leaves).  State (Mamba)
    plans come with ROADMAP.md queue 1 item 7."""

    kind: str
    ring_blocks: int = 0
    kv_dtype: str = "auto"


@dataclasses.dataclass(frozen=True)
class ServingSettings:
    """Continuous-batching engine shape knobs (repro_torch.serving).

    The paged pool holds ``num_blocks`` fixed-size pages shared by all
    layers; block 0 is the trash page that masked slots and padded
    block-table entries write into.  ``max_blocks_per_seq * block_size``
    is the per-request context ceiling.  ``prefill_chunk > 0`` selects
    the token-budget mixed step (one prefill chunk beside the ragged
    decode batch per iteration); ``prefill_chunk = 0`` the legacy
    whole-prompt mode, which pads each prompt to the smallest of
    ``prefill_buckets`` that holds it (the largest must cover
    ``max_context``).
    """

    block_size: int = 16
    num_blocks: int = 512
    max_batch: int = 8
    max_blocks_per_seq: int = 64
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    max_prefill_per_iter: int = 1
    prefill_chunk: int = 256
    prefix_cache: bool = False
    # K/V pool-page storage mode: "auto" (compute dtype), "bf16" (plain
    # cast, no scales), or "int8"/"fp8" (symmetric per-row absmax with
    # float32 scale leaves beside K/V; models.backends.kvquant).  Applies
    # to paged and ring attention layers.  Selection metadata (SOCKET
    # bits/vnorms, Quest kmin/kmax) stays full precision.
    kv_dtype: str = "auto"

    def validate(self) -> None:
        assert self.num_blocks > 1, "need at least one non-trash block"
        for b in self.prefill_buckets:
            assert b % self.block_size == 0, (
                f"prefill bucket {b} not a multiple of block_size "
                f"{self.block_size}")
        assert self.prefill_chunk >= 0, (
            f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.prefill_chunk:
            assert self.prefill_chunk % self.block_size == 0, (
                f"prefill_chunk {self.prefill_chunk} not a multiple of "
                f"block_size {self.block_size} (chunks write whole pages)")
        else:
            assert max(self.prefill_buckets) >= self.max_context, (
                f"largest prefill bucket {max(self.prefill_buckets)} < "
                f"max_context {self.max_context}: an admissible request "
                "(prompt+generated after preemption) could fail prefill "
                "bucketing mid-run")

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def replace(self, **kw) -> "ServingSettings":
        return dataclasses.replace(self, **kw)


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
    quest: QuestSettings = QuestSettings()
    # Route sliding-window (ring) layer decode on the continuous engine
    # through the fused kernels/paged_attention ring pass (CUDA): stream
    # the circular page list straight from the pool with the window mask
    # applied in-kernel instead of gathering the ring K/V.
    use_ring_kernel: bool = False
    # --- continuous-batching engine ----------------------------------------
    serving: ServingSettings = ServingSettings()
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

    def validate(self) -> None:
        """Config-time fused-kernel eligibility and the K/V page dtype
        matrix: every combination the paged kernels would reject, and
        every ``serving.kv_dtype`` a path cannot consume, is rejected here
        with the offending flag pair named (the JAX package's rules and
        messages).  Called from :meth:`cache_plan`, so an engine fails
        before its first step."""
        if self.socket.use_paged_kernel:
            if self.socket.bits_storage != "packed":
                raise ValueError(
                    "socket.use_paged_kernel=True is incompatible with "
                    "socket.bits_storage='int8': the fused paged kernel "
                    "streams packed hash words — set bits_storage='packed' "
                    "or disable use_paged_kernel")
            if self.socket.selection not in ("kvhead", "pooled"):
                raise ValueError(
                    f"socket.use_paged_kernel=True is incompatible with "
                    f"socket.selection='{self.socket.selection}': the "
                    "fused paged kernel group-sums scores — use "
                    "selection='kvhead'/'pooled' or disable "
                    "use_paged_kernel")
            if self.serving.block_size % 8:
                raise ValueError(
                    f"socket.use_paged_kernel=True needs "
                    f"serving.block_size % 8 == 0, got "
                    f"block_size={self.serving.block_size}")
        if self.quest.use_paged_kernel:
            if self.serving.block_size % 8:
                raise ValueError(
                    f"quest.use_paged_kernel=True needs "
                    f"serving.block_size % 8 == 0, got "
                    f"block_size={self.serving.block_size}")
            if self.serving.block_size % self.quest.page_size:
                raise ValueError(
                    f"quest.use_paged_kernel=True needs quest.page_size "
                    f"({self.quest.page_size}) to divide "
                    f"serving.block_size ({self.serving.block_size}) so "
                    "each pool block carries whole min/max pages")
        if self.use_ring_kernel and self.serving.block_size % 8:
            raise ValueError(
                f"use_ring_kernel=True needs serving.block_size % 8 == 0, "
                f"got block_size={self.serving.block_size}")
        # --- quantized K/V page matrix (serving.kv_dtype) ----------------
        kvd = self.serving.kv_dtype
        if kvd not in _KV_DTYPES:
            raise ValueError(
                f"serving.kv_dtype={kvd!r} is not a known K/V page storage "
                f"mode — expected one of {_KV_DTYPES}")
        if kvd == "fp8":
            # fp8 rows are consumed in-register by the fused kernels; demand
            # the fused consumer for every layer kind this config has
            if any(s.kind == "attn" and s.attn_type == "global"
                   for s in self.layer_specs):
                if self.attention_backend in ("socket", "hard_lsh") \
                        and not self.socket.use_paged_kernel:
                    raise ValueError(
                        f"serving.kv_dtype='fp8' with attention_backend="
                        f"'{self.attention_backend}' requires "
                        "socket.use_paged_kernel=True: fp8 rows are only "
                        "dequantized in-register by the fused paged kernel "
                        "— enable use_paged_kernel or use kv_dtype='int8'")
                if self.attention_backend == "quest" \
                        and not self.quest.use_paged_kernel:
                    raise ValueError(
                        "serving.kv_dtype='fp8' with attention_backend="
                        "'quest' requires quest.use_paged_kernel=True: fp8 "
                        "rows are only dequantized in-register by the fused "
                        "paged kernel — enable use_paged_kernel or use "
                        "kv_dtype='int8'")
                if self.attention_backend == "dense":
                    raise ValueError(
                        "serving.kv_dtype='fp8' is incompatible with "
                        "attention_backend='dense': dense decode has no "
                        "fused paged path to dequantize fp8 in-register — "
                        "use kv_dtype='int8' or 'bf16'")
            if any(s.kind == "attn" and s.attn_type == "local"
                   for s in self.layer_specs) and not self.use_ring_kernel:
                raise ValueError(
                    "serving.kv_dtype='fp8' with sliding-window (local) "
                    "layers requires use_ring_kernel=True: fp8 ring pages "
                    "are only dequantized in-register by the fused ring "
                    "kernel — enable use_ring_kernel or use kv_dtype="
                    "'int8'")
        if kvd in ("int8", "fp8") and self.attention_backend == "quest" \
                and not self.quest.stats_from_quantized:
            raise ValueError(
                f"serving.kv_dtype='{kvd}' with attention_backend='quest' "
                "requires quest.stats_from_quantized=True: page kmin/kmax "
                "bounds must be computed from the dequantized quantized "
                "keys the attend phase reads, or Quest's upper bound is "
                "unsound — set stats_from_quantized=True or kv_dtype="
                "'auto'/'bf16'")

    def ring_geometry(self) -> Tuple[int, int]:
        """(blocks, rows) of the paged sliding-window ring: the circular
        page list covers the window (``ceil(window / block_size)`` pool
        blocks, clamped to the per-request block table)."""
        sv = self.serving
        blocks = min(-(-self.sliding_window // sv.block_size),
                     sv.max_blocks_per_seq)
        return blocks, blocks * sv.block_size

    def plan_for(self, spec: LayerSpec) -> LayerCachePlan:
        """One layer's cache plan (see :class:`LayerCachePlan`): paged and
        ring K/V both take ``serving.kv_dtype``."""
        if spec.kind != "attn":
            raise NotImplementedError(
                f"{spec.kind} layers have no cache plan in the port yet: "
                "state plans come with Mamba layers (ROADMAP.md queue 1 "
                "item 7)")
        if spec.attn_type == "local":
            return LayerCachePlan(kind="ring",
                                  ring_blocks=self.ring_geometry()[0],
                                  kv_dtype=self.serving.kv_dtype)
        return LayerCachePlan(kind="paged", kv_dtype=self.serving.kv_dtype)

    def cache_plan(self) -> Tuple[LayerCachePlan, ...]:
        """Per-layer cache plan (one entry per ``layer_specs``) for the
        paged continuous-batching engine."""
        self.validate()
        return tuple(self.plan_for(s) for s in self.layer_specs)

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
            quest=dataclasses.replace(self.quest, page_size=8),
            serving=dataclasses.replace(
                self.serving, block_size=8, num_blocks=48, max_batch=4,
                max_blocks_per_seq=8, prefill_buckets=(24, 32, 48, 64),
                prefill_chunk=16),
        )
