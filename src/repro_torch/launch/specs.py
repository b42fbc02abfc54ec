"""Input shapes, the deployment numerics of a run, and the shardings of
the parameters, the optimizer state and the batch on a mesh.

Port of ``repro.launch.specs``, function for function: :class:`ShapeSpec`,
``SHAPES``, :func:`dryrun_model_config`, :func:`arch_rules`,
:func:`scalar_sharding`, :func:`param_specs`, :func:`opt_specs`,
:func:`batch_specs`, :func:`decode_input_specs`, :func:`cache_specs` and
:func:`input_specs`.  Nothing here allocates: the stand-ins of JAX's
``ShapeDtypeStruct`` are tensors on the ``meta`` device, built by the
real init functions (``init_model_boxed``, ``init_adamw`` and
``init_decode_caches``), so the specs of a full-size model cost
nothing.  Trees are in the port's per-layer layout; a layer's specs are
those of JAX's stacked group leaves without their leading ``groups``
entry.  The SOCKET bit cache is ``int32`` (the port packs the ``uint32``
bit pattern of JAX's words into it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.models import param as pm
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig, init_adamw, tree_map

__all__ = ["ShapeSpec", "SHAPES", "dryrun_model_config", "arch_rules",
           "scalar_sharding", "param_specs", "opt_specs", "batch_specs",
           "decode_input_specs", "cache_specs", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           long_context=True),
}


def dryrun_model_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Deployment numerics for ``shape``: bf16 parameters and compute,
    every layer group rematerialised in the backward of a training shape
    (``remat_policy="full"``), SOCKET scores in bf16 in chunks of 16384
    keys, and prefill attention in query chunks of 1024 above 4096
    tokens: every field the JAX function sets, set the same way."""
    sock = dataclasses.replace(cfg.socket, score_chunk=16384,
                               score_dtype="bfloat16")
    return cfg.replace(
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat_policy="full" if shape.kind == "train" else "none",
        attn_q_chunk=1024 if shape.seq_len > 4096 else 0,
        socket=sock,
    )


def arch_rules(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict:
    """Per-(arch, shape) overrides of the logical sharding rules (the JAX
    function's): at long context the cache's sequence over ``data`` (and
    ``model`` where the KV heads do not divide it) and batch-1
    activations replicated; elsewhere, KV heads that ``model`` does not
    divide put the cache's sequence on it instead; the 8-bit
    optimizer-state flats' rules."""
    rules: Dict = {}
    model_size = mesh.shape.get("model", 1)
    kv_div = cfg.num_kv_heads and cfg.num_kv_heads % model_size == 0
    if shape.kind in ("decode", "prefill"):
        if shape.long_context:
            rules["cache_seq_cp"] = ("data", "model") if not kv_div \
                else ("pod", "data")
            rules["cache_heads"] = ("model",) if kv_div else None
            rules["batch"] = None
            rules["cache_batch"] = None
        elif not kv_div and cfg.num_kv_heads:
            rules["cache_seq"] = ("model",)
            rules["cache_heads"] = None
    rules["q8_flat"] = ("pod", "data", "model")
    rules["q8_scale"] = ("data", "model")
    return rules


def scalar_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _map2(fn, a, b):
    """``fn`` over two trees of one structure (dicts and lists)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


# --------------------------------------------------------------- parameters

def param_specs(cfg: ModelConfig, mesh, rules: Dict,
                log: Optional[List[str]] = None):
    """(values, shardings): the parameters as ``meta`` tensors and each
    one's :class:`NamedSharding` from its logical axes."""
    boxed = tfm.init_model_boxed(cfg, device="meta")
    values, axes = pm.unbox(boxed), pm.axes_of(boxed)
    return values, _map2(lambda v, a: shd.named_sharding(
        mesh, a, v.shape, rules, log), values, axes)


# ---------------------------------------------------------- optimizer state

def opt_specs(ocfg: AdamWConfig, params_sds, param_shardings, mesh,
              rules: Dict, log: Optional[List[str]] = None):
    """(opt_sds, opt_shardings): the moments inherit the parameters'
    shardings (ZeRO over FSDP), an 8-bit moment's ``q`` the parameter's
    spec and its ``scale`` that spec without the last entry (each through
    :func:`~repro_torch.distributed.sharding.fit_spec`), the step counter and a frozen leaf's 0-d placeholder
    replicated."""
    opt_sds = init_adamw(ocfg, params_sds)
    shardings = {}
    for path, psh in _flat(param_shardings):
        shardings[path] = psh

    def moment(path, m):
        psh = shardings[path]
        if isinstance(m, dict):
            pspec = tuple(psh.spec)
            n = m["scale"].ndim
            scale_spec = pspec[:n - 1] + ((None,) if n else ())
            return {"q": shd.fit_spec(mesh, psh.spec, m["q"].shape),
                    "scale": shd.fit_spec(mesh, scale_spec,
                                          m["scale"].shape)}
        if m.ndim == 0:
            return scalar_sharding(mesh)
        return psh

    opt_sh = {"step": scalar_sharding(mesh),
              "m": tree_map(moment, opt_sds["m"]),
              "v": tree_map(moment, opt_sds["v"])}
    return opt_sds, opt_sh


def _flat(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


# ------------------------------------------------------------------- batch

def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: Dict,
                log: Optional[List[str]] = None):
    """(batch_sds, batch_shardings) of a train or prefill batch: int32
    ``tokens`` of (global_batch, seq_len), or for an embeddings-input
    model bf16 ``embeds`` of (global_batch, seq_len, d_model), and int32
    ``labels`` for training; rows over the batch axes."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        inputs = {"tokens": ((b, s), torch.int32, ("batch", "seq"))}
    else:
        inputs = {"embeds": ((b, s, cfg.d_model), torch.bfloat16,
                             ("batch", "seq", "embed"))}
    if shape.kind == "train":
        inputs["labels"] = ((b, s), torch.int32, ("batch", "seq"))
    sds = {k: torch.empty(dims, dtype=dt, device="meta")
           for k, (dims, dt, _) in inputs.items()}
    sh = {k: shd.named_sharding(mesh, axes, dims, rules, log)
          for k, (dims, _, axes) in inputs.items()}
    return sds, sh


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       rules: Dict, log: Optional[List[str]] = None):
    """(inp, sharding) of a decode step's input: int32 token ids (B, 1),
    or an embeddings-input model's bf16 (B, 1, d_model); rows over the
    batch axes."""
    b = shape.global_batch
    if cfg.input_mode == "tokens":
        dims, dt, axes = (b, 1), torch.int32, ("batch", None)
    else:
        dims, dt, axes = (b, 1, cfg.d_model), torch.bfloat16, \
            ("batch", None, "embed")
    return (torch.empty(dims, dtype=dt, device="meta"),
            shd.named_sharding(mesh, axes, dims, rules, log))


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: Dict,
                log: Optional[List[str]] = None):
    """(caches, shardings) of the decode caches: ``init_decode_caches``'
    per-layer list of ``meta`` leaves (the global batch at the shape's
    length) and each leaf's sharding from
    :func:`~repro_torch.models.transformer.decode_cache_axes`."""
    sds = tfm.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                 device="meta",
                                 long_context=shape.long_context)
    axes = tfm.decode_cache_axes(cfg, shape.long_context)
    if len(sds) != len(axes) or any(set(c) != set(a)
                                    for c, a in zip(sds, axes)):
        raise ValueError("cache leaves and axes differ: "
                         f"{[sorted(c) for c in sds]} vs "
                         f"{[sorted(a) for a in axes]}")
    return sds, _map2(lambda v, a: shd.named_sharding(
        mesh, a, v.shape, rules, log), sds, axes)


def input_specs(arch: str, shape_name: str = "train_4k"):
    """Shape-only stand-ins (``meta`` tensors) for every model input of
    one cell on the production 16 x 16 mesh: ``{"batch": ...}`` for a
    train or prefill shape (no ``labels`` for prefill), else the
    ``caches``, ``inp`` and ``pos`` of ``runtime.steps.make_serve_step``
    (``pos`` a 0-d int32)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh

    shape = SHAPES[shape_name]
    mesh = make_production_mesh()
    cfg = dryrun_model_config(get_config(arch), shape)
    rules = arch_rules(cfg, shape, mesh)
    if shape.kind in ("train", "prefill"):
        sds, _ = batch_specs(cfg, shape, mesh, rules)
        if shape.kind == "prefill":
            sds.pop("labels", None)
        return {"batch": sds}
    caches, _ = cache_specs(cfg, shape, mesh, rules)
    inp, _ = decode_input_specs(cfg, shape, mesh, rules)
    return {"caches": caches, "inp": inp,
            "pos": torch.empty((), dtype=torch.int32, device="meta")}
