"""Input shapes, the deployment numerics of a run, and the shardings of
the parameters, the optimizer state and the batch on a mesh.

Port of ``repro.launch.specs``: :class:`ShapeSpec`, ``SHAPES`` and
:func:`dryrun_model_config`, field for field, and the Trainer's specs,
:func:`scalar_sharding`, :func:`param_specs`, :func:`opt_specs` and
:func:`batch_specs`.  Nothing here allocates: the stand-ins of JAX's
``ShapeDtypeStruct`` are tensors on the ``meta`` device, built by the
real init functions (``init_model_boxed`` and ``init_adamw``), so the
specs of a full-size model cost nothing.  Trees are in the port's
per-layer layout; a layer's specs are those of JAX's stacked group
leaves without their leading ``groups`` entry.  ``arch_rules``,
``decode_input_specs``, ``cache_specs`` and ``input_specs`` come with
the dry run (ROADMAP.md queue 1 item 11).
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

__all__ = ["ShapeSpec", "SHAPES", "dryrun_model_config", "scalar_sharding",
           "param_specs", "opt_specs", "batch_specs"]


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
