"""Dry run: one rank's step of every (architecture x shape x mesh) cell on
the production mesh, counted without allocating anything.

Port of ``repro.launch.dryrun``:

    python -m repro_torch.launch.dryrun --arch llama31-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both

For a cell, :func:`build_cell` sets the config as the JAX function does
(``dryrun_model_config``; for the ``"opt"`` variant padded heads, the
MoE all-to-all, pooled selection and context-parallel decode; 8-bit
moments and gradient accumulation by parameter count; a sequence-split
residual stream for train and prefill) and puts SOCKET decode on the
static path's kernel route (:func:`kernel_route`: JAX's lowers its XLA
route), builds the specs and shardings
of ``launch/specs.py`` on the 16 x 16 (or 2 x 16 x 16) mesh, and runs
rank ``rank``'s sharded train, prefill or serve step
(``runtime/steps.py``) once under ``FakeTensorMode`` on tensors of its
blocks' shapes, with the collectives on their dry-run route
(``distributed/collectives.py``).  Where JAX lowers and compiles, the
port counts the step as it runs (:func:`count_step`):

* **FLOPs**: ``FlopCounterMode``: the matmul-type operations and the
  three kernel operators (``repro_torch::socket_score``,
  ``flash_decode``, ``flash_prefill``: each its FLOP formula).  XLA's
  ``cost_analysis`` also counts elementwise operations; this count does
  not, by design.
* **HBM bytes**: each operator's operand and result bytes, once a call,
  no view operator counted (XLA's ``bytes accessed``).
* **Kernel calls** by operator, **collective bytes** by kind, and the
  **peak live bytes** of the tensors' storages (the arguments and every
  storage the step makes, each freed when its last tensor goes).

The record has JAX's keys (``compile_s`` becomes ``trace_s``), plus
``model_flops`` (``model_flops_per_token`` x the global batch's tokens)
and ``kernel_calls``.  ``memory_analysis``: ``argument_size_in_bytes``
the rank's blocks of the parameters, optimizer state, batch and caches;
``output_size_in_bytes`` the step's outputs; ``temp_size_in_bytes`` the
peak less the arguments.

The fake tensors live on ``meta``: on a build without CUDA a tensor
that says ``cuda`` cannot be indexed from Python (the indexing code
takes a CUDA device guard), so the kernel wrappers send every tensor
that is not on the CPU to their operators, whose fake implementation
serves ``meta`` and whose CUDA one launches the kernel.  No library is
built and no device is touched.  The port's ``model`` axis shards
storage, not compute (``distributed/fsdp.py``): a rank's FLOPs in a
(16, 16) cell are a 16th of the global batch's, where XLA's would be a
256th.  The same program runs for real on the card (``chip_smoke.py``
phase 13): :func:`plan_cell`, :func:`make_step` and :func:`count_step`
on real blocks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import entry_axes
# the operators' FLOP formulas register when their modules are imported,
# and a FlopCounterMode copies the registry when it is made
from repro_torch.kernels.flash_decode import ops as _fd  # noqa: F401
from repro_torch.kernels.flash_prefill import ops as _fp  # noqa: F401
from repro_torch.kernels.socket_score import ops as _ss  # noqa: F401
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import apply_backend_arg
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig
from repro_torch.roofline import collective_bytes, roofline_from_counts
from repro_torch.runtime.steps import (make_prefill_step, make_serve_step,
                                       make_train_step)

__all__ = ["ASSIGNED", "Plan", "plan_cell", "kernel_route", "make_args",
           "make_step", "count_step", "StepCounter", "build_cell",
           "record_of", "main", "OUT_DIR"]

# the JAX package's cell architectures (``repro.configs.ASSIGNED``)
ASSIGNED = ("musicgen-medium", "gemma3-27b", "stablelm-12b", "minitron-8b",
            "gemma-7b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
            "jamba-v0.1-52b", "mamba2-780m", "internvl2-26b")
OUT_DIR = "experiments/dryrun_torch"


@dataclasses.dataclass
class Plan:
    """One cell's config, mesh and specs (no tensor allocated)."""
    arch: str
    shape: sp.ShapeSpec
    cfg: object
    mesh: object
    rules: Dict
    ocfg: AdamWConfig
    accum: int
    params_b: float
    log: List[str]
    params_sds: object
    params_sh: object
    cache_sds: object = None
    cache_sh: object = None
    opt_sds: object = None
    opt_sh: object = None
    batch_sh: object = None

    @property
    def chips(self) -> int:
        return self.mesh.size


def _config(arch: str, shape: sp.ShapeSpec, mesh, variant: str,
            smoke: bool = False):
    """The cell's config: JAX's ``build_cell`` lines, line for line."""
    base_cfg = get_config(arch)
    if smoke:
        base_cfg = base_cfg.smoke()
    cfg = sp.dryrun_model_config(base_cfg, shape)
    model_size = mesh.shape.get("model", 1)
    if variant == "opt" and cfg.uses_attention and \
            cfg.num_heads % model_size != 0:
        cfg = cfg.replace(logical_pad_heads=True)
    if variant == "opt" and cfg.uses_moe and shape.kind in ("train",
                                                            "prefill"):
        dispatch = "alltoall" if cfg.num_experts % model_size == 0 \
            else "batch"
        cfg = cfg.replace(moe_dispatch=dispatch)
    if variant == "opt" and shape.kind == "decode":
        kv_div = cfg.num_kv_heads and cfg.num_kv_heads % model_size == 0
        cfg = cfg.replace(socket=dataclasses.replace(cfg.socket,
                                                     selection="pooled"))
        if shape.long_context:
            axes = ("data", "model") if not kv_div else ("pod", "data")
            cfg = cfg.replace(decode_cp_axes=axes, decode_cp_batch_axes=())
        elif not kv_div and cfg.num_kv_heads:
            cfg = cfg.replace(decode_cp_axes=("model",))
    return base_cfg, cfg


def kernel_route(cfg):
    """``cfg`` on the static path's kernel route (``launch/serve.py``'s
    ``socket`` backend: ``socket_score`` and ``flash_decode``), which the
    dry run counts; other backends as they are."""
    if cfg.attention_backend != "socket":
        return cfg
    return apply_backend_arg(cfg, "socket")


def plan_cell(arch: str, shape_name: str, multi_pod: bool = False,
              variant: str = "base", rank: int = 0,
              smoke: bool = False) -> Plan:
    """The config, the production mesh (as rank ``rank``) and the specs
    and shardings of one cell (``smoke``: the architecture's smoke
    config at the cell's shape, the tests' small cells)."""
    shape = sp.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
    base_cfg, cfg = _config(arch, shape, mesh, variant, smoke)
    cfg = kernel_route(cfg)
    pcount = base_cfg.param_count()
    big = pcount > 60e9
    ocfg = AdamWConfig(state_bits=8 if big else 32)
    accum = 8 if big else (4 if pcount > 15e9 else 2)
    rules = sp.arch_rules(cfg, shape, mesh)
    if shape.kind in ("train", "prefill"):
        rules["act_seq"] = ("model",)
    log: List[str] = []
    params_sds, params_sh = sp.param_specs(cfg, mesh, rules, log)
    plan = Plan(arch, shape, cfg, mesh, rules, ocfg, accum, pcount / 1e9,
                log, params_sds, params_sh)
    if shape.kind == "train":
        plan.opt_sds, plan.opt_sh = sp.opt_specs(ocfg, params_sds, params_sh,
                                                 mesh, rules, log)
    if shape.kind in ("train", "prefill"):
        _, plan.batch_sh = sp.batch_specs(cfg, shape, mesh, rules, log)
    if shape.kind in ("prefill", "decode"):
        plan.cache_sds, plan.cache_sh = sp.cache_specs(cfg, shape, mesh,
                                                       rules, log)
    if shape.kind == "decode":
        _, plan.batch_sh = sp.decode_input_specs(cfg, shape, mesh, rules,
                                                 log)
    return plan


def _blocks(sds, shardings, make):
    """``make(block shape, dtype)`` for each leaf of a tree of ``meta``
    stand-ins and its shardings."""
    if isinstance(sds, dict):
        return {k: _blocks(v, shardings[k], make) for k, v in sds.items()}
    if isinstance(sds, list):
        return [_blocks(v, s, make) for v, s in zip(sds, shardings)]
    return make(shardings.shard_shape(sds.shape), sds.dtype)


def make_args(plan: Plan, device, leaf=None) -> tuple:
    """The step's arguments on ``device``: the rank's blocks of the
    parameters (and optimizer state, or caches), and the global batch
    (or decode input and position).  ``leaf(shape, dtype)`` makes a
    block (zeros where None); the batch's token ids are zeros and the
    position is the cache's last row."""
    leaf = leaf or (lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                     device=device))
    shape, cfg = plan.shape, plan.cfg
    params = _blocks(plan.params_sds, plan.params_sh, leaf)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s = 1
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                       device=device)}
    else:
        batch = {"embeds": torch.zeros((b, s, cfg.d_model),
                                       dtype=torch.bfloat16, device=device)}
    if shape.kind == "train":
        batch["labels"] = torch.zeros((b, s), dtype=torch.int32,
                                      device=device)
        return params, _blocks(plan.opt_sds, plan.opt_sh, leaf), batch
    if shape.kind == "prefill":
        return params, batch
    return (params, _blocks(plan.cache_sds, plan.cache_sh, leaf),
            batch[next(iter(batch))], shape.seq_len - 1)


def make_step(plan: Plan):
    """The rank's sharded step of the cell's kind."""
    cfg = plan.cfg
    if plan.shape.kind == "train":
        return make_train_step(cfg, plan.ocfg, accum=plan.accum,
                               grad_shardings=plan.params_sh)
    if plan.shape.kind == "prefill":
        return make_prefill_step(cfg, plan.shape.seq_len,
                                 param_shardings=plan.params_sh,
                                 cache_shardings=plan.cache_sh,
                                 rules=plan.rules)
    return make_serve_step(cfg, plan.params_sh, plan.cache_sh, plan.rules)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """HBM bytes (each non-view operator's operand and result bytes),
    calls of the port's kernel operators, and the peak live bytes of the
    storages: the ``args`` given and every storage a call makes, each
    counted until it is freed."""

    KERNELS = "repro_torch::"

    def __init__(self, args=()):
        super().__init__()
        self.bytes = 0
        self.kernel_calls: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakValueDictionary()
        self._finalizers: List[weakref.finalize] = []
        self.arg_bytes = self.track(args)

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors not counted yet;
        returns their bytes."""
        added = 0
        for t in tree_flatten(tree)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if self._seen.get(id(st)) is st:
                continue
            self._seen[id(st)] = st
            n = st.nbytes()
            self._finalizers.append(weakref.finalize(st, self._free, n))
            self.live += n
            added += n
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name.startswith(self.KERNELS):
            kernel = name[len(self.KERNELS):]
            self.kernel_calls[kernel] = self.kernel_calls.get(kernel, 0) + 1
        if not func.is_view and not name.startswith("aten::empty"):
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += _nbytes(t)
        self.track(out)
        return out

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()


def _output_bytes(out) -> int:
    seen, total = set(), 0
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def count_step(step, args, chips: int) -> Dict:
    """Run ``step(*args)`` once under the counting modes, with the
    collectives on their dry-run route; returns the counts: ``flops``,
    ``bytes``, ``kernel_calls``, ``collective_bytes``,
    ``argument_bytes``, ``output_bytes``, ``peak_bytes``, ``trace_s``
    and the ``roofline`` terms."""
    counter = StepCounter(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    try:
        with collectives.dry_run() as records, flops, counter:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        counts = dict(flops=flops.get_total_flops(), bytes=counter.bytes,
                      kernel_calls=dict(sorted(counter.kernel_calls.items())),
                      collective_bytes=collective_bytes(records),
                      argument_bytes=counter.arg_bytes,
                      output_bytes=_output_bytes(out),
                      peak_bytes=counter.peak, trace_s=trace_s)
    finally:
        counter.close()
    counts["roofline"] = roofline_from_counts(counts, chips).as_dict()
    return counts


def _model_flops(plan: Plan) -> float:
    shape = plan.shape
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return tfm.model_flops_per_token(plan.cfg, shape.seq_len,
                                     training=shape.kind == "train") * tokens


def _batch_share(plan: Plan) -> int:
    """The ranks that split the batch's rows (its sharding's dim 0)."""
    sh = plan.batch_sh
    if isinstance(sh, dict):
        sh = next(iter(sh.values()))
    return plan.mesh.extent(entry_axes(sh.spec[0]))


def _arguments(plan: Plan, args, counts: Dict) -> int:
    """The rank's argument bytes: its blocks, and the batch (or decode
    input) at its rows' size (the step takes the global batch and keeps
    its rows)."""
    batch = args[2] if plan.shape.kind in ("train", "decode") else args[1]
    whole = sum(_nbytes(t) for t in tree_flatten(batch)[0]
                if isinstance(t, torch.Tensor))
    return counts["argument_bytes"] - whole + whole // _batch_share(plan)


def record_of(plan: Plan, args, counts: Dict) -> Dict:
    """The cell's record, JAX's keys (see the module docstring)."""
    args_b = _arguments(plan, args, counts)
    tmp_b = max(counts["peak_bytes"] - counts["argument_bytes"], 0)
    return {
        "arch": plan.arch, "shape": plan.shape.name,
        "mesh": dict(plan.mesh.shape), "chips": plan.chips,
        "params_b": plan.params_b,
        "opt_state_bits": plan.ocfg.state_bits,
        "grad_accum": plan.accum,
        "trace_s": round(counts["trace_s"], 1),
        "memory_analysis": {"argument_size_in_bytes": args_b,
                            "output_size_in_bytes": counts["output_bytes"],
                            "temp_size_in_bytes": tmp_b},
        "hbm_per_device_gb": round((args_b + tmp_b) / 2 ** 30, 3),
        "collective_bytes": counts["collective_bytes"],
        "roofline": counts["roofline"],
        "model_flops": _model_flops(plan),
        "kernel_calls": counts["kernel_calls"],
        "sharding_fallbacks": sorted(set(plan.log)),
    }


def build_cell(arch: str, shape_name: str, multi_pod: bool = False,
               variant: str = "base", rank: int = 0, smoke: bool = False):
    """One rank's step of one cell on fake tensors; returns (counts,
    record)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    plan = plan_cell(arch, shape_name, multi_pod, variant, rank, smoke)
    # allow_non_fake_inputs: ``torch.tensor(x, device="meta")`` inside
    # the step (adamw's bias corrections) is a meta tensor the mode does
    # not lift; it is converted where an operator meets it
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = make_args(plan, "meta")
        counts = count_step(make_step(plan), args, plan.chips)
    return counts, record_of(plan, args, counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(sp.SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ASSIGNED) if args.all or not args.arch else [args.arch]
    shapes = list(sp.SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
                if args.variant != "base":
                    tag += f"__{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                print(f"[cell] {tag} ...", flush=True)
                t0 = time.time()
                try:
                    _, rec = build_cell(arch, shape_name, mp,
                                        variant=args.variant)
                    rec["status"] = "ok"
                except Exception as e:  # noqa: BLE001 — record and go on
                    rec = {"arch": arch, "shape": shape_name,
                           "multi_pod": mp, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures.append(tag)
                rec["wall_s"] = round(time.time() - t0, 1)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
                print(f"[done] {tag}: {rec['status']} "
                      f"({rec['wall_s']}s)", flush=True)

    print(f"\n{len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
