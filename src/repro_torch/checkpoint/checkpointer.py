"""Asynchronous, atomic checkpointing.

Port of ``repro.checkpoint.checkpointer``.  Layout per step::

    <dir>/step_000001230/
        manifest.json        # step, extra metadata, time
        tree.pt              # the tree, every tensor a CPU copy
    <dir>/LATEST             # atomic pointer file (rename-swapped)

* **atomic**: writes go to ``step_X.tmp`` then ``os.replace``, so a crash
  mid-save never corrupts the restore point.
* **asynchronous**: ``save()`` copies every tensor to host memory at
  once (the parameters may be updated in place right after) and hands
  the file IO to a background thread.
* **exact**: the tree (dicts, lists, tensors, numbers) is written with
  ``torch.save``, so bf16 leaves and 8-bit moments' ``q``/``scale`` come
  back bit for bit; it is read back with ``weights_only=True``.
* **placement**: ``restore(device=)`` puts every tensor on the caller's
  device.
* **sharded**: on a mesh the tree is a rank's blocks.  ``save(...,
  shardings=)`` gathers the tree a leaf at a time (collective: every
  rank of the mesh calls it), each whole leaf copied to the host by the
  rank given ``write=True`` and dropped by the others, and that rank
  alone writes it;
  ``restore(shardings=)`` reads the whole tree and keeps this rank's
  block of each leaf (the JAX function's resharding restore), so a
  checkpoint written on one mesh restores onto another.
* **retention**: keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.distributed import fsdp

__all__ = ["Checkpointer"]


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- util
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def latest_step(self) -> Optional[int]:
        pointer = os.path.join(self.directory, "LATEST")
        if not os.path.exists(pointer):
            return None
        with open(pointer) as f:
            return int(f.read().strip())

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def wait(self):
        """Block until any in-flight asynchronous save finishes
        (re-raising its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False, shardings: Any = None,
             write: bool = True):
        """Snapshot ``tree`` (dicts and lists of tensors and numbers) at
        ``step``.  ``shardings`` (a congruent tree of ``NamedSharding``):
        ``tree`` is this rank's blocks, gathered a leaf at a time (every
        rank of the mesh calls this); ``write`` False keeps no copy and
        skips the file (the mesh's other ranks)."""
        self.wait()
        if shardings is None:
            if not write:
                return
            host = _to_host(tree)
        else:
            # a leaf at a time, onto the host of the writing rank only
            host = fsdp.gather_tree(tree, fsdp.flat_tree(shardings),
                                    device="cpu", keep=write)
            if not write:
                return
        manifest = {"step": step, "extra": extra or {}, "time": time.time()}

        def _write():
            try:
                final = self._step_dir(step)
                tmp = final + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                torch.save(host, os.path.join(tmp, "tree.pt"))
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                ptr_tmp = os.path.join(self.directory, "LATEST.tmp")
                with open(ptr_tmp, "w") as f:
                    f.write(str(step))
                os.replace(ptr_tmp, os.path.join(self.directory, "LATEST"))
                self._gc()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, device=None,
                shardings: Any = None) -> Dict:
        """Load a checkpoint (the newest when ``step`` is None); returns
        {"tree", "step", "extra"}, the tensors on ``device`` (the CPU when
        None).  ``shardings`` (a congruent tree of ``NamedSharding``):
        each leaf is this rank's block of the saved one."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self.directory}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        path = os.path.join(d, "tree.pt")
        if shardings is None:
            tree = torch.load(path, map_location=device or "cpu",
                              weights_only=True)
        else:
            # mapped, not read: only this rank's blocks are copied out
            tree = fsdp.shard_tree(
                torch.load(path, map_location="cpu", weights_only=True,
                           mmap=True),
                fsdp.flat_tree(shardings), device or "cpu")
        return {"tree": tree, "step": step, "extra": manifest["extra"]}
