"""The port stands alone and never falls back to the CPU silently.

* Every ``repro_torch`` module and ``chip_smoke.py`` import with ``jax``,
  ``repro`` and ``triton`` blocked (``sys.modules[name] = None`` makes any
  import of them raise), and no source of the port imports ``triton``,
  not even inside a function: its kernels are CUDA C++.
* With no CUDA card, ``run_serve`` and the serve CLI on their default
  device raise, and ``python chip_smoke.py`` exits non-zero without
  printing ``"ok": true``.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["triton"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "repro", "triton") and
             sys.modules[m] is not None)
assert not bad, bad
print(" ".join(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax_and_no_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL,
         os.path.join(REPO, "chip_smoke.py")],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 30                        # every module was walked
    for name in ("repro_torch.serving.engine", "repro_torch.serving.paged",
                 "repro_torch.serving.scheduler",
                 "repro_torch.serving.obs.metrics",
                 "repro_torch.kernels.paged_attention.ops",
                 "repro_torch.kernels.paged_attention.cases",
                 "repro_torch.baselines.quest",
                 "repro_torch.models.backends.hard_lsh",
                 "repro_torch.models.backends.quest"):
        assert name in names, name


def test_port_sources_import_no_triton():
    """No module of the port and no line of ``chip_smoke.py`` imports
    ``triton``, at the top or inside a function."""
    pattern = re.compile(r"^\s*(import\s+triton|from\s+triton\b)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    found = [f for f in files if pattern.search(open(f).read())]
    assert not found, found


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour does "
                    "not apply")


def test_run_serve_default_device_raises_without_card():
    _require_no_card()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main, run_serve
    cfg = get_config("llama31-8b").smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        run_serve(cfg, 1, 8, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "llama31-8b", "--smoke"])


def test_serve_cli_cpu_rehearsal(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "llama31-8b", "--smoke", "--device", "cpu", "--batch",
          "2", "--prompt-len", "16", "--decode-steps", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [2, 4]
    assert out["device"] == "cpu" and out["engine"] == "static"


def test_chip_smoke_fails_without_card():
    _require_no_card()
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
