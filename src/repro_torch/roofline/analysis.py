"""Roofline terms of a step from its counted work, at the H100's rates.

Port of ``repro.roofline.analysis``.  Three terms a (arch × shape ×
mesh) cell, each in one device's seconds:

    compute    = FLOPs a device      / peak_flops
    memory     = HBM bytes a device  / hbm_bw
    collective = collective bytes    / link_bw

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis`` of the
partitioned module and the collective bytes from its HLO text.  Eager
torch has neither: ``launch/dryrun.py`` counts one rank's step as it runs
(FLOPs with ``FlopCounterMode``, bytes with a dispatch mode, each
collective's result bytes on the dry-run route of
``distributed/collectives.py``), and :func:`roofline_from_counts` turns
the counts into the terms.  :func:`collective_bytes` takes the place of
the HLO parse: it sums the recorded result bytes by kind, as the JAX
function sums the result shapes of the collectives it finds.

``HW`` holds the H100 SXM data sheet's dense rates (the 700 W part):
bf16 989 TFLOP/s (``peak_flops``), TF32 495, f32 outside the tensor
cores 67, HBM3 3.35 TB/s.  ``link_bw`` is 50 GB/s, one 400 Gb/s
InfiniBand port a card (a DGX H100): every 16-wide axis of the
production mesh leaves the 8-card NVLink domain (450 GB/s each way), so
the slow link bounds its collectives.  It takes the place of JAX's
``ici_bw``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

__all__ = ["HW", "RooflineTerms", "collective_bytes",
           "roofline_from_counts"]

HW = {
    "peak_flops": 989e12,    # bf16 dense, tensor cores / card
    "tf32_flops": 495e12,    # TF32 dense, tensor cores / card
    "fp32_flops": 67e12,     # f32 outside the tensor cores / card
    "hbm_bw": 3.35e12,       # B/s / card (HBM3)
    "link_bw": 50e9,         # B/s / card: one 400 Gb/s InfiniBand port
}


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum ``(kind, result bytes)`` records by kind, with ``total``."""
    out: Dict[str, int] = {}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0) + int(nbytes)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / HW["peak_flops"]

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HW["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / HW["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def roofline_from_counts(counts: Dict, chips: int) -> RooflineTerms:
    """The terms of one rank's counted step: ``counts`` holds ``flops``,
    ``bytes`` (HBM bytes) and ``collective_bytes`` (by kind, with
    ``total``), each one device's."""
    return RooflineTerms(
        flops_per_device=float(counts.get("flops", 0.0)),
        hbm_bytes_per_device=float(counts.get("bytes", 0.0)),
        collective_bytes_per_device=float(
            counts.get("collective_bytes", {}).get("total", 0)),
        chips=chips,
    )
