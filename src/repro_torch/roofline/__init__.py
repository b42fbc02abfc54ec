"""Roofline terms from a step's counted work (port of ``repro.roofline``)."""

from repro_torch.roofline.analysis import (HW, RooflineTerms,
                                           collective_bytes,
                                           roofline_from_counts)

__all__ = ["HW", "RooflineTerms", "collective_bytes",
           "roofline_from_counts"]
