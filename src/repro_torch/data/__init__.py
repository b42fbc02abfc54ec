"""Data pipelines (synthetic + memmap token sources)."""

from repro_torch.data.pipeline import (DataConfig, HostDataLoader,
                                       MemmapLMSource, SyntheticLMSource)

__all__ = ["DataConfig", "HostDataLoader", "MemmapLMSource",
           "SyntheticLMSource"]
