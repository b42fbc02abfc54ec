"""Distribution over ``torch.distributed``: sharding rules and
context-parallel SOCKET decode (port of ``repro.distributed``; the
pipeline and gradient compression come with ROADMAP.md queue 1 item 11's
Trainer mesh)."""

from repro_torch.distributed import sharding

__all__ = ["sharding"]
