"""Distribution over ``torch.distributed`` (port of ``repro.distributed``):
sharding rules and ``NamedSharding``, the collectives, the sharded train
step's parts (``fsdp``), context-parallel SOCKET decode and int8
error-feedback gradient compression; the pipeline comes with ROADMAP.md
queue 1 item 11."""

from repro_torch.distributed import sharding

__all__ = ["sharding"]
