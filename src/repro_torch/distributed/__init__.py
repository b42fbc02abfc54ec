"""Distribution over ``torch.distributed`` (port of ``repro.distributed``):
sharding rules and ``NamedSharding``, the collectives (gathers,
reductions, the all-to-all and the ring permute, each with its autograd
function), the sharded train step's parts (``fsdp``), context-parallel
SOCKET decode, the GPipe pipeline and int8 error-feedback gradient
compression."""

from repro_torch.distributed import sharding
from repro_torch.distributed.pipeline import gpipe_forward

__all__ = ["sharding", "gpipe_forward"]
