"""Continuous-batching serving: the host-side block pool and scheduler
(copies of the JAX package's), the prefix cache (:mod:`.prefix_cache`,
copies too), the device-side paged pool (:mod:`.paged`), the sampler
(:mod:`.sampling`) and the engine (:mod:`.engine`)."""

from repro_torch.serving.block_pool import TRASH_BLOCK, BlockPool
from repro_torch.serving.scheduler import (DECODE, FINISHED, PREFILL, WAITING,
                                           PrefillChunk, Request, Scheduler)

__all__ = ["TRASH_BLOCK", "BlockPool", "Request", "PrefillChunk",
           "Scheduler", "WAITING", "PREFILL", "DECODE", "FINISHED"]
