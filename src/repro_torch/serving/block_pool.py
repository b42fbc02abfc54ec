"""Host-side block accounting for the paged KV + SOCKET bit-cache pool.

A copy of ``repro.serving.block_pool`` (it imports nothing of the JAX
package).  The device-side pool (see :mod:`repro_torch.serving.paged`)
is a set of
``num_blocks`` fixed-size pages per layer, shared by every layer: one
physical block id addresses the same page index in every layer's K, V,
packed-hash-bit and value-norm arrays, so a single allocation covers the
whole stack (the vLLM layout).

Block 0 is reserved as the **trash page**: padded block-table entries and
masked (inactive) decode slots read from and write to it, which keeps the
engine step free of conditionals.  It is never handed out.

Pure Python accounting that the scheduler drives, so pool invariants
are unit-testable in microseconds.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["TRASH_BLOCK", "BlockPool"]

TRASH_BLOCK = 0


class BlockPool:
    """Free-list allocator over physical block ids ``1..num_blocks-1``.

    Blocks are **reference counted** so the prefix cache can share one
    physical page between the radix index and any number of running
    requests: :meth:`alloc` hands out blocks at refcount 1, each
    additional holder calls :meth:`ref`, and :meth:`free` is a deref that
    only returns the block to the free list when the count reaches zero.
    The copy-on-write invariant lives one layer up (engine/scheduler): a
    block with refcount > 1 is never written in place — writers clone it
    first (see :mod:`repro_torch.serving.prefix_cache`).
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash page)")
        self.num_blocks = num_blocks
        # LIFO free list: recently freed blocks are reused first (warm).
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs = [0] * num_blocks
        # peak simultaneous allocation over the pool's lifetime — the
        # capacity-planning number (how many blocks this workload
        # actually needed)
        self.high_water = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, or return None (state unchanged) if the
        pool cannot satisfy the request — all-or-nothing.  ``n == 0``
        succeeds with an empty list (SSM-only requests hold no blocks;
        see the scheduler's per-kind accounting)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        if self.num_used > self.high_water:
            self.high_water = self.num_used
        return blocks

    def ref(self, block: int) -> None:
        """Take an additional reference on an allocated block (page
        sharing: the radix index and each matching request all hold one
        ref on the same physical page)."""
        if block == TRASH_BLOCK:
            raise ValueError("attempt to ref the trash block")
        if self._refs[block] == 0:
            raise ValueError(f"ref of unallocated block {block}")
        self._refs[block] += 1

    def stats(self) -> dict:
        """Occupancy snapshot for step records / gauges."""
        return {"free": self.num_free, "used": self.num_used,
                "shared": sum(1 for r in self._refs if r > 1),
                "high_water": self.high_water}

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block; blocks whose count hits
        zero return to the free list (others stay live for their
        remaining holders)."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("attempt to free the trash block")
            if self._refs[b] == 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def is_shared(self, block: int) -> bool:
        return self._refs[block] > 1

    def is_allocated(self, block: int) -> bool:
        return self._refs[block] > 0
