"""Radix (compressed trie) index over committed KV pages, keyed by token ids.

A copy of ``repro.serving.prefix_cache.radix`` (pure Python).

This is the host-side lookup structure behind cross-request prefix reuse
(the sglang "RadixAttention" idea, adapted to this engine's paged pool):
every **full, prompt-pure** page a request commits is inserted under its
``block_size``-token chunk path, so a later request whose prompt shares a
token prefix can install the existing physical blocks instead of
re-prefilling them.

Structure:

* Edges are **compressed**: a node's ``keys``/``blocks`` lists hold one or
  more consecutive pages (parallel lists), so a long unbranched prompt is
  one node, not one node per page.  Inserting a prompt that diverges
  mid-edge splits the node at the divergence point (classic radix split).
* Each node additionally carries ``tails``: partially-filled final pages
  (a prompt whose length is not a multiple of ``block_size``), keyed by
  their token run.  Tail pages are shareable too — a sharer copies the
  matching rows out via copy-on-write before writing row ``j`` — but they
  never become part of the page path (only full pages extend the trie).
* Every traversal stamps ``last_use`` from a monotone clock; eviction
  walks **leaves inward** in LRU order, dropping pages from the deep end
  of edges first so the tree never references a freed block that a longer
  cached prefix still needs.

The index never touches device memory and holds no refcounts itself —
the :class:`~repro_torch.serving.prefix_cache.cache.PrefixCache` facade
pairs it with the :class:`~repro_torch.serving.block_pool.BlockPool` and
decides what is actually evictable (pool refcount 1 = only the tree
holds the page).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["RadixIndex", "RadixNode", "TailEntry"]

PageKey = Tuple[int, ...]


@dataclasses.dataclass
class TailEntry:
    """A shareable partially-filled final page hanging off a node."""

    tokens: Tuple[int, ...]     # the partial page's token run (< block_size)
    block: int
    last_use: int = 0


class RadixNode:
    """One compressed edge: ``keys[i]`` (a ``block_size``-token tuple) is
    the page chunk whose KV lives in physical block ``blocks[i]``."""

    __slots__ = ("keys", "blocks", "children", "tails", "parent",
                 "last_use")

    def __init__(self, keys: List[PageKey], blocks: List[int],
                 parent: Optional["RadixNode"]):
        assert len(keys) == len(blocks)
        self.keys = keys
        self.blocks = blocks
        self.children: Dict[PageKey, RadixNode] = {}
        self.tails: Dict[Tuple[int, ...], TailEntry] = {}
        self.parent = parent
        self.last_use = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.tails


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixIndex:
    """Token-keyed radix tree mapping prompt prefixes to page lists."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = RadixNode([], [], None)
        self._clock = 0
        self.num_blocks = 0          # pages referenced by the tree
        self.num_tail_blocks = 0     # of which, tail entries

    # ---------------------------------------------------------------- util
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _pages(self, tokens: Sequence[int]) -> List[PageKey]:
        bs = self.block_size
        return [tuple(tokens[i * bs:(i + 1) * bs])
                for i in range(len(tokens) // bs)]

    # --------------------------------------------------------------- match
    def match(self, tokens: Sequence[int]) -> Tuple[
            List[int], int, Optional[Tuple[TailEntry, int]]]:
        """Longest cached prefix of ``tokens``.

        Returns ``(blocks, full_pages, tail)``: the physical blocks of the
        matched full pages, how many full pages matched, and — when the
        walk ended exactly on a node boundary — the best partially
        matching tail entry there as ``(entry, matched_rows)`` (None
        otherwise).  Stamps ``last_use`` along the path."""
        pages = self._pages(tokens)
        now = self._tick()
        node = self.root
        node.last_use = now
        blocks: List[int] = []
        pi = 0
        while pi < len(pages):
            child = node.children.get(pages[pi])
            if child is None:
                break
            child.last_use = now
            k = 0
            while (k < len(child.keys) and pi < len(pages)
                   and child.keys[k] == pages[pi]):
                blocks.append(child.blocks[k])
                k += 1
                pi += 1
            if k < len(child.keys):
                # diverged (or ran out of prompt) mid-edge: no node sits
                # at this point, so no tail entries can apply here.
                return blocks, pi, None
            node = child
        rem = tokens[pi * self.block_size:]
        best: Optional[Tuple[TailEntry, int]] = None
        if rem:
            for entry in node.tails.values():
                j = _common_prefix(entry.tokens, rem)
                if j > 0 and (best is None or j > best[1]):
                    best = (entry, j)
            if best is not None:
                best[0].last_use = now
        return blocks, pi, best

    # -------------------------------------------------------------- insert
    def _split(self, node: RadixNode, k: int) -> RadixNode:
        """Split ``node``'s edge after ``k`` pages; returns the (new)
        upper node holding ``keys[:k]``.  The original node keeps the deep
        part plus all children/tails."""
        assert 0 < k < len(node.keys)
        upper = RadixNode(node.keys[:k], node.blocks[:k], node.parent)
        upper.last_use = node.last_use
        parent = node.parent
        assert parent is not None
        parent.children[upper.keys[0]] = upper
        node.keys = node.keys[k:]
        node.blocks = node.blocks[k:]
        node.parent = upper
        upper.children[node.keys[0]] = node
        return upper

    def _walk_insert(self, pages: List[PageKey]) -> Tuple[RadixNode, int]:
        """Walk ``pages`` from the root, splitting any edge the path exits
        mid-way, and return ``(node, consumed)`` where ``node`` ends
        exactly at page boundary ``consumed``."""
        node = self.root
        pi = 0
        while pi < len(pages):
            child = node.children.get(pages[pi])
            if child is None:
                return node, pi
            k = _common_prefix(child.keys, pages[pi:])
            pi += k
            if k < len(child.keys):
                return self._split(child, k), pi
            node = child
        return node, pi

    def insert(self, tokens: Sequence[int],
               blocks: Sequence[int]) -> List[int]:
        """Index the full pages of ``tokens`` (``len(blocks)`` pages;
        callers pass only prompt-pure, fully-committed pages).  Pages
        already present keep their existing physical blocks.  Returns the
        blocks newly adopted by the tree (caller takes a pool ref on
        each)."""
        pages = self._pages(tokens)[:len(blocks)]
        if not pages:
            return []
        node, pi = self._walk_insert(pages)
        node.last_use = self._tick()
        if pi == len(pages):
            return []
        fresh = list(blocks[pi:len(pages)])
        child = RadixNode(pages[pi:], fresh, node)
        child.last_use = node.last_use
        node.children[pages[pi]] = child
        self.num_blocks += len(fresh)
        return fresh

    def insert_tail(self, tokens: Sequence[int], block: int,
                    prompt_len: int) -> bool:
        """Index the partial final page of a length-``prompt_len`` prompt
        (rows ``[0, prompt_len % block_size)`` of ``block``).  The full
        pages must already be indexed (insert them first).  Returns True
        if the tree adopted ``block``."""
        bs = self.block_size
        run = tuple(tokens[(prompt_len // bs) * bs:prompt_len])
        assert 0 < len(run) < bs
        node, pi = self._walk_insert(self._pages(tokens)[:prompt_len // bs])
        if pi < prompt_len // bs:
            return False               # full pages not (fully) indexed
        node.last_use = self._tick()
        if run in node.tails:
            return False               # identical run already shareable
        node.tails[run] = TailEntry(run, block, node.last_use)
        self.num_blocks += 1
        self.num_tail_blocks += 1
        return True

    # ------------------------------------------------------------ eviction
    def _evictables(self) -> List[Tuple[int, RadixNode, object]]:
        """All currently trimmable units, leaves inward: every tail entry,
        plus the deepest page of every leaf node (dropping it exposes the
        next page up).  Returned as ``(last_use, node, unit)`` where unit
        is a TailEntry or the string ``"edge"``."""
        out: List[Tuple[int, RadixNode, object]] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            for entry in node.tails.values():
                out.append((entry.last_use, node, entry))
            if node is not self.root and node.is_leaf:
                out.append((node.last_use, node, "edge"))
        return out

    def evict(self, want: int, can_evict: Callable[[int], bool]) -> List[int]:
        """Drop up to ``want`` pages in LRU order, skipping blocks
        ``can_evict`` rejects (pages a live request still holds).  Returns
        the dropped physical blocks (caller derefs them in the pool)."""
        freed: List[int] = []
        while len(freed) < want:
            progressed = False
            for _, node, unit in sorted(self._evictables(),
                                        key=lambda t: t[0]):
                if len(freed) >= want:
                    break
                if isinstance(unit, TailEntry):
                    if not can_evict(unit.block):
                        continue
                    del node.tails[unit.tokens]
                    freed.append(unit.block)
                    self.num_blocks -= 1
                    self.num_tail_blocks -= 1
                    progressed = True
                else:
                    # trim the leaf edge from its deep end while allowed
                    while (node.keys and len(freed) < want
                           and node.is_leaf
                           and can_evict(node.blocks[-1])):
                        node.keys.pop()
                        freed.append(node.blocks.pop())
                        self.num_blocks -= 1
                        progressed = True
                    if not node.keys and node.parent is not None:
                        # fully trimmed: detach (parent may become a leaf,
                        # picked up by the next sweep)
                        for key, child in list(node.parent.children.items()):
                            if child is node:
                                del node.parent.children[key]
            if not progressed:
                break
        return freed

    # -------------------------------------------------------------- status
    def stats(self) -> dict:
        return {"blocks": self.num_blocks,
                "tail_blocks": self.num_tail_blocks}
