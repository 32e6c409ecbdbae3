"""Slotted/paged KV cache for the continuous-batching engine.

The device side is ONE fixed page pool per replica —
``[L, num_pages, page_size, KV, D]`` K/V buffers on the replica's card,
written in place — and the host side is this module: a page allocator
plus per-slot page tables mapping each sequence's logical pages onto
physical pool pages.  Because every engine program is shaped by
(num_slots, pages_per_slot, page_size) only, sequences of wildly
different lengths share one decode program shape and the pool is never
reallocated (the one-shape invariant the engine's ``compile_stats``
reports).

Layout follows the paged-attention kernel convention (page pools +
``page_indices`` + lengths) so the gather-based attention in
models/llama.py can later be swapped for a paged decode-attention kernel
without touching this bookkeeping.

Allocation policy: admission RESERVES a request's worst case
(ceil((prompt + max_new_tokens) / page_size) pages) up front, so a
running sequence can never hit out-of-pages mid-decode — pool pressure
blocks *admission* (requests wait in the queue), it never crashes or
preempts an in-flight stream.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.util.lockwitness import named_lock

import numpy as np

__all__ = ["PageAllocator", "PagedKVCache"]


class PageAllocator:
    """Free-list allocator over the physical page pool (host-side only;
    page CONTENTS live on device).  Lowest-id-first allocation keeps the
    pool dense from the front, which keeps compaction moves short."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = sorted(range(self.num_pages), reverse=True)  # pop() -> lowest id

    # ------------------------------------------------------------- alloc

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache entries."""
        return max(1, math.ceil(tokens / self.page_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, or None when the pool can't satisfy the
        request — the caller blocks ADMISSION on None; this never raises
        for exhaustion."""
        if n <= 0:
            return []
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} outside pool [0, {self.num_pages})")
        live = set(self._free)
        dup = [p for p in pages if p in live]
        if dup:
            raise ValueError(f"double free of pages {dup}")
        self._free.extend(pages)
        # keep pop() returning the lowest free id (reverse-sorted stack)
        self._free.sort(reverse=True)

    # ------------------------------------------------------------ defrag

    def fragmentation(self) -> float:
        """0.0 = the free space is one contiguous run, 1.0 = maximally
        scattered.  Indirection through page tables makes fragmentation
        harmless for correctness; the metric (and compaction) exist for
        HBM locality and for shrinking the pool live."""
        nfree = len(self._free)
        if nfree <= 1:
            return 0.0
        ids = sorted(self._free)
        longest = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / nfree

    def compaction_plan(self, allocated: List[int]) -> List[Tuple[int, int]]:
        """Plan a defrag: moves ``[(src, dst), ...]`` relocating allocated
        pages down into the lowest ids so the free tail becomes one
        contiguous run.  Pure planning — the engine applies the moves as a
        device copy and rewrites page tables, then calls
        :meth:`apply_compaction`."""
        alloc_sorted = sorted(set(allocated))
        moves: List[Tuple[int, int]] = []
        for dst, src in enumerate(alloc_sorted):
            if src != dst:
                moves.append((src, dst))
        return moves

    def apply_compaction(self, n_allocated: int) -> None:
        """After the engine applied a compaction plan: allocated pages now
        occupy ids [0, n_allocated); rebuild the free list as the tail."""
        self._free = sorted(range(n_allocated, self.num_pages), reverse=True)


class PagedKVCache:
    """Host-side view of one replica's page pool: the allocator plus the
    per-slot page-table matrix handed to every engine program call.

    ``tables`` is a ``[num_slots, pages_per_slot]`` int32 array, -1 for
    unallocated logical pages — exactly the argument shape
    ``decode_step_paged`` consumes, so the engine passes ``cache.tables``
    straight through.  All mutation happens on the engine loop thread;
    ``stats()`` may be read from other threads (snapshot semantics only).
    """

    def __init__(self, num_slots: int, pages_per_slot: int, num_pages: int, page_size: int):
        if num_slots <= 0 or pages_per_slot <= 0:
            raise ValueError("num_slots and pages_per_slot must be positive")
        self.num_slots = int(num_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.page_size = int(page_size)
        self.allocator = PageAllocator(num_pages, page_size)
        self.tables = np.full((self.num_slots, self.pages_per_slot), -1, np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        self._lock = named_lock("PagedKVCache._lock")

    @property
    def max_tokens_per_slot(self) -> int:
        return self.pages_per_slot * self.page_size

    def reserve(self, slot: int, tokens: int) -> bool:
        """Reserve enough pages on ``slot`` for ``tokens`` total cache
        entries.  False = pool exhausted (admission must wait); raises only
        on a capacity bug (tokens beyond the slot's logical span)."""
        need = self.allocator.pages_for(tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"{tokens} tokens need {need} pages > pages_per_slot "
                f"{self.pages_per_slot}"
            )
        with self._lock:
            have = self._slot_pages.get(slot, [])
            extra = need - len(have)
            if extra <= 0:
                return True
            pages = self.allocator.alloc(extra)
            if pages is None:
                return False
            self.tables[slot, len(have) : len(have) + extra] = pages
            self._slot_pages[slot] = have + pages
            return True

    def release(self, slot: int) -> None:
        """Free a retired slot's pages and clear its table row — slot
        recycling is what lets the next queued request admit without a new
        compile or a pool grow."""
        with self._lock:
            pages = self._slot_pages.pop(slot, [])
            if pages:
                self.allocator.free(pages)
            self.tables[slot, :] = -1

    def slot_pages(self, slot: int) -> List[int]:
        with self._lock:
            return list(self._slot_pages.get(slot, []))

    # ------------------------------------------------------------ defrag

    def compaction_plan(self) -> List[Tuple[int, int]]:
        with self._lock:
            allocated = [p for pages in self._slot_pages.values() for p in pages]
            return self.allocator.compaction_plan(allocated)

    def apply_compaction(self, moves: List[Tuple[int, int]]) -> None:
        """Rewrite page tables after the engine moved page CONTENTS on
        device (engine.defrag owns the device copy)."""
        if not moves:
            return
        remap = {src: dst for src, dst in moves}
        with self._lock:
            n_alloc = 0
            for slot, pages in self._slot_pages.items():
                newpages = [remap.get(p, p) for p in pages]
                self._slot_pages[slot] = newpages
                self.tables[slot, : len(newpages)] = newpages
                n_alloc += len(newpages)
            self.allocator.apply_compaction(n_alloc)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "pages_total": float(self.allocator.num_pages),
                "pages_used": float(self.allocator.used),
                "page_size": float(self.page_size),
                "fragmentation": self.allocator.fragmentation(),
                "slots_with_pages": float(len(self._slot_pages)),
            }
