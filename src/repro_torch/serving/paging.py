"""Host-side page allocator for the paged KV cache.

Port of ``repro.serving.paging``, whole: the same tables, ``slot_pages``,
``version`` counts and errors for the same operations.

The paged cache splits each attention segment's KV storage into a global
pool of fixed-size pages ``(L_seg, n_pages, page_size, Hkv, hd)`` plus a
per-slot page table ``(n_slots, max_pages_per_slot)`` of int32 page ids
(-1 = unallocated). Every gather and scatter resolves the indirection
inside the compiled steps (the paged branches of ``models.attention``),
so shapes stay fixed and each step keeps one compiled signature.

This module is the HOST half: who owns which pages. It is plain Python
over numpy — no device calls, fully deterministic (pages allocate
lowest-id-first, so the same admission schedule always produces the
same page tables, which is what makes paged runs reproducible enough to
diff bitwise against contiguous runs).

Invariants (``check()`` enforces):

  * no page is owned by two slots;
  * no page is both free and owned;
  * free + owned == n_pages always (conservation);
  * a slot owns at most ``max_pages_per_slot`` pages;
  * a slot's pages are position-ordered: owned[i] backs token positions
    [i * page_size, (i+1) * page_size).

The engine composes continuous batching out of three operations:
``alloc`` at admission (gated — a request only takes a slot when its
prompt's pages are free), ``grow`` during decode (one page as the write
position crosses a page boundary; failure triggers preemption of the
youngest-admitted slot), and ``release`` at completion/preemption.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


class PageAllocError(RuntimeError):
    """An allocator invariant was violated (a scheduler bug, not load)."""


class PageAllocator:
    """Free-list page allocator with per-slot ordered ownership.

    ``version`` increments on every mutation — the engine uses it to
    refresh its device-side copy of the page table only when something
    actually moved (the table is a per-call operand, not cache-resident
    state, so a stale copy would silently misroute writes).
    """

    def __init__(self, n_pages: int, n_slots: int,
                 max_pages_per_slot: int, page_size: int):
        if n_pages < 1 or page_size < 1 or max_pages_per_slot < 1:
            raise ValueError("n_pages, page_size, max_pages_per_slot "
                             "must be >= 1")
        self.n_pages = int(n_pages)
        self.n_slots = int(n_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.page_size = int(page_size)
        # descending so list.pop() hands out the LOWEST free id first —
        # deterministic tables for a deterministic schedule
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {s: [] for s in range(n_slots)}
        self.version = 0

    # ----------------------------------------------------------- queries --

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def owned(self, slot: int) -> int:
        return len(self._owned[slot])

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to back ``n_tokens`` cache positions."""
        return math.ceil(max(int(n_tokens), 0) / self.page_size)

    def can_grow(self, slot: int, total_pages: int) -> bool:
        """Could ``grow(slot, total_pages)`` succeed right now?"""
        if total_pages > self.max_pages_per_slot:
            return False
        return total_pages - len(self._owned[slot]) <= len(self._free)

    # --------------------------------------------------------- mutations --

    def grow(self, slot: int, total_pages: int) -> bool:
        """Grow ``slot``'s ownership to ``total_pages`` pages (no-op when
        it already owns that many). Returns False — allocating NOTHING —
        when the free list cannot cover the delta or the slot cap would
        be exceeded; partial grabs would strand pages on failure."""
        have = self._owned[slot]
        need = total_pages - len(have)
        if need <= 0:
            return True
        if not self.can_grow(slot, total_pages):
            return False
        for _ in range(need):
            have.append(self._free.pop())
        self.version += 1
        return True

    def release(self, slot: int) -> int:
        """Free every page ``slot`` owns; returns how many. The free
        list is re-sorted so future allocations stay lowest-id-first."""
        pages = self._owned[slot]
        if not pages:
            return 0
        n = len(pages)
        self._free.extend(pages)
        self._free.sort(reverse=True)
        self._owned[slot] = []
        self.version += 1
        return n

    # ------------------------------------------------------------- views --

    def table(self) -> np.ndarray:
        """The (n_slots, max_pages_per_slot) int32 page table; -1 marks
        unallocated entries. This array is the per-call step operand."""
        t = np.full((self.n_slots, self.max_pages_per_slot), -1, np.int32)
        for s, pages in self._owned.items():
            if pages:
                t[s, :len(pages)] = pages
        return t

    def slot_pages(self) -> List[List[int]]:
        """Per-slot owned-page lists (ordered) — the snapshot payload."""
        return [[int(p) for p in self._owned[s]]
                for s in range(self.n_slots)]

    def load_slot_pages(self, slot_pages: List[List[int]]):
        """Rebuild ownership from a snapshot's ``slot_pages``; everything
        unowned returns to the free list. Validates before committing."""
        if len(slot_pages) != self.n_slots:
            raise PageAllocError(
                f"snapshot has {len(slot_pages)} slots, allocator has "
                f"{self.n_slots}")
        owned_all = [p for pages in slot_pages for p in pages]
        if len(set(owned_all)) != len(owned_all):
            raise PageAllocError("snapshot page tables share a page "
                                 "between slots")
        for p in owned_all:
            if not (0 <= p < self.n_pages):
                raise PageAllocError(f"snapshot page id {p} out of range "
                                     f"[0, {self.n_pages})")
        for pages in slot_pages:
            if len(pages) > self.max_pages_per_slot:
                raise PageAllocError("snapshot slot owns more than "
                                     "max_pages_per_slot pages")
        self._owned = {s: [int(p) for p in pages]
                       for s, pages in enumerate(slot_pages)}
        free = set(range(self.n_pages)) - set(owned_all)
        self._free = sorted(free, reverse=True)
        self.version += 1

    # ---------------------------------------------------------- invariants

    def check(self):
        """Raise PageAllocError on any broken invariant. O(n_pages) —
        the engine runs it once per tick in paged mode; corruption here
        means silently cross-wired KV streams, which no output-level
        guard would localize."""
        seen: Dict[int, int] = {}
        for s, pages in self._owned.items():
            if len(pages) > self.max_pages_per_slot:
                raise PageAllocError(f"slot {s} owns {len(pages)} pages > "
                                     f"cap {self.max_pages_per_slot}")
            for p in pages:
                if p in seen:
                    raise PageAllocError(
                        f"page {p} owned by slots {seen[p]} and {s}")
                seen[p] = s
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise PageAllocError("free list contains duplicates")
        both = free_set & set(seen)
        if both:
            raise PageAllocError(f"pages both free and owned: "
                                 f"{sorted(both)}")
        if len(free_set) + len(seen) != self.n_pages:
            raise PageAllocError(
                f"conservation broken: {len(free_set)} free + "
                f"{len(seen)} owned != {self.n_pages}")
