"""Host-side page bookkeeping for the paged KV pool (counterpart of
`paddle_tpu/serving/paging.py`; the host swap tier is not ported yet).

The device state is a shared per-layer pool [num_pages, page_size, H, D]
plus a per-slot page table [S, max_pages] (see `nlp.generation`). This
module owns the HOST half: which pages are free and who holds them.

Page 0 is the TRASH page: never handed out, free slots' page-table rows
point at it, and writes past a row's window land in it — so membership
changes never change a tensor's shape.

Pages are reference counted so the prefix cache (`serving.prefix`) can
share one physical page between requests and the radix tree. A page is
FREE (allocatable), USED (refcount >= 1) or CACHED (refcount 0 but kept
resident by the tree, not allocatable; the cache evicts it under
pressure). Double free, freeing a shared page, retaining a free page and
parking a referenced one all raise; `assert_quiesced()` is the
shutdown leak check.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

__all__ = ["PagePool", "TRASH_PAGE", "pages_needed"]

TRASH_PAGE = 0      # reserved: never allocated, absorbs masked writes


class PagePool:
    """Refcounted free-list allocator over page ids 1..num_pages-1."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved trash page)")
        self.num_pages = int(num_pages)
        # LIFO free list: recently freed pages are reused first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._ref = [0] * self.num_pages
        self._is_cached = [False] * self.num_pages
        self._n_cached = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Unreferenced-but-resident pages parked by the prefix cache."""
        return self._n_cached

    @property
    def used_pages(self) -> int:
        """Pages referenced by at least one live request."""
        return (self.num_pages - 1) - len(self._free) - self._n_cached

    def refcount(self, page: int) -> int:
        self._check_range(page)
        return self._ref[page]

    def _check_range(self, p: int):
        if not (0 < p < self.num_pages):
            raise ValueError(f"page id {p} out of range")

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None (without side effects) if not
        enough are free."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            return None
        taken = self._free[len(self._free) - n:]
        del self._free[len(self._free) - n:]
        for p in taken:
            self._free_set.discard(p)
            self._ref[p] = 1
        return taken

    def retain(self, pages: Iterable[int]):
        """refcount++ on resident pages; a CACHED page becomes USED."""
        pages = list(pages)
        for p in pages:
            self._check_range(p)
            if p in self._free_set:
                raise ValueError(f"retain of free page {p} "
                                 "(use-after-free)")
        for p in pages:
            if self._is_cached[p]:
                self._is_cached[p] = False
                self._n_cached -= 1
            self._ref[p] += 1

    def release(self, pages: Iterable[int]) -> List[int]:
        """refcount-- on each page; returns the pages that dropped to
        zero (the caller parks or frees them)."""
        pages = list(pages)
        for p in pages:
            self._check_range(p)
            if p in self._free_set or self._ref[p] < 1:
                raise ValueError(f"release of unreferenced page {p}")
        zeroed = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                zeroed.append(p)
        return zeroed

    def park(self, pages: Iterable[int]):
        """Mark unreferenced pages cache-resident instead of freeing."""
        pages = list(pages)
        for p in pages:
            self._check_range(p)
            if p in self._free_set:
                raise ValueError(f"park of free page {p}")
            if self._ref[p] != 0:
                raise ValueError(f"park of referenced page {p} "
                                 f"(refcount {self._ref[p]})")
            if self._is_cached[p]:
                raise ValueError(f"page {p} already cache-resident")
        for p in pages:
            self._is_cached[p] = True
            self._n_cached += 1

    def free(self, pages: Iterable[int]):
        """Return pages to the free list. Raises on double free and on
        freeing a page another holder still references."""
        pages = list(pages)
        for p in pages:
            self._check_range(p)
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
            if self._ref[p] > 1:
                raise ValueError(
                    f"free of page {p} still referenced "
                    f"(refcount {self._ref[p]}); release shared pages "
                    "instead of freeing through them")
        for p in pages:
            if self._is_cached[p]:
                self._is_cached[p] = False
                self._n_cached -= 1
            self._ref[p] = 0
            self._free.append(p)
            self._free_set.add(p)

    def assert_quiesced(self):
        """Shutdown leak check: every page FREE or CACHED and the
        accounting closes."""
        leaked = [p for p in range(1, self.num_pages) if self._ref[p] > 0]
        if leaked:
            raise RuntimeError(
                f"page leak: pages {leaked} still referenced after "
                f"shutdown (refcounts {[self._ref[p] for p in leaked]})")
        if len(self._free) + self._n_cached != self.num_pages - 1:
            raise RuntimeError(
                f"page accounting broken: free {len(self._free)} + "
                f"cached {self._n_cached} != pool size "
                f"{self.num_pages - 1}")


def pages_needed(prompt_len: int, max_new_tokens: int,
                 page_size: int) -> int:
    """Admission budget: pages covering every position the request can
    occupy (prompt + full output allowance)."""
    return -(-(int(prompt_len) + int(max_new_tokens)) // int(page_size))
