"""Host-side page bookkeeping for the paged KV pool (counterpart of
`paddle_tpu/serving/paging.py`).

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
pressure).

A fourth, SWAPPED, state tracks the HOST tier: `swap_out(pages)` declares
that a page's KV was copied to host memory — the device page returns to
the free list and the pool counts one outstanding host-resident logical
page until `swapped_restored` (swapped back into fresh device pages) or
`drop_swapped` (discarded). The count is kept by kind: a preempted
request's pages are an obligation that must drain before shutdown, a
prefix-cache SPILL is long-lived cache state. The host bytes live in a
`HostPagePool`.

Double free, freeing a shared page, retaining a free page, parking a
referenced one, swapping out a shared or free page and over-draining the
swapped count all raise; `assert_quiesced()` is the shutdown leak check.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = ["PagePool", "HostPagePool", "TRASH_PAGE", "pages_needed",
           "chunk_bucket"]

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
        # logical pages living in the host tier, by kind
        self._n_swapped = 0       # preempted-request pages
        self._n_spilled = 0       # prefix-cache spilled pages

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

    @property
    def swapped_pages(self) -> int:
        """Outstanding logical pages whose KV lives in the host tier,
        both kinds (their device pages are FREE)."""
        return self._n_swapped + self._n_spilled

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

    def swap_out(self, pages: Iterable[int], spill: bool = False):
        """Declare each page's KV moved to the host tier: the device page
        returns to the free list and one SWAPPED logical page is booked
        per entry. Only a privately held page (refcount 1, a preempted
        request's) or a parked cache-resident one (refcount 0, a spilled
        prefix page) may swap out. `spill=True` books the prefix-cache
        kind instead of a preempted request's obligation."""
        pages = list(pages)
        for p in pages:
            self._check_range(p)
            if p in self._free_set:
                raise ValueError(
                    f"swap_out of free page {p} (double swap-out or "
                    "use-after-free)")
            if self._ref[p] > 1:
                raise ValueError(
                    f"swap_out of page {p} still shared "
                    f"(refcount {self._ref[p]}); a shared page cannot "
                    "leave the device")
            if self._ref[p] == 0 and not self._is_cached[p]:
                raise ValueError(
                    f"swap_out of unowned page {p} (neither held nor "
                    "cache-resident)")
        for p in pages:
            if self._is_cached[p]:
                self._is_cached[p] = False
                self._n_cached -= 1
            self._ref[p] = 0
            self._free.append(p)
            self._free_set.add(p)
        if spill:
            self._n_spilled += len(pages)
        else:
            self._n_swapped += len(pages)

    def swapped_restored(self, n: int, spill: bool = False):
        """`n` host-resident pages were swapped back into fresh device
        pages."""
        self._drain_swapped(n, spill, "restore")

    def drop_swapped(self, n: int, spill: bool = False):
        """`n` host-resident pages were discarded without a restore."""
        self._drain_swapped(n, spill, "drop")

    def _drain_swapped(self, n: int, spill: bool, what: str):
        n = int(n)
        if n < 0:
            raise ValueError("n must be >= 0")
        have = self._n_spilled if spill else self._n_swapped
        if n > have:
            raise ValueError(
                f"{what} of {n} swapped pages but only "
                f"{have} are outstanding")
        if spill:
            self._n_spilled -= n
        else:
            self._n_swapped -= n

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
        """Shutdown leak check: every page FREE or CACHED, no preempted
        request's KV stranded in the host tier (spilled prefix pages may
        stay), and the accounting closes."""
        leaked = [p for p in range(1, self.num_pages) if self._ref[p] > 0]
        if leaked:
            raise RuntimeError(
                f"page leak: pages {leaked} still referenced after "
                f"shutdown (refcounts {[self._ref[p] for p in leaked]})")
        if self._n_swapped:
            raise RuntimeError(
                f"host-tier leak: {self._n_swapped} preempted request "
                "page(s) neither restored nor dropped after shutdown")
        if len(self._free) + self._n_cached != self.num_pages - 1:
            raise RuntimeError(
                f"page accounting broken: free {len(self._free)} + "
                f"cached {self._n_cached} != pool size "
                f"{self.num_pages - 1}")


class HostPagePool:
    """The host-RAM page tier: a capacity-bounded store of whole-page KV
    payloads (the engine stores one CPU tensor [n_layers, 2, page_size,
    H_kv, D] per page, allocated when it is stored). `store` returns a
    host slot id, or None when the tier is full (the caller falls back
    to recompute or plain eviction); `load` returns a live slot's
    payload; `free` releases it. Loading or freeing a dead slot raises."""

    def __init__(self, num_pages: int):
        if num_pages < 0:
            raise ValueError("num_pages must be >= 0")
        self.num_pages = int(num_pages)
        self._data: Dict[int, object] = {}
        self._next = 0
        self._free: List[int] = []

    @property
    def used_pages(self) -> int:
        return len(self._data)

    @property
    def free_pages(self) -> int:
        return self.num_pages - len(self._data)

    def store(self, payload) -> Optional[int]:
        """Admit one payload; its host slot id, or None (no side effects)
        when the tier is full."""
        if len(self._data) >= self.num_pages:
            return None
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._next
            self._next += 1
        self._data[slot] = payload
        return slot

    def load(self, slot: int):
        """Payload of a live slot; raises on a slot never stored or
        already freed."""
        if slot not in self._data:
            raise ValueError(
                f"load of dead host page {slot} (swap-in of a freed "
                "page)")
        return self._data[slot]

    def free(self, slot: int):
        """Release a live slot; raises on double free."""
        if slot not in self._data:
            raise ValueError(f"double free of host page {slot}")
        del self._data[slot]
        self._free.append(slot)


def pages_needed(prompt_len: int, max_new_tokens: int,
                 page_size: int) -> int:
    """Admission budget: pages covering every position the request can
    occupy (prompt + full output allowance)."""
    return -(-(int(prompt_len) + int(max_new_tokens)) // int(page_size))


def chunk_bucket(remaining: int, chunk_len: int, min_chunk: int = 8
                 ) -> int:
    """Length of the legacy step's next prefill chunk: full `chunk_len`
    chunks while the remainder is large, then ONE power-of-two bucket
    >= the tail, clamped to [min_chunk, chunk_len] (the JAX function).
    Over all prompts the buckets are {chunk_len} and the
    min_chunk * 2**i <= chunk_len."""
    if remaining <= 0:
        raise ValueError("remaining must be > 0")
    if remaining >= chunk_len:
        return chunk_len
    b = min_chunk
    while b < remaining:
        b *= 2
    return min(b, chunk_len)
