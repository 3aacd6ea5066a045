"""Automatic prefix cache: a token-id radix tree over the paged KV pool,
its host spill tier, session pins, the KV fabric's tree side and the
grouped walk's prefix groups (counterpart of
`paddle_tpu/serving/prefix.py`).

The KV written for position p is a function of tokens[0..p] alone (and
of the request's LoRA adapter), so two requests of one adapter whose
token ids agree on [0, L) can point their page tables at the same
physical pages for those positions and skip prefilling them. Each
adapter id has its own tree root (`acquire`/`insert` take
`adapter_id`, 0 the base model): a prompt under adapter j misses
adapter i's pages. Spill and eviction walk every root.

Each tree edge is one FULL page: `page_size` token ids mapped to one
page id; children are keyed by the next page's token bytes. Leaves may
also carry PARTIAL pages (the tail of a finished request). A prompt
that matches into a partial page or the head of a full page gets it
COPY-ON-WRITE: the engine copies the shared page into a fresh private
one before prefill writes past the match. A shared page is never
written through.

- `acquire(prompt, max_new)` — admission: longest-prefix match,
  refcount++ on the matched full pages, fresh tail pages (evicting LRU
  unreferenced leaves under pressure), a `PrefixGrant`. Refusal has no
  side effects.
- `insert(tokens, pages, valid)` — a normally finished request's pages
  become tree nodes; duplicates free; all its references drop and pages
  at refcount 0 PARK as cache-resident.
- `release(pages)` — any other retirement: refcount--, tree pages park,
  private pages free.
- `spill(need)` — the host tier: under page pressure unreferenced
  parked full pages move to host memory before anything is dropped; the
  node stays in the tree with a host slot and a later match restores it
  into a fresh device page. Wired by the engine (`set_host_tier`);
  without it spill is a no-op.
- `evict(need)` — leaf-to-root LRU over unreferenced pages only (a
  spilled leaf drops its host copy).
- `pin(tokens, ttl_s)` — session pins: the full-page chain of a
  finished conversation turn sits in a TTL tier between "referenced" and
  "evictable" — neither spill nor eviction takes it until the deadline
  on the tree's injectable clock passes (re-pinning extends, never
  shortens; `clear()` drops pins with everything else).
- The KV fabric: `collect_chain` (the resident chain covering a token
  span, device pages and host slots, for export), `graft` (insert's twin
  for pages from another engine: dedup, a partial tail, and a clean stop
  where allocation fails), `snapshot`/`load` (the whole tree with its
  payloads, spilled nodes included, for warm restarts), `fingerprints`
  (the CRC chain of every page-aligned prefix, as
  `fabric.prompt_fingerprints` computes it for a prompt) and `lookup`
  (a side-effect-free match probe).

`shared_prefix_groups` partitions one step's rows into the groups whose
page tables share a physical-page prefix: the grouped walk's operands.
"""
from __future__ import annotations

import heapq
import itertools
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fabric import fp_seed, fp_step
from .paging import TRASH_PAGE, PagePool, pages_needed

__all__ = ["RadixPrefixCache", "PrefixGrant", "shared_prefix_groups",
           "resolve_prefix_cache_flag"]


def resolve_prefix_cache_flag(override=None) -> bool:
    """Whether the engine runs the prefix cache (the JAX function): an
    explicit `ServingEngine(prefix_cache=...)` wins — a bool, or a
    spelling of on/off (on, 1, true, yes; off, 0, false, no) — otherwise
    PADDLE_TPU_PREFIX_CACHE (default on). Anything else raises
    ValueError."""
    if override is not None:
        if isinstance(override, bool):
            return override
        flag = str(override)
    else:
        flag = os.environ.get("PADDLE_TPU_PREFIX_CACHE", "on")
    low = flag.strip().lower()
    if low in ("on", "1", "true", "yes"):
        return True
    if low in ("off", "0", "false", "no"):
        return False
    raise ValueError("PADDLE_TPU_PREFIX_CACHE / prefix_cache must be on|off, "
                     f"got {flag!r}")


def shared_prefix_groups(page_tables, q_len):
    """Prefix-sharing groups for one engine step (the operands of
    `ragged_paged_attention_grouped`), a copy of the JAX package's
    function: rows whose page tables carry identical page ids for a
    leading span attend the same physical pages, and the kernel streams
    that span once per group.

    `page_tables` is the host page table [S, max_pages] int32 (trash page
    0 marks unallocated entries), `q_len` [S] the step's live query
    counts (rows at q_len 0 are never grouped). Rows are partitioned by
    recursive refinement: all rows sharing page 0, split at the first
    column where they diverge, keeping whichever of "one group closed
    here" and "split deeper" saves more page reads. Returns
    (group_id [S], group_leader [S], group_cnt [S]) int32 — row -> group,
    group -> representative row, group -> shared page count (0 for
    singletons; group ids are compact)."""
    pt = np.asarray(page_tables)
    q_len = np.asarray(q_len)
    S, mp = pt.shape
    group_id = np.arange(S, dtype=np.int32)
    group_leader = np.zeros(S, dtype=np.int32)
    group_cnt = np.zeros(S, dtype=np.int32)
    next_gid = [0]

    def close(rows, depth):
        g = next_gid[0]
        next_gid[0] += 1
        for r in rows:
            group_id[r] = g
        group_leader[g] = rows[0]
        group_cnt[g] = depth if len(rows) >= 2 else 0

    def best(rows, depth):
        """Best grouping of `rows`, which share pages [0, depth):
        (page reads saved, [(rows, span), ...])."""
        if len(rows) == 1:
            return 0, [(rows, 0)]
        if depth >= mp:
            return (len(rows) - 1) * depth, [(rows, depth)]
        buckets: Dict[int, List[int]] = {}
        for r in rows:
            buckets.setdefault(int(pt[r, depth]), []).append(r)
        if len(buckets) == 1:
            page = next(iter(buckets))
            if page != TRASH_PAGE:
                return best(rows, depth + 1)   # still together
            return (len(rows) - 1) * depth, [(rows, depth)]
        keep = (len(rows) - 1) * depth         # one group, close here
        split_sav, split_plan = 0, []
        for page, sub in sorted(buckets.items()):
            if page == TRASH_PAGE:
                s, p = ((len(sub) - 1) * depth, [(sub, depth)])
            elif len(sub) == 1:
                s, p = 0, [(sub, 0)]
            else:
                s, p = best(sub, depth + 1)
            split_sav += s
            split_plan.extend(p)
        if keep >= split_sav:
            return keep, [(rows, depth)]
        return split_sav, split_plan

    live = [r for r in range(S)
            if q_len[r] > 0 and pt[r, 0] != TRASH_PAGE]
    buckets: Dict[int, List[int]] = {}
    for r in live:
        buckets.setdefault(int(pt[r, 0]), []).append(r)
    for page, rows in sorted(buckets.items()):
        if len(rows) == 1:
            close(rows, 0)
        else:
            _, plan = best(rows, 1)
            for sub, span in plan:
                close(sub, span)
    live_set = set(live)
    for r in range(S):
        if r not in live_set:
            g = next_gid[0]
            next_gid[0] += 1
            group_id[r] = g
            group_leader[g] = r
            group_cnt[g] = 0
    return group_id, group_leader, group_cnt


class _Node:
    """One radix edge: a full page of `page_size` token ids. A node whose
    page was spilled to the host tier has `page` None and a `host` slot
    until a match restores it."""

    __slots__ = ("tokens", "page", "parent", "children", "partials",
                 "last_used", "host", "pin_until")

    def __init__(self, tokens: Optional[np.ndarray], page: Optional[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens          # int64 [page_size]; None at root
        self.page = page              # pool page id; None at root/spilled
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.partials: List["_Partial"] = []
        self.last_used = 0
        self.host = None              # host-tier slot id when spilled
        self.pin_until = 0.0          # session-pin deadline (tree clock)


class _Partial:
    """A leaf-only partially filled page: positions [0, len(tokens))
    of `page` hold valid KV for `tokens`."""

    __slots__ = ("tokens", "page", "last_used")

    def __init__(self, tokens: np.ndarray, page: int):
        self.tokens = tokens
        self.page = page
        self.last_used = 0


@dataclass
class PrefixGrant:
    """`pages` in page-table order (shared fulls, then fresh pages — the
    first of which is the COW copy, if any), the prefill start
    (`cached_len`) and the pending single-page COW copy. `cow_src` stays
    refcount-protected until the engine reports the copy done via
    `RadixPrefixCache.cow_done`."""

    pages: List[int]
    cached_len: int
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None
    matched_full_pages: int = 0
    fresh_pages: List[int] = field(default_factory=list)


def _tok(seq) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(seq).reshape(-1),
                                dtype=np.int64)


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class RadixPrefixCache:
    """Radix-tree prefix cache over one engine's `PagePool`. Called
    only between engine steps, from the engine's thread."""

    def __init__(self, pool: PagePool, page_size: int, clock=None):
        self.pool = pool
        self.page_size = int(page_size)
        # the session pins' clock (the engine passes its own; tests
        # drive expiry with theirs)
        self._clock = clock if clock is not None else time.monotonic
        # one namespace root per adapter id: KV written under adapter i is
        # a function of its weights too, so the same prompt under adapter
        # j must miss it. Adapter 0 (the base model) is `root`
        self.root = _Node(None, None, None)
        self._roots: Dict[int, _Node] = {0: self.root}
        # page id -> owning _Node/_Partial ("is this page tree-resident")
        self._owner: Dict[int, object] = {}
        self._tick = itertools.count(1)
        self.lookups = 0
        self.hits = 0
        self.cached_tokens_total = 0
        self.evicted_pages_total = 0
        self.cow_copies_total = 0
        self.inserted_pages_total = 0
        self.spilled_pages_total = 0
        self.restored_pages_total = 0
        # host tier callbacks (engine-wired; None = no host tier):
        # _host_store(page) -> host slot or None (copies the device page
        # to host memory; the cache then swap_out's it), _host_load(slot)
        # -> a fresh device page holding it, handed back PARKED, or None,
        # _host_drop(slot) discards a spilled page's host copy
        self._host_store = None
        self._host_load = None
        self._host_drop = None
        self._n_spilled = 0

    @property
    def tree_pages(self) -> int:
        return len(self._owner)

    @property
    def spilled_nodes(self) -> int:
        """Tree nodes whose page lives in the host tier."""
        return self._n_spilled

    def set_host_tier(self, store, load, drop):
        """Wire the host tier (engine callbacks, see `__init__`): page
        pressure then spills parked pages before evicting, and a match
        on a spilled node restores it instead of falling back to
        prefill."""
        self._host_store = store
        self._host_load = load
        self._host_drop = drop

    @property
    def pinned_pages(self) -> int:
        """Device-resident tree pages under an unexpired session pin (the
        `prefix_pinned_pages` gauge)."""
        now = self._clock()
        count = 0
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.page is not None and node.pin_until > now:
                count += 1
        return count

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "cached_tokens": self.cached_tokens_total,
            "evicted_pages": self.evicted_pages_total,
            "cow_copies": self.cow_copies_total,
            "inserted_pages": self.inserted_pages_total,
            "spilled_pages": self.spilled_pages_total,
            "restored_pages": self.restored_pages_total,
            "spilled_nodes": self._n_spilled,
            "pinned_pages": self.pinned_pages,
            "tree_pages": self.tree_pages,
            "resident_pages": self.pool.cached_pages,
            "hit_rate": (self.hits / self.lookups) if self.lookups
            else None,
        }

    def _touch(self, obj):
        obj.last_used = next(self._tick)

    def _root_for(self, adapter_id: int) -> _Node:
        """The adapter's namespace root, made on first use."""
        root = self._roots.get(int(adapter_id))
        if root is None:
            root = self._roots[int(adapter_id)] = _Node(None, None, None)
        return root

    # -- matching ----------------------------------------------------------
    def _match_full(self, tok: np.ndarray, limit: int, root: _Node,
                    acquire: bool = True) -> Tuple[_Node, List[int], int]:
        """Walk full-page edges: (last node, matched page ids, matched
        token count), capped at `limit` so at least one prompt token
        always prefills (its logits start decoding). With `acquire` (the
        reservation) each matched page is retained as it is walked, so
        the restore and spill below can never touch the match in
        progress; a spilled node on the path is restored from the host
        tier, and where that fails the walk stops and the tail prefills.
        Without it (`lookup`'s probe) a spilled node counts as matched
        and nothing is retained or restored."""
        ps = self.page_size
        node, pages, depth = root, [], 0
        while depth + ps <= limit:
            child = node.children.get(tok[depth:depth + ps].tobytes())
            if child is None:
                break
            if child.page is None:
                if not acquire:
                    node = child
                    depth += ps
                    continue
                if not self._restore(child):
                    break
            node = child
            if acquire:
                self.pool.retain([child.page])
            pages.append(child.page)
            depth += ps
            self._touch(child)
        return node, pages, depth

    def _restore(self, node: _Node) -> bool:
        """Swap a spilled node's page back in: the engine's load callback
        returns the restored device page PARKED, so the caller's retain
        treats it like any other tree page."""
        if self._host_load is None:
            return False
        page = self._host_load(node.host)
        if page is None:
            return False
        node.page = page
        node.host = None
        self._owner[page] = node
        self._n_spilled -= 1
        self.restored_pages_total += 1
        return True

    def _best_tail(self, node: _Node, tail: np.ndarray
                   ) -> Tuple[int, Optional[int]]:
        """Best copy-on-write source below `node` for the remaining
        sub-page prompt tokens: (matched token count, source page)."""
        best_k, best_page, best_obj = 0, None, None
        for part in node.partials:
            k = _common_prefix(tail, part.tokens)
            if k > best_k:
                best_k, best_page, best_obj = k, part.page, part
        for child in node.children.values():
            if child.page is None:
                continue      # spilled: not a COW source on the device
            k = _common_prefix(tail, child.tokens)
            if k > best_k:
                best_k, best_page, best_obj = k, child.page, child
        if best_obj is not None:
            self._touch(best_obj)
        return best_k, best_page

    def lookup(self, prompt, adapter_id: int = 0) -> int:
        """Side-effect-free probe: how many tokens of `prompt` the cache
        could serve now (full pages, device or spilled, plus the best
        copy-on-write tail) within `adapter_id`'s namespace."""
        tok = _tok(prompt)
        limit = max(0, tok.size - 1)
        node, _, depth = self._match_full(
            tok, limit, self._root_for(adapter_id), acquire=False)
        k, _ = self._best_tail(node, tok[depth:limit])
        return depth + k

    # -- admission ---------------------------------------------------------
    def acquire(self, prompt, max_new_tokens: int, adapter_id: int = 0
                ) -> Optional[PrefixGrant]:
        """Longest-prefix match + page reservation for one request, within
        `adapter_id`'s namespace. On success every granted page holds one
        reference for the request (and the COW source an extra one until
        `cow_done`). On refusal nothing changed."""
        ps = self.page_size
        tok = _tok(prompt)
        plen = tok.size
        self.lookups += 1
        limit = plen - 1        # >= 1 token must prefill for logits
        node, shared, depth = self._match_full(
            tok, limit, self._root_for(adapter_id))
        cow_k, cow_src = self._best_tail(node, tok[depth:limit])
        need_fresh = pages_needed(plen, max_new_tokens, ps) - len(shared)
        if cow_src is not None:
            self.pool.retain([cow_src])
        fresh = self.pool.alloc(need_fresh)
        if fresh is None:
            # page pressure: spill parked pages to the host tier first
            # (a later match restores them), then evict what remains
            self._make_room(need_fresh)
            fresh = self.pool.alloc(need_fresh)
        if fresh is None and cow_src is not None:
            # the retained COW source may be the very page blocking
            # admission: forfeit the partial-page match, admit with the
            # full-page match alone
            self.release([cow_src])
            cow_src, cow_k = None, 0
            self._make_room(need_fresh)
            fresh = self.pool.alloc(need_fresh)
        if fresh is None:
            self.release(shared)     # roll back the match
            return None
        cached = depth + cow_k
        if cached:
            self.hits += 1
            self.cached_tokens_total += cached
        grant = PrefixGrant(pages=shared + fresh, cached_len=cached,
                            matched_full_pages=len(shared),
                            fresh_pages=fresh)
        if cow_src is not None:
            self.cow_copies_total += 1
            grant.cow_src = cow_src
            grant.cow_dst = fresh[0]
        return grant

    def _make_room(self, need: int):
        """Free pages until `need` are free: spill parked pages to the
        host tier first, evict what is still short."""
        short = need - self.pool.free_pages
        short -= self.spill(short)
        if short > 0:
            self.evict(short)

    def cow_done(self, grant: PrefixGrant):
        """The engine copied the COW page: drop the source's protection
        reference."""
        if grant.cow_src is not None:
            self.release([grant.cow_src])
            grant.cow_src = None

    # -- retirement --------------------------------------------------------
    def release(self, pages: List[int]):
        """Drop one reference per page; pages at refcount 0 park
        (tree-resident) or free (private)."""
        zeroed = self.pool.release(pages)
        park = [p for p in zeroed if p in self._owner]
        if park:
            self.pool.park(park)
        gone = [p for p in zeroed if p not in self._owner]
        if gone:
            self.pool.free(gone)

    def insert(self, tokens, pages: List[int], valid: int,
               adapter_id: int = 0):
        """Index a finished request's pages under `adapter_id`'s
        namespace: `tokens` is its prompt + generated ids, `valid` how
        many positions hold KV. Duplicates free (the tree keeps its
        original); then all of the request's references drop."""
        ps = self.page_size
        tok = _tok(tokens)
        valid = int(valid)
        if valid > tok.size or valid > len(pages) * ps:
            raise ValueError(
                f"valid={valid} exceeds tokens ({tok.size}) or page "
                f"capacity ({len(pages) * ps})")
        node = self._root_for(adapter_id)
        n_full = valid // ps
        for i in range(n_full):
            span = tok[i * ps:(i + 1) * ps]
            key = span.tobytes()
            child = node.children.get(key)
            if child is None:
                child = _Node(np.array(span), pages[i], node)
                node.children[key] = child
                self._owner[pages[i]] = child
                self.inserted_pages_total += 1
            node = child
            self._touch(node)
        rem = valid - n_full * ps
        if rem > 0:
            ptoks = np.array(tok[n_full * ps:valid])
            page = pages[n_full]
            if page not in self._owner and self._tail_is_new(node, ptoks):
                part = _Partial(ptoks, page)
                node.partials.append(part)
                self._owner[page] = part
                self.inserted_pages_total += 1
                self._touch(part)
        self.release(pages)

    def _tail_is_new(self, node: _Node, ptoks: np.ndarray) -> bool:
        """Keep a partial tail only if no resident page already covers
        it."""
        for part in node.partials:
            if part.tokens.size >= ptoks.size and \
                    _common_prefix(part.tokens, ptoks) == ptoks.size:
                return False
        for child in node.children.values():
            if _common_prefix(child.tokens, ptoks) == ptoks.size:
                return False
        return True

    # -- session pins ------------------------------------------------------
    def _pinned(self, node: _Node) -> bool:
        return node.pin_until > self._clock()

    def pin(self, tokens, ttl_s: float, adapter_id: int = 0) -> int:
        """Hold the full-page chain covering `tokens` above LRU until
        `ttl_s` from now on the tree's clock: neither spill nor eviction
        takes a pinned node, so a conversation's next turn hits its warm
        KV. Re-pinning extends the deadline (max, never shortens); an
        expired pin needs no sweep. Returns the pages pinned."""
        if ttl_s <= 0:
            return 0
        deadline = self._clock() + float(ttl_s)
        tok = _tok(tokens)
        ps = self.page_size
        node = self._root_for(adapter_id)
        pinned = 0
        for i in range(tok.size // ps):
            child = node.children.get(tok[i * ps:(i + 1) * ps].tobytes())
            if child is None:
                break
            child.pin_until = max(child.pin_until, deadline)
            self._touch(child)
            pinned += 1
            node = child
        return pinned

    # -- spill (host tier) -------------------------------------------------
    def spill(self, need: int) -> int:
        """Move up to `need` unreferenced parked FULL pages to the host
        tier, LRU first: the device page frees (PagePool.swap_out), the
        node stays walkable with a host slot. Any node, leaf or interior,
        may spill. Returns the device pages freed (0 without a host
        tier)."""
        if need <= 0 or self._host_store is None:
            return 0
        heap = []
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (node.tokens is not None and node.page is not None
                    and self.pool.refcount(node.page) == 0
                    and not self._pinned(node)):
                heapq.heappush(heap, (node.last_used, id(node), node))
        spilled = 0
        while spilled < need and heap:
            _, _, node = heapq.heappop(heap)
            if node.page is None or self.pool.refcount(node.page) != 0:
                continue
            slot = self._host_store(node.page)
            if slot is None:
                break                       # host tier full
            self.pool.swap_out([node.page], spill=True)
            del self._owner[node.page]
            node.host = slot
            node.page = None
            self._n_spilled += 1
            self.spilled_pages_total += 1
            spilled += 1
        return spilled

    # -- eviction ----------------------------------------------------------
    def _evictable(self, obj) -> bool:
        if isinstance(obj, _Partial):
            return self.pool.refcount(obj.page) == 0
        if obj.children or obj.partials:
            return False
        if self._pinned(obj):
            return False      # session-pinned: the TTL tier, not LRU
        if obj.page is None:
            return True       # spilled leaf: only a host copy to drop
        return self.pool.refcount(obj.page) == 0

    def evict(self, need: int) -> int:
        """Free at least `need` unreferenced cached pages, LRU leaves
        first, walking leaf-to-root as parents become childless.
        Returns the number of pages freed."""
        if need <= 0:
            return 0
        heap = []
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            for part in node.partials:
                heapq.heappush(heap, (part.last_used, id(part), part, node))
            if node.tokens is not None and self._evictable(node):
                heapq.heappush(heap, (node.last_used, id(node), node,
                                      node.parent))
        freed = 0
        while freed < need and heap:
            _, _, obj, parent = heapq.heappop(heap)
            if isinstance(obj, _Partial):
                if obj not in parent.partials or \
                        self.pool.refcount(obj.page) != 0:
                    continue
                parent.partials.remove(obj)
            else:
                key = obj.tokens.tobytes()
                if obj.parent is None or not self._evictable(obj) or \
                        parent.children.get(key) is not obj:
                    continue
                del parent.children[key]
                obj.parent = None
            if obj.page is None:
                # spilled node: drop its host copy. Frees no device page,
                # but may make the parent a leaf
                self._host_drop(obj.host)
                obj.host = None
                self._n_spilled -= 1
            else:
                del self._owner[obj.page]
                self.pool.free([obj.page])
                self.evicted_pages_total += 1
                freed += 1
            if parent.tokens is not None and self._evictable(parent):
                heapq.heappush(heap, (parent.last_used, id(parent),
                                      parent, parent.parent))
        return freed

    def clear(self) -> int:
        """Drop every unreferenced cached page, device-resident and
        spilled (a forced cold cache). Session pins do not survive it;
        referenced nodes do. Returns the device pages freed."""
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            node.pin_until = 0.0
        return self.evict(self.tree_pages + self._n_spilled)

    # -- the KV fabric (serving.fabric) ------------------------------------
    def fingerprints(self, limit: int = 4096) -> set:
        """The CRC chain of every page-aligned prefix this tree can
        serve, seeded by the adapter id (`fabric.fp_seed`/`fp_step`, as
        `fabric.prompt_fingerprints` walks a prompt). Spilled nodes
        count: a match restores them. Breadth first, so a `limit` keeps
        the shallow prefixes most prompts share."""
        out: set = set()
        queue = deque((root, fp_seed(aid))
                      for aid, root in self._roots.items())
        while queue and len(out) < limit:
            node, fp = queue.popleft()
            for child in node.children.values():
                cfp = fp_step(fp, child.tokens)
                out.add(cfp)
                if len(out) >= limit:
                    break
                queue.append((child, cfp))
        return out

    def collect_chain(self, tokens, adapter_id: int = 0
                      ) -> Tuple[int, List[Tuple[str, int]]]:
        """The resident page chain covering `tokens`' full pages, for
        export: (covered token count, [("page", id) | ("host", slot),
        ...]), walked without acquiring or restoring, stopping at the
        first miss. The engine reads device pages with its swap-out copy
        and host slots straight from the host tier. The chain stays
        valid until the next engine step."""
        ps = self.page_size
        tok = _tok(tokens)
        node = self._root_for(adapter_id)
        refs: List[Tuple[str, int]] = []
        depth = 0
        while depth + ps <= tok.size:
            child = node.children.get(tok[depth:depth + ps].tobytes())
            if child is None:
                break
            if child.page is not None:
                refs.append(("page", child.page))
            elif child.host is not None:
                refs.append(("host", child.host))
            else:
                break
            node = child
            depth += ps
            self._touch(child)
        return depth, refs

    def graft(self, tokens, payloads: List, valid: int,
              adapter_id: int = 0, *, alloc_restore) -> int:
        """`insert`'s twin for pages from ANOTHER engine: index a
        transferred chain so the next `acquire` hits it. `payloads` hold
        one page payload per page of `tokens[:valid]`;
        `alloc_restore(payload)` allocates a device page, writes the
        payload into it and hands it back PARKED, or returns None, which
        ends the graft at that depth (a shorter prefix is still a
        prefix: grafting runs root-first). Spans the tree already holds
        cost no page. Returns the pages grafted."""
        ps = self.page_size
        tok = _tok(tokens)
        valid = int(valid)
        if valid > tok.size or valid > len(payloads) * ps:
            raise ValueError(
                f"valid={valid} exceeds tokens ({tok.size}) or "
                f"payload capacity ({len(payloads) * ps})")
        node = self._root_for(adapter_id)
        n_full = valid // ps
        grafted = 0
        for i in range(n_full):
            span = tok[i * ps:(i + 1) * ps]
            key = span.tobytes()
            child = node.children.get(key)
            if child is None:
                page = alloc_restore(payloads[i])
                if page is None:
                    return grafted
                child = _Node(np.array(span), page, node)
                node.children[key] = child
                self._owner[page] = child
                self.inserted_pages_total += 1
                grafted += 1
            node = child
            self._touch(node)
        rem = valid - n_full * ps
        if rem > 0 and n_full < len(payloads) and \
                self._tail_is_new(node, tok[n_full * ps:valid]):
            page = alloc_restore(payloads[n_full])
            if page is not None:
                part = _Partial(np.array(tok[n_full * ps:valid]), page)
                node.partials.append(part)
                self._owner[page] = part
                self.inserted_pages_total += 1
                self._touch(part)
                grafted += 1
        return grafted

    def snapshot(self, extract_page, host_payload=None) -> dict:
        """The whole tree, structure and page contents, as a host-side
        record for warm restarts: one entry {adapter, parent index, token
        span, payload, partial} a node (device pages through
        `extract_page(page)`, spilled ones through `host_payload(slot)`),
        parents before children. A node whose payload is unreachable is
        skipped with its subtree (a chain with a hole is no prefix).
        Meant for a quiesced engine; a live one only reads pages."""
        nodes: List[dict] = []
        for aid, root in sorted(self._roots.items()):
            stack: List[Tuple[object, int]] = [(root, -1)]
            while stack:
                node, pidx = stack.pop()
                if node.tokens is None:
                    midx = -1
                else:
                    if node.page is not None:
                        payload = extract_page(node.page)
                    elif node.host is not None and \
                            host_payload is not None:
                        payload = host_payload(node.host)
                    else:
                        continue
                    if payload is None:
                        continue
                    midx = len(nodes)
                    nodes.append({"adapter": aid, "parent": pidx,
                                  "tokens": np.array(node.tokens),
                                  "payload": payload,
                                  "partial": False})
                for part in node.partials:
                    pay = extract_page(part.page)
                    if pay is not None:
                        nodes.append({"adapter": aid, "parent": midx,
                                      "tokens": np.array(part.tokens),
                                      "payload": pay, "partial": True})
                for child in node.children.values():
                    stack.append((child, midx))
        return {"version": 1, "page_size": self.page_size,
                "nodes": nodes}

    def load(self, snap: dict, *, alloc_restore) -> int:
        """Rebuild a `snapshot` into this tree (usually a fresh engine's),
        parent first, with `graft`'s `alloc_restore` contract and dedup.
        An entry whose page cannot be allocated drops with its
        descendants; everything restored parks cache-resident. Returns
        the pages restored."""
        if snap.get("version") != 1:
            raise ValueError(
                f"prefix snapshot version {snap.get('version')!r} "
                "not supported")
        if int(snap.get("page_size", -1)) != self.page_size:
            raise ValueError(
                f"prefix snapshot page_size {snap.get('page_size')} "
                f"!= cache page_size {self.page_size}")
        restored = 0
        placed: Dict[int, _Node] = {}
        for i, ent in enumerate(snap["nodes"]):
            pidx = int(ent["parent"])
            if pidx < 0:
                parent = self._root_for(int(ent["adapter"]))
            else:
                parent = placed.get(pidx)
                if parent is None:
                    continue
            toks = _tok(ent["tokens"])
            if ent.get("partial"):
                if not self._tail_is_new(parent, toks):
                    continue
                page = alloc_restore(ent["payload"])
                if page is None:
                    continue
                part = _Partial(np.array(toks), page)
                parent.partials.append(part)
                self._owner[page] = part
                self.inserted_pages_total += 1
                self._touch(part)
                restored += 1
            else:
                key = toks.tobytes()
                child = parent.children.get(key)
                if child is None:
                    page = alloc_restore(ent["payload"])
                    if page is None:
                        continue
                    child = _Node(np.array(toks), page, parent)
                    parent.children[key] = child
                    self._owner[page] = child
                    self.inserted_pages_total += 1
                    restored += 1
                placed[i] = child
                self._touch(child)
        return restored
