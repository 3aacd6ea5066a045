"""Multi-tenant LoRA serving: a paged adapter pool (counterpart of
`paddle_tpu/serving/adapters.py`).

Most tenants of one fleet share one base model and differ by a low-rank
delta on the attention projections (LoRA: per layer a pair A [in, r],
B [r, out] per projection, applied as y = x W + (x A) B scale). The
engine serves them as operand data, not as weight swaps:

- **AdapterStore**, the registry plus a PAGED adapter pool on the
  device under the `PagePool` discipline the KV pages live under. One
  pool page holds one adapter's whole A/B block (every layer, the q, k,
  v and o projections, zero-padded to the pool rank); page 0 is the
  reserved all-zero page, so adapter 0 (the base model) gives an
  exactly-zero delta. An adapter is refcounted while a resident slot
  uses it (eviction never touches it), parks hot when its last user
  retires, and under page pressure is spilled whole to a host tier
  (`HostPagePool`) or evicted LRU; either way it comes back on demand
  (the registry keeps its weights: eviction loses residency, never
  data).
- **Rank buckets**: registered ranks round up to a fixed set
  (`rank_buckets`, default (2, 4, 8)) and are zero-padded; the pool has
  one rank, the largest bucket, so every row's pages have one shape.
  Zero padding contributes exactly 0 to x A B.
- **Batched multi-adapter execution**: the engine keeps a per-slot
  adapter page and scale beside pos and q_len; each step every layer
  takes its rows' A/B pages from the pool (gathered per row for
  `lora_delta`, or whole pools for the megakernel's `lora_delta_paged`,
  K11), so a batch mixing tenants and base rows is one step.

An upload writes a page of every pool tensor with in-place copies.
`LoRAWeights` holds numpy arrays, as in the JAX package, so one adapter
registers the same arrays in both. The pools hold the engine's dtype:
the padded payload is kept as f32 numpy and cast to it at upload.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .paging import HostPagePool, PagePool

__all__ = ["AdapterStore", "LoRAWeights", "resolve_adapters_flag",
           "make_random_lora", "BASE_ADAPTER", "ADAPTER_PROJS",
           "ADAPTER_MODES"]

# adapter_id 0 is the base model: its pool page is the all-zero page 0
BASE_ADAPTER = 0
# the projections an adapter patches, in pool order (A then B each)
ADAPTER_PROJS = ("q", "k", "v", "o")
ADAPTER_MODES = ("on", "off")


def resolve_adapters_flag(override=None) -> bool:
    """Whether the engine builds the adapter subsystem (default off): an
    explicit override wins (None defers), otherwise
    PADDLE_TPU_ADAPTERS=on|off, read at engine construction. Anything
    else raises ValueError."""
    if override is not None:
        return bool(override)
    v = os.environ.get("PADDLE_TPU_ADAPTERS", "off")
    if v not in ADAPTER_MODES:
        raise ValueError(
            f"PADDLE_TPU_ADAPTERS must be one of {ADAPTER_MODES}, "
            f"got {v!r}")
    return v == "on"


class LoRAWeights:
    """One adapter's host-side weights: per layer, per projection
    (q/k/v/o) a pair (A [in, r], B [r, out]) of numpy arrays. `layers` is
    a list of dicts {"q": (A, B), "k": ..., "v": ..., "o": ...}; a
    missing projection means no delta. The scale is alpha / rank (alpha
    defaults to the rank: scale 1)."""

    def __init__(self, layers: Sequence[Dict[str, Tuple]], rank: int,
                 alpha: Optional[float] = None):
        self.layers = list(layers)
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError("LoRA rank must be >= 1")
        self.alpha = float(alpha) if alpha is not None else float(rank)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def make_random_lora(n_layers: int, hidden: int, q_out: int, kv_out: int,
                     rank: int, rng, amp: float = 0.05) -> LoRAWeights:
    """A random adapter for tests and benches (the JAX function, drawing
    from the numpy `rng` in the same order): every projection patched,
    N(0, amp) entries."""
    def pair(in_f, out_f):
        return (rng.normal(0.0, amp, size=(in_f, rank)),
                rng.normal(0.0, amp, size=(rank, out_f)))
    layers = []
    for _ in range(n_layers):
        layers.append({"q": pair(hidden, q_out),
                       "k": pair(hidden, kv_out),
                       "v": pair(hidden, kv_out),
                       "o": pair(q_out, hidden)})
    return LoRAWeights(layers, rank=rank)


class _Adapter:
    """One registered adapter's lifecycle record."""

    __slots__ = ("adapter_id", "name", "rank", "bucket", "scale",
                 "payload", "page", "host_slot", "last_used")

    def __init__(self, adapter_id: int, name: str, rank: int, bucket: int,
                 scale: float, payload: List[np.ndarray]):
        self.adapter_id = adapter_id
        self.name = name
        self.rank = rank            # registered rank
        self.bucket = bucket        # the rank bucket it was padded to
        self.scale = scale
        # pool-shaped per-layer arrays padded to the pool rank, in pool
        # order [Aq, Bq, Ak, Bk, Av, Bv, Ao, Bo] x n_layers: the upload
        # source and the restore of last resort
        self.payload = payload
        self.page: Optional[int] = None       # device pool page
        self.host_slot: Optional[int] = None  # host tier slot
        self.last_used = 0

    @property
    def state(self) -> str:
        if self.page is not None:
            return "resident"
        if self.host_slot is not None:
            return "spilled"
        return "registered"


class AdapterStore:
    """Registry and paged device pool of LoRA adapters for one engine.

    Device state: per layer a tuple of eight pool tensors (Aq
    [P, hidden, R], Bq [P, R, q_out], Ak/Av [P, hidden, R], Bk/Bv
    [P, R, kv_out], Ao [P, q_out, R], Bo [P, R, hidden]) of `dtype` on
    `device`; page p of each holds one adapter's block for that layer,
    R is the pool rank (the largest bucket), page 0 is the zero page.
    Host state: `PagePool` bookkeeping (an adapter referenced by a
    resident slot is never evicted), a `HostPagePool` spill tier and the
    registry. Mutations happen between engine steps, on the engine's
    thread; `stats()` and `debug()` take a lock against torn reads."""

    def __init__(self, n_layers: int, hidden: int, q_out: int, kv_out: int,
                 *, num_pages: int = 9,
                 rank_buckets: Sequence[int] = (2, 4, 8),
                 dtype: torch.dtype = torch.float32, device=None,
                 host_pages: Optional[int] = None):
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.q_out = int(q_out)
        self.kv_out = int(kv_out)
        self.rank_buckets = tuple(sorted(int(b) for b in rank_buckets))
        if not self.rank_buckets or self.rank_buckets[0] < 1:
            raise ValueError("rank_buckets must be >= 1")
        self.rank = self.rank_buckets[-1]      # the pool rank R
        self.num_pages = int(num_pages)
        self.dtype = dtype
        self.device = torch.device("cpu") if device is None else \
            torch.device(device)
        self.pool = PagePool(self.num_pages)
        self.host_pool = HostPagePool(
            self.num_pages - 1 if host_pages is None else int(host_pages))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)         # 0 is the base model
        self._by_name: Dict[str, int] = {}
        self._recs: Dict[int, _Adapter] = {}
        self._tick = itertools.count(1)
        # traffic counters, mirrored into the engine's metrics each step
        self.loads_total = 0          # registry -> device uploads
        self.evictions_total = 0      # device copy dropped outright
        self.spills_total = 0         # device -> host tier moves
        self.restores_total = 0       # host tier -> device moves
        P, R = self.num_pages, self.rank
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype,
                                           device=self.device)
        self.pools = tuple(
            (zeros(P, self.hidden, R), zeros(P, R, self.q_out),
             zeros(P, self.hidden, R), zeros(P, R, self.kv_out),
             zeros(P, self.hidden, R), zeros(P, R, self.kv_out),
             zeros(P, self.q_out, R), zeros(P, R, self.hidden))
            for _ in range(self.n_layers))

    # -- registry ----------------------------------------------------------
    def bucket_for(self, rank: int) -> int:
        """Smallest rank bucket >= rank; a rank above every bucket is a
        registration error."""
        for b in self.rank_buckets:
            if rank <= b:
                return b
        raise ValueError(
            f"LoRA rank {rank} exceeds the largest rank bucket "
            f"{self.rank_buckets[-1]}; legal buckets: {self.rank_buckets} "
            "(grow rank_buckets at engine construction)")

    def _pad_payload(self, w: LoRAWeights) -> List[np.ndarray]:
        """Registered (A, B) pairs -> pool-shaped f32 arrays, zero-padded
        from the registered rank to the pool rank; missing projections
        all zero."""
        if len(w.layers) != self.n_layers:
            raise ValueError(f"adapter patches {len(w.layers)} layers but "
                             f"the model has {self.n_layers}")
        R = self.rank
        shapes = {"q": (self.hidden, self.q_out),
                  "k": (self.hidden, self.kv_out),
                  "v": (self.hidden, self.kv_out),
                  "o": (self.q_out, self.hidden)}
        out: List[np.ndarray] = []
        for li, layer in enumerate(w.layers):
            for proj in ADAPTER_PROJS:
                in_f, out_f = shapes[proj]
                a_pad = np.zeros((in_f, R), np.float64)
                b_pad = np.zeros((R, out_f), np.float64)
                pair = layer.get(proj)
                if pair is not None:
                    a, b = np.asarray(pair[0]), np.asarray(pair[1])
                    if a.shape != (in_f, w.rank) or \
                            b.shape != (w.rank, out_f):
                        raise ValueError(
                            f"layer {li} proj {proj!r}: A/B shapes "
                            f"{a.shape}/{b.shape} do not match (in={in_f}, "
                            f"rank={w.rank}, out={out_f})")
                    a_pad[:, :w.rank] = a
                    b_pad[:w.rank, :] = b
                out.append(a_pad.astype(np.float32))
                out.append(b_pad.astype(np.float32))
        return out

    def register(self, name: str, weights: LoRAWeights) -> int:
        """Register one adapter under `name` and return its adapter_id
        (1, 2, ... in registration order, so engines registering the same
        adapters in the same order agree on ids). Host-side only: nothing
        reaches the device until a request under this id is admitted."""
        with self._lock:
            if name in self._by_name:
                raise ValueError(f"adapter {name!r} already registered")
            bucket = self.bucket_for(weights.rank)
            aid = next(self._ids)
            self._recs[aid] = _Adapter(aid, name, weights.rank, bucket,
                                       weights.scale,
                                       self._pad_payload(weights))
            self._by_name[name] = aid
        return aid

    def known(self, adapter_id: int) -> bool:
        return adapter_id == BASE_ADAPTER or adapter_id in self._recs

    def id_for(self, name: str) -> Optional[int]:
        """The adapter_id registered under `name`; None if unknown (the
        router maps an HTTP `model` name through it)."""
        with self._lock:
            return self._by_name.get(name)

    def is_hot(self, adapter_id: int) -> bool:
        """Whether the adapter's page is on the device (the router's
        placement affinity: hot beats cold)."""
        if adapter_id == BASE_ADAPTER:
            return True
        rec = self._recs.get(adapter_id)
        return rec is not None and rec.page is not None

    # -- device upload ------------------------------------------------------
    def _upload(self, rec: _Adapter, page: int):
        """Write the adapter's payload into page `page` of every pool
        tensor, in place."""
        i = 0
        for layer in self.pools:
            for t in layer:
                t[page].copy_(torch.from_numpy(rec.payload[i]).to(t.dtype))
                i += 1

    # -- residency (the paged-pool lifecycle) -------------------------------
    def _free_one_page(self) -> bool:
        """Make room: spill the LRU parked adapter to the host tier, else
        evict it outright (the registry still holds its weights). False
        when every resident adapter is referenced by a running slot."""
        victim = None
        for rec in self._recs.values():
            if rec.page is None or self.pool.refcount(rec.page) != 0:
                continue
            if victim is None or rec.last_used < victim.last_used:
                victim = rec
        if victim is None:
            return False
        slot = self.host_pool.store(victim.payload)
        if slot is not None:
            self.pool.swap_out([victim.page], spill=True)
            victim.host_slot = slot
            self.spills_total += 1
        else:
            self.pool.free([victim.page])
            self.evictions_total += 1
        victim.page = None
        return True

    def acquire(self, adapter_id: int) -> Optional[Tuple[int, float]]:
        """Admission's residency claim: make `adapter_id` device-resident
        (upload, or restore from the host tier, spilling or evicting LRU
        parked adapters under pressure) and take one reference on its
        page. Returns (pool page, LoRA scale), or None when every page is
        referenced (the request waits). The base model is always
        (0, 0.0) at no cost."""
        if adapter_id == BASE_ADAPTER:
            return (0, 0.0)
        rec = self._recs.get(adapter_id)
        if rec is None:
            raise ValueError(f"unknown adapter_id {adapter_id}")
        if rec.page is None:
            pages = self.pool.alloc(1)
            if pages is None and self._free_one_page():
                pages = self.pool.alloc(1)
            if pages is None:
                return None
            page = pages[0]
            self._upload(rec, page)
            if rec.host_slot is not None:
                # close the host-tier obligation the spill opened
                self.host_pool.free(rec.host_slot)
                self.pool.swapped_restored(1, spill=True)
                rec.host_slot = None
                self.restores_total += 1
            else:
                self.loads_total += 1
            rec.page = page     # alloc() granted the first reference
        else:
            # resident (parked or shared): one more reference; a parked
            # page leaves the cache-resident state here
            self.pool.retain([rec.page])
        rec.last_used = next(self._tick)
        return (rec.page, rec.scale)

    def release(self, adapter_id: int):
        """A resident slot retired: drop one reference; an adapter nobody
        uses parks hot instead of freeing."""
        if adapter_id == BASE_ADAPTER:
            return
        rec = self._recs[adapter_id]
        zeroed = self.pool.release([rec.page])
        if zeroed:
            self.pool.park(zeroed)

    # -- introspection -------------------------------------------------------
    def assert_quiesced(self):
        """Shutdown leak check: every adapter page free or parked, no
        slot reference left (spilled pages are legitimate state)."""
        self.pool.assert_quiesced()

    def stats(self) -> dict:
        with self._lock:
            states = [r.state for r in self._recs.values()]
            return {
                "registered": len(self._recs),
                "resident": states.count("resident"),
                "spilled": states.count("spilled"),
                "pages_used": self.pool.used_pages,
                "pages_cached": self.pool.cached_pages,
                "pages_swapped": self.pool.swapped_pages,
                "pages_total": self.num_pages - 1,
                "host_pages_used": self.host_pool.used_pages,
                "loads_total": self.loads_total,
                "evictions_total": self.evictions_total,
                "spills_total": self.spills_total,
                "restores_total": self.restores_total,
            }

    def debug(self) -> List[dict]:
        """Per-adapter rows: id, name, rank (registered and bucket),
        scale, residency state, page and refcount."""
        with self._lock:
            out = []
            for aid in sorted(self._recs):
                rec = self._recs[aid]
                out.append({
                    "adapter_id": aid, "name": rec.name, "rank": rec.rank,
                    "rank_bucket": rec.bucket, "scale": rec.scale,
                    "state": rec.state, "page": rec.page,
                    "refcount": (0 if rec.page is None
                                 else self.pool.refcount(rec.page))})
            return out
