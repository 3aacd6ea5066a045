"""Admission + continuous-batching policy (counterpart of
`paddle_tpu/serving/scheduler.py`).

The scheduler owns WHICH request occupies WHICH slot; the engine owns
the device state. Membership changes happen between engine steps only.
The queue is ordered by (priority, deadline, arrival): lower `priority`
goes first, within a class an earlier placement deadline, then FIFO. A
freed slot is refilled by the queue head at the next step boundary,
subject to the engine's resource check (`assign(reserve=...)`): the
request's whole page budget must fit, and when the head's pages do not
fit nothing behind it is admitted either (head-of-line backpressure). A
blocked head may then PREEMPT the least important resident of a
strictly lower class (`preemption_victim`); the engine banks it, swaps
its KV to the host tier and `requeue`s it by its original key, past
max_queue. `pack_tokens` packs a unified step's decode, prefill and
speculative draft tokens under the token budget, and `pack_draft_seed`
the draft model's warming from what is left. `queue_summary()` is the
queue's view for the engine's `debug_state()`.
"""
from __future__ import annotations

import bisect
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

from .errors import QueueFull
from .request import Request, RequestState

__all__ = ["Scheduler"]


class Scheduler:
    def __init__(self, num_slots: int, max_queue: Optional[int] = None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.max_queue = max_queue
        # ordered by _queue_key: (priority, deadline, arrival, seq)
        self._queue: List[Request] = []
        self._seq = itertools.count()
        self.running: Dict[int, Request] = {}   # slot -> request

    # -- queue side -------------------------------------------------------
    @staticmethod
    def _queue_key(req: Request) -> Tuple:
        dl = req.place_deadline
        return (req.sampling.priority, math.inf if dl is None else dl,
                req.arrival_t, getattr(req, "_queue_seq", 0))

    def _insert(self, req: Request):
        if not hasattr(req, "_queue_seq"):
            req._queue_seq = next(self._seq)
        bisect.insort(self._queue, req, key=self._queue_key)

    def submit(self, req: Request):
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue full ({self.max_queue}); shed load or "
                "raise max_queue")
        self._insert(req)

    def requeue(self, req: Request):
        """Put a preempted resident back in line, past max_queue (banked
        progress is never shed) and by its original ordering key."""
        self._insert(req)

    def drop_queued(self, req: Request) -> bool:
        try:
            self._queue.remove(req)
            return True
        except ValueError:
            return False

    def pop_queued(self) -> List[Request]:
        """Remove and return every queued request (the drain path)."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def peek_queued(self) -> Optional[Request]:
        """The first non-cancelled queued request, left in place."""
        for req in self._queue:
            if req.state is not RequestState.CANCELLED:
                return req
        return None

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def occupancy(self) -> float:
        return len(self.running) / self.num_slots

    def queue_summary(self, max_items: int = 16) -> dict:
        """The ordered queue for debug introspection (the engine's
        `debug_state()`): depth, per-priority-class counts, and the
        first `max_items` entries in admission order."""
        by_prio: Dict[str, int] = {}
        head: List[dict] = []
        for req in self._queue:
            p = str(req.sampling.priority)
            by_prio[p] = by_prio.get(p, 0) + 1
            if len(head) < max_items:
                head.append({"request_id": req.request_id,
                             "priority": req.sampling.priority,
                             "state": req.state.name,
                             "deadline_s": req.sampling.deadline_s})
        return {"depth": len(self._queue), "by_priority": by_prio,
                "head": head}

    def free_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if s not in self.running]

    # -- membership changes (between steps only) --------------------------
    def assign(self, reserve: Optional[Callable[[Request], bool]] = None
               ) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue head in order. `reserve(req)`
        must claim the request's KV pages and return True, or refuse
        without side effects — a refusal stops admission at the head.
        Returns the (slot, request) pairs granted this boundary."""
        grants = []
        for slot in self.free_slots():
            while self._queue and \
                    self._queue[0].state is RequestState.CANCELLED:
                self._queue.pop(0)      # cancel raced admission
            if not self._queue:
                break
            req = self._queue[0]
            if reserve is not None and not reserve(req):
                break
            self._queue.pop(0)
            req.slot = slot
            self.running[slot] = req
            grants.append((slot, req))
        return grants

    def preemption_victim(self, than: Request
                          ) -> Optional[Tuple[int, Request]]:
        """The least important resident STRICTLY below `than`'s priority
        class, or None: highest priority value, then latest (or no)
        placement deadline, then latest arrival — the mirror of the
        admission order. Equal-priority traffic never preempts itself."""
        victim = None
        for slot, req in self.running.items():
            if req.sampling.priority <= than.sampling.priority:
                continue
            if req.state not in (RequestState.PREFILL, RequestState.DECODE):
                continue
            key = self._queue_key(req)
            if victim is None or key > victim[2]:
                victim = (slot, req, key)
        return None if victim is None else (victim[0], victim[1])

    def pack_tokens(self, budget: int, width: int,
                    prefill_remaining: Dict[int, int],
                    draft_wanted: Optional[Dict[int, int]] = None):
        """Unified-step token packing: every DECODE slot gets its one
        token (a resident decoder is never stalled by prefill), then
        mid-PREFILL slots split the spare budget in slot order, each at
        most `width` prompt tokens, and last the speculative drafts
        (`draft_wanted` maps decode slots to proposed draft counts) take
        what is left, at most `width - 1` a slot so that the verify row's
        `1 + drafts` fits the step; slots that do not decode are ignored.
        Prefill outranks drafts: a prompt token is sure work, a draft a
        bet. `prefill_remaining` maps mid-prefill slots to their
        unprefilled prompt token counts. Returns (decode_slots,
        {slot: prefill tokens}), and with `draft_wanted` given also
        {slot: draft tokens}; a prefill slot with no grant idles this
        step at q_len 0. Embed requests and grammar-constrained ones need
        no change here: an embed row is a PREFILL slot that never reaches
        DECODE (the engine retires it at the end of its prompt), and a
        constrained row is a decode row whose bias is step data."""
        decode_slots = [s for s, r in sorted(self.running.items())
                        if r.state is RequestState.DECODE]
        spare = max(0, budget - len(decode_slots))
        grants: Dict[int, int] = {}
        for slot in sorted(prefill_remaining):
            if spare <= 0:
                break
            take = min(prefill_remaining[slot], width, spare)
            if take > 0:
                grants[slot] = take
                spare -= take
        if draft_wanted is None:
            return decode_slots, grants
        draft_grants: Dict[int, int] = {}
        decode = set(decode_slots)
        for slot in sorted(draft_wanted):
            if spare <= 0:
                break
            if slot not in decode:
                continue
            take = min(draft_wanted[slot], width - 1, spare)
            if take > 0:
                draft_grants[slot] = take
                spare -= take
        return decode_slots, grants, draft_grants

    def pack_draft_seed(self, spare: int, width: int,
                        seed_wanted: Dict[int, int]) -> Dict[int, int]:
        """Draft-cache warming grants (the draft-model tier's chunked
        draft prefill): split what `pack_tokens` left over, after decode,
        prefill and drafts, across lagging draft slots in slot order, at
        most `width` tokens each. Spare budget only: warming never
        displaces sure work. `seed_wanted` maps slots to their committed
        token lag. Returns {slot: seed tokens granted}."""
        grants: Dict[int, int] = {}
        spare = int(spare)
        for slot in sorted(seed_wanted):
            if spare <= 0:
                break
            take = min(int(seed_wanted[slot]), int(width), spare)
            if take > 0:
                grants[slot] = take
                spare -= take
        return grants

    def retire(self, slot: int) -> Optional[Request]:
        req = self.running.pop(slot, None)
        if req is not None:
            req.slot = None
        return req

    def expired(self, now: float) -> List[Request]:
        """Queued or running requests past their timeout_s deadline."""
        out = [r for r in self._queue
               if r.deadline is not None and now >= r.deadline]
        out += [r for r in self.running.values()
                if r.deadline is not None and now >= r.deadline]
        return out

    def deadline_expired(self, now: float) -> List[Request]:
        """Queued, never-admitted requests past their placement deadline
        (`deadline_s`). A preempted request waiting to resume met its
        placement deadline and is never in this list."""
        return [r for r in self._queue
                if r.admitted_t is None
                and r.place_deadline is not None
                and now >= r.place_deadline
                and r.state is not RequestState.CANCELLED]

    def cancelled_running(self) -> List[Request]:
        return [r for r in self.running.values()
                if r.state is RequestState.CANCELLED]

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or bool(self.running)
