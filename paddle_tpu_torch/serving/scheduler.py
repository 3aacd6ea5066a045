"""Admission + continuous-batching policy (counterpart of
`paddle_tpu/serving/scheduler.py`).

The scheduler owns WHICH request occupies WHICH slot; the engine owns
the device state. Membership changes happen between engine steps only.
The queue is ordered by (priority, arrival): lower `priority` goes
first, FIFO within a class. A freed slot is refilled by the queue head
at the next step boundary, subject to the engine's resource check
(`assign(reserve=...)`): the request's whole page budget must fit, and
when the head's pages do not fit nothing behind it is admitted either
(head-of-line backpressure). Preemption, placement deadlines and draft
packing are not ported yet (ROADMAP.md, queue 1, item 10).
"""
from __future__ import annotations

import bisect
import itertools
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
        # the queue, and beside it each entry's (priority, arrival, seq)
        # sort key
        self._queue: List[Request] = []
        self._keys: List[Tuple] = []
        self._seq = itertools.count()
        self.running: Dict[int, Request] = {}   # slot -> request

    # -- queue side -------------------------------------------------------
    def submit(self, req: Request):
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue full ({self.max_queue}); shed load or "
                "raise max_queue")
        key = (req.sampling.priority, req.arrival_t, next(self._seq))
        i = bisect.bisect(self._keys, key)
        self._keys.insert(i, key)
        self._queue.insert(i, req)

    def _pop(self, i: int = 0) -> Request:
        del self._keys[i]
        return self._queue.pop(i)

    def drop_queued(self, req: Request) -> bool:
        for i, r in enumerate(self._queue):
            if r is req:
                self._pop(i)
                return True
        return False

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def occupancy(self) -> float:
        return len(self.running) / self.num_slots

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
                self._pop()      # cancel raced admission
            if not self._queue:
                break
            req = self._queue[0]
            if reserve is not None and not reserve(req):
                break
            self._pop()
            req.slot = slot
            self.running[slot] = req
            grants.append((slot, req))
        return grants

    def pack_tokens(self, budget: int, width: int,
                    prefill_remaining: Dict[int, int]
                    ) -> Tuple[List[int], Dict[int, int]]:
        """Unified-step token packing: every DECODE slot gets its one
        token (a resident decoder is never stalled by prefill), then
        mid-PREFILL slots split the spare budget in slot order, each at
        most `width` prompt tokens. `prefill_remaining` maps mid-prefill
        slots to their unprefilled prompt token counts. Returns
        (decode_slots, {slot: prefill tokens}); a prefill slot with no
        grant idles this step at q_len 0."""
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
        return decode_slots, grants

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

    def cancelled_running(self) -> List[Request]:
        return [r for r in self.running.values()
                if r.state is RequestState.CANCELLED]

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or bool(self.running)
