"""Request/response surface of the serving engine (counterpart of
`paddle_tpu/serving/request.py`).

A `Request` moves through

    QUEUED -> PREFILL -> DECODE -> FINISHED | CANCELLED
                 ^          |
                 +- PREEMPTED (overload: tokens banked, KV pages swapped
                    to the host tier, re-queued; resumes via swap-in)

PREFILL spans as many engine steps as the prompt needs chunks; states
advance only at step boundaries. A request names its LoRA adapter by
`SamplingParams.adapter_id` (0, the default, is the base model). A
request may carry a grammar (`grammar`, a `serving.grammar.GrammarSpec`,
with `grammar_prefix` prompt tokens that already belong to its output),
ask for an embedding instead of tokens (`embed`: prefill only, the pooled
last hidden state in `RequestOutput.embedding`), or name a conversation
(`session`: its cached pages stay pinned for the engine's session TTL).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, Optional

import numpy as np

__all__ = ["RequestState", "SamplingParams", "Request", "RequestOutput"]


class RequestState(Enum):
    QUEUED = 0
    PREFILL = 1
    DECODE = 2
    FINISHED = 3
    CANCELLED = 4
    # preempted under overload: emitted tokens banked, KV pages swapped
    # to the host tier, waiting in the queue to resume
    PREEMPTED = 5


@dataclass
class SamplingParams:
    """Per-request decode knobs. greedy=True (default) is first-
    occurrence argmax decoding; setting top_k or top_p (or greedy=False)
    samples with this request's own temperature/top-k/top-p from the
    engine's seeded generator. The queue orders by (priority, deadline,
    arrival): lower `priority` is more important, and a blocked request
    may preempt a resident of strictly higher `priority` value.
    `deadline_s` is a placement deadline from arrival: a request still
    queued when it passes fails fast as "deadline"; `timeout_s` bounds
    the whole request. `adapter_id` names the registered LoRA adapter
    the request decodes under (0: the base model); riding on the
    sampling parameters, it stays with the request through preemption
    and resume. `grammar` constrains the output (the engine's grammar
    gate must be on, and `eos_token_id` set: EOS is how a complete
    stream ends); `grammar_prefix` counts the trailing prompt tokens that
    are already constrained output, which the automaton replays.
    `embed` makes the request prefill-only: it retires at the end of its
    prompt with the pooled last hidden state (max_new_tokens and EOS are
    ignored). `session` names a conversation: a normally finished
    request's cached pages are pinned for the engine's `session_ttl_s`,
    so the next turn finds them."""

    max_new_tokens: int = 16
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = True
    eos_token_id: Optional[int] = None
    timeout_s: Optional[float] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    adapter_id: int = 0
    grammar: Optional[object] = None
    grammar_prefix: int = 0
    embed: bool = False
    session: Optional[str] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.adapter_id < 0:
            raise ValueError("adapter_id must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k is not None or self.top_p is not None:
            self.greedy = False
        if self.grammar_prefix < 0:
            raise ValueError("grammar_prefix must be >= 0")
        if self.grammar is not None:
            if self.embed:
                raise ValueError(
                    "grammar and embed are mutually exclusive")
            if self.eos_token_id is None:
                raise ValueError(
                    "grammar requires eos_token_id — EOS is the only "
                    "way a structurally complete stream terminates")


_FINISH_SENTINEL = object()


class Request:
    """One queued/running generation job, created by
    `ServingEngine.add_request`. Its tokens arrive through the
    `on_token(request, token)` callback, through the blocking stream
    (`stream()`, `next_event(timeout)`, `wait(timeout)`) when another
    thread pumps the engine, and in the final `output()`."""

    def __init__(self, request_id: str, prompt_ids,
                 sampling: SamplingParams,
                 on_token: Optional[Callable] = None,
                 arrival_t: Optional[float] = None):
        self.request_id = request_id
        self.prompt_ids = np.asarray(prompt_ids).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("empty prompt")
        self.sampling = sampling
        self.on_token = on_token
        self.state = RequestState.QUEUED
        self.output_tokens: List[int] = []
        # stop | length | cancelled | timeout | deadline | aborted
        self.finish_reason: Optional[str] = None
        # typed terminal error, when the finish reason carries one
        # (DeadlineExceeded)
        self.error: Optional[BaseException] = None
        self.slot: Optional[int] = None
        # KV pages granted at admission; None while queued
        self.pages: Optional[List[int]] = None
        # prompt tokens served from cached prefix pages (0 on a miss)
        self.cached_tokens: int = 0
        self._prefix_grant = None
        # emitted tokens that arrived as verified speculative drafts (0
        # with speculation off)
        self.accepted_draft_tokens: int = 0
        # times this request was preempted (banked, swapped, resumed)
        self.preemptions: int = 0
        # the adapter claim (engine-owned): the (pool page, LoRA scale)
        # granted at reserve time, and whether the request holds a
        # reference on its adapter's page (dropped at retirement and at
        # preemption)
        self._adapter_binding = (0, 0.0)
        self._adapter_held = False
        # preemption swap handle (engine-owned) while the request waits
        # to resume with KV in the host tier
        self._swap = None
        # committed sequence (prompt + emitted tokens) frozen at the last
        # preemption: what the resume prefills; None until preempted
        self._resume_ids: Optional[np.ndarray] = None
        # the embeddings lane: the pooled last hidden state (f32
        # [hidden]) an embed request retires with; None otherwise
        self.embedding: Optional[np.ndarray] = None
        self.arrival_t = time.monotonic() if arrival_t is None else arrival_t
        self.admitted_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self._last_token_t: Optional[float] = None
        # the blocking stream: each token is queued before the finish
        # sentinel, so a reader that saw "finish" has every token
        self._stream_q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()

    # -- engine-side transitions ------------------------------------------
    def _emit(self, token: int, now: float):
        self.output_tokens.append(token)
        if self.first_token_t is None:
            self.first_token_t = now
        self._last_token_t = now
        if self.on_token is not None:
            self.on_token(self, token)
        self._stream_q.put(token)

    def _finish(self, reason: str, now: float):
        self.finish_reason = reason
        self.finished_t = now
        self.state = (RequestState.CANCELLED if reason == "cancelled"
                      else RequestState.FINISHED)
        self._stream_q.put(_FINISH_SENTINEL)
        self._done.set()

    @property
    def deadline(self) -> Optional[float]:
        if self.sampling.timeout_s is None:
            return None
        return self.arrival_t + self.sampling.timeout_s

    @property
    def place_deadline(self) -> Optional[float]:
        """Absolute time by which the request must have been admitted
        (`deadline_s` from arrival); None without a placement deadline."""
        if self.sampling.deadline_s is None:
            return None
        return self.arrival_t + self.sampling.deadline_s

    @property
    def prefill_ids(self) -> np.ndarray:
        """The sequence the engine prefills: the prompt or, after a
        preemption, the committed sequence frozen then (prompt + banked
        tokens), so the resume regenerates the state the slot held."""
        return (self._resume_ids if self._resume_ids is not None
                else self.prompt_ids)

    # -- user-facing ------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED)

    def stream(self):
        """Blocking token iterator, for an engine pumped on another
        thread: yields tokens as they decode, returns at the finish."""
        while True:
            tok = self._stream_q.get()
            if tok is _FINISH_SENTINEL:
                return
            yield tok

    def next_event(self, timeout: Optional[float] = None):
        """Poll-able stream read for front ends that interleave token
        delivery with liveness checks: ("token", id), ("finish",
        reason), or ("idle", None) when `timeout` passes with nothing
        queued."""
        try:
            tok = self._stream_q.get(timeout=timeout)
        except queue.Empty:
            return ("idle", None)
        if tok is _FINISH_SENTINEL:
            return ("finish", self.finish_reason)
        return ("token", tok)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes; False if `timeout` passed."""
        return self._done.wait(timeout)

    def output(self) -> "RequestOutput":
        return RequestOutput(
            request_id=self.request_id,
            prompt_token_ids=self.prompt_ids.tolist(),
            token_ids=list(self.output_tokens),
            finish_reason=self.finish_reason,
            cached_tokens=self.cached_tokens,
            accepted_draft_tokens=self.accepted_draft_tokens,
            preemptions=self.preemptions,
            embedding=(None if self.embedding is None
                       else np.asarray(self.embedding)),
            ttft_s=(None if self.first_token_t is None
                    else self.first_token_t - self.arrival_t),
            queue_wait_s=(None if self.admitted_t is None
                          else self.admitted_t - self.arrival_t),
            e2e_s=(None if self.finished_t is None
                   else self.finished_t - self.arrival_t))

    def __repr__(self):
        return (f"Request({self.request_id!r}, state={self.state.name}, "
                f"prompt_len={self.prompt_ids.size}, "
                f"generated={len(self.output_tokens)})")


@dataclass
class RequestOutput:
    """Final result handed back when a request leaves the engine."""

    request_id: str
    prompt_token_ids: List[int]
    token_ids: List[int]
    finish_reason: Optional[str]
    cached_tokens: int = 0
    # emitted tokens that arrived as verified speculative drafts
    accepted_draft_tokens: int = 0
    # times a router migrated the request mid-stream to another replica
    # after its host died (only a router's merged view sets it)
    migrations: int = 0
    # times the request was preempted under overload and resumed
    preemptions: int = 0
    ttft_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    e2e_s: Optional[float] = None
    # the embeddings lane: the pooled last hidden state (f32 [hidden]) of
    # an embed request; None for generation requests
    embedding: Optional[np.ndarray] = None
