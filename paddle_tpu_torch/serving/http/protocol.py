"""Wire protocol of the serving front end, OpenAI-completions shaped
(counterpart of `paddle_tpu/serving/http/protocol.py`).

The stack has no server-side tokenizer, so `prompt` is a list of token
ids.

    POST /v1/completions
    {"prompt": [3, 14, 15, 9], "max_tokens": 8, "stream": true,
     "temperature": 0.8, "top_k": 5, "top_p": 0.9,
     "eos_token_id": 50256, "timeout": 30.0,
     "priority": 0, "deadline": 2.0}

`priority` (int, default 0, LOWER = more important) and `deadline`
(seconds from arrival by which the request must have been PLACED)
drive the overload scheduler: the queue orders by
(priority, deadline, arrival), a blocked higher-priority request may
preempt the lowest-priority resident, and a queued request whose
deadline expires fails fast as 504 instead of silently waiting.

Non-stream responses mirror the OpenAI completion object with
`token_ids` in the choice; streaming responses are SSE (`data:` JSON
frames, one per token, a final frame carrying `finish_reason` +
`usage`, then `data: [DONE]`).

Typed serving errors map to status codes here — never by
string-matching exception text:

    QueueFull           -> 429 (+ Retry-After)
    RateLimited         -> 429 (+ Retry-After, per client key)
    EngineClosed        -> 503
    ReplicaDead         -> 502 (only after failover/migration failed)
    PoisonedRequest     -> 422 (this request kills the step; not retried)
    DeadlineExceeded    -> 504 (placement deadline expired while queued)
    timeout, 0 tokens   -> 503 (runtime timeout passed while queued)

`usage` carries three resilience fields next to the token counts:
`cached_tokens` (prompt tokens served from the prefix cache),
`migrations` (how many times the request was moved to another replica
mid-stream after its host died — the stream stayed token-identical)
and `preemptions` (how many times it was preempted under overload,
swapped to the host tier and resumed — also token-identical).
"""
from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..errors import (DeadlineExceeded, EngineClosed, PoisonedRequest,
                      QueueFull, RateLimited)
from ..grammar import GrammarSpec
from ..request import RequestOutput, SamplingParams
from .driver import ReplicaDead

__all__ = ["ProtocolError", "CompletionRequest",
           "parse_completion_request", "parse_embeddings_request",
           "completion_body", "embeddings_body",
           "stream_chunk", "stream_final", "sse", "SSE_DONE",
           "error_body", "status_for_error", "status_for_output"]

SSE_DONE = b"data: [DONE]\n\n"


class ProtocolError(Exception):
    """Client-side request problem -> HTTP 4xx."""

    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = int(status)
        self.err_type = err_type


@dataclass
class CompletionRequest:
    prompt_ids: np.ndarray
    sampling: SamplingParams
    stream: bool
    # optional CLIENT-named ticket id (observability: the id is the
    # engine request id on every replica, so a client that names its
    # request can pull `GET /debug/requests/<id>` afterwards without
    # parsing the response first); None = server-assigned `cmpl-N`
    request_id: Optional[str] = None
    # multi-tenant LoRA serving: which registered fine-tune to decode
    # under (the OpenAI-style `model` field). None = the base model;
    # the server maps the name through the fleet's adapter registry
    # (404 on an unknown name) and sets sampling.adapter_id, so the
    # tenant identity rides migration/preemption with the sampling.
    model: Optional[str] = None


# client-supplied request ids: URL-safe, bounded (they ride in debug
# paths and Prometheus-adjacent surfaces — no exotic bytes)
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9_.:-]{1,128}$")


def _get(payload: dict, key: str, types, default=None):
    v = payload.get(key, default)
    if v is not None and not isinstance(v, types):
        raise ProtocolError(400, f"field {key!r} has wrong type "
                            f"({type(v).__name__})")
    return v


def _parse_response_format(payload: dict) -> Optional[GrammarSpec]:
    """OpenAI-style `response_format` -> a `GrammarSpec` for the
    engine's grammar-constrained decoding. Every malformed shape is a
    typed 400 with err_type "invalid_grammar" — clients distinguish a
    bad grammar from a bad request without string-matching."""
    rf = payload.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise ProtocolError(400, "\"response_format\" must be an "
                            "object", "invalid_grammar")
    kind = rf.get("type")
    if kind == "text":
        return None
    if kind not in ("json_object", "choice", "regex"):
        raise ProtocolError(
            400, "\"response_format\".type must be one of "
            "\"text\", \"json_object\", \"choice\", \"regex\"",
            "invalid_grammar")
    choices = rf.get("choices")
    if choices is not None:
        if (not isinstance(choices, list)
                or not all(isinstance(c, str) for c in choices)):
            raise ProtocolError(
                400, "\"response_format\".choices must be a list of "
                "strings", "invalid_grammar")
        choices = tuple(choices)
    pattern = rf.get("pattern")
    if pattern is not None and not isinstance(pattern, str):
        raise ProtocolError(400, "\"response_format\".pattern must be "
                            "a string", "invalid_grammar")
    try:
        return GrammarSpec(kind=kind, choices=choices, pattern=pattern)
    except ValueError as e:
        raise ProtocolError(400, str(e), "invalid_grammar")


def parse_completion_request(raw: bytes) -> CompletionRequest:
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, f"request body is not JSON: {e}")
    if not isinstance(payload, dict):
        raise ProtocolError(400, "request body must be a JSON object")
    prompt = payload.get("prompt")
    if isinstance(prompt, str):
        raise ProtocolError(
            400, "string prompts are not supported: this endpoint "
            "serves token ids; send \"prompt\": [int, ...]")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) for t in prompt)):
        raise ProtocolError(400, "\"prompt\" must be a non-empty list "
                            "of token ids")
    max_tokens = _get(payload, "max_tokens", int, 16)
    temperature = _get(payload, "temperature", (int, float), 1.0)
    top_k = _get(payload, "top_k", int)
    top_p = _get(payload, "top_p", (int, float))
    eos = _get(payload, "eos_token_id", int)
    timeout = _get(payload, "timeout", (int, float))
    priority = _get(payload, "priority", int, 0)
    deadline = _get(payload, "deadline", (int, float))
    stream = bool(_get(payload, "stream", bool, False))
    request_id = _get(payload, "request_id", str)
    model = _get(payload, "model", str)
    session = _get(payload, "session", str)
    grammar = _parse_response_format(payload)
    if grammar is not None and eos is None:
        raise ProtocolError(
            400, "\"response_format\" requires \"eos_token_id\": a "
            "constrained stream terminates only via EOS in an "
            "accepting state", "invalid_grammar")
    if request_id is not None and not _REQUEST_ID_RE.match(request_id):
        raise ProtocolError(
            400, "\"request_id\" must match [A-Za-z0-9_.:-]{1,128}")
    if timeout is not None and (timeout <= 0
                                or not math.isfinite(timeout)):
        raise ProtocolError(400, "\"timeout\" must be a positive "
                            "finite number of seconds")
    if deadline is not None and (deadline <= 0
                                 or not math.isfinite(deadline)):
        raise ProtocolError(400, "\"deadline\" must be a positive "
                            "finite number of seconds")
    try:
        sampling = SamplingParams(
            max_new_tokens=max_tokens,
            temperature=float(temperature),
            top_k=top_k,
            top_p=None if top_p is None else float(top_p),
            greedy=bool(payload.get("greedy", True)),
            eos_token_id=eos,
            timeout_s=None if timeout is None else float(timeout),
            priority=int(priority),
            deadline_s=None if deadline is None else float(deadline),
            grammar=grammar,
            session=session)
    except ValueError as e:
        raise ProtocolError(400, str(e),
                            "invalid_grammar" if grammar is not None
                            else "invalid_request_error")
    return CompletionRequest(
        prompt_ids=np.asarray(prompt, dtype=np.int64),
        sampling=sampling, stream=stream, request_id=request_id,
        model=model)


def parse_embeddings_request(raw: bytes) -> CompletionRequest:
    """`POST /v1/embeddings`: `{"input": [token ids]}` (OpenAI-shaped;
    same token-id convention as completions). Rides the completion
    plumbing as a prefill-only request — `sampling.embed=True`, the
    engine pools the final hidden state and retires the row at cursor
    end without ever decoding."""
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, f"request body is not JSON: {e}")
    if not isinstance(payload, dict):
        raise ProtocolError(400, "request body must be a JSON object")
    inp = payload.get("input")
    if isinstance(inp, str):
        raise ProtocolError(
            400, "string inputs are not supported: this endpoint "
            "serves token ids; send \"input\": [int, ...]")
    if (not isinstance(inp, list) or not inp
            or not all(isinstance(t, int) for t in inp)):
        raise ProtocolError(400, "\"input\" must be a non-empty list "
                            "of token ids")
    timeout = _get(payload, "timeout", (int, float))
    if timeout is not None and (timeout <= 0
                                or not math.isfinite(timeout)):
        raise ProtocolError(400, "\"timeout\" must be a positive "
                            "finite number of seconds")
    request_id = _get(payload, "request_id", str)
    model = _get(payload, "model", str)
    session = _get(payload, "session", str)
    priority = _get(payload, "priority", int, 0)
    if request_id is not None and not _REQUEST_ID_RE.match(request_id):
        raise ProtocolError(
            400, "\"request_id\" must match [A-Za-z0-9_.:-]{1,128}")
    try:
        sampling = SamplingParams(
            max_new_tokens=1, embed=True,
            timeout_s=None if timeout is None else float(timeout),
            priority=int(priority), session=session)
    except ValueError as e:
        raise ProtocolError(400, str(e))
    return CompletionRequest(
        prompt_ids=np.asarray(inp, dtype=np.int64),
        sampling=sampling, stream=False, request_id=request_id,
        model=model)


def embeddings_body(ticket_id: str, model: str,
                    out: RequestOutput) -> dict:
    emb = getattr(out, "embedding", None)
    vec = [] if emb is None else [float(v) for v in np.asarray(emb)]
    return {
        "object": "list",
        "data": [{"object": "embedding", "index": 0,
                  "embedding": vec}],
        "id": ticket_id,
        "model": model,
        "usage": {"prompt_tokens": len(out.prompt_token_ids),
                  "total_tokens": len(out.prompt_token_ids),
                  "cached_tokens": int(
                      getattr(out, "cached_tokens", 0) or 0)},
    }


# -- responses -------------------------------------------------------------
def _usage(out: RequestOutput) -> dict:
    # cached_tokens: prompt tokens served from the engine's prefix
    # cache (shared KV pages; zero prefill work) — the OpenAI-style
    # cache-hit accounting knob clients use to verify prompt reuse
    return {"prompt_tokens": len(out.prompt_token_ids),
            "completion_tokens": len(out.token_ids),
            "total_tokens": len(out.prompt_token_ids)
            + len(out.token_ids),
            "cached_tokens": int(getattr(out, "cached_tokens", 0) or 0),
            # completion tokens that arrived as VERIFIED speculative
            # drafts (speculative decoding; each one skipped a full
            # decode step and is still exactly the greedy token)
            "accepted_draft_tokens": int(
                getattr(out, "accepted_draft_tokens", 0) or 0),
            # mid-stream replica migrations this request survived
            # (each one a token-identical continuation on a survivor)
            "migrations": int(getattr(out, "migrations", 0) or 0),
            # overload preemptions this request survived (banked +
            # swapped to the host tier + resumed, token-identically)
            "preemptions": int(getattr(out, "preemptions", 0) or 0)}


def completion_body(ticket_id: str, model: str,
                    out: RequestOutput) -> dict:
    return {
        "id": ticket_id,
        "object": "text_completion",
        "model": model,
        "choices": [{"index": 0, "token_ids": out.token_ids,
                     "finish_reason": out.finish_reason}],
        "usage": _usage(out),
        "timing": {"ttft_s": out.ttft_s,
                   "queue_wait_s": out.queue_wait_s,
                   "e2e_s": out.e2e_s},
    }


def stream_chunk(ticket_id: str, model: str, token: int) -> dict:
    return {"id": ticket_id, "object": "text_completion.chunk",
            "model": model,
            "choices": [{"index": 0, "token": int(token),
                         "finish_reason": None}]}


def stream_final(ticket_id: str, model: str,
                 out: RequestOutput) -> dict:
    return {"id": ticket_id, "object": "text_completion.chunk",
            "model": model,
            "choices": [{"index": 0, "token": None,
                         "finish_reason": out.finish_reason}],
            "usage": _usage(out)}


def sse(data: dict) -> bytes:
    return b"data: " + json.dumps(data).encode("utf-8") + b"\n\n"


def error_body(status: int, message: str,
               err_type: str = "server_error") -> dict:
    return {"error": {"message": message, "type": err_type,
                      "code": int(status)}}


def status_for_error(exc: BaseException) -> int:
    if isinstance(exc, ProtocolError):
        return exc.status
    if isinstance(exc, (QueueFull, RateLimited)):
        return 429
    if isinstance(exc, PoisonedRequest):
        return 422
    if isinstance(exc, DeadlineExceeded):
        return 504
    if isinstance(exc, ReplicaDead):
        return 502
    if isinstance(exc, EngineClosed):
        return 503
    return 500


def status_for_output(out: RequestOutput) -> int:
    """Status of a completed non-stream request. A deadline that fired
    while the request was still QUEUED (zero tokens) is load shedding
    -> 503; a mid-decode timeout returns the partial output as 200 with
    finish_reason "timeout". "replica_failure" surfaces only after
    failover AND migration were exhausted -> 502; "poisoned" (the
    request itself kills the serving step; quarantined, never
    retried) -> 422."""
    if out.finish_reason in ("stop", "length"):
        return 200
    if out.finish_reason == "timeout":
        return 503 if not out.token_ids else 200
    if out.finish_reason == "deadline":
        # the placement deadline expired while queued: by construction
        # zero tokens — the overload fail-fast, distinct from 429
        # (shed at the door) and 503 (not admitting at all)
        return 504
    if out.finish_reason == "replica_failure":
        return 502
    if out.finish_reason == "poisoned":
        return 422
    return 503          # "aborted" (drain), "cancelled", unknown
