"""Draft-then-verify speculative decoding for the serving engine
(counterpart of `paddle_tpu/serving/spec.py`; numpy only).

A decoding slot otherwise emits one token per step. Speculative
decoding lets a cheap DRAFTER propose up to `k` likely next tokens from
the request's own history; the engine feeds `[sampled, draft_1 ..
draft_k]` as one `q_len = 1 + k` row of the same unified ragged step,
and greedy acceptance keeps the longest prefix of drafts that matches
the model's own argmax chain. Every accepted draft is a token the
sequential path would have produced in its own step; a rejected draft's
K/V stays past the row's new position and is overwritten by the next
real token before anything attends it. Outputs stay token for token
those of one-at-a-time greedy decoding.

- `Drafter` (ABC): the per-request proposal source, made at admission
  (and again at resume, from the banked history).
- `NgramDrafter`: prompt lookup over the request's prompt + output. It
  finds the most recent previous occurrence of the history's tail
  n-gram and proposes what followed it, unrolling the implied period
  where the match overlaps the tail, so a repeating pattern drafts a
  full `k`.
- `ModelDrafter`: the marker of the draft-MODEL tier ("model[:k]"): the
  engine's resident `serving.draft.DraftEngine` proposes for every such
  row in one batched call per micro-step; standalone `propose` proposes
  nothing.
- `SpecConfig`: `k`, the drafter factory, the `mode` tag and, for the
  model tier, an optional `draft_model`.

Gated `PADDLE_TPU_SPEC_DECODE=off|ngram[:k]|model[:k]` (default off) or
`ServingEngine(spec=...)`; the verify row is a unified-step row, so the
legacy step refuses it. Only greedy rows speculate: a sampled row would
need rejection sampling to keep its distribution.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np

__all__ = ["Drafter", "NgramDrafter", "ModelDrafter", "SpecConfig",
           "resolve_spec_config", "SPEC_DECODE_ENV", "SPEC_MODES"]

SPEC_DECODE_ENV = "PADDLE_TPU_SPEC_DECODE"
SPEC_MODES = ("off", "ngram", "model")

# the sentence every malformed-spec ValueError ends with
_LEGAL_FORMS = ("legal forms: 'off', 'ngram', 'ngram:<k>', 'model', "
                "'model:<k>' with integer k >= 1")

_EMPTY = np.empty((0,), np.int64)


class Drafter(ABC):
    """Per-request proposal source. The engine calls `propose` once a
    step with the request's committed history (prompt + every emitted
    token). Proposals are speculative: the engine may pack fewer, and
    the verify pass may reject any suffix."""

    @abstractmethod
    def propose(self, history: np.ndarray, k: int,
                budget: Optional[int] = None) -> np.ndarray:
        """Up to `k` proposed next token ids (an int array, maybe empty)
        after the committed `history` (1-D, never empty). `budget` (None
        = unlimited) is the request's remaining emission budget past the
        step's own sampled token: drafts past it are dead verify work.
        The engine falls back to the two-argument form for drafters
        without it."""


class NgramDrafter(Drafter):
    """Prompt-lookup drafter (n-gram suffix matching): the most recent
    PREVIOUS occurrence of the history's final `n`-gram (longest `n`
    first, `max_ngram` down to `min_ngram`), continued cyclically with
    the period `d = tail_start - match_start`: draft i is
    `history[match_start + n + (i % d)]`. A distant match reads the
    plain following window; a match overlapping the tail unrolls the
    repeating pattern to all `k` drafts. Stateless between calls."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1:
            raise ValueError("min_ngram must be >= 1")
        if max_ngram < min_ngram:
            raise ValueError("max_ngram must be >= min_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history: np.ndarray, k: int,
                budget: Optional[int] = None) -> np.ndarray:
        if budget is not None:
            k = min(int(k), max(0, int(budget)))
        h = np.asarray(history).reshape(-1).astype(np.int64)
        n_h = int(h.size)
        if k <= 0 or n_h < self.min_ngram + 1:
            return _EMPTY
        for n in range(min(self.max_ngram, n_h - 1),
                       self.min_ngram - 1, -1):
            tail = h[n_h - n:]
            # windows over h[:-1]: every previous occurrence, overlapping
            # the tail allowed (the overlap is the period detection)
            wins = np.lib.stride_tricks.sliding_window_view(
                h[:n_h - 1], n)
            hits = np.nonzero((wins == tail).all(axis=1))[0]
            if hits.size == 0:
                continue
            p = int(hits[-1])              # the most recent occurrence
            d = (n_h - n) - p              # the implied period, >= 1
            return h[p + n + (np.arange(k) % d)]
        return _EMPTY


class ModelDrafter(Drafter):
    """Marker drafter of the resident draft-MODEL tier: the engine routes
    every slot whose drafter is a ModelDrafter through one batched
    `DraftEngine.propose_batch` call a step. It holds no state; outside
    an engine it has no draft K/V to decode from and proposes
    nothing."""

    def propose(self, history: np.ndarray, k: int,
                budget: Optional[int] = None) -> np.ndarray:
        return _EMPTY


def _default_drafter() -> Drafter:
    return NgramDrafter()


def _model_drafter() -> Drafter:
    return ModelDrafter()


_DRAFTER_FACTORIES = {"ngram": _default_drafter, "model": _model_drafter}


@dataclass
class SpecConfig:
    """The engine's speculative-decoding knobs: `k` drafts a slot a step
    (further capped by the step width and the request's remaining
    budget); `drafter`, a zero-argument factory of one `Drafter` a
    request, or a tier name ("ngram" / "model", which also sets `mode`);
    `mode`, the tag the metrics report; `draft_model` (model tier), the
    resident draft model, None to shrink one from the target
    (`serving.draft.make_draft_model`)."""

    k: int = 4
    drafter: Union[str, Callable[[], Drafter]] = \
        field(default=_default_drafter)
    mode: str = "ngram"
    draft_model: Optional[object] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec k must be >= 1")
        if isinstance(self.drafter, str):
            if self.drafter not in _DRAFTER_FACTORIES:
                raise ValueError(
                    f"unknown drafter tier {self.drafter!r}: expected "
                    f"one of {tuple(_DRAFTER_FACTORIES)}")
            self.mode = self.drafter
            self.drafter = _DRAFTER_FACTORIES[self.mode]

    def make_drafter(self) -> Drafter:
        d = self.drafter()
        if not isinstance(d, Drafter):
            raise TypeError(
                f"spec drafter factory returned {type(d).__name__}, "
                "not a serving.spec.Drafter")
        return d


def resolve_spec_config(override=None) -> Optional[SpecConfig]:
    """The speculative-decoding gate as a SpecConfig (on) or None (off).
    An explicit override wins: a SpecConfig, a mode string ("off",
    "ngram", "ngram:8", "model", "model:6") or a bool (True = the default
    ngram config); None reads PADDLE_TPU_SPEC_DECODE (default off).
    Every malformed spelling raises ValueError naming the legal forms;
    another type raises TypeError."""
    if override is None:
        spec = os.environ.get(SPEC_DECODE_ENV, "off")
    elif isinstance(override, SpecConfig):
        return override
    elif isinstance(override, bool):
        return SpecConfig() if override else None
    elif isinstance(override, str):
        spec = override
    else:
        raise TypeError(
            f"spec must be None, bool, str or SpecConfig, got "
            f"{type(override).__name__}")
    mode, sep, knob = spec.partition(":")
    if mode not in SPEC_MODES:
        raise ValueError(
            f"invalid {SPEC_DECODE_ENV} spec {spec!r}: unknown mode "
            f"{mode!r}; {_LEGAL_FORMS}")
    if mode == "off":
        if sep:
            raise ValueError(
                f"invalid {SPEC_DECODE_ENV} spec {spec!r}: 'off' "
                f"takes no ':k' suffix; {_LEGAL_FORMS}")
        return None
    if sep and not knob:
        raise ValueError(
            f"invalid {SPEC_DECODE_ENV} spec {spec!r}: empty ':k' "
            f"suffix; {_LEGAL_FORMS}")
    k = None
    if knob:
        try:
            k = int(knob)
        except ValueError:
            raise ValueError(
                f"invalid {SPEC_DECODE_ENV} spec {spec!r}: ':k' "
                f"suffix must be an integer; {_LEGAL_FORMS}") from None
        if k < 1:
            raise ValueError(
                f"invalid {SPEC_DECODE_ENV} spec {spec!r}: k must be "
                f">= 1; {_LEGAL_FORMS}")
    kw = {} if k is None else {"k": k}
    if mode == "model":
        return SpecConfig(drafter="model", **kw)
    return SpecConfig(**kw)
