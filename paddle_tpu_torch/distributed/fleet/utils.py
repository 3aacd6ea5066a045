"""Activation checkpointing (counterpart of
`paddle_tpu/distributed/fleet/utils.py`: `recompute` and
`recompute_sequential`).

`recompute(function, *args, **kwargs)` runs `function` keeping none of
its activations for the backward; the backward runs it again to rebuild
them (`torch.utils.checkpoint`, non-reentrant), the FLOPs-for-memory
trade the JAX package makes with `jax.checkpoint`. Parameters the
function reaches get their gradients by autograd, so nothing is lifted
as the JAX `_closure_state` lifts it.

The rerun must draw what the forward drew. The port's dropout and flash
dropout draw from explicit `torch.Generator`s (GPT's model-owned one),
which `torch.utils.checkpoint`'s `preserve_rng_state` does not cover: so
the state of every generator among the arguments is saved before the
forward and restored for the rerun, and after the rerun each is put back
where it stood, where a forward without recompute would have left it.
The JAX package gets the same by pushing one trace key into the
function (fleet/utils.py:88). `use_reentrant` and `preserve_rng_state`
are taken and ignored, as JAX pops them; torch's default generators are
always preserved.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential"]


def recompute(function: Callable, *args, **kwargs):
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    gens = [a for a in (*args, *kwargs.values())
            if isinstance(a, torch.Generator)]
    states = [g.get_state() for g in gens]
    runs = []

    def run(*a, **kw):
        if not runs:                      # the forward
            runs.append(True)
            return function(*a, **kw)
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, states):
            g.set_state(s)
        try:
            return function(*a, **kw)
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=True, **kwargs)


def recompute_sequential(ctx, functions: Sequence[Callable], *args):
    """`functions` run in sequence, in `ctx["segments"]` segments (1 by
    default) of len // segments functions each, every segment under
    `recompute` (the JAX counterpart's split)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    functions = list(functions)
    n = len(functions)
    per = max(n // segments, 1)
    x = args[0] if len(args) == 1 else args

    def seg_fn(layers):
        def run(v):
            for layer in layers:
                v = layer(v)
            return v
        return run

    for i in range(0, n, per):
        x = recompute(seg_fn(functions[i:i + per]), x)
    return x
