"""Operation and byte counts of an eager program: the serving engine's
"lowered" cost census (`serving/slo.py`).

`count_cost(fn, *args)` runs `fn` once under a `TorchDispatchMode` and
returns the FLOPs and bytes of what it ran:

- a torch op's FLOPs are `torch.utils.flop_counter`'s (the registry
  `FlopCounterMode` reads: matrix products, convolutions, attention;
  elementwise ops count none), its bytes those of its distinct tensor
  operands and results (view ops move nothing and count nothing);
- a hand-written kernel's wrapper, marked with `@kernel_cost(work)`,
  adds its kernel's FLOPs and bytes, reckoned from its operands' shapes
  by `work` (the arithmetic `chip_smoke.py`'s `bound()` uses: each input
  read once, each output written once; a paged walk at its table's full
  capacity, so the count is shape arithmetic), and nothing it runs
  inside is counted: neither the kernel's glue on the card nor the plain
  version that stands in for the kernel on the CPU. So the CPU and the
  card count the same program.

A count belongs to the thread that runs it, as PyTorch's dispatch modes
do: a wrapper called on another thread meanwhile is not counted. With no
count running a marked wrapper costs one attribute read a call.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["CostCounter", "count_cost", "kernel_cost", "nbytes"]

# per thread: `stack`, the counts running there, innermost last
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of the ops dispatched while it is entered, plus
    the kernels the marked wrappers report (`kernels`: name -> [calls,
    flops, bytes])."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, list] = {}
        self._paused = 0

    def __enter__(self):
        _stack().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _stack().remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or getattr(func, "is_view", False):
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        seen = set()
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()),
                       t.dtype)
                if key not in seen:
                    seen.add(key)
                    self.bytes += t.numel() * t.element_size()
        return out

    def add_kernel(self, name: str, flops: float, n_bytes: float):
        k = self.kernels.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += int(flops)
        k[2] += int(n_bytes)
        self.flops += int(flops)
        self.bytes += int(n_bytes)


def count_cost(fn: Callable, *args, **kwargs) -> Tuple[dict, object]:
    """Run fn(*args, **kwargs) once, counting: ({"flops", "bytes_accessed",
    "kernels"}, fn's result)."""
    with CostCounter() as c:
        result = fn(*args, **kwargs)
    return ({"flops": float(c.flops), "bytes_accessed": float(c.bytes),
             "kernels": {k: list(v) for k, v in sorted(c.kernels.items())}},
            result)


def kernel_cost(work: Callable[..., Optional[Tuple[str, float, float]]]):
    """Mark a kernel's wrapper: while a count runs, `work(*args,
    **kwargs)` gives the call's (kernel name, FLOPs, bytes), or None where
    this call runs no hand-written kernel (its torch ops are then counted
    as any others), and the wrapper's own ops go uncounted."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            stack = getattr(_LOCAL, "stack", None)
            if not stack or stack[-1]._paused:
                return fn(*args, **kwargs)
            w = work(*args, **kwargs)
            if w is None:
                return fn(*args, **kwargs)
            c = stack[-1]
            c.add_kernel(*w)
            c._paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                c._paused -= 1
        return wrapper
    return deco


def nbytes(*ts) -> int:
    """The bytes of the tensors given (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)
