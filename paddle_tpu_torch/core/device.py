"""Device resolution and seeded generators.

Counterpart of `paddle_tpu/core/device.py` and `core/random.py`, cut to
what the serving slice needs. The port's entry points run on the card:
`resolve_device(None)` is "cuda" and raises when CUDA is absent — it
never falls back to the CPU. Callers that want the plain versions on the
CPU (the tests) pass `device="cpu"` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "make_generator"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by "
                "default; pass device='cpu' to run the plain versions "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_generator(seed: int, device: DeviceLike = None
                   ) -> torch.Generator:
    """A `torch.Generator` on `device`, seeded with `seed`."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
