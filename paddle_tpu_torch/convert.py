"""Weights from the JAX package into the port.

The JAX package's `model.state_dict()` (or a `.pdparams` pickle written
by its `paddle.save`) is a `{name: array}` mapping whose names the port
keeps (`gpt.layers.0.attn.qkv_proj.weight`, ...). Two things differ:

- Linear weights are stored [in, out] there (`nn/layer/common.py:30`)
  and [out, in] by `torch.nn.Linear`: every 2-D `.weight` outside the
  embedding tables (GPT's `embeddings.*`, Llama's `embed_tokens`) is
  transposed;
- bf16 arrays arrive as `ml_dtypes.bfloat16` numpy arrays, which torch
  cannot read directly: they cross as their 16-bit pattern.

`to_paddle_state_dict` is the inverse, for round trips.
"""
from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_paddle_state_dict", "to_paddle_state_dict",
           "load_pdparams"]

_NAME_TABLE_KEY = "StructuredToParameterName@@"


_EMBEDDINGS = ("embeddings", "embed_tokens")


def _is_linear_weight(name: str, ndim: int) -> bool:
    return ndim == 2 and name.endswith(".weight") and \
        not any(e in name for e in _EMBEDDINGS)


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, np.ndarray):
        return value
    if hasattr(value, "numpy"):          # a framework tensor
        return np.asarray(value.numpy())
    return np.asarray(value)


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def from_paddle_state_dict(params: Mapping[str, object]
                           ) -> Dict[str, torch.Tensor]:
    """{name: array or tensor} of the JAX package -> the port's
    `state_dict` (CPU tensors; `load_state_dict` moves them)."""
    out = {}
    for name, value in params.items():
        if name == _NAME_TABLE_KEY:
            continue
        t = _to_torch(_to_numpy(value))
        if _is_linear_weight(name, t.dim()):
            t = t.t().contiguous()
        out[name] = t
    return out


def to_paddle_state_dict(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The port's `state_dict` -> {name: float32 numpy array} in the JAX
    package's layout."""
    out = {}
    for name, t in state.items():
        t = t.detach().cpu()
        if _is_linear_weight(name, t.dim()):
            t = t.t()
        out[name] = t.float().contiguous().numpy()
    return out


def load_pdparams(path) -> Dict[str, np.ndarray]:
    """Read a `.pdparams` file written by the JAX package's
    `paddle.save`. It is a pickle: load only files you trust. bf16
    checkpoints need `ml_dtypes` installed to unpickle."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return {k: np.asarray(v) for k, v in data.items()
            if k != _NAME_TABLE_KEY}
