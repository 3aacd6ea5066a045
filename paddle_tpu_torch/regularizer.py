"""Regularizers (counterpart of `paddle_tpu/regularizer.py`).

An optimizer that is not decoupled (`Adam`) folds coeff * p into each
gradient after the clip. The JAX package's optimizers read only the
coefficient (`_decay_coeff`) and never the L1 flag, so an `L1Decay`
folds coeff * p as an `L2Decay` does, not coeff * sign(p); the port
keeps the reference's behaviour.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._l1 = True

    def __repr__(self):
        return f"L1Decay({self._coeff})"


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self._coeff})"
