"""Distributed (counterpart of `paddle_tpu/distributed/`): so far
`fleet.utils.recompute`; the mesh, collectives and parallel layers are
ROADMAP.md's queue 1, item 13."""
from . import fleet

__all__ = ["fleet"]
