"""Operators of the port; `ops.cuda` holds the hand-written kernels."""
