"""Core of the port (counterpart of `paddle_tpu/core/`): so far device
resolution and seeded generators."""
from .device import make_generator, resolve_device

__all__ = ["make_generator", "resolve_device"]
