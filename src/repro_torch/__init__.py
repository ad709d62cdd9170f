"""PyTorch + CUDA port of the two-stage hierarchical retrieval engine.

The JAX package `repro` is the reference; this package mirrors its layout
(`core/`, `kernels/`, `data/`) so each module has a counterpart at the same
relative path. It imports torch and numpy only. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; with no CUDA device
and no explicit CPU request they raise (see `resolve_device`).
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
