"""Reusable batched numerical ops: the bracketed root finds and the
condensation kernel (pallas_cond)."""

from . import rootfind

__all__ = ["rootfind"]
