"""The renderer ladder.

Two rungs mirroring the first steps of the reference's renderer set
(reference: Renderer.h:30-80, common.h:16):

  0. ``jax-golden``  — per-ray vmapped reference semantics (CPURenderer analog)
  1. ``xla-batched`` — lockstep vectorized XLA march (GPURenderer1 analog);
                       trilinear or nearest, diffuse or gradient Blinn-Phong

Rung 1 renders the same scene allclose to rung 0 within documented
tolerances.
"""
from __future__ import annotations

from volrt.constants import RENDERER_COUNT


def get_renderer(renderer_id: int):
    """Return the module for a renderer id (lazy imports keep deps light)."""
    if renderer_id == 0:
        from volrt.renderers import golden as mod
    elif renderer_id == 1:
        from volrt.renderers import batched as mod
    else:
        raise ValueError(
            f"renderer id {renderer_id} out of range 0..{RENDERER_COUNT - 1}"
        )
    return mod


def renderer_name(renderer_id: int) -> str:
    return get_renderer(renderer_id).NAME
