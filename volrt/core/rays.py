"""Ray-bundle generation and AABB intersection (vectorized, pure jnp).

Vectorized replacement for the per-pixel ``View::get_ray``
(reference: ViewBase.h:23-35) and the slab-method ``Raycaster::intersect``
(reference: RaycasterBase.h:32-42): instead of one ray per thread we build the
whole bundle as ``(H, W, 3)`` arrays in one vectorized expression, which XLA
fuses into the march.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from volrt.core.types import View


def get_rays(view: View) -> tuple[jax.Array, jax.Array]:
    """Generate the full ray bundle for a viewport.

    Returns ``(origins, directions)`` each of shape ``(H, W, 3)``.

    Matches the reference exactly (reference: ViewBase.h:23-35):
      * pixel offsets are ``pos - dims/2`` with integer division of dims;
      * perspective directions are intentionally NOT normalized
        (reference: ViewBase.h:28 is commented out).
    """
    w, h = view.dims
    # Integer division like the C code's `dims.x / 2` (reference: ViewBase.h:26).
    px = (jnp.arange(w, dtype=jnp.float32) - (w // 2))[None, :, None]  # (1,W,1)
    py = (jnp.arange(h, dtype=jnp.float32) - (h // 2))[:, None, None]  # (H,1,1)
    plane_offset = view.right_plane * px + view.up_plane * py  # (H,W,3)
    if view.perspective:
        origins = jnp.broadcast_to(view.origin, plane_offset.shape)
        directions = view.direction + plane_offset
    else:
        origins = view.origin + plane_offset
        directions = jnp.broadcast_to(view.direction, plane_offset.shape)
    return origins, directions


def intersect_aabb(
    origins: jax.Array,
    directions: jax.Array,
    min_bound: tuple[float, float, float] = (-1.0, -1.0, -1.0),
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Slab-method ray/AABB intersection over a batch of rays.

    Args:
      origins, directions: ``(..., 3)``.
    Returns:
      ``(k_near, k_far, hit)`` with shapes ``(...)``; ``k_near`` is clamped to
      ``>= 0`` (ray origins inside the cube start at the origin).

    Matches the reference slab test including the zero-direction epsilon
    substitution (reference: RaycasterBase.h:32-42).
    """
    lo = jnp.asarray(min_bound, jnp.float32)
    hi = -lo
    # dir components of exactly 0 are replaced by 1e-5 (reference line 33-35).
    d = jnp.where(directions == 0.0, 1e-5, directions)
    k1 = (lo - origins) / d
    k2 = (hi - origins) / d
    knear = jnp.max(jnp.minimum(k1, k2), axis=-1)
    kfar = jnp.min(jnp.maximum(k1, k2), axis=-1)
    knear = jnp.maximum(knear, 0.0)
    hit = (knear < kfar) & (kfar > 0.0)
    return knear, kfar, hit


def max_march_steps(ray_step: float, perspective: bool = False) -> int:
    """Static upper bound on the number of march steps through the cube.

    The chord of the ``[-1,1]^3`` cube is ``2*sqrt(3)``; for unnormalized
    perspective directions the parametric length can only shrink (|dir|>=1 at
    the principal ray and grows off-axis), so the orthographic bound is safe.
    """
    chord = 2.0 * (3.0 ** 0.5)
    return int(chord / ray_step) + 2
