"""Renderer 1 — batched XLA renderer.

The reference's first device rung keeps the identical per-ray algorithm and
moves it onto the GPU one thread per pixel (reference: GPURenderer1.cu:30-63).
Here it is one *vectorized* XLA program over the whole ray bundle: all rays
march in lockstep under a single ``lax.while_loop`` with per-ray masks
standing in for per-thread ``break``, and a whole-bundle early exit once
every ray has terminated — ERT/ESL become mask updates instead of control
flow. Volume taps are XLA gathers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from volrt.core import esl as esl_mod
from volrt.core import rays as rays_mod
from volrt.core import sampling
from volrt.core.types import Raycaster
from volrt.renderers.common import classify_and_shade, composite

NAME = "xla-batched"


def esl_start(
    rc: Raycaster, origins: jax.Array, directions: jax.Array,
    knear: jax.Array, kfar: jax.Array, hit: jax.Array,
) -> jax.Array:
    """Vectorized empty-space-leaping start offsets.

    Replays the reference's leading leap loop (reference: CPURenderer.cpp:18-25)
    for every ray in lockstep; the loop exits when every ray has left its
    leading empty region. Leap distances are quantized to whole steps so the
    sampling lattice phase is preserved per ray.
    """
    return esl_start_raw(
        rc.esl_empty, rc.volume.dims, rc.esl_block_dims, rc.esl_block_size,
        rc.ray_step, origins, directions, knear, kfar, hit)


def esl_start_raw(
    esl_empty: jax.Array, dims, block: int, block_size, step: float,
    origins: jax.Array, directions: jax.Array,
    knear: jax.Array, kfar: jax.Array, hit: jax.Array,
) -> jax.Array:
    """:func:`esl_start` from raw components (no Raycaster — used by the
    differentiable path, whose scene is a float density grid).

    Leaps are sphere-tracing style: a Chebyshev distance field over the
    block grid (:func:`volrt.core.esl.empty_distance_grid`) lets a ray
    ``m`` blocks from the nearest non-empty block cross ``m - 1`` block
    widths in one leap, so wide empty regions cost O(1) lockstep
    iterations instead of one per block (the reference leaps a single
    block per loop pass, RaycasterBase.h:67-85). Every leap is quantized
    down to whole ray steps, and every skipped lattice sample provably
    lies in an empty block — images are unchanged.
    """
    from volrt.core.sampling import world_to_voxel_idx

    dist = esl_mod.empty_distance_grid(esl_empty)  # int32 (32, 32, 32)
    min_bw = jnp.min(jnp.asarray(block_size, jnp.float32))
    # Perspective ray directions are unnormalized (reference quirk,
    # ViewBase.h:28): convert the world-space safe radius to parametric.
    dnorm = jnp.sqrt(jnp.sum(directions * directions, axis=-1) + 1e-20)

    def cond(state):
        _, stopped = state
        return ~jnp.all(stopped)

    def body(state):
        k, stopped = state
        pt = origins + directions * k[..., None]
        in_range = k <= kfar
        idx = world_to_voxel_idx(pt, dims) // block
        m = dist[idx[..., 2], idx[..., 1], idx[..., 0]]
        do_leap = in_range & (m >= 1) & ~stopped
        dk = esl_mod.leap_distance(
            pt, directions, dims, block, block_size, step)
        # Chebyshev-ball leap: (m-1) block widths from pt stay empty.
        ball = jnp.floor(
            (m - 1).astype(jnp.float32) * min_bw / dnorm / step) * step
        k = jnp.where(do_leap, k + jnp.maximum(dk, ball) + step, k)
        return k, stopped | ~do_leap

    k0, _ = jax.lax.while_loop(cond, body, (knear, ~hit))
    return k0


def march(rc: Raycaster, o: jax.Array, d: jax.Array) -> jax.Array:
    """March the rays ``o, d: f32[N, 3]`` -> premultiplied RGBA ``f32[N, 4]``.

    One lockstep ``while_loop`` over the whole bundle; it exits once every
    ray has terminated (ERT) or left the volume."""
    knear, kfar, hit = rays_mod.intersect_aabb(o, d, rc.volume.min_bound)

    if rc.esl:
        k0 = esl_start(rc, o, d, knear, kfar, hit)
    else:
        k0 = knear
    step = rc.ray_step

    def cond(state):
        _, _, alive = state
        return jnp.any(alive)

    def body(state):
        k, acc, alive = state
        pt = o + d * k[..., None]
        color = classify_and_shade(rc, pt, d)
        acc = jnp.where(alive[..., None], composite(acc, color), acc)
        ert = acc[..., 3] > rc.ray_threshold
        k = k + step
        alive = alive & ~ert & (k <= kfar)
        return k, acc, alive

    acc0 = jnp.zeros((o.shape[0], 4), jnp.float32)
    alive0 = hit & (k0 <= kfar)
    _, acc, _ = jax.lax.while_loop(cond, body, (k0, acc0, alive0))
    return acc


@jax.jit
def render_float(rc: Raycaster) -> jax.Array:
    """Render to a float RGBA image ``f32[H, W, 4]``."""
    origins, directions = rays_mod.get_rays(rc.view)
    w, h = rc.view.dims
    acc = march(rc, origins.reshape(-1, 3), directions.reshape(-1, 3))
    return acc.reshape(h, w, 4)


def render(rc: Raycaster) -> jax.Array:
    """Render to ``uint8[H, W, 4]``."""
    return sampling.write_color(render_float(rc))
