"""Empty-space-leaping (ESL) min-max block grid.

Vectorized rebuild of the reference's ESL machinery: the O(N^3) host triple
loop that builds a 32^3 per-block min/max table (reference:
RaycasterBase.cpp:94-125) becomes a padded block-reshape + reduction that XLA
vectorizes, and the packed uint32 bitmask (reference: RaycasterBase.cpp:62-67)
becomes a dense ``bool[32, 32, 32]`` emptiness grid. ``pack_bitmask`` /
``unpack_bitmask`` provide the exact reference layout for parity tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from volrt.constants import ESL_VOLUME_DIMS, TF_RATIO
from volrt.core.tf import first_opaque_index
from volrt.core.types import Volume


def build_min_max_grid(volume: Volume, block_dims: int) -> jax.Array:
    """Per-block (min, max) voxel values as ``uint8[32, 32, 32, 2]``.

    Blocks outside the volume extent keep the init values ``(255, 0)``,
    matching the reference init loop (reference: RaycasterBase.cpp:101-104).
    """
    w, h, d = volume.dims
    b = block_dims
    nbx = -(-w // b)
    nby = -(-h // b)
    nbz = -(-d // b)
    if max(nbx, nby, nbz) > ESL_VOLUME_DIMS:
        raise ValueError(
            f"volume {volume.dims} with block {b} exceeds the "
            f"{ESL_VOLUME_DIMS}^3 ESL grid"
        )
    data = volume.data  # (D, H, W) uint8

    pad = ((0, nbz * b - d), (0, nby * b - h), (0, nbx * b - w))
    data_min = jnp.pad(data, pad, constant_values=255)
    data_max = jnp.pad(data, pad, constant_values=0)

    def block_reduce(x, op):
        x = x.reshape(nbz, b, nby, b, nbx, b)
        return op(x, axis=(1, 3, 5))

    bmin = block_reduce(data_min, jnp.min)
    bmax = block_reduce(data_max, jnp.max)

    full_min = jnp.full((ESL_VOLUME_DIMS,) * 3, 255, jnp.uint8)
    full_max = jnp.zeros((ESL_VOLUME_DIMS,) * 3, jnp.uint8)
    full_min = full_min.at[:nbz, :nby, :nbx].set(bmin)
    full_max = full_max.at[:nbz, :nby, :nbx].set(bmax)
    return jnp.stack([full_min, full_max], axis=-1)


def derive_empty_grid(min_max: jax.Array, premult_tf: jax.Array) -> jax.Array:
    """Per-block emptiness under the current transfer function.

    A block is empty iff no value in its [min, max] range maps to nonzero
    opacity: ``first_opaque[min/TF_RATIO] > max/TF_RATIO``
    (reference: RaycasterBase.cpp:62-67). Returns ``bool[32, 32, 32]``.
    """
    first_opaque = first_opaque_index(premult_tf)  # int32[TF_SIZE]
    lo_bucket = (min_max[..., 0].astype(jnp.int32)) // TF_RATIO
    hi_bucket = (min_max[..., 1].astype(jnp.int32)) // TF_RATIO
    return first_opaque[lo_bucket] > hi_bucket


def pack_bitmask(empty: jax.Array) -> jax.Array:
    """Pack ``bool[32,32,32]`` into the reference's ``uint32[1024]`` layout:
    word index ``z*32 + y``, bit ``x`` (reference: RaycasterBase.h:59-64)."""
    bits = empty.astype(jnp.uint32)  # (z, y, x)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    words = jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)  # (z, y)
    return words.reshape(-1)


def unpack_bitmask(words: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_bitmask`."""
    words = words.reshape(ESL_VOLUME_DIMS, ESL_VOLUME_DIMS, 1)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return ((words >> shifts) & 1).astype(jnp.bool_)


def empty_distance_grid(empty: jax.Array) -> jax.Array:
    """Chebyshev distance (in blocks) to the nearest non-empty block.

    ``dist == 0`` at non-empty blocks; ``dist == m >= 1`` guarantees every
    block within max-norm radius ``m - 1`` is empty. Built by iterated
    3x3x3 min-dilation (``reduce_window``) over the 32^3 grid — the
    vectorized distance transform that upgrades the reference's
    one-block-at-a-time leap (RaycasterBase.h:67-85) into multi-block
    sphere-tracing leaps. No reference counterpart.
    """
    n = ESL_VOLUME_DIMS
    d0 = jnp.where(empty, jnp.int32(n), jnp.int32(0))

    def body(_, d):
        m = jax.lax.reduce_window(
            d, jnp.int32(n), jax.lax.min,
            (3, 3, 3), (1, 1, 1), "SAME")
        return jnp.minimum(d, m + 1)

    return jax.lax.fori_loop(0, n - 1, body, d0)


def sample_empty(
    empty: jax.Array,
    pos: jax.Array,
    dims: tuple[int, int, int],
    block_dims: int,
) -> jax.Array:
    """Is the ESL block containing world position ``pos`` empty?

    Vectorized equivalent of ``sample_data_esl`` (reference:
    RaycasterBase.h:52-65). ``pos`` is ``(..., 3)``; returns bool ``(...)``.
    """
    from volrt.core.sampling import world_to_voxel_idx

    idx = world_to_voxel_idx(pos, dims) // block_dims
    bx, by, bz = idx[..., 0], idx[..., 1], idx[..., 2]
    return empty[bz, by, bx]


def leap_distance(
    pos: jax.Array,
    directions: jax.Array,
    dims: tuple[int, int, int],
    block_dims: int,
    block_size: tuple[float, float, float],
    ray_step: float,
    min_bound: tuple[float, float, float] = (-1.0, -1.0, -1.0),
) -> jax.Array:
    """Parametric distance to leap to the current ESL block's exit boundary,
    quantized down to a whole number of ray steps so the sampling lattice
    phase is preserved (reference: RaycasterBase.h:67-85).

    ``pos``/``directions`` are ``(..., 3)``; returns f32 ``(...)``.
    """
    from volrt.core.sampling import world_to_voxel_idx

    idx = world_to_voxel_idx(pos, dims) // block_dims  # (..., 3) int32
    # Step to the far face along axes the ray moves positively.
    idx = idx + (directions > 0.0).astype(jnp.int32)
    boundary = jnp.asarray(min_bound, jnp.float32) + (
        jnp.asarray(block_size, jnp.float32) * idx.astype(jnp.float32)
    )
    kp = (boundary - pos) / directions
    kp = jnp.where(directions == 0.0, 100.0, kp)  # reference lines 77-79
    dk = jnp.maximum(jnp.min(kp, axis=-1), 0.0)
    return jnp.floor(dk / ray_step) * ray_step
