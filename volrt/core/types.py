"""Core pytree types of the framework.

Design notes:
  * Everything that participates in `jit` tracing is a registered dataclass
    pytree; shape-determining fields (volume dims, viewport dims, projection
    mode, ray step) are static metadata so XLA sees fully static shapes and
    loop bounds.
  * The voxel grid is stored z-major as shape ``(D, H, W)`` = ``[z, y, x]``,
    matching the reference's linearization ``z*W*H + y*W + x``
    (reference: ModelBase.h:17-23).  World positions are ``(x, y, z)`` vectors
    in the cube ``[-1, 1]^3`` (reference: ModelBase.cpp:10-14).
  * The ESL emptiness grid is a dense ``bool[32, 32, 32]`` array ``[z, y, x]``
    rather than the reference's packed uint32 bitmask
    (reference: RaycasterBase.h:52-65) — bit packing is a CUDA constant-memory
    footprint trick; a dense bool grid vectorizes cleanly.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from volrt.constants import (
    DEFAULT_LIGHT_KD,
    DEFAULT_RAY_THRESHOLD,
    DEFAULT_WIN_HEIGHT,
    DEFAULT_WIN_WIDTH,
    ESL_MIN_BLOCK_SIZE,
    ESL_VOLUME_DIMS,
)


def _pytree_dataclass(cls=None, *, meta_fields=()):
    """Register a dataclass as a jax pytree with the given static fields."""
    if cls is None:
        return partial(_pytree_dataclass, meta_fields=meta_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=tuple(meta_fields)
    )
    return cls


@_pytree_dataclass(meta_fields=("dims",))
class Volume:
    """A scalar voxel volume in the unit-ish cube ``[-1, 1]^3``.

    Attributes:
      data: ``uint8[D, H, W]`` voxel grid, ``[z, y, x]`` order.
      dims: static ``(W, H, D)`` — matches the reference's ``dims.{x,y,z}``
        convention (reference: ModelBase.h:14).
    """

    data: jax.Array
    dims: tuple[int, int, int]

    @property
    def min_bound(self) -> tuple[float, float, float]:
        # Reference: ModelBase.cpp:13 — cube is always [-1,1]^3.
        return (-1.0, -1.0, -1.0)

    @property
    def size(self) -> int:
        w, h, d = self.dims
        return w * h * d

    @classmethod
    def from_numpy(cls, arr: np.ndarray) -> "Volume":
        """Build from a ``(D, H, W)`` uint8 array."""
        if arr.ndim != 3:
            raise ValueError(f"expected 3D array, got shape {arr.shape}")
        arr = np.asarray(arr, dtype=np.uint8)
        d, h, w = arr.shape
        return cls(data=jnp.asarray(arr), dims=(w, h, d))


@_pytree_dataclass(meta_fields=("dims", "perspective"))
class View:
    """Projection parameters for one rendered frame.

    Mirrors the reference ``View`` POD (reference: ViewBase.h:14-36):
      dims: static viewport ``(W, H)``.
      origin / direction: camera ray origin and unit forward direction.
      right_plane / up_plane: per-pixel step vectors of the view plane.
      light_pos: point light position.
      perspective: static projection mode flag.
    """

    origin: jax.Array       # f32[3]
    direction: jax.Array    # f32[3]
    right_plane: jax.Array  # f32[3]
    up_plane: jax.Array     # f32[3]
    light_pos: jax.Array    # f32[3]
    dims: tuple[int, int]
    perspective: bool

    @classmethod
    def default(cls) -> "View":
        # Reference: ViewBase.cpp:8-15.
        w, h = DEFAULT_WIN_WIDTH, DEFAULT_WIN_HEIGHT
        step_px = 3.0 / min(w, h)
        return cls(
            origin=jnp.array([0.0, 0.0, 3.0], jnp.float32),
            direction=jnp.array([0.0, 0.0, -1.0], jnp.float32),
            right_plane=jnp.array([0.0, 0.0, -1.0], jnp.float32) * step_px,
            up_plane=jnp.array([0.0, 1.0, 0.0], jnp.float32) * step_px,
            light_pos=jnp.array([0.0, 0.0, 3.0], jnp.float32),
            dims=(w, h),
            perspective=False,
        )


@_pytree_dataclass(
    meta_fields=("ray_step", "esl", "esl_block_dims", "interpolation",
                 "shading")
)
class Raycaster:
    """The full render state for one frame — the framework's central pytree.

    JAX analog of the reference ``Raycaster`` struct
    (reference: RaycasterBase.h:20-31).

    Attributes:
      volume: the voxel grid.
      view: camera/projection.
      transfer_fn: premultiplied RGBA LUT ``f32[TF_SIZE, 4]``
        (reference: RaycasterBase.cpp:46-52).
      ray_step: static march step in world units — static so the march length
        is a compile-time constant (reference: RaycasterBase.h:24).
      ray_threshold: traced ERT opacity threshold (reference: RaycasterBase.h:25).
      esl: static empty-space-leaping flag.
      esl_empty: ``bool[32, 32, 32]`` per-block emptiness, ``[z, y, x]``.
      esl_block_dims: static voxels per ESL block edge
        (reference: RaycasterBase.cpp:97-99).
      light_kd: traced diffuse light intensity.
      interpolation: static ``"nearest"`` (renderers 0-3 semantics: uint8
        sample, bucketed TF) or ``"trilinear"`` (renderer 4 semantics:
        trilinear sample in [0,1], linearly-interpolated TF).
    """

    volume: Volume
    view: View
    transfer_fn: jax.Array   # f32[TF_SIZE, 4] premultiplied
    ray_threshold: jax.Array  # f32 scalar
    esl_empty: jax.Array     # bool[32, 32, 32]
    light_kd: jax.Array      # f32 scalar
    ray_step: float
    esl: bool
    esl_block_dims: int
    interpolation: str
    shading: str = "diffuse"

    @property
    def esl_block_size(self) -> tuple[float, float, float]:
        # Reference: RaycasterBase.cpp:118-122.
        w, h, d = self.volume.dims
        b = float(self.esl_block_dims)
        return (2.0 * b / w, 2.0 * b / h, 2.0 * b / d)

    def replace(self, **kw: Any) -> "Raycaster":
        return dataclasses.replace(self, **kw)


def default_esl_block_dims(dims: tuple[int, int, int]) -> int:
    """Voxels per ESL block edge (reference: RaycasterBase.cpp:97-99)."""
    max_dim = max(dims)
    block = -(-max_dim // ESL_VOLUME_DIMS)  # ceil div
    return max(ESL_MIN_BLOCK_SIZE, block)


def default_ray_step(dims: tuple[int, int, int]) -> float:
    """Auto ray step from the largest dimension (reference: RaycasterBase.cpp:86-92)."""
    max_dim = max(dims)
    step = 2.0 / max_dim
    return step - step / max_dim


def ray_step_limits(dims: tuple[int, int, int]) -> tuple[float, float]:
    """Legal ray-step range (reference: RaycasterBase.cpp:90-91)."""
    step = default_ray_step(dims)
    return (step / 3.0, step * 1.666)


def make_raycaster(
    volume: Volume,
    view: View | None = None,
    base_transfer_fn: jax.Array | None = None,
    *,
    ray_step: float | None = None,
    ray_threshold: float = DEFAULT_RAY_THRESHOLD,
    esl: bool = True,
    light_kd: float = DEFAULT_LIGHT_KD,
    interpolation: str = "nearest",
    shading: str = "diffuse",
) -> Raycaster:
    """Assemble a full render state, deriving ESL grid and TF like the
    reference's ``RaycasterBase::set_volume`` + ``reset_transfer_fn``
    (reference: RaycasterBase.cpp:76-125)."""
    # Imported here to avoid a cycle (tf/esl import types).
    from volrt.core import esl as esl_mod
    from volrt.core import tf as tf_mod

    if view is None:
        view = View.default()
    if base_transfer_fn is None:
        base_transfer_fn = tf_mod.default_transfer_fn()
    if ray_step is None:
        ray_step = default_ray_step(volume.dims)
    if interpolation not in ("nearest", "trilinear"):
        raise ValueError(f"unknown interpolation: {interpolation}")

    premult = tf_mod.premultiply(base_transfer_fn)
    block_dims = default_esl_block_dims(volume.dims)
    min_max = esl_mod.build_min_max_grid(volume, block_dims)
    empty = esl_mod.derive_empty_grid(min_max, premult)
    return Raycaster(
        volume=volume,
        view=view,
        transfer_fn=premult,
        ray_threshold=jnp.float32(ray_threshold),
        esl_empty=empty,
        light_kd=jnp.float32(light_kd),
        ray_step=float(ray_step),
        esl=esl,
        esl_block_dims=block_dims,
        interpolation=interpolation,
        shading=shading,
    )
