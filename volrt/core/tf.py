"""Transfer-function pipeline: default ramp, premultiplication, editing ops.

The interactive GLUT TF editor of the reference becomes a pure data API here:
a transfer function is an ``f32[TF_SIZE, 4]`` RGBA LUT that can be edited
functionally, premultiplied, trained by gradient descent, or loaded/saved.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from volrt.constants import TF_RATIO, TF_SIZE


def default_transfer_fn() -> jax.Array:
    """The reference's default RGB ramp TF (reference: RaycasterBase.cpp:76-84).

    R ramps over the first third of the LUT, G the middle, B the last;
    alpha ramps linearly but is zeroed below ``255*0.1/TF_RATIO``.
    Returned un-premultiplied ("base") as ``f32[TF_SIZE, 4]``.
    """
    i = np.arange(TF_SIZE, dtype=np.float32)
    third = TF_SIZE // 3
    r = np.where(i <= third, (i * 3) / TF_SIZE, 0.0)
    g = np.where((i > third) & (i <= 2 * third), ((i - third) * 3) / TF_SIZE, 0.0)
    b = np.where(i > 2 * third, ((i - 2 * third) * 3) / TF_SIZE, 0.0)
    a = np.where(i > (255.0 * 0.1) / TF_RATIO, i / TF_SIZE, 0.0)
    return jnp.asarray(np.stack([r, g, b, a], axis=-1), jnp.float32)


def premultiply(base_tf: jax.Array) -> jax.Array:
    """Premultiply RGB by alpha (reference: RaycasterBase.cpp:46-52)."""
    rgb = base_tf[:, :3] * base_tf[:, 3:4]
    return jnp.concatenate([rgb, base_tf[:, 3:4]], axis=-1)


def first_opaque_index(premult_tf: jax.Array) -> jax.Array:
    """For each LUT index x, the first index y >= x with nonzero opacity.

    Vectorized equivalent of the reference's ``esl_temp_tf`` helper table
    (reference: RaycasterBase.cpp:53-61): computed with a reverse cummin over
    indices instead of the O(TF_SIZE^2) nested loop. Entries whose suffix is
    fully transparent get ``TF_SIZE``.
    """
    idx = jnp.arange(TF_SIZE, dtype=jnp.int32)
    cand = jnp.where(premult_tf[:, 3] != 0.0, idx, TF_SIZE)
    # Reverse cumulative minimum: first nonzero-opacity index at or after x.
    return jnp.flip(jax.lax.cummin(jnp.flip(cand)))


def edit_alpha(
    base_tf: jax.Array, lo: int, hi: int, intensity: float
) -> jax.Array:
    """Set the opacity of LUT entries ``[lo, hi]`` like a TF-editor drag.

    The editor maps drag height ``y in [0,1]`` to ``alpha = y**4``
    (reference: UI.cpp:317-340); callers pass the already-curved intensity or
    use :func:`editor_alpha_curve`.
    """
    idx = jnp.arange(TF_SIZE)
    mask = (idx >= lo) & (idx <= hi)
    a = jnp.where(mask, jnp.float32(intensity), base_tf[:, 3])
    return base_tf.at[:, 3].set(a)


def set_colors(base_tf: jax.Array, lo: int, hi: int, rgb) -> jax.Array:
    """Paint the RGB of LUT entries ``[lo, hi]`` (reference: UI.cpp:330-335)."""
    idx = jnp.arange(TF_SIZE)
    mask = ((idx >= lo) & (idx <= hi))[:, None]
    rgb_arr = jnp.broadcast_to(jnp.asarray(rgb, jnp.float32), (TF_SIZE, 3))
    new_rgb = jnp.where(mask, rgb_arr, base_tf[:, :3])
    return jnp.concatenate([new_rgb, base_tf[:, 3:4]], axis=-1)


def editor_alpha_curve(height: jax.Array) -> jax.Array:
    """Editor drag-height -> opacity curve: ``clip(h,0,1)**4``
    (reference: UI.cpp:327-329)."""
    return jnp.clip(height, 0.0, 1.0) ** 4


def save_tf(path: str, base_tf) -> None:
    """Persist a base (un-premultiplied) TF LUT as .npy — the data-file
    equivalent of the reference's interactive TF editor state."""
    np.save(path, np.asarray(base_tf, np.float32))


def load_tf(path: str) -> jax.Array:
    arr = np.load(path)
    if arr.shape != (TF_SIZE, 4):
        raise ValueError(
            f"TF file must be ({TF_SIZE}, 4); got {arr.shape}"
        )
    return jnp.asarray(arr, jnp.float32)
