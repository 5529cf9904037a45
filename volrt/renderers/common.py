"""Shared per-step march math used by every renderer rung.

One source of truth for the classify/shade/composite step so the golden and
batched-XLA renderers provably implement the same algorithm
(reference: CPURenderer.cpp:29-39, GPURenderer4.cu:75-85).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from volrt.constants import (
    PHONG_KA,
    PHONG_KS,
    PHONG_SHININESS,
    SHADE_ALPHA_GATE,
    SHADE_KD_GATE,
    SHADE_LIGHT_OFFSET,
)
from volrt.core import sampling
from volrt.core.types import Raycaster


def normalize(v: jax.Array) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def _safe_normalize(v: jax.Array, eps: float = 1e-8) -> jax.Array:
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def gradient_normal(rc: Raycaster, pt: jax.Array,
                    light_sampler) -> jax.Array:
    """Central-difference density gradient at world points -> unit normals
    pointing *against* increasing density (outward from dense features)."""
    w, h, d = rc.volume.dims
    comps = []
    for axis, n in ((0, w), (1, h), (2, d)):
        off = jnp.zeros((3,), jnp.float32).at[axis].set(2.0 / n)
        comps.append(light_sampler(pt + off) - light_sampler(pt - off))
    g = jnp.stack(comps, axis=-1)
    return -_safe_normalize(g)


def phong_shade(rc: Raycaster, pt: jax.Array, rgb: jax.Array,
                alpha: jax.Array, light_sampler,
                view_dir: jax.Array) -> jax.Array:
    """Blinn-Phong shading over gradient normals (new capability; the
    reference has only the one-tap diffuse, RaycasterBase.h:87-98):

        rgb' = rgb * (ka + kd * max(N.L, 0)) + ks * max(N.H, 0)^n * alpha

    with N the central-difference gradient normal, L the light direction
    and H the Blinn half vector between L and the (reversed) ray
    direction. Gated like the reference's diffuse tap."""
    light_dir = normalize(rc.view.light_pos - pt)
    nrm = gradient_normal(rc, pt, light_sampler)
    vdir = _safe_normalize(-view_dir)
    half = _safe_normalize(light_dir + vdir)
    ndl = jnp.maximum(jnp.sum(nrm * light_dir, axis=-1), 0.0)
    ndh = jnp.maximum(jnp.sum(nrm * half, axis=-1), 0.0)
    lit = rgb * (PHONG_KA + rc.light_kd * ndl)[..., None] + (
        PHONG_KS * ndh ** PHONG_SHININESS * alpha)[..., None]
    gate = (alpha > SHADE_ALPHA_GATE) & (rc.light_kd > SHADE_KD_GATE)
    return jnp.where(gate[..., None], lit, rgb)


def classify_and_shade(rc: Raycaster, pt: jax.Array,
                       view_dir: jax.Array | None = None) -> jax.Array:
    """Sample the volume at world points ``pt (..., 3)``, classify through the
    TF and apply the configured shading. Returns premultiplied RGBA
    ``(..., 4)``.

    ``nearest`` mode: uint8 sample + bucketed TF + nearest light tap
    (reference: CPURenderer.cpp:30-33, RaycasterBase.h:87-98).
    ``trilinear`` mode: trilinear sample + linearly-interpolated TF + trilinear
    light tap (reference: GPURenderer4.cu:41-51,76-79).
    ``rc.shading == "phong"`` replaces the one-tap diffuse with gradient
    Blinn-Phong (requires ``view_dir``, the unnormalized ray direction).
    """
    if rc.interpolation == "nearest":
        sample_u8 = sampling.sample_nearest(rc.volume, pt)
        color = sampling.tf_lookup_bucket(rc.transfer_fn, sample_u8)
        sample_norm = sample_u8.astype(jnp.float32) / 255.0
        light_sampler = lambda p: (
            sampling.sample_nearest(rc.volume, p).astype(jnp.float32) / 255.0
        )
    else:
        sample_norm = sampling.sample_trilinear(rc.volume, pt)
        color = sampling.tf_lookup_linear(rc.transfer_fn, sample_norm)
        light_sampler = lambda p: sampling.sample_trilinear(rc.volume, p)

    if rc.shading == "phong":
        if view_dir is None:
            raise ValueError("phong shading requires the ray direction")
        rgb = phong_shade(
            rc, pt, color[..., :3], color[..., 3], light_sampler, view_dir)
        return jnp.concatenate([rgb, color[..., 3:4]], axis=-1)

    # Diffuse shading: one extra volume tap a small distance toward the light;
    # gated on alpha and light intensity (reference: RaycasterBase.h:87-98).
    light_dir = normalize(rc.view.light_pos - pt)
    gate = (color[..., 3] > SHADE_ALPHA_GATE) & (rc.light_kd > SHADE_KD_GATE)
    sample_l = light_sampler(pt + light_dir * SHADE_LIGHT_OFFSET)
    diffuse = jnp.where(gate, (sample_l - sample_norm) * rc.light_kd, 0.0)
    rgb = color[..., :3] + diffuse[..., None]
    return jnp.concatenate([rgb, color[..., 3:4]], axis=-1)


def composite(acc: jax.Array, color: jax.Array) -> jax.Array:
    """Front-to-back premultiplied compositing step:
    ``C_out = C_in + C * (1 - alpha_in)`` (reference: CPURenderer.cpp:34)."""
    return acc + color * (1.0 - acc[..., 3:4])
