"""Volume-sharded rendering: Z-slab partitioning with transmittance-scan
segment compositing.

The volumetric cousin of context/ring parallelism (SURVEY §2 stretch
component; no reference counterpart): when the volume itself exceeds one
device's memory, each device holds one Z-slab (plus a one-voxel halo for
trilinear taps) and marches every ray only through its own slab.

v2 algorithm (replaces round 1's full-image all_gather fold):

1. **Alpha prepass**: each device marches its slab accumulating opacity
   only -> per-ray slab alpha ``A_i``.
2. **Cross-device exclusive scan** of the (associative, non-commutative)
   opacity composite ``a ⊕ b = a + b(1-a)`` in ray order via log2(n)
   ``ppermute`` rounds of one (H, W) plane each -> upstream opacity
   ``p_i`` entering slab i.
3. **Main march** re-renders the slab with the compositing accumulator
   *seeded* at ``p_i``: contributions are pre-scaled by the global
   transmittance, and the reference ERT recurrence ``acca <= threshold``
   continues *across* slabs exactly as in the unsharded march (round 1 had
   no cross-slab ERT at all).
4. **psum** of the pre-scaled segment deltas: because every contribution
   already carries its global transmittance weight, segment composition
   reduces to a commutative sum — one bandwidth-optimal all-reduce instead
   of an n-fold image gather.

Traffic: log2(n) * H*W + allreduce(H*W*4), vs round 1's n * H*W*4 gather.

Samples stay on each ray's *global* lattice ``knear + i*step`` (each slab
starts at the first lattice point inside it), so the composed image equals
the unsharded render (including ERT at the given ``ray_threshold``) up to
fp reassociation of the opacity prefix — knife-edge ERT pixels may take
one extra/fewer step. Compare with matching thresholds.

March direction across slabs must be uniform (sign of the view direction's
z component; pass ``front_to_back`` explicitly under jit).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from volrt.core import rays as rays_mod
from volrt.diff.render import CHECKPOINT_CHUNK, DiffScene
from volrt.dist.mesh import RAY_AXIS


def shard_slabs(density: jax.Array, n: int, halo: int = 1) -> jax.Array:
    """Split ``f32[D, H, W]`` into ``n`` Z-slabs with ``halo``-voxel
    halos: returns ``f32[n, D/n + 2*halo, H, W]`` (edge slabs
    clamp-padded). ``halo=1`` covers trilinear taps; shaded marches need
    more (:func:`shading_halo`).

    Note: this materializes the full grid in one process — fine for tests
    and single-host use; for volumes beyond one device's memory build the
    sharded array host-side with :func:`shard_slabs_to_devices` instead.
    """
    d, h, w = density.shape
    if d % n:
        raise ValueError(f"volume depth {d} not divisible by {n} slabs")
    slab = d // n
    padded = jnp.pad(density, ((halo, halo), (0, 0), (0, 0)), mode="edge")
    return jnp.stack(
        [jax.lax.dynamic_slice_in_dim(
            padded, k * slab, slab + 2 * halo, 0)
         for k in range(n)]
    )


def shading_halo(full_d: int, shading: str | None) -> int:
    """Slab halo (voxels) required so every shading tap stays inside
    the halo'd slab: the diffuse light tap samples
    ``SHADE_LIGHT_OFFSET`` world units away (0.01 * full_d / 2 voxels in
    z) and phong's central-difference taps reach +-1 voxel; +1 for the
    trilinear neighbor."""
    if shading == "diffuse":
        import math

        return int(math.ceil(0.01 * 0.5 * full_d)) + 2
    if shading == "phong":
        return 2
    return 1


def shard_slabs_to_devices(density, mesh: Mesh,
                           halo: int = 1) -> jax.Array:
    """Build the halo'd slab array with each slab placed directly on its
    target device (no full-volume replica per process).

    ``density`` is a host array (numpy); each device receives only its
    ``(D/n + 2*halo, H, W)`` slab buffer, so volumes larger than one
    device's memory stay feasible (the per-process host copy is the
    remaining limit).
    """
    import numpy as np

    devices = list(mesh.devices.flat)
    n = len(devices)
    d, h, w = density.shape
    if d % n:
        raise ValueError(f"volume depth {d} not divisible by {n} slabs")
    slab = d // n
    density = np.asarray(density)
    padded = np.pad(density, ((halo, halo), (0, 0), (0, 0)), mode="edge")
    sharding = NamedSharding(mesh, P(RAY_AXIS))
    shards = [
        jax.device_put(
            padded[k * slab:k * slab + slab + 2 * halo][None], dev)
        for k, dev in enumerate(devices)
    ]
    return jax.make_array_from_single_device_arrays(
        (n, slab + 2 * halo, h, w), sharding, shards)


def _sample_slab(slab: jax.Array, z_start: int, full_d: int,
                 pos: jax.Array, halo: int = 1) -> jax.Array:
    """Trilinear sample of one halo'd slab at world positions, using the
    FULL volume's coordinate mapping (so samples match the unsharded
    renderer exactly). ``slab`` is ``(slab_d + 2*halo, H, W)`` covering
    global z voxels ``[z_start - halo, z_start + slab_d + halo - 1]``
    (clamped)."""
    sd, h, w = slab.shape
    nvec = jnp.array([w, h, full_d], jnp.float32)
    t = (pos + 1.0) * 0.5 * nvec - 0.5
    i0 = jnp.floor(t)
    frac = t - i0
    i0 = i0.astype(jnp.int32)
    i1 = i0 + 1
    # Global clamp (CUDA clamp addressing), then remap z to slab-local.
    nmax = jnp.array([w - 1, h - 1, full_d - 1], jnp.int32)
    i0 = jnp.clip(i0, 0, nmax)
    i1 = jnp.clip(i1, 0, nmax)
    x0, y0 = i0[..., 0], i0[..., 1]
    x1, y1 = i1[..., 0], i1[..., 1]
    z0 = jnp.clip(i0[..., 2] - (z_start - halo), 0, sd - 1)
    z1 = jnp.clip(i1[..., 2] - (z_start - halo), 0, sd - 1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    c000 = slab[z0, y0, x0]
    c001 = slab[z0, y0, x1]
    c010 = slab[z0, y1, x0]
    c011 = slab[z0, y1, x1]
    c100 = slab[z1, y0, x0]
    c101 = slab[z1, y0, x1]
    c110 = slab[z1, y1, x0]
    c111 = slab[z1, y1, x1]
    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _slab_march(slab, z_start, full_d, tf_base, ray_step, view,
                ray_threshold, acc0_alpha=None, alpha_only=False,
                halo=1, shading=None, light_kd=0.0):
    """March one slab's global-lattice samples.

    Returns the final RGBA accumulator (alpha channel continues from
    ``acc0_alpha`` when given — the cross-slab ERT/compositing seed).
    ``alpha_only=True`` skips the RGB accumulation (the prepass).
    ``shading`` ("diffuse" | "phong") shades each sample exactly like
    the unsharded diff renderer (diff/render.py step); the shading taps
    stay inside the slab when ``halo >= shading_halo(full_d, shading)``
    (shading alters RGB only, so the alpha prepass and the cross-slab
    opacity scan are unaffected).
    """
    from volrt.constants import (
        PHONG_KA, PHONG_KS, PHONG_SHININESS, SHADE_ALPHA_GATE,
        SHADE_KD_GATE, SHADE_LIGHT_OFFSET, TF_SIZE)

    origins, directions = rays_mod.get_rays(view)
    knear, kfar, hit = rays_mod.intersect_aabb(origins, directions)

    sd = slab.shape[0] - 2 * halo
    z_lo = -1.0 + 2.0 * z_start / full_d
    z_hi = -1.0 + 2.0 * (z_start + sd) / full_d
    oz = origins[..., 2]
    dz = jnp.where(directions[..., 2] == 0.0, 1e-5, directions[..., 2])
    ka = (z_lo - oz) / dz
    kb = (z_hi - oz) / dz
    k_in = jnp.maximum(jnp.minimum(ka, kb), knear)

    # Samples sit on each ray's global lattice knear + j * ray_step,
    # computed exactly as the unsharded march computes them. A sample
    # belongs to the slab whose half-open z range holds its position, so
    # a sample on a slab boundary is taken by exactly one slab. The march
    # starts one lattice point before the slab entry to catch it.
    j0 = jnp.maximum(
        jnp.ceil(jnp.maximum(k_in - knear, 0.0) / ray_step) - 1.0, 0.0)
    z_lo_vox = jnp.where(z_start == 0, -jnp.inf, z_start)
    z_hi_vox = jnp.where(z_start + sd == full_d, jnp.inf, z_start + sd)

    premult = jnp.concatenate(
        [tf_base[:, :3] * tf_base[:, 3:4], tf_base[:, 3:4]], axis=-1
    )

    def tf_lookup(val):
        t = val * TF_SIZE - 0.5
        i0 = jnp.floor(t)
        frac = (t - i0)[..., None]
        i0 = i0.astype(jnp.int32)
        lo = jnp.clip(i0, 0, TF_SIZE - 1)
        hi = jnp.clip(i0 + 1, 0, TF_SIZE - 1)
        return premult[lo] * (1 - frac) + premult[hi] * frac

    # Every slab marches the cube's longest chord: a grazing ray can spend
    # all of it inside one slab.
    n_steps = int(math.ceil(2.0 * math.sqrt(3.0) / ray_step)) + 2

    def _safe_normalize(v):
        n2 = jnp.sum(v * v, axis=-1, keepdims=True)
        return v * jax.lax.rsqrt(jnp.maximum(n2, 1e-24))

    def step(carry, i):
        acc, alive = carry
        k = knear + (j0 + i) * ray_step
        pt = origins + directions * k[..., None]
        z_vox = (pt[..., 2] + 1.0) * 0.5 * full_d
        inside = (k <= kfar) & (z_vox >= z_lo_vox) & (z_vox < z_hi_vox)
        val = _sample_slab(slab, z_start, full_d, pt, halo)
        if alpha_only:
            t = val * TF_SIZE - 0.5
            i0 = jnp.floor(t)
            frac = t - i0
            i0 = i0.astype(jnp.int32)
            lo = jnp.clip(i0, 0, TF_SIZE - 1)
            hi = jnp.clip(i0 + 1, 0, TF_SIZE - 1)
            ca = (premult[lo, 3] * (1 - frac)
                  + premult[hi, 3] * frac)[..., None]
            color = jnp.concatenate(
                [jnp.zeros_like(ca), jnp.zeros_like(ca),
                 jnp.zeros_like(ca), ca], axis=-1)
        else:
            color = tf_lookup(val)
            if shading == "phong":
                # Gradient Blinn-Phong, semantics of diff/render.py's
                # step (renderers.common.phong_shade).
                light_pos = view.light_pos
                ldir = _safe_normalize(light_pos - pt)
                comps = []
                _, h_, w_ = slab.shape
                for axis, nv in ((0, w_), (1, h_), (2, full_d)):
                    off = jnp.zeros((3,), jnp.float32).at[axis].set(
                        2.0 / nv)
                    comps.append(
                        _sample_slab(slab, z_start, full_d, pt + off,
                                     halo)
                        - _sample_slab(slab, z_start, full_d, pt - off,
                                       halo))
                nrm = -_safe_normalize(jnp.stack(comps, axis=-1))
                vdir = _safe_normalize(-directions)
                half = _safe_normalize(ldir + vdir)
                ndl = jnp.maximum(jnp.sum(nrm * ldir, axis=-1), 0.0)
                ndh = jnp.maximum(jnp.sum(nrm * half, axis=-1), 0.0)
                alpha = color[..., 3]
                lit = (color[..., :3]
                       * (PHONG_KA + light_kd * ndl)[..., None]
                       + (PHONG_KS * ndh ** PHONG_SHININESS
                          * alpha)[..., None])
                gate = ((alpha > SHADE_ALPHA_GATE)
                        & (light_kd > SHADE_KD_GATE))
                rgb = jnp.where(gate[..., None], lit, color[..., :3])
                color = jnp.concatenate([rgb, color[..., 3:4]], axis=-1)
            elif shading == "diffuse":
                light_pos = view.light_pos
                ldir = light_pos - pt
                ldir = ldir / jnp.linalg.norm(
                    ldir, axis=-1, keepdims=True)
                val_l = _sample_slab(
                    slab, z_start, full_d,
                    pt + ldir * SHADE_LIGHT_OFFSET, halo)
                gate = ((color[..., 3] > SHADE_ALPHA_GATE)
                        & (light_kd > SHADE_KD_GATE))
                diffuse = jnp.where(
                    gate, (val_l - val) * light_kd, 0.0)
                color = jnp.concatenate(
                    [color[..., :3] + diffuse[..., None],
                     color[..., 3:4]], axis=-1)
        mask = (alive & inside)[..., None]
        acc = acc + jnp.where(mask, color * (1.0 - acc[..., 3:4]), 0.0)
        alive = alive & (acc[..., 3] <= ray_threshold)
        return (acc, alive), None

    acc0 = jnp.zeros(origins.shape[:-1] + (4,), slab.dtype)
    if acc0_alpha is not None:
        acc0 = acc0.at[..., 3].set(acc0_alpha)
    alive0 = hit & (acc0[..., 3] <= ray_threshold)
    # Chunked rematerialization, as in diff/render.py: the backward keeps
    # only chunk-boundary carries. Both passes need it, since the alpha
    # prepass feeds the cross-slab opacity scan that gradients flow through.
    chunk = min(CHECKPOINT_CHUNK, n_steps)

    @jax.checkpoint
    def chunk_step(carry, i0):
        return jax.lax.scan(
            lambda c, j: step(c, i0 + j), carry,
            jnp.arange(chunk, dtype=jnp.float32))[0], None

    starts = jnp.arange(-(-n_steps // chunk), dtype=jnp.float32) * chunk
    (acc, _), _ = jax.lax.scan(chunk_step, (acc0, alive0), starts)
    return acc


def _opacity_exclusive_scan(alpha, n, reverse):
    """Exclusive in-march-order scan of ``a ⊕ b = a + b(1-a)`` across the
    mesh axis via log2(n) ppermute rounds (one (H, W) plane each)."""
    idx = jax.lax.axis_index(RAY_AXIS)
    order = (n - 1 - idx) if reverse else idx  # march position of device

    def fwd_perm(r):
        # send device at march position p to position p + r
        if reverse:
            return [(n - 1 - p, n - 1 - (p + r)) for p in range(n - r)]
        return [(p, p + r) for p in range(n - r)]

    incl = alpha
    r = 1
    while r < n:
        recv = jax.lax.ppermute(incl, RAY_AXIS, perm=fwd_perm(r))
        # devices at march position < r receive nothing (identity = 0)
        recv = jnp.where(order >= r, recv, 0.0)
        incl = recv + incl * (1.0 - recv)
        r *= 2
    # exclusive = previous device's inclusive
    prev = jax.lax.ppermute(incl, RAY_AXIS, perm=fwd_perm(1))
    return jnp.where(order >= 1, prev, 0.0)


def render_volume_sharded(
    scene: DiffScene, view, mesh: Mesh,
    ray_threshold: float = 0.95,
    front_to_back: bool | None = None,
    slabs: jax.Array | None = None,
    shading: str | None = None,
    light_kd: float = 0.6,
) -> jax.Array:
    """Render with the volume Z-slab-sharded across ``mesh`` ->
    ``f32[H, W, 4]``. Differentiable w.r.t. the scene (pure XLA).

    ``ray_threshold`` is the ERT threshold, honored *across* slab
    boundaries (pass 2.0 to disable). Autodiff carries each segment's
    upstream-opacity cotangent through the ppermute scan into upstream
    slabs' density gradients. ``front_to_back`` is the slab march
    order (device 0's slab first); when None it is derived from the view's
    z direction, which requires a concrete (non-traced) view — under an
    outer jit pass it explicitly (it selects the static ppermute
    schedule). Pre-sharded ``slabs`` (see
    :func:`shard_slabs_to_devices`) skip the in-graph slab stack — build
    them with ``halo=shading_halo(D, shading)`` when shading.

    ``shading``: per-sample shading with the unsharded diff renderer's
    exact semantics. The slabs get a wider halo so every light/gradient
    tap resolves slab-locally; shading alters RGB only, so the
    cross-slab opacity scan and ERT are unchanged ("diffuse" = the
    reference one-tap shade, "phong" = gradient Blinn-Phong).
    """
    if front_to_back is None:
        try:
            front_to_back = bool(view.direction[2] >= 0)
        except jax.errors.TracerBoolConversionError as e:
            raise ValueError(
                "front_to_back must be passed explicitly when the view is "
                "traced (it selects the static ppermute schedule)") from e
    return _render_volume_sharded(
        scene, view, mesh, jnp.float32(ray_threshold),
        bool(front_to_back), slabs, shading, jnp.float32(light_kd))


@partial(jax.jit, static_argnames=("mesh", "front_to_back", "shading"))
def _render_volume_sharded(scene, view, mesh, ray_threshold,
                           front_to_back, slabs, shading=None,
                           light_kd=0.6):
    n = mesh.devices.size
    d = scene.density.shape[0]
    slab = d // n
    if slabs is None:
        slabs = shard_slabs(scene.density, n,
                            halo=shading_halo(d, shading))
    halo = (slabs.shape[1] - slab) // 2
    tf_base, ray_step = scene.tf_base, scene.ray_step
    reverse = not front_to_back

    def per_device(slab_block, tfb):
        z_start = jax.lax.axis_index(RAY_AXIS) * slab
        # Pass 1: slab opacity (shading alters RGB only).
        a_i = _slab_march(
            slab_block[0], z_start, d, tfb, ray_step, view,
            ray_threshold=2.0, alpha_only=True,
            halo=halo)[..., 3]
        # Pass 2: upstream opacity entering this slab.
        p_i = _opacity_exclusive_scan(a_i, n, reverse)
        # Pass 3: full march seeded at the upstream opacity; the
        # delta is this slab's globally-scaled contribution.
        acc = _slab_march(
            slab_block[0], z_start, d, tfb, ray_step, view,
            ray_threshold=ray_threshold, acc0_alpha=p_i,
            halo=halo, shading=shading, light_kd=light_kd)
        seg = acc - jnp.concatenate(
            [jnp.zeros_like(acc[..., :3]), p_i[..., None]], axis=-1)
        # Pass 4: commutative reduction of pre-scaled segments.
        return jax.lax.psum(seg, RAY_AXIS)

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(slabs, tf_base)
