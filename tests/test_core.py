"""Unit tests for the core math layer: sampling, rays, TF, ESL, view."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volrt.constants import ESL_VOLUME_DIMS, TF_RATIO, TF_SIZE
from volrt.core import esl, rays, sampling, tf
from volrt.core.histogram import compute_histogram
from volrt.core.types import (
    View,
    Volume,
    default_esl_block_dims,
    default_ray_step,
    make_raycaster,
)
from volrt.core.view import Camera


class TestMapFloatInt:
    def test_basic(self):
        f = jnp.array([0.0, 0.5, 0.999, 1.0, 1.5, -0.2])
        out = sampling.map_float_int(f, 256)
        np.testing.assert_array_equal(out, [0, 128, 255, 255, 255, 0])

    def test_truncation_matches_c_cast(self):
        # (long)(f*n) truncates toward zero (reference: common.h:106).
        f = jnp.array([0.00389, 0.00391])  # straddles 1/256
        out = sampling.map_float_int(f, 256)
        np.testing.assert_array_equal(out, [0, 1])


class TestSampling:
    def test_nearest_center(self, synth32):
        vol = Volume.from_numpy(synth32)
        pos = jnp.array([[0.0, 0.0, 0.0]])
        s = sampling.sample_nearest(vol, pos)
        assert int(s[0]) == int(synth32[16, 16, 16])

    def test_nearest_corners_clamped(self, synth32):
        vol = Volume.from_numpy(synth32)
        pos = jnp.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [1.2, -1.2, 0.0]])
        s = sampling.sample_nearest(vol, pos)
        assert int(s[0]) == int(synth32[0, 0, 0])
        assert int(s[1]) == int(synth32[31, 31, 31])

    def test_trilinear_at_voxel_centers(self, synth32):
        vol = Volume.from_numpy(synth32)
        # Voxel center i maps to u=(i+0.5)/N -> pos = 2u-1.
        idx = np.array([[3, 7, 11], [0, 0, 0], [31, 31, 31]], np.float32)
        pos = jnp.asarray((idx + 0.5) / 16.0 - 1.0)
        s = sampling.sample_trilinear(vol, pos)
        want = synth32[11, 7, 3] / 255.0
        assert abs(float(s[0]) - want) < 1e-5
        assert abs(float(s[1]) - synth32[0, 0, 0] / 255.0) < 1e-5
        assert abs(float(s[2]) - synth32[31, 31, 31] / 255.0) < 1e-5

    def test_trilinear_midpoint(self):
        data = np.zeros((2, 2, 2), np.uint8)
        data[0, 0, 0] = 100
        data[0, 0, 1] = 200
        vol = Volume.from_numpy(data)
        # Midpoint between the two x-neighbors at (y=0,z=0) voxel centers.
        pos = jnp.array([[0.0, -0.5, -0.5]])
        s = sampling.sample_trilinear(vol, pos)
        assert abs(float(s[0]) - 150 / 255.0) < 1e-5

    def test_tf_lookup_bucket(self):
        lut = jnp.arange(TF_SIZE * 4, dtype=jnp.float32).reshape(TF_SIZE, 4)
        out = sampling.tf_lookup_bucket(lut, jnp.array([0, 1, 2, 255]))
        np.testing.assert_array_equal(out[0], lut[0])
        np.testing.assert_array_equal(out[1], lut[0])
        np.testing.assert_array_equal(out[2], lut[1])
        np.testing.assert_array_equal(out[3], lut[127])

    def test_tf_lookup_linear_interp(self):
        lut = jnp.zeros((TF_SIZE, 4), jnp.float32).at[1].set(1.0)
        # Sample exactly at entry-1's center: (1 + 0.5)/TF_SIZE.
        s = jnp.array([1.5 / TF_SIZE])
        out = sampling.tf_lookup_linear(lut, s)
        np.testing.assert_allclose(out[0], [1, 1, 1, 1], atol=1e-6)
        # Halfway between entries 0 and 1.
        s = jnp.array([1.0 / TF_SIZE])
        out = sampling.tf_lookup_linear(lut, s)
        np.testing.assert_allclose(out[0], [0.5] * 4, atol=1e-6)

    def test_write_color(self):
        c = jnp.array([[0.0, 0.5, 1.0, 1.7]])
        out = sampling.write_color(c)
        np.testing.assert_array_equal(out[0], [0, 128, 255, 255])
        assert out.dtype == jnp.uint8


class TestRays:
    def _view(self, perspective):
        v = View.default()
        return View(
            origin=v.origin,
            direction=v.direction,
            right_plane=v.right_plane,
            up_plane=v.up_plane,
            light_pos=v.light_pos,
            dims=(8, 6),
            perspective=perspective,
        )

    def test_ortho_shapes_and_center(self):
        view = self._view(False)
        o, d = rays.get_rays(view)
        assert o.shape == (6, 8, 3) and d.shape == (6, 8, 3)
        # Center pixel (dims//2) has zero plane offset.
        np.testing.assert_allclose(o[3, 4], view.origin, atol=1e-6)
        np.testing.assert_allclose(d[3, 4], view.direction, atol=1e-6)

    def test_perspective_unnormalized(self):
        view = self._view(True)
        o, d = rays.get_rays(view)
        np.testing.assert_allclose(o[0, 0], view.origin, atol=1e-6)
        # Off-center direction = direction + offset, NOT normalized
        # (reference: ViewBase.h:28 commented out).
        want = (
            np.asarray(view.direction)
            + np.asarray(view.right_plane) * (0 - 4)
            + np.asarray(view.up_plane) * (0 - 3)
        )
        np.testing.assert_allclose(d[0, 0], want, atol=1e-6)

    def test_intersect_hit_miss(self):
        o = jnp.array([[0.0, 0.0, 3.0], [5.0, 5.0, 3.0], [0.0, 0.0, 0.0]])
        d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
        knear, kfar, hit = rays.intersect_aabb(o, d)
        np.testing.assert_array_equal(hit, [True, False, True])
        assert abs(float(knear[0]) - 2.0) < 1e-5
        assert abs(float(kfar[0]) - 4.0) < 1e-5
        # Origin inside the cube: near clamps to 0 (reference line 40).
        assert float(knear[2]) == 0.0
        assert abs(float(kfar[2]) - 1.0) < 1e-5

    def test_intersect_behind(self):
        o = jnp.array([[0.0, 0.0, 3.0]])
        d = jnp.array([[0.0, 0.0, 1.0]])  # pointing away
        _, _, hit = rays.intersect_aabb(o, d)
        assert not bool(hit[0])

    def test_axis_parallel_ray(self):
        # dir has exact zeros -> epsilon substitution must not NaN.
        o = jnp.array([[0.5, 0.5, 3.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        knear, kfar, hit = rays.intersect_aabb(o, d)
        assert bool(hit[0]) and np.isfinite(float(knear[0]))


class TestTransferFn:
    def test_default_shape_and_ramp(self):
        base = tf.default_transfer_fn()
        assert base.shape == (TF_SIZE, 4)
        b = np.asarray(base)
        # R ramps in the first third, then zero.
        assert b[10, 0] > 0 and b[60, 0] == 0
        # Low-alpha cutoff below 255*0.1/TF_RATIO ~ 12.75.
        assert b[12, 3] == 0 and b[13, 3] > 0

    def test_premultiply(self):
        base = jnp.array([[0.5, 1.0, 0.25, 0.5]])
        p = tf.premultiply(base)
        np.testing.assert_allclose(p[0], [0.25, 0.5, 0.125, 0.5], atol=1e-6)

    def test_first_opaque_index(self):
        lut = jnp.zeros((TF_SIZE, 4), jnp.float32)
        lut = lut.at[50, 3].set(1.0).at[100, 3].set(1.0)
        fo = tf.first_opaque_index(lut)
        assert int(fo[0]) == 50
        assert int(fo[50]) == 50
        assert int(fo[51]) == 100
        assert int(fo[101]) == TF_SIZE

    def test_editor_ops(self):
        base = tf.default_transfer_fn()
        edited = tf.edit_alpha(base, 10, 20, 0.5)
        b = np.asarray(edited)
        assert np.all(b[10:21, 3] == 0.5)
        np.testing.assert_array_equal(b[:10, 3], np.asarray(base)[:10, 3])
        painted = tf.set_colors(base, 0, 5, (1.0, 0.0, 0.0))
        p = np.asarray(painted)
        assert np.all(p[:6, 0] == 1.0) and np.all(p[:6, 1] == 0.0)
        np.testing.assert_array_equal(p[6:, :3], np.asarray(base)[6:, :3])

    def test_alpha_curve(self):
        np.testing.assert_allclose(
            tf.editor_alpha_curve(jnp.array([0.0, 0.5, 1.0, 2.0])),
            [0.0, 0.0625, 1.0, 1.0],
            atol=1e-6,
        )


class TestESL:
    def test_block_dims(self):
        assert default_esl_block_dims((32, 32, 32)) == 8   # min block size
        assert default_esl_block_dims((256, 256, 256)) == 8
        assert default_esl_block_dims((512, 512, 512)) == 16
        assert default_esl_block_dims((300, 100, 100)) == 10

    def test_min_max_grid_values(self, synth32):
        vol = Volume.from_numpy(synth32)
        mm = esl.build_min_max_grid(vol, 8)
        mm = np.asarray(mm)
        # 32^3 volume with block 8 -> 4x4x4 occupied blocks.
        want_min = synth32[:8, :8, :8].min()
        want_max = synth32[:8, :8, :8].max()
        assert mm[0, 0, 0, 0] == want_min and mm[0, 0, 0, 1] == want_max
        want_max2 = synth32[8:16, 16:24, 24:32].max()
        assert mm[1, 2, 3, 1] == want_max2
        # Out-of-volume blocks keep init (255, 0) (reference init loop).
        assert mm[10, 10, 10, 0] == 255 and mm[10, 10, 10, 1] == 0

    def test_empty_grid_derivation(self):
        # TF transparent below bucket 64, opaque from 64 up.
        lut = jnp.zeros((TF_SIZE, 4), jnp.float32)
        lut = lut.at[64:, 3].set(1.0)
        mm = np.zeros((ESL_VOLUME_DIMS,) * 3 + (2,), np.uint8)
        mm[..., 0] = 255  # init min
        # Block A: values 0..100 -> max bucket 50 < 64 -> empty.
        mm[0, 0, 0] = (0, 100)
        # Block B: values 0..200 -> max bucket 100 >= 64 -> not empty.
        mm[0, 0, 1] = (0, 200)
        empty = np.asarray(esl.derive_empty_grid(jnp.asarray(mm), lut))
        assert empty[0, 0, 0] and not empty[0, 0, 1]

    def test_bitmask_pack_roundtrip(self):
        rng = np.random.default_rng(0)
        grid = rng.random((32, 32, 32)) > 0.5
        words = esl.pack_bitmask(jnp.asarray(grid))
        assert words.shape == (1024,)
        back = np.asarray(esl.unpack_bitmask(words))
        np.testing.assert_array_equal(back, grid)

    def test_empty_distance_grid(self):
        """Chebyshev distance field: 0 at non-empty blocks, exact max-norm
        distance elsewhere (brute-force oracle on a sparse grid)."""
        rng = np.random.default_rng(3)
        empty = np.ones((ESL_VOLUME_DIMS,) * 3, bool)
        occ = rng.integers(0, ESL_VOLUME_DIMS, size=(5, 3))
        for z, y, x in occ:
            empty[z, y, x] = False
        dist = np.asarray(esl.empty_distance_grid(jnp.asarray(empty)))
        zz, yy, xx = np.meshgrid(
            *[np.arange(ESL_VOLUME_DIMS)] * 3, indexing="ij")
        want = np.full(empty.shape, ESL_VOLUME_DIMS, np.int64)
        for z, y, x in occ:
            cheb = np.maximum.reduce(
                [np.abs(zz - z), np.abs(yy - y), np.abs(xx - x)])
            want = np.minimum(want, cheb)
        np.testing.assert_array_equal(
            dist, np.minimum(want, ESL_VOLUME_DIMS))

    def test_leap_preserves_lattice(self, synth32):
        vol = Volume.from_numpy(synth32)
        block = 8
        bs = (0.5, 0.5, 0.5)
        pos = jnp.array([[-0.9, 0.1, 0.1]])
        d = jnp.array([[1.0, 0.0, 0.0]])
        step = 0.06
        dk = esl.leap_distance(pos, d, vol.dims, block, bs, step)
        v = float(dk[0])
        # Quantized to whole steps (reference: RaycasterBase.h:83).
        assert abs(v / step - round(v / step)) < 1e-4
        assert v >= 0.0

    def test_sample_empty(self):
        grid = jnp.zeros((32, 32, 32), bool).at[0, 0, 0].set(True)
        # Position in the first 8^3 block of a 32^3 volume.
        pos = jnp.array([[-0.99, -0.99, -0.99], [0.5, 0.5, 0.5]])
        out = esl.sample_empty(grid, pos, (32, 32, 32), 8)
        np.testing.assert_array_equal(out, [True, False])


class TestCamera:
    def test_default_front_view(self):
        cam = Camera(dims=(100, 100))
        cam.set_camera_position((0, 0, 0), 2.0)
        v = cam.view()
        np.testing.assert_allclose(v.origin, [0, 0, 2], atol=1e-6)
        np.testing.assert_allclose(v.direction, [0, 0, -1], atol=1e-6)
        # step_px = virtual_view_size / min(dims) = 2/100.
        np.testing.assert_allclose(v.right_plane, [0.02, 0, 0], atol=1e-6)
        np.testing.assert_allclose(v.up_plane, [0, 0.02, 0], atol=1e-6)

    def test_rotation_preserves_distance_and_orthogonality(self):
        cam = Camera()
        cam.set_camera_position((-45, -45, 0), 2.0)
        v = cam.view()
        assert abs(np.linalg.norm(v.origin) - 2.0) < 1e-5
        np.testing.assert_allclose(
            v.direction, -np.asarray(v.origin) / 2.0, atol=1e-5
        )
        r = np.asarray(v.right_plane)
        u = np.asarray(v.up_plane)
        assert abs(np.dot(r, u)) < 1e-6
        assert abs(np.dot(r, np.asarray(v.direction))) < 1e-6

    def test_zoom_clamps(self):
        cam = Camera()
        cam.zoom(100.0)
        assert cam.cam_dist == 3.0
        cam.zoom(-100.0)
        assert cam.cam_dist == 0.1

    def test_ortho_zoom_changes_view_size(self):
        cam = Camera()
        cam.set_camera_position((0, 0, 0), 2.0)
        assert cam.virtual_view_size == 2.0
        cam.toggle_perspective()
        assert cam.perspective and cam.virtual_view_size == 1.5

    def test_viewport_scale(self):
        cam = Camera(dims=(800, 700))
        cam.set_viewport_dims((800, 700), 0.5)
        assert cam.dims == (400, 350)


class TestRaycasterAssembly:
    def test_make_raycaster(self, synth32):
        vol = Volume.from_numpy(synth32)
        rc = make_raycaster(vol)
        assert rc.transfer_fn.shape == (TF_SIZE, 4)
        assert rc.esl_empty.shape == (32, 32, 32)
        assert rc.esl_block_dims == 8
        assert abs(rc.ray_step - default_ray_step((32, 32, 32))) < 1e-9
        assert rc.esl_block_size == (0.5, 0.5, 0.5)

    def test_raycaster_is_pytree(self, synth32):
        vol = Volume.from_numpy(synth32)
        rc = make_raycaster(vol)
        leaves = jax.tree_util.tree_leaves(rc)
        assert any(l.shape == (TF_SIZE, 4) for l in leaves)
        rc2 = jax.tree_util.tree_map(lambda x: x, rc)
        assert rc2.ray_step == rc.ray_step

    def test_histogram(self, synth32):
        h = compute_histogram(synth32)
        assert h.shape == (256,)
        assert h.max() == 1.0
        assert np.all(h >= 0)


class TestErrorLayer:
    """Unified error shim (reference: cuda_utils.h:21-49)."""

    def test_band_view_rays_exact(self):
        """Row-band sub-views reproduce the full bundle's rays exactly
        (ortho and perspective), so OOM band-splitting is lossless."""
        from volrt.core import rays as rays_mod
        from volrt.core.view import Camera
        from volrt.utils.errors import band_view

        for persp in (False, True):
            cam = Camera(dims=(12, 8), perspective=persp)
            cam.toggle_perspective(update_mode=True)
            cam.set_camera_position((30.0, 20.0, 0.0))
            view = cam.view()
            o_full, d_full = rays_mod.get_rays(view)
            for r0, hb in ((0, 4), (4, 4), (2, 2)):
                o, d = rays_mod.get_rays(band_view(view, r0, hb))
                np.testing.assert_allclose(
                    np.asarray(o), np.asarray(o_full[r0:r0 + hb]),
                    atol=1e-6)
                np.testing.assert_allclose(
                    np.asarray(d), np.asarray(d_full[r0:r0 + hb]),
                    atol=1e-6)

    def test_oom_fallback_splits_and_stitches(self, synth32):
        """A render that OOMs above a height limit is stitched from row
        bands, matching the unsplit result."""
        from volrt.core.view import Camera
        from volrt.renderers import batched
        from volrt.utils.errors import render_with_oom_fallback

        rc = make_raycaster(
            Volume.from_numpy(synth32),
            view=Camera(dims=(16, 16)).view(),
            interpolation="trilinear", light_kd=0.0)

        ref = batched.render_float(rc)

        calls = []

        def flaky(sub_rc):
            h = sub_rc.view.dims[1]
            calls.append(h)
            if h > 4:
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
            return batched.render_float(sub_rc)

        img = render_with_oom_fallback(flaky, rc)
        assert max(calls) == 16 and 4 in calls
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(ref), atol=1e-6)

    def test_safe_call_nosafe(self):
        from volrt.utils.errors import safe_call

        def boom():
            raise ValueError("x")

        res, err = safe_call(boom, nosafe=True)
        assert res is None and isinstance(err, ValueError)
        import pytest

        with pytest.raises(ValueError):
            safe_call(boom, nosafe=False)
