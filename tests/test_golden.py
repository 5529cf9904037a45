"""Golden renderer behavior tests + golden vs batched parity."""
import jax.numpy as jnp
import numpy as np
import pytest

from volrt.core.types import Volume, make_raycaster, View
from volrt.core.view import Camera
from volrt.renderers import batched, golden


def _rc(data, dims=(64, 64), angles=(0.0, 0.0, 0.0), distance=2.0, **kw):
    cam = Camera(dims=dims)
    cam.set_camera_position(angles, distance)
    return make_raycaster(Volume.from_numpy(data), view=cam.view(), **kw)


class TestGolden:
    def test_renders_nonempty(self, bucky):
        rc = _rc(bucky)
        img = np.asarray(golden.render(rc))
        assert img.shape == (64, 64, 4)
        assert img.dtype == np.uint8
        assert img.max() > 0, "image is all black"

    def test_corners_black_at_distance(self, bucky):
        # At distance 3 the ortho view plane (size 3) is wider than the cube
        # diagonal slice -> corner rays miss and stay memset-zero.
        rc = _rc(bucky, distance=3.0)
        img = np.asarray(golden.render(rc))
        assert img[0, 0].sum() == 0
        assert img.max() > 0

    def test_alpha_monotone_bounded(self, bucky):
        rc = _rc(bucky)
        img = np.asarray(golden.render_float(rc))
        assert img[..., 3].min() >= 0.0
        # Premultiplied compositing keeps alpha <= 1 + one step overshoot.
        assert img[..., 3].max() <= 1.0 + 1e-5

    def test_esl_does_not_change_image(self, bucky):
        """ESL leaps only through provably transparent blocks on the same
        sampling lattice -> image must be bit-identical (the reference's
        implicit contract)."""
        rc_on = _rc(bucky, esl=True)
        rc_off = _rc(bucky, esl=False)
        a = np.asarray(golden.render_float(rc_on))
        b = np.asarray(golden.render_float(rc_off))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_ert_bounded_difference(self, bucky):
        """Disabling ERT (threshold 1.0) may only add the tail contribution,
        bounded by the remaining transmittance (1 - 0.95)."""
        rc = _rc(bucky)
        rc_noert = rc.replace(ray_threshold=jnp.float32(1.0))
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(golden.render_float(rc_noert))
        # Shading can add up to light_kd per sample on top of transmittance.
        assert np.abs(a - b).max() <= (1 - 0.95) * (1.0 + 0.6) + 1e-4

    def test_trilinear_mode(self, bucky):
        rc = _rc(bucky, interpolation="trilinear")
        img = np.asarray(golden.render_float(rc))
        assert img.max() > 0
        # Trilinear and nearest must roughly agree (same scene).
        img_nn = np.asarray(golden.render_float(_rc(bucky)))
        assert np.abs(img - img_nn).mean() < 0.2

    def test_perspective_mode(self, bucky):
        cam = Camera(dims=(48, 48), perspective=True)
        cam.toggle_perspective(update_mode=True)
        cam.set_camera_position((30.0, -20.0, 0.0), 2.0)
        rc = make_raycaster(Volume.from_numpy(bucky), view=cam.view())
        img = np.asarray(golden.render_float(rc))
        assert img.max() > 0

    def test_empty_volume_black(self):
        rc = _rc(np.zeros((16, 16, 16), np.uint8))
        img = np.asarray(golden.render(rc))
        assert img.sum() == 0

    def test_light_kd_zero_unshaded(self, bucky):
        rc = _rc(bucky)
        rc0 = rc.replace(light_kd=jnp.float32(0.0))
        rc1 = rc.replace(light_kd=jnp.float32(0.005))  # below gate 0.01
        a = np.asarray(golden.render_float(rc0))
        b = np.asarray(golden.render_float(rc1))
        np.testing.assert_allclose(a, b, atol=1e-6)


class TestBatchedParity:
    @pytest.mark.parametrize("angles", [(0, 0, 0), (-45, -45, 0), (90, 0, 0), (180, 90, 0)])
    @pytest.mark.parametrize("interp", ["nearest", "trilinear"])
    def test_matches_golden(self, bucky, angles, interp):
        rc = _rc(bucky, dims=(48, 48), angles=angles, interpolation=interp)
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)

    def test_matches_golden_esl_off(self, bucky):
        rc = _rc(bucky, esl=False)
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        np.testing.assert_allclose(a, b, atol=2e-5)

    def test_matches_golden_perspective(self, bucky):
        cam = Camera(dims=(40, 40), perspective=True)
        cam.toggle_perspective(update_mode=True)
        cam.set_camera_position((-45, -45, 0), 2.0)
        rc = make_raycaster(Volume.from_numpy(bucky), view=cam.view())
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        np.testing.assert_allclose(a, b, atol=2e-5)

    def test_uint8_output(self, bucky):
        rc = _rc(bucky)
        a = np.asarray(golden.render(rc))
        b = np.asarray(batched.render(rc))
        # Float-identical pipelines may still straddle a quantization edge.
        assert (a.astype(int) - b.astype(int)).__abs__().max() <= 1

    def test_nonsquare_viewport(self, synth48):
        rc = _rc(synth48, dims=(52, 36))
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        assert a.shape == (36, 52, 4)
        np.testing.assert_allclose(a, b, atol=2e-5)


class TestGradientPhong:
    """Gradient Blinn-Phong shading option (SURVEY §7 step 4's upgrade of
    the reference's one-tap diffuse for BASELINE config 4)."""

    def _rc(self, shading):
        from tests.conftest import synthetic_volume
        from volrt.core.types import Volume, make_raycaster
        from volrt.core.view import Camera

        cam = Camera(dims=(24, 24))
        cam.set_camera_position((30.0, 20.0, 0.0))
        return make_raycaster(
            Volume.from_numpy(synthetic_volume(16)),
            view=cam.view(), interpolation="trilinear", shading=shading,
        )

    def test_batched_matches_golden(self):
        import numpy as np

        from volrt.renderers import batched, golden

        rc = self._rc("phong")
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        np.testing.assert_allclose(a, b, atol=3e-5)

    def test_phong_differs_from_diffuse_and_is_lit(self):
        import numpy as np

        from volrt.renderers import batched

        a = np.asarray(batched.render_float(self._rc("diffuse")))
        b = np.asarray(batched.render_float(self._rc("phong")))
        assert np.abs(a - b).max() > 1e-3  # actually shades differently
        assert np.isfinite(b).all()
        # Alpha is shading-independent.
        np.testing.assert_allclose(a[..., 3], b[..., 3], atol=1e-6)
