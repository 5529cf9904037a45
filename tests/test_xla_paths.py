"""The plain XLA paths that serve every device: rung 1 against the golden
rung 0 over volume shapes, shadings and viewports; ``diff/render.py``
gradients against finite differences; partial-gradient and ESL fits; and
the sharded paths on 2, 4 and 8 devices of the virtual CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn
from volrt.core.types import Volume, make_raycaster
from volrt.core.view import Camera
from volrt.diff.render import DiffScene, render_diff_image, scene_from_volume
from volrt.renderers import batched, golden
from volrt.train.fit import fit, make_loss_fn


def blob_volume(d, h, w, seed=0):
    """A soft ellipsoid blob filling a (d, h, w) box, plus noise."""
    z, y, x = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w),
        indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    noise = np.random.default_rng(seed).uniform(0, 20, size=(d, h, w))
    return np.clip(np.exp(-((r - 0.6) ** 2) / 0.05) * 220 + noise,
                   0, 255).astype(np.uint8)


def posed_view(dims, angles=(30.0, 20.0, 0.0), perspective=False):
    cam = Camera(dims=dims, perspective=perspective)
    cam.toggle_perspective(update_mode=True)
    cam.set_camera_position(angles)
    return cam.view()


# (D, H, W): wider than 128 voxels in x, and non-cubic boxes in each axis
# order.
SHAPES = {
    "wide_x136": (8, 12, 136),
    "tall_y": (10, 40, 12),
    "deep_z": (36, 10, 14),
    "flat": (6, 24, 20),
}


class TestRung1MatchesGolden:
    @pytest.mark.parametrize("esl", [False, True])
    @pytest.mark.parametrize("shading", ["diffuse", "phong"])
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_volume_shapes(self, shape, shading, esl):
        rc = make_raycaster(
            Volume.from_numpy(blob_volume(*SHAPES[shape])),
            view=posed_view((24, 20)), interpolation="trilinear",
            shading=shading, esl=esl)
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        assert a[..., 3].max() > 0.05, "scene left the view"
        np.testing.assert_allclose(b, a, atol=3e-5)

    @pytest.mark.parametrize("interp", ["nearest", "trilinear"])
    @pytest.mark.parametrize("dims,perspective", [
        ((31, 17), False), ((7, 33), True), ((1, 9), False),
        ((45, 1), True)])
    def test_odd_viewports(self, dims, perspective, interp):
        rc = make_raycaster(
            Volume.from_numpy(synthetic_volume(20)),
            view=posed_view(dims, (-40.0, 25.0, 0.0), perspective),
            interpolation=interp)
        a = np.asarray(golden.render_float(rc))
        b = np.asarray(batched.render_float(rc))
        assert b.shape == (dims[1], dims[0], 4)
        np.testing.assert_allclose(b, a, atol=3e-5)


def _scene(n=8, step=0.2):
    return scene_from_volume(
        jnp.asarray(synthetic_volume(n)), default_transfer_fn(), step)


class TestDiffGradients:
    """Reverse-mode gradients of the L2 loss through ``diff/render.py``
    against central finite differences, at the entries with the largest
    gradient, for each shading model with and without the ESL leap."""

    @pytest.mark.parametrize("leaf", ["density", "tf_base"])
    @pytest.mark.parametrize("esl", [False, True])
    @pytest.mark.parametrize("shading", [None, "diffuse", "phong"])
    def test_matches_finite_differences(self, shading, esl, leaf):
        scene = _scene()
        view = posed_view((16, 16))
        target = jnp.zeros((16, 16, 4), jnp.float32)
        loss = make_loss_fn(shading, 0.6, esl)
        g = np.asarray(getattr(jax.grad(loss)(scene, view, target), leaf))
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        base = getattr(scene, leaf)
        eps = 1e-3
        for flat in np.argsort(np.abs(g).ravel())[-3:]:
            idx = np.unravel_index(flat, g.shape)
            lp = float(loss(scene.replace(**{leaf: base.at[idx].add(eps)}),
                            view, target))
            lm = float(loss(scene.replace(**{leaf: base.at[idx].add(-eps)}),
                            view, target))
            fd = (lp - lm) / (2 * eps)
            assert abs(fd - g[idx]) < 2e-2 * max(1.0, abs(fd)), (
                idx, fd, g[idx])


class TestPartialFits:
    @pytest.mark.parametrize("train", ["density", "tf", "both"])
    def test_frozen_leaves_stay_and_loss_falls(self, train):
        gt = _scene(step=0.15)
        view = posed_view((16, 16))
        target = render_diff_image(gt, view)
        init = DiffScene(
            density=(gt.density if train == "tf"
                     else jnp.full_like(gt.density, 0.3)),
            tf_base=(jnp.full_like(gt.tf_base, 0.5) if train != "density"
                     else gt.tf_base),
            ray_step=gt.ray_step)
        fitted, losses = fit(
            init, [(view, target)], steps=5, lr=0.05,
            train_density=train in ("density", "both"),
            train_tf=train in ("tf", "both"))
        assert losses[-1] < losses[0]
        if train == "density":
            np.testing.assert_array_equal(fitted.tf_base, init.tf_base)
        if train == "tf":
            np.testing.assert_array_equal(fitted.density, init.density)
        if train == "both":
            assert not np.array_equal(fitted.tf_base, init.tf_base)
            assert not np.array_equal(fitted.density, init.density)


class TestEslTfTrap:
    """The ESL TF-gradient trap and its escape: under esl=True, samples in
    the leaped TF-empty space give no cotangent, so a TF whose opacity is
    zero everywhere can never open — unless fit(esl_refresh_every=N)
    periodically runs a full march."""

    def _setup(self):
        # All density at 200/255; the trainable TF starts with zero opacity
        # everywhere, so every ESL block derives empty and rays leap out.
        vol = np.zeros((16, 16, 16), np.uint8)
        vol[4:12, 4:12, 4:12] = 200
        tf_open = jnp.asarray(default_transfer_fn())
        gt = scene_from_volume(jnp.asarray(vol), tf_open, 0.15)
        view = posed_view((24, 24), (25.0, 10.0, 0.0))
        target = render_diff_image(gt, view)
        scene0 = DiffScene(density=gt.density,
                           tf_base=tf_open.at[:, 3].set(0.0), ray_step=0.15)
        return scene0, view, target

    def test_pure_esl_training_is_trapped(self):
        scene0, view, target = self._setup()
        fitted, losses = fit(scene0, [(view, target)], steps=4, lr=0.05,
                             train_density=False, esl=True)
        assert float(jnp.max(fitted.tf_base[:, 3])) == 0.0
        np.testing.assert_allclose(losses[-1], losses[0], rtol=1e-6)

    def test_esl_refresh_escapes_the_trap(self):
        scene0, view, target = self._setup()
        fitted, losses = fit(scene0, [(view, target)], steps=4, lr=0.05,
                             train_density=False, esl=True,
                             esl_refresh_every=2)
        assert float(jnp.max(fitted.tf_base[:, 3])) > 0.0
        assert losses[-1] < losses[0]


def _mesh(n):
    from volrt.dist.mesh import make_mesh

    return make_mesh(jax.devices()[:n])


DEVICE_COUNTS = [2, 4, 8]


class TestShardedParity:
    """Each multi-device path against its single-device reference on 2, 4
    and 8 virtual devices."""

    @pytest.mark.parametrize("rows", [32, 27])
    @pytest.mark.parametrize("n", DEVICE_COUNTS)
    def test_row_sharded_render(self, n, rows):
        from volrt.dist.render import render_float_sharded, render_sharded

        rc = make_raycaster(
            Volume.from_numpy(synthetic_volume(16)),
            view=posed_view((24, rows)), interpolation="trilinear")
        a = np.asarray(batched.render_float(rc))
        b = np.asarray(render_float_sharded(rc, _mesh(n)))
        np.testing.assert_allclose(b, a, atol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(render_sharded(rc, _mesh(n))),
            np.asarray(batched.render(rc)))

    @pytest.mark.parametrize("n", DEVICE_COUNTS)
    def test_row_sharded_train_step(self, n):
        from volrt.dist.mesh import replicated, rows_sharding
        from volrt.train.fit import (
            init_state, make_optimizer, make_train_step)

        scene = _scene(step=0.2)
        view = posed_view((16, 16))
        target = render_diff_image(scene, view) * 0.5
        opt = make_optimizer(0.01)
        s1, l1 = make_train_step(opt)(init_state(scene, opt), view, target)
        mesh = _mesh(n)
        s2, l2 = make_train_step(opt, mesh=mesh)(
            jax.device_put(init_state(scene, opt), replicated(mesh)), view,
            jax.device_put(target, rows_sharding(mesh)))
        assert abs(float(l1) - float(l2)) < 1e-6
        np.testing.assert_allclose(
            np.asarray(s2.scene.density), np.asarray(s1.scene.density),
            atol=1e-6)

    @pytest.mark.parametrize("shading", [None, "diffuse", "phong"])
    @pytest.mark.parametrize("n", DEVICE_COUNTS)
    def test_volume_sharded_render(self, n, shading):
        from volrt.dist.volume_sharded import render_volume_sharded

        # ERT off: with it on, a ray whose opacity lands on the threshold
        # can stop one step apart across the reassociated cross-slab
        # prefix (test_dist.py covers cross-slab ERT on a dense volume).
        scene = _scene(16, 0.15)
        view = posed_view((20, 20), (25.0, 10.0, 0.0))
        ref = render_diff_image(
            scene, view, ray_threshold=2.0, light_kd=0.6,
            shaded=shading == "diffuse", phong=shading == "phong")
        img = render_volume_sharded(
            scene, view, _mesh(n), ray_threshold=2.0, shading=shading,
            light_kd=0.6)
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(ref), atol=2e-5)

    @pytest.mark.parametrize("n", DEVICE_COUNTS)
    def test_volume_sharded_grads(self, n):
        """Gradients through the cross-slab opacity scan equal the
        unsharded march's (ERT on, so cross-slab termination counts)."""
        scene = _scene(16, 0.15)
        view = posed_view((16, 16), (25.0, 10.0, 0.0))
        target = jnp.zeros((16, 16, 4), jnp.float32)
        _, g_ref = jax.value_and_grad(make_loss_fn())(scene, view, target)
        _, g = jax.value_and_grad(make_loss_fn(volume_mesh=_mesh(n)))(
            scene, view, target)
        for leaf in ("density", "tf_base"):
            a, b = np.asarray(getattr(g, leaf)), np.asarray(
                getattr(g_ref, leaf))
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), leaf
