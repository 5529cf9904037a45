"""Differentiable renderer tests: forward parity, gradient correctness
(finite differences), fitting convergence, checkpoint round-trip."""
import jax
import jax.numpy as jnp
import numpy as np

from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn
from volrt.core.view import Camera
from volrt.diff.render import DiffScene, render_diff_image, scene_from_volume
from volrt.train.fit import (
    fit,
    init_state,
    l2_loss,
    make_optimizer,
    make_train_step,
)


def tiny_scene(n=8, step=0.2):
    return scene_from_volume(
        jnp.asarray(synthetic_volume(n)), default_transfer_fn(), step
    )


def tiny_view(wh=16):
    cam = Camera(dims=(wh, wh))
    cam.set_camera_position((30.0, 20.0, 0.0))
    return cam.view()


class TestForward:
    def test_matches_batched_renderer(self):
        """The scan-based diff forward equals the batched trilinear renderer
        when ERT is disabled on both (the diff path checks ERT *before* each
        step like the reference loop, but masks instead of breaking)."""
        from volrt.core.types import Volume, make_raycaster
        from volrt.renderers import batched

        data = synthetic_volume(8)
        view = tiny_view()
        rc = make_raycaster(
            Volume.from_numpy(data), view=view, interpolation="trilinear",
            esl=False, light_kd=0.0, ray_threshold=2.0,
        )
        a = np.asarray(batched.render_float(rc))
        scene = scene_from_volume(
            jnp.asarray(data), default_transfer_fn(), rc.ray_step
        )
        b = np.asarray(render_diff_image(scene, view, ray_threshold=2.0))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_phong_matches_batched_renderer(self):
        """Gradient-Phong in the diff path equals the batched renderer's
        phong mode (same six central-difference taps + Blinn-Phong), so
        shaded inverse rendering covers both shading models."""
        from volrt.core.types import Volume, make_raycaster
        from volrt.renderers import batched

        data = synthetic_volume(8)
        view = tiny_view()
        rc = make_raycaster(
            Volume.from_numpy(data), view=view, interpolation="trilinear",
            esl=False, light_kd=0.6, ray_threshold=2.0, shading="phong",
        )
        a = np.asarray(batched.render_float(rc))
        scene = scene_from_volume(
            jnp.asarray(data), default_transfer_fn(), rc.ray_step
        )
        b = np.asarray(render_diff_image(
            scene, view, ray_threshold=2.0, light_kd=0.6, phong=True))
        np.testing.assert_allclose(a, b, atol=2e-3)

    def test_phong_grads_finite_nonzero(self):
        scene = tiny_scene()
        view = tiny_view()

        def loss(s):
            img = render_diff_image(
                s, view, light_kd=0.6, phong=True)
            return jnp.mean(img**2)

        g = jax.grad(loss)(scene)
        gd = np.asarray(g.density)
        gt = np.asarray(g.tf_base)
        assert np.isfinite(gd).all() and np.isfinite(gt).all()
        assert np.abs(gd).sum() > 0 and np.abs(gt).sum() > 0

    def test_ert_threshold(self):
        scene = tiny_scene()
        img_ert = render_diff_image(scene, tiny_view(), ray_threshold=0.5)
        img_full = render_diff_image(scene, tiny_view(), ray_threshold=2.0)
        # ERT must only reduce accumulated alpha.
        assert (np.asarray(img_ert[..., 3]) <=
                np.asarray(img_full[..., 3]) + 1e-6).all()


class TestGradients:
    def test_finite_nonzero(self):
        scene = tiny_scene()
        view = tiny_view()
        target = jnp.zeros((16, 16, 4), jnp.float32)
        loss, grads = jax.value_and_grad(l2_loss)(scene, view, target)
        gd = np.asarray(grads.density)
        gt = np.asarray(grads.tf_base)
        assert np.isfinite(gd).all() and np.isfinite(gt).all()
        assert (np.abs(gd) > 0).any() and (np.abs(gt) > 0).any()

    def test_density_grad_finite_difference(self):
        scene = tiny_scene()
        view = tiny_view()
        target = jnp.zeros((16, 16, 4), jnp.float32)
        grads = jax.grad(l2_loss)(scene, view, target)
        gd = np.asarray(grads.density)
        # Check the 3 voxels with the largest gradient magnitude.
        flat = np.argsort(np.abs(gd).ravel())[-3:]
        eps = 1e-3
        for idx in flat:
            z, y, x = np.unravel_index(idx, gd.shape)
            d_plus = scene.density.at[z, y, x].add(eps)
            d_minus = scene.density.at[z, y, x].add(-eps)
            lp = float(l2_loss(scene.replace(density=d_plus), view, target))
            lm = float(l2_loss(scene.replace(density=d_minus), view, target))
            fd = (lp - lm) / (2 * eps)
            assert abs(fd - gd[z, y, x]) < 2e-2 * max(1.0, abs(fd)), (
                f"voxel {(z, y, x)}: fd {fd} vs ad {gd[z, y, x]}"
            )

    def test_tf_grad_finite_difference(self):
        scene = tiny_scene()
        view = tiny_view()
        target = jnp.zeros((16, 16, 4), jnp.float32)
        grads = jax.grad(l2_loss)(scene, view, target)
        gt = np.asarray(grads.tf_base)
        idx = np.argsort(np.abs(gt).ravel())[-2:]
        eps = 1e-3
        for flat_i in idx:
            i, c = np.unravel_index(flat_i, gt.shape)
            tp = scene.tf_base.at[i, c].add(eps)
            tm = scene.tf_base.at[i, c].add(-eps)
            lp = float(l2_loss(scene.replace(tf_base=tp), view, target))
            lm = float(l2_loss(scene.replace(tf_base=tm), view, target))
            fd = (lp - lm) / (2 * eps)
            assert abs(fd - gt[i, c]) < 2e-2 * max(1.0, abs(fd))


class TestFit:
    def test_loss_decreases(self):
        gt = tiny_scene()
        view = tiny_view()
        target = render_diff_image(gt, view)
        # Start from a nonzero constant: at exactly zero density the TF
        # lerp's two taps coincide (clamped index -1 -> 0,0) and the
        # density gradient vanishes identically.
        scene = DiffScene(
            density=jnp.full_like(gt.density, 0.3),
            tf_base=gt.tf_base,
            ray_step=gt.ray_step,
        )
        _, losses = fit(
            scene, [(view, target)], steps=15, lr=0.05, train_tf=False
        )
        assert losses[-1] < losses[0] * 0.8

    def test_shaded_fit_loss_decreases(self):
        """Shaded inverse rendering through XLA autodiff: the diffuse
        one-tap shade and gradient Blinn-Phong."""
        gt = tiny_scene()
        view = tiny_view()
        for shading in ("diffuse", "phong"):
            target = render_diff_image(
                gt, view, light_kd=0.6,
                shaded=(shading == "diffuse"),
                phong=(shading == "phong"))
            scene = DiffScene(
                density=jnp.full_like(gt.density, 0.3),
                tf_base=gt.tf_base,
                ray_step=gt.ray_step,
            )
            _, losses = fit(
                scene, [(view, target)], steps=8, lr=0.05,
                train_tf=False, shading=shading,
            )
            assert losses[-1] < losses[0], (shading, losses)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        from volrt.train import checkpoint as ckpt

        scene = tiny_scene()
        opt = make_optimizer(0.01)
        state = init_state(scene, opt)
        # Advance one step so opt state is nontrivial.
        step_fn = make_train_step(opt)
        target = jnp.zeros((16, 16, 4), jnp.float32)
        state, _ = step_fn(state, tiny_view(), target)

        path = str(tmp_path / "ck.npz")
        ckpt.save(path, state)
        loaded = ckpt.load(path, opt)
        np.testing.assert_array_equal(
            np.asarray(loaded.scene.density), np.asarray(state.scene.density)
        )
        assert int(loaded.step) == int(state.step)
        for a, b in zip(
            jax.tree_util.tree_leaves(loaded.opt_state),
            jax.tree_util.tree_leaves(state.opt_state),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # Resuming from the checkpoint must produce identical next steps.
        s1, l1 = step_fn(state, tiny_view(), target)
        s2, l2 = step_fn(loaded, tiny_view(), target)
        assert float(l1) == float(l2)

    def test_roundtrip_orbax(self, tmp_path):
        """Non-.npz paths dispatch to the orbax directory format (the
        sharding-aware production path) with identical restore."""
        from volrt.train import checkpoint as ckpt

        scene = tiny_scene()
        opt = make_optimizer(0.01)
        state = init_state(scene, opt)
        step_fn = make_train_step(opt)
        target = jnp.zeros((16, 16, 4), jnp.float32)
        state, _ = step_fn(state, tiny_view(), target)

        path = str(tmp_path / "ck_orbax")
        ckpt.save(path, state)
        loaded = ckpt.load(path, opt)
        np.testing.assert_array_equal(
            np.asarray(loaded.scene.density),
            np.asarray(state.scene.density))
        assert loaded.scene.ray_step == state.scene.ray_step
        assert int(loaded.step) == int(state.step)
        for a, b in zip(
            jax.tree_util.tree_leaves(loaded.opt_state),
            jax.tree_util.tree_leaves(state.opt_state),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestPeriodicCheckpointResume:
    def test_fit_checkpoints_and_resumes(self, tmp_path):
        """fit() persists TrainState every N steps and --resume semantics
        continue from the saved step with identical trajectory."""
        import jax.numpy as jnp

        from tests.conftest import synthetic_volume
        from volrt.core.tf import default_transfer_fn
        from volrt.core.view import Camera
        from volrt.diff.render import DiffScene, render_diff_image
        from volrt.diff.render import scene_from_volume
        from volrt.train.fit import fit

        n, wh, steps = 8, 16, 6
        gt = scene_from_volume(
            jnp.asarray(synthetic_volume(n)), default_transfer_fn(), 0.25)
        cam = Camera(dims=(wh, wh))
        targets = [(cam.view(), render_diff_image(gt, cam.view()))]
        init = DiffScene(
            density=jnp.full((n, n, n), 0.3, jnp.float32),
            tf_base=default_transfer_fn(), ray_step=0.25)
        path = str(tmp_path / "ck.npz")

        # Uninterrupted run: the trajectory oracle.
        scene_full, losses_full = fit(
            init, targets, steps=steps, lr=0.05, train_tf=False)

        # Interrupted run: 3 steps (periodic checkpoint), then resume.
        fit(init, targets, steps=3, lr=0.05, train_tf=False,
            checkpoint_path=path, checkpoint_every=1)
        scene_res, losses_res = fit(
            init, targets, steps=steps, lr=0.05, train_tf=False,
            checkpoint_path=path, resume=True)
        assert len(losses_res) == steps - 3
        np.testing.assert_allclose(
            losses_res, losses_full[3:], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(scene_res.density), np.asarray(scene_full.density),
            atol=1e-6)


class TestFusedFit:
    def test_fused_training_converges(self):
        """fit() on the XLA autodiff step converges from a flat start."""
        n, wh = 8, 16
        gt = scene_from_volume(
            jnp.asarray(synthetic_volume(n)), default_transfer_fn(), 0.25)
        cam = Camera(dims=(wh, wh))
        targets = [(cam.view(), render_diff_image(gt, cam.view()))]
        init = DiffScene(
            density=jnp.full((n, n, n), 0.3, jnp.float32),
            tf_base=default_transfer_fn(), ray_step=0.25)
        _, losses = fit(init, targets, steps=8, lr=0.05, train_tf=False)
        assert losses[-1] < losses[0]
