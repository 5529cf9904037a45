"""Multi-device tests on the 8-virtual-CPU-device mesh (conftest):
sharded render == unsharded render; sharded train step == single-device
train step; driver dryrun entry."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import synthetic_volume
from volrt.core.tf import default_transfer_fn
from volrt.core.types import Volume, make_raycaster
from volrt.core.view import Camera
from volrt.diff.render import scene_from_volume, render_diff_image
from volrt.dist.mesh import make_mesh, replicated, rows_sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 devices"
)


@needs_devices
class TestShardedRender:
    def test_matches_unsharded(self):
        from volrt.dist.render import render_float_sharded
        from volrt.renderers import batched

        rc = make_raycaster(
            Volume.from_numpy(synthetic_volume(16)),
            view=Camera(dims=(32, 64)).view(),  # 8 rows per device
            interpolation="trilinear",
            light_kd=0.0,
        )
        mesh = make_mesh()
        a = batched.render_float(rc)
        b = render_float_sharded(rc, mesh)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_uneven_tiles_padded(self):
        from volrt.dist.render import render_float_sharded
        from volrt.renderers import batched

        rc = make_raycaster(
            Volume.from_numpy(synthetic_volume(16)),
            view=Camera(dims=(48, 30)).view(),  # 30 rows -> pad to 32
            interpolation="trilinear",
            light_kd=0.0,
        )
        mesh = make_mesh()
        a = batched.render_float(rc)
        b = render_float_sharded(rc, mesh)
        assert b.shape == (30, 48, 4)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    @pytest.mark.parametrize("shading,esl", [
        ("diffuse", False), ("phong", False), ("diffuse", True),
        ("phong", True)])
    def test_shaded_esl_matches_unsharded(self, shading, esl):
        """Each device's band runs rung 1's march with its own early exit;
        shading and the ESL leap are per-ray, so the stitched image equals
        the single-device render."""
        from volrt.dist.render import render_float_sharded
        from volrt.renderers import batched

        cam = Camera(dims=(32, 64))
        cam.set_camera_position((30.0, 20.0, 0.0))
        rc = make_raycaster(
            Volume.from_numpy(synthetic_volume(16)),
            view=cam.view(),
            interpolation="trilinear",
            shading=shading,
            esl=esl,
        )
        mesh = make_mesh()
        a = batched.render_float(rc)
        b = render_float_sharded(rc, mesh)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_bench_sharded_render_runs(self):
        """The scaling benchmark drives rung 1 over the full mesh and
        reports a finite efficiency (machinery validation; the real
        scaling number needs real devices)."""
        from volrt.bench.harness import bench_sharded_render

        m = bench_sharded_render(volume_size=16, viewport=64, iters=1)
        assert m["devices"] == 8
        assert m["ms_1dev"] > 0 and m["ms_ndev"] > 0
        assert np.isfinite(m["scaling_efficiency"])


@needs_devices
class TestShardedTraining:
    def test_step_matches_single_device(self):
        from volrt.train.fit import init_state, make_optimizer, make_train_step

        scene = scene_from_volume(
            jnp.asarray(synthetic_volume(8)), default_transfer_fn(), 0.2
        )
        cam = Camera(dims=(16, 16))
        cam.set_camera_position((30.0, 0.0, 0.0))
        view = cam.view()
        target = render_diff_image(scene, view) * 0.5

        opt = make_optimizer(0.01)
        mesh = make_mesh()

        s_single = init_state(scene, opt)
        step_single = make_train_step(opt)
        s1, loss1 = step_single(s_single, view, target)

        s_shard = jax.device_put(init_state(scene, opt), replicated(mesh))
        step_shard = make_train_step(opt, mesh=mesh)
        tgt = jax.device_put(target, rows_sharding(mesh))
        s2, loss2 = step_shard(s_shard, view, tgt)

        assert abs(float(loss1) - float(loss2)) < 1e-6
        np.testing.assert_allclose(
            np.asarray(s1.scene.density),
            np.asarray(s2.scene.density),
            atol=1e-6,
        )


@needs_devices
def test_dryrun_multichip():
    import sys

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_compiles():
    import sys

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


@needs_devices
class TestVolumeSharded:
    def test_matches_unsharded(self):
        from volrt.core.tf import default_transfer_fn
        from volrt.diff.render import render_diff_image, scene_from_volume
        from volrt.dist.volume_sharded import render_volume_sharded

        scene = scene_from_volume(
            jnp.asarray(synthetic_volume(16)), default_transfer_fn(), 0.15
        )
        cam = Camera(dims=(24, 24))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        mesh = make_mesh()
        a = np.asarray(render_diff_image(scene, view, ray_threshold=2.0))
        b = np.asarray(
            render_volume_sharded(scene, view, mesh, ray_threshold=2.0))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_cross_slab_ert_matches_unsharded(self):
        """v2's upstream-opacity scan makes ERT exact across slab
        boundaries: the sharded render matches the unsharded render at the
        same (enabled) threshold."""
        from volrt.core.tf import default_transfer_fn
        from volrt.diff.render import render_diff_image, scene_from_volume
        from volrt.dist.volume_sharded import render_volume_sharded

        # Dense volume so ERT actually triggers mid-volume.
        vol = np.full((16, 16, 16), 200, np.uint8)
        scene = scene_from_volume(
            jnp.asarray(vol), default_transfer_fn(), 0.15)
        cam = Camera(dims=(24, 24))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        mesh = make_mesh()
        a = np.asarray(render_diff_image(scene, view, ray_threshold=0.6))
        b = np.asarray(
            render_volume_sharded(scene, view, mesh, ray_threshold=0.6))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_device_placed_slabs(self):
        """shard_slabs_to_devices builds the sharded slab array without
        an in-graph full-volume stack and renders identically."""
        from volrt.core.tf import default_transfer_fn
        from volrt.diff.render import scene_from_volume
        from volrt.dist.volume_sharded import (
            render_volume_sharded, shard_slabs_to_devices)

        vol = synthetic_volume(16)
        scene = scene_from_volume(
            jnp.asarray(vol), default_transfer_fn(), 0.2)
        cam = Camera(dims=(16, 16))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        mesh = make_mesh()
        slabs = shard_slabs_to_devices(
            np.asarray(scene.density), mesh)
        a = np.asarray(render_volume_sharded(scene, view, mesh))
        b = np.asarray(
            render_volume_sharded(scene, view, mesh, slabs=slabs))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_differentiable(self):
        from volrt.core.tf import default_transfer_fn
        from volrt.diff.render import scene_from_volume
        from volrt.dist.volume_sharded import render_volume_sharded

        scene = scene_from_volume(
            jnp.asarray(synthetic_volume(16)), default_transfer_fn(), 0.2
        )
        cam = Camera(dims=(16, 16))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        mesh = make_mesh()

        def loss(s):
            return jnp.mean(render_volume_sharded(s, view, mesh) ** 2)

        g = jax.grad(loss)(scene)
        assert np.isfinite(np.asarray(g.density)).all()
        assert float(jnp.linalg.norm(g.density)) > 0


@needs_devices
class TestShardedFusedTraining:
    def test_fit_volume_sharded_trains(self):
        """End-to-end Z-slab-sharded training: loss decreases with the
        volume split across the mesh."""
        from volrt.diff.render import DiffScene
        from volrt.train.fit import fit

        vol = synthetic_volume(16)
        gt = scene_from_volume(
            jnp.asarray(vol), default_transfer_fn(), 0.15)
        cam = Camera(dims=(32, 32))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        target = render_diff_image(gt, view)
        scene = DiffScene(
            density=jnp.full(vol.shape, 0.3, jnp.float32),
            tf_base=default_transfer_fn(), ray_step=0.15)
        mesh = make_mesh()
        _, losses = fit(scene, [(view, target)], steps=3, lr=0.05,
                        train_tf=False, mesh=mesh, volume_sharded=True)
        assert losses[-1] < losses[0]

    def test_volume_sharded_shaded_matches_unsharded(self):
        """Shaded volume-sharded rendering (wider slab halos carry the
        light/gradient taps) equals the unsharded shaded diff renderer,
        for both diffuse and phong; gradients flow."""
        from volrt.dist.volume_sharded import render_volume_sharded

        vol = synthetic_volume(16)
        scene = scene_from_volume(
            jnp.asarray(vol), default_transfer_fn(), 0.15)
        cam = Camera(dims=(24, 24))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        mesh = make_mesh()
        for shading in ("diffuse", "phong"):
            ref = render_diff_image(
                scene, view, light_kd=0.6,
                shaded=(shading == "diffuse"),
                phong=(shading == "phong"))
            img = render_volume_sharded(
                scene, view, mesh, shading=shading, light_kd=0.6)
            np.testing.assert_allclose(
                np.asarray(img), np.asarray(ref), atol=2e-5)

            def loss(s, shading=shading):
                img = render_volume_sharded(
                    s, view, mesh, shading=shading, light_kd=0.6)
                return jnp.mean(img ** 2)

            g = jax.grad(loss)(scene)
            assert np.isfinite(np.asarray(g.density)).all()
            assert float(jnp.linalg.norm(g.density)) > 0

    def test_fit_volume_sharded_esl_raises(self):
        """The Z-slab march has no empty-space leap: fit refuses esl
        there instead of silently ignoring it."""
        from volrt.diff.render import DiffScene
        from volrt.train.fit import fit

        scene = DiffScene(
            density=jnp.full((16, 16, 16), 0.3, jnp.float32),
            tf_base=default_transfer_fn(), ray_step=0.15)
        view = Camera(dims=(16, 16)).view()
        with pytest.raises(NotImplementedError, match="esl"):
            fit(scene, [(view, jnp.zeros((16, 16, 4)))], steps=1,
                mesh=make_mesh(), volume_sharded=True, esl=True)

    def test_fit_volume_sharded_shaded_trains(self):
        from volrt.diff.render import DiffScene
        from volrt.train.fit import fit

        vol = synthetic_volume(16)
        gt = scene_from_volume(
            jnp.asarray(vol), default_transfer_fn(), 0.15)
        cam = Camera(dims=(24, 24))
        cam.set_camera_position((25.0, 10.0, 0.0))
        view = cam.view()
        target = render_diff_image(gt, view, light_kd=0.6, shaded=True)
        scene = DiffScene(
            density=jnp.full(vol.shape, 0.3, jnp.float32),
            tf_base=default_transfer_fn(), ray_step=0.15)
        mesh = make_mesh()
        _, losses = fit(scene, [(view, target)], steps=3, lr=0.05,
                        train_tf=False, mesh=mesh, volume_sharded=True,
                        shading="diffuse")
        assert losses[-1] < losses[0]

    def test_fit_fused_mesh_trains(self):
        from volrt.diff.render import DiffScene
        from volrt.train.fit import fit

        vol = synthetic_volume(12)
        gt = scene_from_volume(
            jnp.asarray(vol), default_transfer_fn(), 0.15)
        cam = Camera(dims=(32, 32))
        cam.set_camera_position((30.0, 20.0, 0.0))
        view = cam.view()
        target = render_diff_image(gt, view)
        scene = DiffScene(
            density=jnp.full(vol.shape, 0.3, jnp.float32),
            tf_base=default_transfer_fn(), ray_step=0.15)
        mesh = make_mesh()
        _, losses = fit(scene, [(view, target)], steps=3, lr=0.05,
                        train_tf=False, mesh=mesh)
        assert losses[-1] < losses[0]
