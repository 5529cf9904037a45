"""Tests that need a GPU. They skip elsewhere; ``python chip_smoke.py`` runs
them on the card, where each compares the GPU's result with the same plain
reference run on the CPU device of the same process (tolerances as in
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import FWD_ATOL, grad_errors, no_worse
from volrt.bench.harness import synthetic_volume
from volrt.core.tf import default_transfer_fn
from volrt.core.types import Volume, make_raycaster
from volrt.core.view import Camera
from volrt.diff.render import DiffScene, render_diff_image, scene_from_volume
from volrt.renderers import batched, golden
from volrt.train.fit import fit

pytestmark = pytest.mark.gpu


def _view(w=48, h=40):
    cam = Camera(dims=(w, h))
    cam.set_camera_position((30.0, 20.0, 0.0))
    return cam.view()


@pytest.mark.parametrize("shading", ["diffuse", "phong"])
def test_rung1_matches_golden_on_cpu(gpu, shading):
    rc = make_raycaster(
        Volume.from_numpy(synthetic_volume(40)), view=_view(),
        interpolation="trilinear", shading=shading, ray_threshold=2.0)
    img = np.asarray(batched.render_float(jax.device_put(rc, gpu)))
    ref = np.asarray(golden.render_float(
        jax.device_put(rc, jax.devices("cpu")[0])))
    assert np.abs(img - ref).max() <= FWD_ATOL


def _loss_no_ert(scene, view, target):
    img = render_diff_image(scene, view, ray_threshold=2.0)
    return jnp.mean((img - target) ** 2)


def test_diff_grads_match_cpu(gpu):
    scene = scene_from_volume(
        jnp.asarray(synthetic_volume(40)), default_transfer_fn(), 0.05)
    view = _view()
    target = jnp.zeros((40, 48, 4), jnp.float32)
    args_cpu = jax.device_put((scene, view, target), jax.devices("cpu")[0])
    grad = jax.value_and_grad(_loss_no_ert)
    _, g = grad(*jax.device_put((scene, view, target), gpu))
    _, g_cpu = grad(*args_cpu)
    err = grad_errors({"gpu": g, "cpu": g_cpu}, _loss_no_ert, args_cpu)
    assert no_worse(err["gpu_density"], err["cpu_density"]), err
    assert no_worse(err["gpu_tf_base"], err["cpu_tf_base"]), err


def test_fit_loss_falls(gpu):
    gt = scene_from_volume(
        jnp.asarray(synthetic_volume(32)), default_transfer_fn(), 0.06)
    view = _view()
    target = render_diff_image(gt, view)
    scene = DiffScene(density=jnp.full(gt.density.shape, 0.3, jnp.float32),
                      tf_base=gt.tf_base, ray_step=gt.ray_step)
    _, losses = fit(scene, [(view, target)], steps=4, lr=0.05,
                    train_tf=False)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
