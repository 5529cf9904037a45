"""Smoke test of volrt on a GPU: the render and training paths at full size.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs: fit --dist rays / volume vs one

With no option it drives, in this one process and through ``volrt.cli.main``
as a user would, BASELINE config 3's shape: a 256^3 synthetic volume, a
1024x1024 viewport, trilinear sampling and the default transfer function.

1. ``volrt render`` with rung 1 (the batched XLA march).
2. ``volrt fit`` for 3 steps of the XLA autodiff training step; the loss must
   be finite and must fall.
3. Parity: rung 1's image and the L2 loss gradients computed on the GPU
   against the plain references (golden rung 0, ``diff/render.py``) run on
   this process's CPU device, over a 16-row band through the centre of the
   1024^2 view and the full 256^3 volume.
4. The tests marked ``gpu`` (``tests/test_gpu.py``), in process.

``--four`` runs only one training step of ``fit --dist rays`` and of
``fit --dist volume`` on four GPUs and the same step on one, and compares
their losses and gradients.

Earlier lines are informative: the card's name and power limit, JAX's
version and ``XLA_FLAGS``, compile seconds, step times, memory. The last line
is one JSON object naming the device. Without a GPU, or when any phase fails,
the script exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

SIZE, VIEWPORT, FIT_STEPS = 256, 1024, 3
BAND_ROWS = 16
TIMED_ITERS = 3

# Forward parity, max abs over the band's RGBA with ERT off. Both sides
# evaluate the same float32 ops, but XLA's CPU and GPU code round
# differently (FMA contraction, rsqrt and division), about 1e-7 per op,
# compounding over ~450 composite steps to ~1e-5. The bound leaves room for
# that and is still far below one sample's contribution (the TF's smallest
# nonzero alpha step is ~1e-2).
FWD_ATOL = 1e-3
# With ERT on, a ray whose opacity lands within rounding of the threshold
# stops one sample earlier on one side: that pixel moves by up to
# (1 - threshold) x |color| (< 0.1). Such pixels are rare; at most this
# share of the band may exceed FWD_ATOL, and none ERT_FLIP_MAX_ABS.
ERT_FLIP_SHARE = 1e-3
ERT_FLIP_MAX_ABS = 0.1
# Gradient parity. The density gradient is discontinuous wherever a sample
# value crosses a TF bucket edge (the TF is piecewise linear), and across
# ~5 M samples float32 rounding puts some samples on the other side of an
# edge. On the 1024^2 view that moves the float32 gradient ~1e-2 (relative
# L2) away from a float64 evaluation, on the CPU as on the GPU. So the
# check is that the GPU's float32 gradient is no further from the float64
# reference (the same code on the CPU under jax_enable_x64) than the CPU's
# own float32 gradient, within this factor and floor. ERT is off here for
# the same reason as above.
GRAD_ERR_RATIO = 2.0
GRAD_ERR_FLOOR = 1e-5
# Four cards vs one: the loss is a sum over pixels reduced in another order,
# so it may move by float32 reassociation only. The gradients obey the same
# rule as above against the float64 one-card gradient.
FOUR_LOSS_RTOL = 1e-5


def say(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """The first device, which must be a GPU; raises otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {dev.platform!r}")
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _timed(fn, iters: int = TIMED_ITERS):
    """(seconds per call, last result) of ``fn()`` after one warm call,
    timed to ``block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def _nominal_rate(seconds: float, w: int, h: int, ray_step: float) -> float:
    """rays*steps/s counting every pixel's ray at the full in-cube
    ~2/ray_step steps (the headline convention; rays that miss the cube or
    stop early count too)."""
    return w * h * int(2.0 / ray_step) / seconds


def phase_render(size: int, viewport: int, workdir: str):
    """``volrt render`` (rung 1) to PNG, then the same frame timed.

    Returns ``(raycaster, f32[H, W, 4] image as numpy)``."""
    import numpy as np

    from volrt import cli
    from volrt.renderers import batched
    from volrt.viz import read_png

    argv = ["render", "--synthetic", str(size), "-r", "1",
            "-s", str(viewport), str(viewport),
            "-o", os.path.join(workdir, "render.png"),
            "--log", os.path.join(workdir, "render.log")]
    # Compile first, so the number is the compile alone; the CLI's own
    # call then finds the program in JAX's cache.
    rc = cli._make_rc(cli.build_parser().parse_args(argv))
    t0 = time.perf_counter()
    batched.render_float.lower(rc).compile()
    compile_s = time.perf_counter() - t0
    if cli.main(argv) != 0:
        raise RuntimeError("volrt render failed")
    png = read_png(os.path.join(workdir, "render.png"))
    if png.shape != (viewport, viewport, 4) or not png[..., :3].any():
        raise RuntimeError(f"bad render: shape {png.shape}, "
                           f"max {int(png.max())}")

    dt, img = _timed(lambda: batched.render_float(rc))
    img = np.asarray(img)
    if img.shape != (viewport, viewport, 4) or not np.isfinite(img).all():
        raise RuntimeError("rung-1 image is not finite or has a wrong shape")
    say(f"render: {size}^3 volume, {viewport}x{viewport}, rung 1 "
        f"(xla-batched), trilinear, ERT+ESL on: compile {compile_s:.2f} s, "
        f"{dt * 1e3:.3f} ms/frame, nominal "
        f"{_nominal_rate(dt, viewport, viewport, rc.ray_step):.4g} "
        f"rays*steps/s")
    return rc, img


def _fit_losses(log_path: str) -> list[float]:
    with open(log_path) as f:
        return [float(m.group(1)) for m in
                re.finditer(r"fit step \d+: loss (\S+)", f.read())]


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "not available"
    return ", ".join(
        f"{k} {getattr(m, k) / 2**20:.1f} MiB"
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "alias_size_in_bytes",
                  "generated_code_size_in_bytes")
        if getattr(m, k, None) is not None)


def phase_fit(size: int, viewport: int, steps: int, workdir: str) -> list:
    """``volrt fit`` for ``steps`` steps, then its train step compiled
    alone (memory analysis) and timed. Returns the fit's losses."""
    import jax
    import jax.numpy as jnp

    from volrt import cli
    from volrt.bench.harness import synthetic_volume
    from volrt.core.tf import default_transfer_fn
    from volrt.core.types import default_ray_step
    from volrt.core.view import Camera
    from volrt.diff.render import DiffScene, render_diff_image
    from volrt.diff.render import scene_from_volume
    from volrt.train.fit import init_state, make_optimizer, make_train_step

    log = os.path.join(workdir, "fit.log")
    argv = ["fit", "-s", str(viewport), str(viewport),
            "--synthetic", str(size), "--steps", str(steps), "--log", log]
    if cli.main(argv) != 0:
        raise RuntimeError("volrt fit failed")
    losses = _fit_losses(log)
    say("fit losses: " + ", ".join(f"{x:.6f}" for x in losses))
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"fit losses missing or not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"fit loss did not fall: {losses}")

    # The step `volrt fit` ran (density-only L2, lr 0.05, first pose),
    # compiled as one program.
    step = default_ray_step((size,) * 3)
    gt = scene_from_volume(
        jnp.asarray(synthetic_volume(size)), default_transfer_fn(), step)
    cam = Camera(dims=(viewport, viewport))
    cam.set_camera_position((0.0, 0.0, 0.0))
    view = cam.view()
    target = render_diff_image(gt, view)
    opt = make_optimizer(0.05)
    state = init_state(DiffScene(
        density=jnp.full(gt.density.shape, 0.3, jnp.float32),
        tf_base=gt.tf_base, ray_step=step), opt)
    train_step = jax.jit(make_train_step(opt, train_tf=False))
    t0 = time.perf_counter()
    compiled = train_step.lower(state, view, target).compile()
    compile_s = time.perf_counter() - t0
    say(f"fit step memory_analysis: {_memory_line(compiled)}")
    dt, _ = _timed(lambda: compiled(state, view, target))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    rate = _nominal_rate(dt, viewport, viewport, step)
    say(f"fit step: {size}^3 volume, {viewport}x{viewport}, density-only "
        f"XLA autodiff + Adam: compile {compile_s:.2f} s, "
        f"{dt * 1e3:.3f} ms/step, nominal {rate:.4g} rays*steps/s; "
        f"peak_bytes_in_use of the process so far "
        + (f"{peak / 2**30:.2f} GiB" if peak is not None
           else "not available"))
    return losses


def _rel_l2(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _to_f64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        tree)


def grad_errors(grads32: dict, loss_fn, args) -> dict:
    """Relative L2 distance of each float32 gradient in ``grads32``
    (name -> gradient pytree with ``density``/``tf_base``) from
    ``value_and_grad(loss_fn)(*args)`` evaluated in float64 where
    ``args`` live."""
    import jax

    with jax.enable_x64(True):
        _, g64 = jax.value_and_grad(loss_fn)(*_to_f64(args))
        return {f"{name}_{leaf}": _rel_l2(getattr(g, leaf),
                                          getattr(g64, leaf))
                for name, g in grads32.items()
                for leaf in ("density", "tf_base")}


def no_worse(err: float, ref_err: float) -> bool:
    return err <= GRAD_ERR_RATIO * ref_err + GRAD_ERR_FLOOR


def phase_parity(rc, img, band_rows: int = BAND_ROWS) -> dict:
    """Rung 1's image ``img`` of ``rc`` and the L2 gradients on the GPU
    against the plain references on this process's CPU device, over the
    ``band_rows`` rows through the centre of the view and the full volume.
    The renderers contain no device matmul, so TF32 never enters;
    ``highest`` precision pins it anyway."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from volrt.core.tf import default_transfer_fn
    from volrt.diff.render import render_diff_image, scene_from_volume
    from volrt.renderers import batched, golden
    from volrt.utils.errors import band_view

    cpu = jax.devices("cpu")[0]
    w, h = rc.view.dims
    r0 = h // 2 - band_rows // 2
    band = band_view(rc.view, r0, band_rows)
    out = {}
    with jax.default_matmul_precision("highest"):
        # ERT on, as `volrt render` drew it.
        ref = np.asarray(golden.render_float(
            jax.device_put(rc.replace(view=band), cpu)))
        err = np.abs(img[r0:r0 + band_rows] - ref).max(axis=-1)
        out["fwd_ert_share_over"] = float((err > FWD_ATOL).mean())
        out["fwd_ert_max_abs"] = float(err.max())
        # ERT off.
        rc_full = rc.replace(view=band, ray_threshold=jnp.float32(2.0))
        img_full = np.asarray(batched.render_float(rc_full))
        ref_full = np.asarray(golden.render_float(
            jax.device_put(rc_full, cpu)))
        out["fwd_max_abs"] = float(np.abs(img_full - ref_full).max())

        scene = scene_from_volume(
            rc.volume.data, default_transfer_fn(), rc.ray_step)
        target = jnp.zeros((band_rows, w, 4), jnp.float32)

        def loss(s, v, t):
            img = render_diff_image(s, v, ray_threshold=2.0)
            return jnp.mean((img - t) ** 2)

        args_cpu = jax.device_put((scene, band, target), cpu)
        _, g_dev = jax.value_and_grad(loss)(scene, band, target)
        _, g_cpu = jax.value_and_grad(loss)(*args_cpu)
        out.update(grad_errors({"dev": g_dev, "cpu": g_cpu}, loss,
                               args_cpu))
    say(f"parity over rows [{r0}, {r0 + band_rows}) of the {w}x{h} view, "
        f"full volume. Forward vs golden rung 0 on the CPU: ERT off max "
        f"abs {out['fwd_max_abs']:.3g} (tol {FWD_ATOL:g}); ERT on max abs "
        f"{out['fwd_ert_max_abs']:.3g}, share of pixels over {FWD_ATOL:g}: "
        f"{out['fwd_ert_share_over']:.3g} (tol {ERT_FLIP_SHARE:g})")
    say("gradient rel L2 from the float64 CPU reference (ERT off): "
        f"density GPU {out['dev_density']:.3g} vs CPU float32 "
        f"{out['cpu_density']:.3g}; TF GPU {out['dev_tf_base']:.3g} vs CPU "
        f"float32 {out['cpu_tf_base']:.3g}; GPU vs CPU float32 directly: "
        f"density {_rel_l2(g_dev.density, g_cpu.density):.3g}, TF "
        f"{_rel_l2(g_dev.tf_base, g_cpu.tf_base):.3g} (tol: GPU error <= "
        f"{GRAD_ERR_RATIO:g} x CPU error + {GRAD_ERR_FLOOR:g})")
    ok = (out["fwd_max_abs"] <= FWD_ATOL
          and out["fwd_ert_share_over"] <= ERT_FLIP_SHARE
          and out["fwd_ert_max_abs"] < ERT_FLIP_MAX_ABS
          and no_worse(out["dev_density"], out["cpu_density"])
          and no_worse(out["dev_tf_base"], out["cpu_tf_base"]))
    if not ok:
        raise RuntimeError(f"parity outside tolerance: {out}")
    return out


def phase_gpu_tests() -> int:
    """Run the tests marked ``gpu`` in this process; returns passes."""
    import pytest

    class Count:
        passed = 0
        skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            if report.skipped:
                self.skipped += 1

    count = Count()
    os.environ["VOLRT_TEST_GPU"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "--rootdir", here,
         "-c", os.path.join(here, "pyproject.toml"),
         os.path.join(here, "tests", "test_gpu.py")], plugins=[count])
    if rc != 0 or count.skipped or not count.passed:
        raise RuntimeError(
            f"gpu tests: exit {int(rc)}, {count.passed} passed, "
            f"{count.skipped} skipped")
    say(f"gpu tests: {count.passed} passed")
    return count.passed


def phase_four(size: int, viewport: int, n: int = 4) -> dict:
    """One training step of ``fit --dist rays`` and ``fit --dist volume``
    on ``n`` devices against the same step on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from volrt.bench.harness import synthetic_volume
    from volrt.core.tf import default_transfer_fn
    from volrt.core.types import default_ray_step
    from volrt.core.view import Camera
    from volrt.diff.render import render_diff_image, scene_from_volume
    from volrt.dist.mesh import make_mesh, replicated, rows_sharding
    from volrt.dist.volume_sharded import (
        render_volume_sharded, shard_slabs_to_devices)
    from volrt.train.fit import make_loss_fn

    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)}")
    meshes = {k: make_mesh(devs[:k]) for k in (1, n)}
    step = default_ray_step((size,) * 3)
    gt = scene_from_volume(
        jnp.asarray(synthetic_volume(size)), default_transfer_fn(), step)
    cam = Camera(dims=(viewport, viewport))
    cam.set_camera_position((0.0, 0.0, 0.0))
    view = cam.view()
    target = render_diff_image(gt, view)
    scene = gt.replace(density=jnp.full(gt.density.shape, 0.3, jnp.float32))

    def rays_step(mesh):
        # The row-sharded step of `fit --dist rays`: replicated scene,
        # target rows split over the mesh, gradients all-reduced by XLA.
        s, v = jax.device_put((scene, view), replicated(mesh))
        t = jax.device_put(target, rows_sharding(mesh))
        vg = jax.jit(jax.value_and_grad(make_loss_fn()),
                     out_shardings=replicated(mesh))
        return lambda: vg(s, v, t)

    def volume_step(mesh):
        # The Z-slab step of `fit --dist volume`.
        vg = jax.value_and_grad(make_loss_fn(volume_mesh=mesh))
        return lambda: vg(scene, view, target)

    out = {}
    for mode, make in (("rays", rays_step), ("volume", volume_step)):
        res = {}
        for k in (1, n):
            dt, (loss, g) = _timed(make(meshes[k]))
            res[k] = (dt, float(loss), g)
        loss_fn = (make_loss_fn() if mode == "rays"
                   else make_loss_fn(volume_mesh=meshes[1]))
        err = grad_errors({"one": res[1][2], "four": res[n][2]}, loss_fn,
                          jax.device_put((scene, view, target), devs[0]))
        loss_rel = abs(res[n][1] - res[1][1]) / abs(res[1][1])
        out[mode] = {"loss_rel": loss_rel, **err}
        say(f"fit --dist {mode}, one step at {size}^3/{viewport}^2: {n} "
            f"devices {res[n][0] * 1e3:.3f} ms vs 1 device "
            f"{res[1][0] * 1e3:.3f} ms; loss {res[n][1]:.8g} vs "
            f"{res[1][1]:.8g} (rel {loss_rel:.3g}, tol {FOUR_LOSS_RTOL:g});"
            f" gradient rel L2 from float64 on 1 device: density {n} "
            f"{err['four_density']:.3g} vs 1 {err['one_density']:.3g}, TF "
            f"{err['four_tf_base']:.3g} vs {err['one_tf_base']:.3g}; {n} vs "
            f"1 directly: density "
            f"{_rel_l2(res[n][2].density, res[1][2].density):.3g}, TF "
            f"{_rel_l2(res[n][2].tf_base, res[1][2].tf_base):.3g}")
        if not (loss_rel <= FOUR_LOSS_RTOL
                and no_worse(err["four_density"], err["one_density"])
                and no_worse(err["four_tf_base"], err["one_tf_base"])):
            raise RuntimeError(f"--dist {mode}: {n} devices do not match 1")

    # Every slab lands on its own device, and the device-placed slabs
    # render the same image as the in-graph slab split.
    mesh = meshes[n]
    slabs = shard_slabs_to_devices(np.asarray(scene.density), mesh)
    placed = {s.device: s.data.shape for s in slabs.addressable_shards}
    want = (1, size // n + 2, size, size)
    if set(placed) != set(devs[:n]) or set(placed.values()) != {want}:
        raise RuntimeError(f"slab placement {placed}, want {want} on each "
                           f"of {devs[:n]}")
    a = render_volume_sharded(scene, view, mesh)
    b = render_volume_sharded(scene, view, mesh, slabs=slabs)
    placed_err = float(jnp.abs(a - b).max())
    in_use = [(d.memory_stats() or {}).get("bytes_in_use")
              for d in devs[:n]]
    say(f"slabs: one {want[1:]} slab on each of {n} devices; image from "
        f"device-placed slabs differs by {placed_err:.3g}; bytes_in_use "
        "per device " + ", ".join(
            "not available" if b is None else f"{b / 2**30:.2f} GiB"
            for b in in_use))
    if placed_err > 1e-6:
        raise RuntimeError("device-placed slabs render a different image")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU --dist rays/volume phase")
    args = ap.parse_args(argv)
    try:
        from volrt.utils.compile_cache import setup_compile_cache

        setup_compile_cache()
        import jax

        dev = require_gpu()
        say(card_line())
        say(f"jax {jax.__version__}; XLA_FLAGS="
            f"{os.environ.get('XLA_FLAGS', '')!r}")
        if args.four:
            phase_four(SIZE, VIEWPORT)
        else:
            with tempfile.TemporaryDirectory() as workdir:
                rc, img = phase_render(SIZE, VIEWPORT, workdir)
                phase_fit(SIZE, VIEWPORT, FIT_STEPS, workdir)
            phase_parity(rc, img)
            phase_gpu_tests()
    except Exception:
        traceback.print_exc()
        print("chip_smoke failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
