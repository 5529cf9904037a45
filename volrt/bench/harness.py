"""Scripted multi-configuration benchmark suite.

Rebuilds the reference benchmark mode (reference: VolR.cpp:225-321) in JAX:
the same sweep structure — datasets, optimization toggles (ERT/ESL), viewport
scales 0.9..0.3, ray-step factors 1.1..1.7 — across the renderer ladder, with
8 fixed camera poses per config (4 orientations x {ortho, perspective},
reference: VolR.cpp:233-248), a per-frame timeout analog, and avg/max/samples
CSV reports (reference: VolR.cpp:200-223). Adds derived rays/s and
rays*steps/s plus the differentiable fwd+bwd benchmark (no reference analog).
"""
from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from volrt.core.types import Raycaster, Volume, make_raycaster
from volrt.core.view import Camera
from volrt.utils.errors import is_oom
from volrt.utils.logger import get_logger
from volrt.utils.profiler import Profiler

MAX_BENCH_SAMPLE_MS = 7500.0  # reference: VolR.cpp:26

# 4 poses x {ortho, persp} (reference: VolR.cpp:233-248).
BENCH_ANGLES = [
    (0.0, 0.0, 0.0),
    (-90.0, 0.0, 0.0),
    (0.0, -90.0, 0.0),
    (45.0, 45.0, 0.0),
]


@dataclasses.dataclass
class BenchConfig:
    name: str
    volume_size: int = 64
    viewport: int = 256
    esl: bool = True
    ert: bool = True
    ray_step_factor: float = 1.0
    interpolation: str = "trilinear"
    light_kd: float = 0.6
    shading: str = "diffuse"  # "diffuse" (reference one-tap) | "phong"
    file: str | None = None  # PVM/RAW dataset (reference: VolR.cpp:255-268)


def synthetic_volume(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic procedural volume: soft shell + central blob."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
    shell = np.exp(-((r - 0.7) ** 2) / 0.02) * 200
    blob = np.exp(-(r ** 2) / 0.08) * 255
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0, 20, size=(n, n, n))
    return np.clip(shell + blob + noise, 0, 255).astype(np.uint8)


def default_suite(small: bool = False,
                  files: list[str] | None = None) -> list[BenchConfig]:
    """The benchmark sweep, mirroring the reference's 24-config structure
    (reference: VolR.cpp:34-38,270-321) with synthetic datasets, plus any
    real PVM/RAW datasets passed in ``files`` (the reference loads seven
    named PVM files, VolR.cpp:255-268)."""
    import os

    cfgs: list[BenchConfig] = []
    for path in files or []:
        cfgs.append(BenchConfig(
            os.path.splitext(os.path.basename(path))[0], file=path))
    # Dataset sweep (reference configs 1-7: seven PVM datasets).
    sizes = [32, 64, 128] if small else [32, 64, 128, 256]
    for n in sizes:
        cfgs.append(BenchConfig(f"synthetic_{n}", volume_size=n))
    # Nearest-neighbor config (the reference's GPURenderer1-3 sampling).
    cfgs.append(BenchConfig(
        "nearest_64", volume_size=64, interpolation="nearest"))
    # Unshaded config.
    cfgs.append(BenchConfig(
        "noshade_128" if not small else "noshade_64",
        volume_size=64 if small else 128, light_kd=0.0))
    # BASELINE config 4: gradient Blinn-Phong + ESL.
    cfgs.append(BenchConfig(
        "phong_esl_64" if small else "phong_esl_256",
        volume_size=64 if small else 256,
        viewport=256 if small else 512, shading="phong"))
    # Optimization toggles on one dataset (reference configs 8-10).
    base = 64 if small else 128
    cfgs.append(BenchConfig("no_optim", base, esl=False, ert=False))
    cfgs.append(BenchConfig("ert_only", base, esl=False, ert=True))
    cfgs.append(BenchConfig("ert_esl", base, esl=True, ert=True))
    # Viewport scale sweep (reference configs 11-17).
    for s in ([0.9, 0.5] if small else [0.9, 0.7, 0.5, 0.3]):
        cfgs.append(
            BenchConfig(f"viewport_{s}", base, viewport=int(512 * s))
        )
    # Ray-step factor sweep (reference configs 18-24).
    for f in ([1.1, 1.7] if small else [1.1, 1.3, 1.5, 1.7]):
        cfgs.append(BenchConfig(f"ray_step_{f}", base, ray_step_factor=f))
    return cfgs


def make_raycaster_for(cfg: BenchConfig, volume: Volume | None = None,
                       camera: Camera | None = None) -> Raycaster:
    from volrt.core.types import default_ray_step

    if volume is None:
        volume = Volume.from_numpy(synthetic_volume(cfg.volume_size))
    if camera is None:
        camera = Camera(dims=(cfg.viewport, cfg.viewport))
    step = default_ray_step(volume.dims) * cfg.ray_step_factor
    return make_raycaster(
        volume,
        view=camera.view(),
        ray_step=step,
        ray_threshold=0.95 if cfg.ert else 1.1,
        esl=cfg.esl,
        light_kd=cfg.light_kd,
        interpolation=cfg.interpolation,
        shading=cfg.shading,
    )


def renderer_fns(rc: Raycaster, renderers: list[int]):
    """(id, name, fn) for each requested ladder rung; ``fn()`` renders
    ``rc`` to ``f32[H, W, 4]``."""
    from volrt.renderers import get_renderer, renderer_name

    return [
        (rid, renderer_name(rid),
         lambda rc=rc, mod=get_renderer(rid): mod.render_float(rc))
        for rid in renderers
    ]


def run_suite(
    configs: list[BenchConfig] | None = None,
    renderers: list[int] = (0, 1),
    frames: int = 8,
    warmup: int = 1,
    profiler: Profiler | None = None,
    logger=None,
    trace_dir: str | None = None,
) -> Profiler:
    """Run the benchmark sweep; returns the filled profiler.

    Each (config, renderer) renders ``frames`` samples over the 8 reference
    camera poses; a renderer stops sampling a config once a frame exceeds
    the reference's 7.5 s timeout (reference: VolR.cpp:237), and skips a
    config that does not fit in device memory. Any other failure raises.
    The scalar golden rung (0) runs only on light configs — the
    reference's CPU-renderer skip for heavy configs (reference:
    VolR.cpp:228-230). ``trace_dir`` captures a ``jax.profiler`` trace of
    the timed frames (one directory per run; view with TensorBoard/XProf).
    """
    import contextlib

    log = (logger or get_logger()).log
    prof = profiler or Profiler()
    configs = configs if configs is not None else default_suite()

    for cfg in configs:
        if cfg.file:
            from volrt.io.pvm import load_volume

            data, _ = load_volume(cfg.file)
            volume = Volume.from_numpy(data)
        else:
            volume = Volume.from_numpy(synthetic_volume(cfg.volume_size))
        camera = Camera(dims=(cfg.viewport, cfg.viewport))
        poses = []
        for angles in BENCH_ANGLES:
            for persp in (False, True):
                camera.perspective = persp
                camera.toggle_perspective(update_mode=True)
                camera.set_camera_position(angles)
                poses.append(camera.view())

        for rid in renderers:
            if rid == 0 and (cfg.volume_size > 64 or cfg.viewport > 256
                             or cfg.file):
                # The vmapped per-ray golden rung is the CPURenderer
                # analog; the reference skips it on heavy configs
                # (reference: VolR.cpp:228-230).
                continue
            rc0 = make_raycaster_for(cfg, volume, camera)
            name = renderer_fns(rc0, [rid])[0][1]
            # Warm both projection modes: `perspective` is a static field,
            # so ortho and perspective poses compile separately.
            try:
                for wview in (poses[0], poses[1]):
                    img0 = renderer_fns(
                        rc0.replace(view=wview), [rid])[0][2]()
                    jax.block_until_ready(img0)
            except Exception as e:
                if not is_oom(e):
                    raise
                log(f"bench {cfg.name}/{name}: skipped, out of memory "
                    f"({e})")
                continue
            # Build every pose's closure before the timed region so frame
            # timings measure device work, not Python dispatch setup.
            frame_fns = [
                renderer_fns(rc0.replace(view=poses[f % len(poses)]),
                             [rid])[0][2]
                for f in range(frames)
            ]
            trace_cm = (
                jax.profiler.trace(trace_dir) if trace_dir
                else contextlib.nullcontext()
            )
            with trace_cm:
                for fn in frame_fns:
                    prof.start(cfg.name, name)
                    ms = prof.stop(fn())
                    if ms > MAX_BENCH_SAMPLE_MS:
                        log(f"bench {cfg.name}/{name}: frame took "
                            f"{ms:.0f} ms, over the "
                            f"{MAX_BENCH_SAMPLE_MS:.0f} ms timeout")
                        break
        log(f"bench config {cfg.name} done")
    return prof


def _headline_scene_view(volume_size: int, viewport: int,
                         ray_step: float | None):
    """The headline accounting (BASELINE config 3 shape): a synthetic
    ``volume_size^3`` scene and an ortho view zoomed so the viewport
    covers exactly the volume cube, so every ray marches."""
    from volrt.core.tf import default_transfer_fn
    from volrt.core.types import default_ray_step
    from volrt.diff.render import scene_from_volume

    if ray_step is None:
        ray_step = default_ray_step((volume_size,) * 3)
    scene = scene_from_volume(
        jnp.asarray(synthetic_volume(volume_size)), default_transfer_fn(),
        ray_step)
    cam = Camera(dims=(viewport, viewport))
    cam.zoom(-1.0)  # distance 2.0 -> ortho view spans [-1, 1]
    return scene, cam.view()


def _time(fn, iters: int) -> float:
    """Seconds per call of ``fn()`` after one warm-up call, each timed
    to ``block_until_ready``."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _rates(dt: float, viewport: int, ray_step: float) -> dict:
    n_rays = viewport * viewport
    n_steps = int(2.0 / ray_step)  # in-cube steps per ray (full march)
    return {
        "ms": dt * 1e3,
        "rays_per_s": n_rays / dt,
        "ray_steps_per_s": n_rays * n_steps / dt,
    }


def run_diff_suite(
    configs: list[tuple[int, int]] | None = None,
    frames: int = 4,
    profiler: Profiler | None = None,
    logger=None,
) -> Profiler:
    """Differentiable fwd+bwd sweep in the reference CSV-report style
    (no reference analog — the reference has no backward): one row per
    (volume_size, viewport) config, each frame a full L2 loss+grad step
    through XLA autodiff (:mod:`volrt.diff.render`). A config that does
    not fit in device memory is skipped; any other failure raises.
    """
    from volrt.train.fit import l2_loss

    log = (logger or get_logger()).log
    prof = profiler or Profiler()
    if configs is None:
        configs = [(64, 256), (128, 512), (256, 1024)]
    name = "xla-diff"
    grad_fn = jax.value_and_grad(l2_loss)
    if jax.default_backend() != "cpu":
        # The outer jit fuses the whole step on accelerators; on CPU a
        # second differently-shaped outer-jit-of-grad-of-inner-jit trace
        # trips a JAX 0.9 executable-lookup bug ("Execution supplied 8
        # buffers but compiled program expected 15"), and the inner
        # render jit already carries the compute.
        grad_fn = jax.jit(grad_fn)
    for n, viewport in configs:
        cfg = f"diff_{n}_{viewport}"
        scene, view = _headline_scene_view(n, viewport, None)
        target = jnp.zeros((viewport, viewport, 4), jnp.float32)
        try:
            jax.block_until_ready(grad_fn(scene, view, target))
        except Exception as e:
            if not is_oom(e):
                raise
            log(f"bench {cfg}/{name}: skipped, out of memory ({e})")
            continue
        timed_out = False
        for _ in range(frames):
            prof.start(cfg, name)
            ms = prof.stop(grad_fn(scene, view, target))
            if ms > MAX_BENCH_SAMPLE_MS:
                timed_out = True
                break
        log(f"bench config {cfg} done"
            + (" (timed out)" if timed_out else ""))
    return prof


def bench_diff_step(
    volume_size: int = 256,
    viewport: int = 1024,
    ray_step: float | None = None,
    iters: int = 10,
) -> dict:
    """Benchmark one differentiable forward+backward step (L2 loss and
    its gradients through XLA autodiff) under the headline accounting:
    ERT off and a viewport that covers the cube, so every ray takes the
    full ~2/ray_step steps and rays*steps/s counts real work."""
    from volrt.diff.render import render_diff_image

    scene, view = _headline_scene_view(volume_size, viewport, ray_step)
    target = jnp.zeros((viewport, viewport, 4), jnp.float32)

    def loss_fn(scene):
        img = render_diff_image(scene, view, ray_threshold=2.0)
        return jnp.mean((img - target) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    loss, _ = grad_fn(scene)
    dt = _time(lambda: grad_fn(scene), iters)
    return {**_rates(dt, viewport, scene.ray_step), "loss": float(loss)}


def bench_fwd_step(
    volume_size: int = 256,
    viewport: int = 1024,
    ray_step: float | None = None,
    iters: int = 10,
    shading: str | None = None,
    esl: bool = False,
) -> dict:
    """Benchmark one rung-1 forward render under the headline accounting
    (full-cube viewport, no ERT). ``shading``: None (unshaded),
    "diffuse", or "phong" — the latter is BASELINE config 4 when combined
    with ``esl=True``."""
    from volrt.renderers import batched

    scene, view = _headline_scene_view(volume_size, viewport, ray_step)
    rc = make_raycaster(
        Volume.from_numpy(synthetic_volume(volume_size)), view=view,
        ray_step=scene.ray_step, ray_threshold=2.0, esl=esl,
        light_kd=0.6 if shading else 0.0,
        interpolation="trilinear", shading=shading or "diffuse")
    dt = _time(lambda: batched.render_float(rc), iters)
    return _rates(dt, viewport, scene.ray_step)


def bench_sharded_render(
    volume_size: int = 64,
    viewport: int = 512,
    iters: int = 10,
) -> dict:
    """Scaling benchmark: rung 1 over pixel-row bands of all local
    devices vs one device (:func:`volrt.dist.render.render_float_sharded`;
    BASELINE scaling-efficiency metric). Under the CPU test mesh it
    validates the machinery only."""
    from volrt.dist.mesh import make_mesh
    from volrt.dist.render import render_float_sharded

    volume = Volume.from_numpy(synthetic_volume(volume_size))
    cam = Camera(dims=(viewport, viewport))
    rc = make_raycaster_for(
        BenchConfig("sharded", volume_size, viewport), volume, cam
    )

    results = {}
    n = jax.device_count()
    for ndev in {1, n}:
        mesh = make_mesh(jax.devices()[:ndev])
        results[ndev] = _time(lambda: render_float_sharded(rc, mesh), iters)
    eff = (
        results[1] / (results[n] * n) if n > 1 and results.get(n) else 1.0
    )
    return {
        "devices": n,
        "ms_1dev": results[1] * 1e3,
        "ms_ndev": results.get(n, results[1]) * 1e3,
        "scaling_efficiency": eff,
    }
