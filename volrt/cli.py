"""Command-line interface: ``volrt render | bench | fit | info``.

The offline replacement for the reference's interactive app + CLI
(reference: VolR.cpp:339-410): the same knob set — file, renderer, viewport
scale, ray step, ERT/ESL toggles, benchmark mode — exposed as flags; frames
render to PNG instead of a GLUT window (interactivity is subsumed by
"render(view, tf, params) is a fast jitted function").
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-f", "--file", help="PVM/DDS/RAW volume file "
                   "(default: built-in synthetic volume)")
    p.add_argument("--synthetic", type=int, default=64,
                   help="synthetic volume size if no file given")
    p.add_argument("-r", "--renderer", type=int, default=1,
                   help="renderer id 0-1 (reference: -r flag; 0 = golden "
                   "reference, 1 = batched XLA march)")
    p.add_argument("-s", "--size", type=int, nargs=2, default=(512, 512),
                   metavar=("W", "H"), help="viewport size")
    p.add_argument("--scale", type=float, default=1.0,
                   help="viewport scale factor (reference GLUI slider)")
    p.add_argument("--ray-step", type=float, default=None)
    p.add_argument("--ray-threshold", type=float, default=0.95)
    p.add_argument("--no-esl", action="store_true")
    p.add_argument("--no-ert", action="store_true")
    p.add_argument("--light-kd", type=float, default=0.6)
    p.add_argument("--shading", choices=("diffuse", "phong"),
                   default="diffuse",
                   help="diffuse = reference one-tap shading; phong = "
                   "gradient Blinn-Phong")
    p.add_argument("--interpolation", choices=("nearest", "trilinear"),
                   default="trilinear")
    p.add_argument("--angles", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="camera orbit angles (deg)")
    p.add_argument("--distance", type=float, default=3.0)
    p.add_argument("--perspective", action="store_true")
    p.add_argument("--tf", default=None,
                   help=".npy transfer-function LUT (128x4 RGBA)")
    p.add_argument("--raw-dims", type=int, nargs=3, default=None,
                   metavar=("W", "H", "D"),
                   help="dimensions for headerless .raw volumes")
    p.add_argument("--raw-components", type=int, default=1,
                   help=".raw voxel components (2 = 16-bit, quantized)")


def _load_volume(args):
    from volrt.core.types import Volume

    if args.file:
        from volrt.io.pvm import load_volume

        vol, meta = load_volume(
            args.file,
            raw_dims=tuple(args.raw_dims) if getattr(
                args, "raw_dims", None) else None,
            raw_components=getattr(args, "raw_components", 1),
        )
        return Volume.from_numpy(vol), meta
    from volrt.bench.harness import synthetic_volume

    return Volume.from_numpy(synthetic_volume(args.synthetic)), {}


def _make_rc(args, camera=None):
    from volrt.core.types import make_raycaster
    from volrt.core.view import Camera

    base_tf = None
    if getattr(args, "tf", None):
        from volrt.core.tf import load_tf

        base_tf = load_tf(args.tf)
    volume, _ = _load_volume(args)
    w, h = args.size
    cam = camera
    if cam is None:
        cam = Camera(dims=(int(w * args.scale), int(h * args.scale)),
                     perspective=args.perspective)
        cam.toggle_perspective(update_mode=True)
        cam.set_camera_position(tuple(args.angles), args.distance)
    return make_raycaster(
        volume,
        view=cam.view(),
        base_transfer_fn=base_tf,
        ray_step=args.ray_step,
        ray_threshold=1.1 if args.no_ert else args.ray_threshold,
        esl=not args.no_esl,
        light_kd=args.light_kd,
        interpolation=args.interpolation,
        shading=getattr(args, "shading", "diffuse"),
    )


def _render_frame(mod, rc, log):
    """Render one frame -> ``uint8[H, W, 4]``. Frames that exhaust device
    memory are retried in row bands (the ``cuda_safe_malloc`` soft-OOM
    analog, reference: cuda_utils.h:43-49)."""
    from volrt.core import sampling
    from volrt.utils.errors import render_with_oom_fallback

    fimg = render_with_oom_fallback(mod.render_float, rc, log=log)
    return np.asarray(sampling.write_color(fimg))


def _composite_bg(img, bg):
    """Composite the premultiplied uint8 frame over a grayscale
    background exactly like the reference's display blend
    (GL_SRC_ALPHA / ONE_MINUS_SRC_ALPHA over glClearColor(bg, bg, bg);
    reference: UI.cpp:122-128, 431-433) -> (H, W, 3) uint8."""
    import numpy as np

    f = img.astype(np.float32) / 255.0
    a = f[..., 3:4]
    rgb = f[..., :3] * a + bg * (1.0 - a)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def cmd_render(args) -> int:
    from volrt.renderers import get_renderer, renderer_name
    from volrt.utils.logger import Logger
    from volrt.viz import write_png

    # The session closes (and logs its runtime) before the command returns,
    # so nothing of it reaches stdout after the caller's own output.
    with Logger(args.log, quiet=False) as log:
        rc = _make_rc(args)
        mod = get_renderer(args.renderer)
        log.log_time("rendering with %s ...", renderer_name(args.renderer))
        if args.orbit <= 1:
            img = _render_frame(mod, rc, log)
            if args.background is not None:
                img = _composite_bg(img, args.background)
            write_png(args.output, img[::-1])  # y-up buffer -> top-down PNG
            log.log_time("wrote %s (%dx%d)", args.output,
                         img.shape[1], img.shape[0])
            return 0

        # Orbit sequence: the offline analog of the reference's
        # auto-rotate (reference: UI.cpp:132-139): same jitted render, new
        # camera per frame.
        from volrt.core.view import Camera
        from volrt.utils.errors import safe_call

        base, ext = (args.output.rsplit(".", 1) + ["png"])[:2]
        step_deg = 360.0 / args.orbit
        cam = Camera(dims=rc.view.dims, perspective=args.perspective)
        cam.toggle_perspective(update_mode=True)
        cam.set_camera_position(tuple(args.angles), args.distance)
        for i in range(args.orbit):
            frame_rc = rc.replace(view=cam.view())
            # -nosafe continues past per-frame failures (reference:
            # VolR.cpp:404-406, cuda_utils.h:28-29).
            img, err = safe_call(
                _render_frame, mod, frame_rc, log,
                log=log, nosafe=args.nosafe, what=f"orbit frame {i}")
            if err is not None:
                cam.rotate((0.0, step_deg, 0.0))
                continue
            path = f"{base}_{i:04d}.{ext}"
            if args.background is not None:
                img = _composite_bg(img, args.background)
            write_png(path, img[::-1])
            log.log_time("frame %d/%d -> %s", i + 1, args.orbit, path)
            cam.rotate((0.0, step_deg, 0.0))
        return 0


def cmd_bench(args) -> int:
    from volrt.bench.harness import (
        default_suite, run_diff_suite, run_suite)
    from volrt.utils.logger import Logger

    with Logger(args.log) as log:
        prof = run_suite(
            configs=default_suite(small=args.small, files=args.files),
            renderers=tuple(args.renderers),
            frames=args.frames,
            logger=log,
            trace_dir=args.trace_dir,
        )
        if args.diff:
            diff_cfgs = [(64, 256), (128, 512)] if args.small else None
            run_diff_suite(configs=diff_cfgs,
                           frames=max(2, args.frames // 2),
                           profiler=prof, logger=log)
        if args.sharded:
            from volrt.bench.harness import bench_sharded_render

            m = bench_sharded_render(
                volume_size=64 if args.small else 128,
                viewport=256 if args.small else 512,
                iters=max(2, args.frames // 2))
            log.log(
                "sharded render over %d devices: %.2f ms (1 dev %.2f ms), "
                "scaling efficiency %.3f",
                m["devices"], m["ms_ndev"], m["ms_1dev"],
                m["scaling_efficiency"])
        log.log(prof.print_avg())
        log.log(prof.print_max())
        log.log(prof.print_samples())
    if args.output:
        with open(args.output, "w") as f:
            f.write(prof.print_avg() + "\n\n" + prof.print_max()
                    + "\n\n" + prof.print_samples() + "\n")
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering demo: recover a density volume from rendered views."""
    from volrt.utils.logger import Logger

    with Logger(args.log) as log:
        return _fit(args, log)


def _fit(args, log) -> int:
    import jax.numpy as jnp

    from volrt.core.tf import default_transfer_fn
    from volrt.core.view import Camera
    from volrt.core.types import default_ray_step
    from volrt.diff.render import DiffScene, render_diff_image
    from volrt.train.fit import fit

    volume, _ = _load_volume(args)
    dims = volume.dims
    step = args.ray_step or default_ray_step(dims)
    tf_base = default_transfer_fn()

    # Ground-truth scene renders the targets; optimization starts from zero.
    from volrt.diff.render import scene_from_volume

    gt = scene_from_volume(volume.data, tf_base, step)
    cams = []
    for ax, ay in [(0, 0), (0, 90), (90, 0), (45, 45)]:
        c = Camera(dims=tuple(args.size))
        c.set_camera_position((ax, ay, 0.0))
        cams.append(c.view())
    shading = args.shading
    targets = [
        (v, render_diff_image(
            gt, v, light_kd=(args.light_kd if shading else 0.0),
            shaded=(shading == "diffuse"), phong=(shading == "phong")))
        for v in cams
    ]
    log.log_time("rendered %d target views", len(targets))

    # Init per training target: density fits start from a constant
    # (zero density has a vanishing TF-lerp gradient); TF fits keep the
    # true density and start from a flat half-intensity LUT (recovering
    # the default TF from itself would be a no-op).
    train = getattr(args, "train", "density")
    init_density = (gt.density if train == "tf"
                    else jnp.full(volume.data.shape, 0.3, jnp.float32))
    init_tf = (jnp.full_like(tf_base, 0.5) if train in ("tf", "both")
               else tf_base)
    scene = DiffScene(
        density=init_density,
        tf_base=init_tf,
        ray_step=step,
    )
    mesh = None
    if args.dist != "none":
        from volrt.dist.mesh import make_mesh

        mesh = make_mesh()
        log.log("dist=%s over %d devices", args.dist, len(mesh.devices))
    scene, losses = fit(
        scene, targets, steps=args.steps, lr=args.lr,
        train_density=(train in ("density", "both")),
        train_tf=(train in ("tf", "both")),
        log_every=max(1, args.steps // 10), logger=log,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        mesh=mesh,
        volume_sharded=(args.dist == "volume"),
        shading=args.shading,
        light_kd=args.light_kd,
        esl=args.esl,
    )
    if losses:
        log.log_time("final loss %.6f", losses[-1])
    else:
        log.log("nothing to do: checkpoint already at %d steps", args.steps)
    return 0


def cmd_info(args) -> int:
    """Device + volume report (reference: VolR.cpp:175-193 device report)."""
    import jax

    info = {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "device_count": jax.device_count(),
    }
    if args.file:
        from volrt.io.pvm import load_volume

        vol, meta = load_volume(args.file)
        info["volume"] = {
            "shape_zyx": list(vol.shape),
            "dtype": str(vol.dtype),
            **{k: (list(v) if isinstance(v, tuple) else v)
               for k, v in meta.items()},
        }
    print(json.dumps(info, indent=2, default=str))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volrt",
        description="differentiable volume raycaster",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame to PNG")
    _add_render_args(p)
    p.add_argument("--orbit", type=int, default=1,
                   help="render N orbit frames (auto-rotate analog)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--log", default="volrt.log")
    p.add_argument("--background", type=float, default=None,
                   metavar="GRAY",
                   help="composite over a grayscale background in [0, 1] "
                        "(the reference UI's Background slider, default "
                        "0.25 there); omit to keep straight RGBA")
    p.add_argument("--nosafe", action="store_true",
                   help="continue past per-frame render errors in orbit "
                   "sequences (reference: -nosafe, cuda_utils.h:28-29)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="run the benchmark suite")
    p.add_argument("-f", "--files", nargs="*", default=None,
                   help="PVM/RAW dataset files to bench (reference loads "
                   "seven named PVM datasets)")
    p.add_argument("--renderers", type=int, nargs="+",
                   default=[0, 1],
                   help="ladder rungs to sweep (the reference loops every "
                   "renderer per config, VolR.cpp:225-248; the golden "
                   "rung 0 auto-skips heavy configs)")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--small", action="store_true")
    p.add_argument("--trace-dir", default=None,
                   help="capture a jax.profiler trace of the timed frames")
    p.add_argument("--diff", action="store_true",
                   help="append differentiable fwd+bwd rows (XLA "
                        "autodiff loss+grad steps) to the report")
    p.add_argument("--sharded", action="store_true",
                   help="append the multi-device scaling row (rung 1 "
                        "over pixel-row bands of all local devices vs "
                        "one; the BASELINE scaling-efficiency metric)")
    p.add_argument("-o", "--output", default=None, help="CSV report path")
    p.add_argument("--log", default="volrt.log")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="inverse-rendering fit demo")
    _add_render_args(p)
    # Fits are unshaded unless --shading is given explicitly (the render
    # default of "diffuse" would silently change training targets).
    p.set_defaults(shading=None)
    p.add_argument("--train", choices=["density", "tf", "both"],
                   default="density",
                   help="which scene parameters to optimize")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--checkpoint", default=None,
                   help="TrainState checkpoint path (.npz file, or an "
                        "orbax directory for any other path)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the checkpoint every N steps (0 = only at "
                   "the end)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--dist", choices=["none", "rays", "volume"],
                   default="none",
                   help="train over all local devices: rays = pixel-row "
                        "data parallelism (volume replicated, gradients "
                        "all-reduced); volume = Z-slab volume sharding "
                        "(for volumes larger than one device's memory)")
    p.add_argument("--esl", action="store_true",
                   help="leap each ray's leading TF-empty space during "
                   "training (image-exact; skipped samples give no TF "
                   "gradient, see train.fit.fit)")
    p.add_argument("--log", default="volrt.log")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("info", help="device and volume info")
    p.add_argument("-f", "--file", default=None)
    p.set_defaults(fn=cmd_info)
    return parser


def main(argv=None) -> int:
    from volrt.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
