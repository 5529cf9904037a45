"""Headline benchmark: one JSON line.

Times one differentiable forward+backward step (L2 loss and its gradients
through XLA autodiff) and one rung-1 forward render on a 256^3 synthetic
volume at 1024^2 (BASELINE config 3), with ERT off and the view zoomed so the
viewport covers the volume cube: every ray takes the full ~2/ray_step steps,
so rays*steps/s counts real work. Needs a GPU; exits nonzero without one.

    python bench.py
"""
from __future__ import annotations

import json
import sys

SIZE, VIEWPORT, ITERS = 256, 1024, 5


def main() -> int:
    from volrt.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1

    from volrt.bench.harness import bench_diff_step, bench_fwd_step

    m = bench_diff_step(volume_size=SIZE, viewport=VIEWPORT, iters=ITERS)
    f = bench_fwd_step(volume_size=SIZE, viewport=VIEWPORT, iters=ITERS)
    print(json.dumps({
        "metric": "diff_fwd_bwd_ray_steps_per_s",
        "value": m["ray_steps_per_s"],
        "unit": "rays*steps/s",
        "ms": m["ms"],
        "fwd_ms": f["ms"],
        "fwd_ray_steps_per_s": f["ray_steps_per_s"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
