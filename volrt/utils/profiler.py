"""Frame profiler: per-(config, renderer) timing statistics.

Rebuilds the reference ``Profiler`` (reference: Profiler.cpp:19-114) in JAX
terms: CUDA-event timing becomes wall clock around ``block_until_ready`` (the
same implicit device sync the reference's ``cudaEventSynchronize`` provides,
reference: Profiler.cpp:64-66), and the stats matrix keeps the reference's
shape — {samples, sum, max} per (config, renderer) — plus derived rays/s and
rays*steps/s. A rolling ring of recent frame times mirrors the on-screen
graph buffer (reference: Profiler.cpp:73-74).
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

MIN_SAMPLE_STAT = 8  # reference: Profiler.h:12
RING_SIZE = 300      # reference: Profiler.h graph ring


@dataclass
class _Stat:
    samples: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    def add(self, ms: float) -> None:
        self.samples += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.samples if self.samples else 0.0


@dataclass
class Profiler:
    stats: dict = field(
        default_factory=lambda: defaultdict(lambda: defaultdict(_Stat))
    )
    ring: list = field(default_factory=list)
    _t0: float = 0.0
    _key: tuple = ()

    def start(self, config: str, renderer: str) -> None:
        self._key = (config, renderer)
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Stop timing; blocks on ``result`` first (device sync)."""
        if result is not None:
            try:
                import jax

                jax.block_until_ready(result)
            except Exception:
                pass
        ms = (time.perf_counter() - self._t0) * 1e3
        config, renderer = self._key
        self.stats[config][renderer].add(ms)
        self.ring.append(ms)
        if len(self.ring) > RING_SIZE:
            self.ring.pop(0)
        return ms

    def time_fn(self, config: str, renderer: str, fn, iters: int = 1):
        """Time ``fn()`` ``iters`` times; returns the last result."""
        result = None
        for _ in range(iters):
            self.start(config, renderer)
            result = fn()
            self.stop(result)
        return result

    # --- reports (shape of reference print_avg/max/samples,
    #     Profiler.cpp:80-114) ---

    def _table(self, cell) -> str:
        renderers = sorted({
            r for cfg in self.stats.values() for r in cfg
        })
        lines = ["config," + ",".join(renderers)]
        for config, per_r in self.stats.items():
            row = [config]
            for r in renderers:
                s = per_r.get(r)
                row.append(
                    f"{cell(s):.2f}"
                    if s and s.samples >= MIN_SAMPLE_STAT else ""
                    if s is None else f"{cell(s):.2f}*"
                )
            lines.append(",".join(row))
        return "\n".join(lines)

    def print_avg(self) -> str:
        return "average ms:\n" + self._table(lambda s: s.avg_ms)

    def print_max(self) -> str:
        return "max ms:\n" + self._table(lambda s: s.max_ms)

    def print_samples(self) -> str:
        return "samples:\n" + self._table(lambda s: float(s.samples))

    def reset(self) -> None:
        self.stats.clear()
        self.ring.clear()


def derived_metrics(ms: float, n_rays: int, n_steps: int) -> dict:
    s = ms / 1e3
    return {
        "ms": ms,
        "rays_per_s": n_rays / s if s else 0.0,
        "ray_steps_per_s": n_rays * n_steps / s if s else 0.0,
    }
