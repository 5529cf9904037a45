"""Unified error handling: the JAX analog of the reference's CUDA shim
(cuda_safe_call / cuda_safe_malloc / the -nosafe flag,
reference: cuda_utils.h:21-49, VolR.cpp:404-406).

Two pieces:

- :func:`safe_call` — run a step, log failures; re-raise unless
  ``nosafe`` (the reference's ``NO_SAFE`` continue-past-errors mode).
- :func:`render_with_oom_fallback` — the ``cuda_safe_malloc`` analog:
  when a frame render exhausts device memory, split the viewport into row bands
  (each a shifted sub-view; ray bundles are affine in pixel index, so
  band renders are exact) and stitch, halving memory per attempt.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def is_oom(exc: BaseException) -> bool:
    """True for XLA out-of-memory failures (any backend)."""
    s = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


def safe_call(fn, *args, log=None, nosafe: bool = False, what: str = "",
              **kwargs):
    """Run ``fn`` and log failures. Returns ``(result, error)``; with
    ``nosafe`` errors are swallowed (result None), else re-raised after
    logging — matching cuda_safe_call's log-then-exit vs -nosafe
    continue (reference: cuda_utils.h:25-39)."""
    try:
        return fn(*args, **kwargs), None
    except Exception as e:  # noqa: BLE001 — the shim's whole purpose
        if log is not None:
            log.log("ERROR in %s: %s", what or getattr(fn, "__name__", "?"),
                    e)
        if nosafe:
            return None, e
        raise


def band_view(view, r0: int, hb: int):
    """Sub-view rendering rows ``[r0, r0 + hb)`` of ``view``'s viewport.

    Ray bundles are affine in the pixel index (reference: ViewBase.h:23-35
    uses ``pos - dims/2`` offsets), so a row band equals a smaller view
    whose center is shifted by ``(r0 + hb//2 - h//2) * up_plane`` —
    folded into the origin (ortho) or direction (perspective)."""
    w, h = view.dims
    shift = float(r0 + hb // 2 - h // 2)
    off = view.up_plane * shift
    if view.perspective:
        return dataclasses.replace(
            view, dims=(w, hb), direction=view.direction + off)
    return dataclasses.replace(
        view, dims=(w, hb), origin=view.origin + off)


def render_with_oom_fallback(render_fn, rc, log=None, max_splits: int = 4):
    """Render a frame, splitting the viewport into row bands on OOM.

    ``render_fn(rc) -> f32[H, W, 4]``; returns the stitched
    ``np.ndarray[H, W, 4]``. Each OOM halves the band height (up to
    ``2**max_splits`` bands). Exact: band sub-views reproduce the full
    bundle's rays bit-for-bit."""
    w, h = rc.view.dims
    n_bands = 1
    last: BaseException | None = None
    while n_bands <= (1 << max_splits):
        if h % n_bands:
            n_bands *= 2
            continue
        hb = h // n_bands
        try:
            rows = []
            for b in range(n_bands):
                sub = rc.replace(view=band_view(rc.view, b * hb, hb))
                rows.append(np.asarray(render_fn(sub)))
            out = rows[0] if n_bands == 1 else np.concatenate(rows, axis=0)
            if n_bands > 1 and log is not None:
                log.log("rendered in %d row bands after OOM", n_bands)
            return out
        except Exception as e:  # noqa: BLE001
            if not is_oom(e):
                raise
            last = e
            n_bands *= 2
    raise last  # type: ignore[misc]
