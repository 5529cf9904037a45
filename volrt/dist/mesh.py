"""Device-mesh construction and sharding specs.

One logical axis ``"rays"`` spans all devices (hosts x devices flattened):
pixel rows are embarrassingly parallel in the forward pass, and every GPU of
a host reaches every other over NVLink at the same rate, so a 1-D mesh in
device order is all the layout the algorithm needs.

Multi-host entry: call :func:`init_distributed` once per process before any
jax call (wraps ``jax.distributed.initialize``); single-process/multi-device
works with no init at all.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def init_distributed(**kw) -> None:
    """Multi-host runtime init (the reference has no distributed layer at
    all; this replaces nothing and enables the BASELINE multi-host configs).
    """
    jax.distributed.initialize(**kw)


def make_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices, axis ``"rays"``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def tiles_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``(T, ...)`` ray-tile arrays: tiles split across devices."""
    return NamedSharding(mesh, P(RAY_AXIS))


def rows_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``(H, W, ...)`` images: pixel rows split across devices."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
