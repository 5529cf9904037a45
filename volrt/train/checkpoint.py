"""Checkpoint / resume for fitting runs (new capability; the reference
persists nothing but a log file, reference: Logger.cpp:18).

Two formats, dispatched on the path:

- ``*.npz`` (default): a single file holding the scene leaves, flattened
  optimizer-state leaves and the step counter. The optimizer treedef is
  reconstructed from a freshly-initialized state of the same optimizer,
  so checkpoints stay plain arrays — no pickled code.
- any other path: an orbax-checkpoint directory (sharding-aware restore
  and multi-host-safe writes come from orbax rather than hand-rolled IO).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from volrt.diff.render import DiffScene
from volrt.train.fit import TrainState


def save(path: str, state: TrainState) -> None:
    if not path.endswith(".npz"):
        return _save_orbax(path, state)
    opt_leaves = jax.tree_util.tree_leaves(state.opt_state)
    arrays = {
        "density": np.asarray(state.scene.density),
        "tf_base": np.asarray(state.scene.tf_base),
        "step": np.asarray(state.step),
        "meta": np.frombuffer(
            json.dumps({
                "ray_step": state.scene.ray_step,
                "n_opt_leaves": len(opt_leaves),
            }).encode(), dtype=np.uint8,
        ),
    }
    for i, leaf in enumerate(opt_leaves):
        arrays[f"opt_{i}"] = np.asarray(leaf)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _tree(state: TrainState) -> dict:
    """Orbax-facing pytree: plain dict of arrays (ray_step, a static
    float, rides along as a 0-d array)."""
    return {
        "density": state.scene.density,
        "tf_base": state.scene.tf_base,
        "ray_step": np.float64(state.scene.ray_step),
        "step": state.step,
        "opt": list(jax.tree_util.tree_leaves(state.opt_state)),
    }


def _save_orbax(path: str, state: TrainState) -> None:
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), _tree(state), force=True)
    ckptr.wait_until_finished()


def _load_orbax(path: str, optimizer) -> TrainState:
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    tree = ckptr.restore(os.path.abspath(path))
    scene = DiffScene(
        density=jnp.asarray(tree["density"]),
        tf_base=jnp.asarray(tree["tf_base"]),
        ray_step=float(tree["ray_step"]),
    )
    template = optimizer.init((scene.density, scene.tf_base))
    treedef = jax.tree_util.tree_structure(template)
    opt_state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in tree["opt"]])
    return TrainState(scene, opt_state, jnp.asarray(tree["step"]))


def load(path: str, optimizer) -> TrainState:
    """Load a checkpoint; ``optimizer`` must match the one used to save."""
    if not path.endswith(".npz"):
        return _load_orbax(path, optimizer)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        scene = DiffScene(
            density=jnp.asarray(z["density"]),
            tf_base=jnp.asarray(z["tf_base"]),
            ray_step=float(meta["ray_step"]),
        )
        template = optimizer.init((scene.density, scene.tf_base))
        treedef = jax.tree_util.tree_structure(template)
        leaves = [
            jnp.asarray(z[f"opt_{i}"]) for i in range(meta["n_opt_leaves"])
        ]
        opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
        return TrainState(scene, opt_state, jnp.asarray(z["step"]))
