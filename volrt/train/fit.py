"""Gradient-descent fitting of a DiffScene to target images.

The ``volrt fit`` training loop: render the scene differentiably, L2-compare
against target images over one or more camera poses, and optimize the voxel
density grid and/or the transfer-function LUT with optax. Under a device
mesh, pixel rows are sharded across devices and parameter gradients are
all-reduced by XLA-inserted collectives (psum over the ray axis).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from volrt.core.types import View, _pytree_dataclass
from volrt.diff.render import DiffScene, render_diff_image


@_pytree_dataclass(meta_fields=())
class TrainState:
    scene: DiffScene
    opt_state: object
    step: jax.Array  # int32 scalar


def l2_loss(scene: DiffScene, view: View, target: jax.Array) -> jax.Array:
    img = render_diff_image(scene, view)
    return jnp.mean((img - target) ** 2)


def make_loss_fn(shading: str | None = None, light_kd: float = 0.6,
                 esl: bool = False, volume_mesh=None) -> Callable:
    """The L2 loss ``(scene, view, target) -> scalar`` that :func:`fit`
    trains.

    ``shading``: None (unshaded), "diffuse" (the reference one-tap shade)
    or "phong" (gradient Blinn-Phong); both are differentiated by XLA
    autodiff. ``esl=True`` leaps each ray's leading TF-empty space (see
    :func:`fit` for the TF-gradient caveat). ``volume_mesh``: Z-slab-shard
    the volume over this mesh (:mod:`volrt.dist.volume_sharded`).
    """
    if shading not in (None, "diffuse", "phong"):
        raise ValueError(f"unknown shading mode: {shading!r}")
    if volume_mesh is not None:
        if esl:
            raise NotImplementedError(
                "esl in volume-sharded training is not supported: the "
                "slab march has no empty-space leap")
        from volrt.dist.volume_sharded import render_volume_sharded

        def sharded_loss(scene, view, target):
            img = render_volume_sharded(
                scene, view, volume_mesh, shading=shading,
                light_kd=light_kd)
            return jnp.mean((img - target) ** 2)

        return sharded_loss

    def loss(scene, view, target):
        img = render_diff_image(
            scene, view, esl=esl, light_kd=(light_kd if shading else 0.0),
            shaded=(shading == "diffuse"), phong=(shading == "phong"))
        return jnp.mean((img - target) ** 2)

    return loss


def make_optimizer(lr: float = 1e-2) -> optax.GradientTransformation:
    return optax.adam(lr)


def make_train_step(
    optimizer: optax.GradientTransformation,
    loss_fn: Callable = l2_loss,
    train_density: bool = True,
    train_tf: bool = True,
    mesh=None,
    two_dispatch: bool = False,
):
    """Build a train step ``(state, view, target) -> (state, loss)``.

    With ``mesh``, the target image (and thus the ray bundle) is sharded over
    pixel rows across devices; scene parameters are replicated and their
    gradients all-reduced by XLA. Frozen leaves get zeroed gradients (so one
    optimizer covers density-only, TF-only and joint fits).

    ``two_dispatch=True`` runs the loss+grads as its own dispatch (outer
    trace eager; the jitted renderers inside still compile and cache) and
    jits only the optimizer update. The volume-sharded loss needs it:
    wrapping its shard_map in an outer jit intermittently trips a JAX 0.9
    dispatch bug on the CPU mesh ("Execution supplied N buffers but
    compiled program expected M").
    """

    def apply_update(state: TrainState, grads, loss):
        if not train_density:
            grads = grads.replace(density=jnp.zeros_like(grads.density))
        if not train_tf:
            grads = grads.replace(tf_base=jnp.zeros_like(grads.tf_base))
        updates, opt_state = optimizer.update(
            (grads.density, grads.tf_base), state.opt_state
        )
        du, tu = updates
        # Frozen leaves are left as they are (not even clipped).
        scene = state.scene.replace(
            density=(jnp.clip(state.scene.density + du, 0.0, 1.0)
                     if train_density else state.scene.density),
            tf_base=(jnp.clip(state.scene.tf_base + tu, 0.0, 1.0)
                     if train_tf else state.scene.tf_base),
        )
        return TrainState(scene, opt_state, state.step + 1), loss

    def step(state: TrainState, view: View, target: jax.Array):
        loss, grads = jax.value_and_grad(loss_fn)(state.scene, view, target)
        return apply_update(state, grads, loss)

    if two_dispatch or (mesh is None and jax.default_backend() == "cpu"):
        # Two-dispatch also guards every CPU train step: JAX 0.9's CPU
        # executable lookup intermittently fails ("Execution supplied N
        # buffers but compiled program expected M") when a second
        # differently-parameterized outer-jit-of-grad-of-inner-jit is
        # traced in one process (e.g. a shaded fit followed by an
        # unshaded one). The eager outer dispatch sidesteps it; inner
        # jits (the renderers) still compile, and accelerators keep the
        # fully fused outer jit.
        jup = jax.jit(apply_update)

        def two_phase_step(state, view, target):
            loss, grads = jax.value_and_grad(loss_fn)(
                state.scene, view, target)
            return jup(state, grads, loss)

        return two_phase_step

    if mesh is None:
        return jax.jit(step)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from volrt.dist.mesh import RAY_AXIS

    rows = NamedSharding(mesh, P(RAY_AXIS))
    repl = NamedSharding(mesh, P())

    def sharded_step(state, view, target):
        target = jax.lax.with_sharding_constraint(target, rows)
        return step(state, view, target)

    # Prefix pytree: replicate every leaf of the state and the scalar loss.
    return jax.jit(sharded_step, out_shardings=(repl, repl))


def init_state(scene: DiffScene,
               optimizer: optax.GradientTransformation) -> TrainState:
    opt_state = optimizer.init((scene.density, scene.tf_base))
    return TrainState(scene, opt_state, jnp.int32(0))


def fit(
    scene: DiffScene,
    views_and_targets: list[tuple[View, jax.Array]],
    steps: int = 200,
    lr: float = 1e-2,
    train_density: bool = True,
    train_tf: bool = True,
    mesh=None,
    log_every: int = 0,
    logger=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    volume_sharded: bool = False,
    shading: str | None = None,
    light_kd: float = 0.6,
    esl: bool = False,
    esl_refresh_every: int = 0,
) -> tuple[DiffScene, list[float]]:
    """Fit the scene to targets; returns (scene, per-step losses).

    ``checkpoint_path`` + ``checkpoint_every`` periodically persist the full
    TrainState (scene + optimizer + step) so long fits survive preemption;
    ``resume=True`` loads that state (if the file exists) and continues from
    its step counter — ``steps`` counts total steps including resumed ones.
    ``mesh`` trains over its devices with pixel-row data parallelism;
    ``volume_sharded=True`` (requires ``mesh``) instead splits the volume
    into Z-slabs across the mesh — the configuration for volumes larger
    than one device's memory: each device marches its own slab and the
    seed cotangents flow back across the ppermute opacity scan
    (dist.volume_sharded).
    ``esl_refresh_every=N`` (with ``esl=True``) runs every Nth step as
    a FULL march (esl off): under ESL training, samples in the leaped
    TF-empty space receive no cotangent, so a trained TF can never
    "switch on" a density range the running TF maps to zero opacity
    (the ESL TF-gradient trap). The periodic full step gives every TF
    entry its gradient; the other (N-1)/N steps keep the leap. Tested in
    tests/test_diff.py::TestEslTfTrap.
    """
    import os

    if volume_sharded and mesh is None:
        raise ValueError("volume_sharded=True requires a mesh")
    optimizer = make_optimizer(lr)

    def _build_train_step(esl):
        loss_fn = make_loss_fn(
            shading, light_kd, esl,
            volume_mesh=mesh if volume_sharded else None)
        # The volume-sharded loss shards its own slabs; its state stays
        # local.
        return make_train_step(
            optimizer, loss_fn=loss_fn,
            train_density=train_density, train_tf=train_tf,
            mesh=None if volume_sharded else mesh,
            two_dispatch=volume_sharded,
        )

    train_step = _build_train_step(esl)
    refresh_step = (_build_train_step(False)
                    if (esl and esl_refresh_every) else None)
    state = init_state(scene, optimizer)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        from volrt.train import checkpoint as ckpt

        state = ckpt.load(checkpoint_path, optimizer)
        if logger:
            logger.log(
                f"resumed from {checkpoint_path} at step {int(state.step)}")
    losses = []
    start = int(state.step)
    for i in range(start, steps):
        j = i % len(views_and_targets)
        view, target = views_and_targets[j]
        step_fn = train_step
        if refresh_step is not None and i % esl_refresh_every == 0:
            # Periodic full march: every TF entry gets its cotangent
            # (the ESL TF-gradient trap mitigation — see docstring).
            step_fn = refresh_step
        state, loss = step_fn(state, view, target)
        losses.append(float(loss))
        if log_every and (i % log_every == 0):
            msg = f"fit step {i}: loss {losses[-1]:.6f}"
            (logger.log if logger else print)(msg)
        if (checkpoint_path and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            from volrt.train import checkpoint as ckpt

            ckpt.save(checkpoint_path, state)
            if logger:
                logger.log(f"checkpoint at step {i + 1} -> "
                           f"{checkpoint_path}")
    if checkpoint_path:
        from volrt.train import checkpoint as ckpt

        ckpt.save(checkpoint_path, state)
    return state.scene, losses
