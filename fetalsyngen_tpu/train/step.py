"""Fused generate+train step: synthesis feeds segmentation training on-device.

BASELINE config #5: batched multi-subject generation + training on the same
devices, so the "dataloader" can never starve the trainer — the generator IS
part of the compiled step. Sharding: pure data parallelism over the batch
axis (generation needs no cross-device traffic; the gradient all-reduce is
inserted by XLA from the sharding annotations).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..generator.config import GeneratorCfg
from ..generator.pipeline import _synth_core
from .unet import UNet3D


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def create_train_state(key, model: UNet3D, shape, lr=1e-3):
    x = jnp.zeros((1, *shape, 1), jnp.float32)
    params = model.init(key, x)
    tx = optax.adamw(lr)
    return TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)), tx


def _loss_fn(params, model, images, labels):
    logits = model.apply(params, images[..., None])
    onehot = jax.nn.one_hot(labels, logits.shape[-1])
    loss = optax.softmax_cross_entropy(logits, onehot).mean()
    return loss


def generate_and_train_step(
    state: TrainState,
    keys: jax.Array,
    seeds: jnp.ndarray,
    segs: jnp.ndarray,
    model: UNet3D,
    tx: optax.GradientTransformation,
    cfg: GeneratorCfg,
):
    """One fused step: synthesize a batch, then take a gradient step on it."""
    images, labels = jax.vmap(
        lambda k, sd, sg: _synth_core(
            k, sd, sg, jnp.zeros((), jnp.float32), (), cfg, (), False
        )[:2]
    )(keys, seeds, segs)
    # scale to [0,1] per-sample like the dataset (datasets.py:311)
    peak = jnp.max(images, axis=(1, 2, 3), keepdims=True)
    images = images / jnp.where(peak > 0, peak, 1.0)

    loss, grads = jax.value_and_grad(_loss_fn)(state.params, model, images, labels)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return (
        TrainState(params=params, opt_state=opt_state, step=state.step + 1),
        loss,
    )


def make_sharded_train_step(mesh: Mesh, model: UNet3D, tx, cfg: GeneratorCfg, axis="data"):
    """jit the fused step with dp sharding: batch over ``axis``, params replicated."""
    batch_s = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    step = partial(generate_and_train_step, model=model, tx=tx, cfg=cfg)
    return jax.jit(
        step,
        in_shardings=(repl, batch_s, batch_s, batch_s),
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )
