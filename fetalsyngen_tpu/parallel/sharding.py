"""Device mesh + batch sharding for multi-device generation.

The reference scales by forking CPU ``DataLoader`` workers around a single
CUDA device (``test_dl.py:17-23``). Here (SURVEY §2) generation is
embarrassingly parallel per volume, so the batch axis is ``vmap``-ed and
sharded across devices with ``jax.sharding`` — no collectives inside the
generator itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..generator.config import GeneratorCfg
from ..generator.pipeline import _synth_core


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    """1-D data-parallel mesh over all (or given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (axis,))


def make_sharded_generator(mesh: Mesh, cfg: GeneratorCfg, axis: str = "data"):
    """Build a jitted batch generator sharded over ``mesh``.

    Returns ``gen(keys, seeds, segs) -> (images, labels)`` where all inputs
    carry a leading batch axis sharded across ``axis``. Each device
    generates its local shard independently (no cross-device traffic — the
    ideal layout for an input pipeline feeding a data-parallel trainer).
    """
    batch_sharding = NamedSharding(mesh, P(axis))

    def _batch(keys, seeds, segs):
        out, seg = jax.vmap(
            lambda k, sd, sg: _synth_core(
                k, sd, sg, jnp.zeros((), jnp.float32), (), cfg, (), False
            )[:2]
        )(keys, seeds, segs)
        return out, seg

    gen = jax.jit(
        _batch,
        in_shardings=(batch_sharding, batch_sharding, batch_sharding),
        out_shardings=(batch_sharding, batch_sharding),
    )
    return gen


def shard_batch(mesh: Mesh, arr, axis: str = "data"):
    """Place a host batch onto the mesh, sharded along its leading axis."""
    return jax.device_put(arr, NamedSharding(mesh, P(axis)))


def make_sharded_artifact_generator(
    mesh: Mesh,
    generator,
    shape,
    cube: int,
    ns_grid: int,
    small_cube: int | None = None,
    axis: str = "data",
):
    """Sharded generation INCLUDING the SR-artifact chain.

    ``make_sharded_generator`` covers the artifact-free core; this builds the
    full production program — synth core (bf16 production mode) + the traced
    quality/motion chain of ``generator.artifacts`` — as a ``shard_map`` over
    ``mesh``: each device runs a LOCAL ``lax.map`` over its own batch shard
    (one sample's scanner buffers live at a time per device), with zero
    cross-device traffic. A global ``lax.map`` under plain sharded jit would
    serialize the whole batch across the mesh; the shard_map form keeps the
    per-device sequential structure the single-device stream uses.

    Returns ``gen(keys, seeds, segs, pack) -> (images, labels)``; all inputs
    carry a leading batch axis sharded over ``axis`` (``pack`` rows from
    ``batched.pack_motion`` — pass ``pack=None`` to skip motion). Divisible
    batch required (batch %% mesh size == 0).
    """
    from ..generator.artifacts.batched import (
        QualityArtifacts,
        apply_post_motion,
        apply_pre_motion,
        motion_t,
    )
    from ..generator.pipeline import _synth_core
    from .input_pipeline import _production_scopes

    qa = QualityArtifacts.from_generator(generator)
    sm = (getattr(generator, "artifacts", {}) or {}).get("simulate_motion")
    cfg = generator.cfg
    has_quality = (
        qa.blur_cortex is not None
        or qa.struct_noise is not None
        or qa.boundaries is not None
    )

    def local_fn(keys, seeds, segs, pack):
        def one(args):
            key, sd, sg, row = args
            with _production_scopes():
                out, seg_o, _, _ = _synth_core(
                    key, sd, sg, jnp.zeros((), jnp.float32), (), cfg, (), False
                )
                out = out.astype(jnp.float32)
                ka = jax.random.fold_in(key, 77)
                if has_quality:
                    out = apply_pre_motion(ka, out, seg_o, qa)
                if sm is not None and row is not None:
                    out = motion_t(
                        jax.random.fold_in(ka, 303), out, seg_o, row, sm,
                        tuple(shape), cube, ns_grid, small_cube=small_cube,
                    )
                if has_quality:
                    out = apply_post_motion(ka, out, seg_o, qa)
            out = out.astype(jnp.float32)
            peak = jnp.max(out)
            return out / jnp.where(peak > 0, peak, 1.0), seg_o

        return jax.lax.map(one, (keys, seeds, segs, pack))

    pspec = P(axis)
    # check_vma off: the body is collective-free (pure per-shard compute),
    # and the motion engine's lax.cond branches mix shard-varying values
    # with constants, which the varying-axes type check rejects
    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(pspec, pspec, pspec, pspec),
        out_specs=(pspec, pspec),
        check_vma=False,
    )
