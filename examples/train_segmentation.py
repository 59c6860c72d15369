"""End-to-end example: train a 3D UNet on a stream of synthetic volumes.

BASELINE config #5 in miniature: the generator is fused into the jitted
training step, sharded data-parallel over all available devices — no host
dataloader in the loop, so the devices never starve.

Run (any backend; uses a procedural phantom so no data files are needed):
    python examples/train_segmentation.py --steps 10 --shape 64
On CPU:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/train_segmentation.py --steps 3 --shape 32
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--shape", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from fetalsyngen_tpu.compile_cache import enable_compile_cache
    from fetalsyngen_tpu.generator.config import GeneratorCfg, IntensityCfg
    from fetalsyngen_tpu.testing import phantom_seeds_and_seg
    from fetalsyngen_tpu.train.step import create_train_state, make_sharded_train_step
    from fetalsyngen_tpu.train.unet import UNet3D

    enable_compile_cache()
    shape = (args.shape,) * 3
    labels = tuple([0] + list(range(10, 50)))
    gen_classes = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
    cfg = GeneratorCfg(
        shape=shape, resolution=(0.5, 0.5, 0.5), intensity=IntensityCfg(1, 6, labels, gen_classes)
    )

    devices = np.asarray(jax.devices())
    mesh = Mesh(devices, ("data",))
    batch = len(devices)
    print(f"devices: {len(devices)} ({jax.default_backend()}), batch {batch}, shape {shape}")

    model = UNet3D(channels=(8, 16, 32), n_classes=8)
    state, tx = create_train_state(jax.random.PRNGKey(0), model, shape)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = make_sharded_train_step(mesh, model, tx, cfg)

    seeds_np, seg_np = phantom_seeds_and_seg(shape, seed=0, n_subclusters=3)
    sharded = NamedSharding(mesh, P("data"))
    seeds = jax.device_put(jnp.broadcast_to(jnp.asarray(seeds_np, jnp.int32), (batch, *shape)), sharded)
    segs = jax.device_put(jnp.broadcast_to(jnp.asarray(seg_np, jnp.int32), (batch, *shape)), sharded)

    key = jax.random.PRNGKey(1)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        key, sub = jax.random.split(key)
        keys = jax.device_put(jax.random.split(sub, batch), sharded)
        state, loss = step(state, keys, seeds, segs)
        losses.append(float(loss))
        print(f"step {i}: loss {losses[-1]:.4f}  ({time.time() - t0:.1f}s)")
    # per-step losses are noisy (every step sees a fresh random sample), so
    # compare smoothed ends rather than single steps
    k = max(1, len(losses) // 3)
    head, tail = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    assert tail < head, f"loss should trend down on the synthetic stream ({head:.4f} -> {tail:.4f})"
    print(f"OK: loss trended down {head:.4f} -> {tail:.4f}")


if __name__ == "__main__":
    main()
