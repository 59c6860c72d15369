"""Throughput benchmark: randomized 256^3 image+label volumes per second.

Modes (one process each): the default batched core pipeline (plus a
single-volume latency p50), ``--stream`` (the ``SyntheticStream`` end to
end) and ``--artifacts`` (the host-path SR-artifact chain, s/sample). Each
mode prints a device line (platform, device kind, count and the card's
name and power limit from ``nvidia-smi``) and then JSON result lines; the
last line is the mode's final record. Without a GPU it fails instead of
printing a rate.

Baseline: the reference reports 0.56-0.62 s per volume on an unspecified
CUDA GPU (upstream ``docs/datasets.md:76,131``), i.e. ~1.78 vol/s
(BASELINE.md). ``vs_baseline`` = our vol/s divided by 1.78.

Timing: every timed call ends in ``block_until_ready``; compilation is
warmed up before the timed region.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import jax
import jax.numpy as jnp

from fetalsyngen_tpu.compile_cache import enable_compile_cache

REFERENCE_VOLS_PER_SEC = 1.78


def bench_artifacts(shape_edge: int, samples: int):
    """Wall-clock seconds/sample for the 4-artifact SR pipeline at
    ``shape_edge``^3 (host-orchestrated path; includes dispatch overhead —
    that's what a user pays). Reference path: ``simulate_reco.py:300-466``."""
    import numpy as np

    from fetalsyngen_tpu.config import load_yaml, resolve_interpolations, instantiate

    gen_cfg = resolve_interpolations(load_yaml("configs/dataset/generator/default.yaml"))
    # enable all four SR artifacts with the YAML-default parameters
    for k in ("blur_cortex", "struct_noise", "simulate_motion", "boundaries"):
        assert k in gen_cfg, f"missing artifact {k} in default.yaml"
    shape = (shape_edge,) * 3
    gen_cfg["shape"] = list(shape)
    gen_cfg["spatial_deform"]["size"] = list(shape)
    generator = instantiate(gen_cfg)

    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    _, seg_np = phantom_seeds_and_seg(shape)
    from scipy.ndimage import gaussian_filter

    out = gaussian_filter(
        (seg_np > 0).astype(np.float32) * 100 + (seg_np > 2) * 80, 1.5
    ).astype(np.float32)

    out_dev = jnp.asarray(out)
    seg_dev = jnp.asarray(seg_np.astype(np.int32))  # on device, like the
    # production path (model.sample hands the artifacts the jitted
    # pipeline's device seg, model.py:377-380)

    def one(i):
        key = jax.random.PRNGKey(100 + i)
        rng = np.random.default_rng(100 + i)
        o = out_dev
        for name, artifact in generator.artifacts.items():
            if artifact is None:
                continue
            akey = jax.random.fold_in(key, hash(name) % 1000)
            o, _ = artifact(
                o, seg_dev, resolution=(0.5, 0.5, 0.5),
                rng=np.random.default_rng(rng.integers(2**31)), key=akey,
            )
        return jax.block_until_ready(o)

    # warmup on a DISJOINT index range (2x as many draws), so the timed
    # samples are fresh draws, not replays of pre-compiled exact sequences.
    # Host-branch program variants (artifact gates, merge types, cube tiers)
    # are still expected to be compiled by the warmup / the persistent cache;
    # a timed draw that hits a brand-new variant pays its compile — that is
    # what a production user pays too.
    for i in range(samples + 1, 3 * samples + 1):
        one(i)
    t0 = time.perf_counter()
    for i in range(1, samples + 1):
        one(i)
    sec = (time.perf_counter() - t0) / samples
    print(
        json.dumps(
            {
                "device": DEVICE,
                "metric": (
                    f"SR-artifact pipeline {shape_edge}^3 sec/sample "
                    "(vs_baseline = speedup vs this repo's round-1 48 s/sample "
                    "self-baseline; the reference publishes no artifact-path number)"
                ),
                "value": sec,
                "unit": "s/sample",
                "vs_baseline": 48.0 / sec,
            }
        )
    )


def bench_stream(shape_edge: int, batch: int, iters: int, artifacts: bool = True):
    """End-to-end production path: BIDS tree on disk -> native IO -> device
    seed banks -> jitted batched generation + the default-probability
    SR-artifact chain (``SyntheticStream``), wall-clock volumes/sec
    including all host work. ``artifacts=False`` reproduces the artifact-free
    core-pipeline number."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from fetalsyngen_tpu.data.datasets import FetalSynthDataset
    from fetalsyngen_tpu.io import nifti
    from fetalsyngen_tpu.parallel.input_pipeline import SyntheticStream
    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    shape = (shape_edge,) * 3
    root = Path(tempfile.mkdtemp(prefix="fsg_bench_bids_"))
    rng = np.random.default_rng(0)
    for si, sub in enumerate(["sub-b01", "sub-b02"]):
        seeds_np, seg_np = phantom_seeds_and_seg(shape, seed=si)
        anat = root / sub / "anat"
        anat.mkdir(parents=True)
        nifti.save(anat / f"{sub}_dseg.nii.gz", seg_np.astype(np.int16))
        nifti.save(anat / f"{sub}_T2w.nii.gz", (seg_np > 0).astype(np.float32))
        for n in (1, 2):
            sd = root / "derivatives" / "seeds" / f"subclasses_{n}" / sub / "anat"
            sd.mkdir(parents=True)
            for m in range(1, 5):
                part = np.where(seeds_np % 4 == (m - 1), seeds_np, 0).astype(np.int8)
                nifti.save(sd / f"{sub}_mlabel_{m}.nii.gz", part)

    if artifacts:
        # the FULL default generator incl. the 4 SR artifacts at their YAML
        # default probabilities — the reference's dataset path applies them
        # inside sample (fetalsyngen/generator/model.py:210-220)
        from fetalsyngen_tpu.config import load_yaml, resolve_interpolations, instantiate

        gen_cfg = resolve_interpolations(
            load_yaml("configs/dataset/generator/default.yaml")
        )
        gen_cfg["shape"] = list(shape)
        gen_cfg["spatial_deform"]["size"] = list(shape)
        generator = instantiate(gen_cfg)
    else:
        import __graft_entry__ as ge

        generator_cfg = ge._default_cfg(shape)
        # dataset needs a FetalSynthGen-like object exposing .cfg
        class _Gen:
            cfg = generator_cfg
            artifacts = {}

        generator = _Gen()

    ds = FetalSynthDataset(str(root), generator, str(root / "derivatives" / "seeds"))
    stream = SyntheticStream(ds, batch_size=batch, seed=0, prefetch=True)
    it = iter(stream)

    # warmup: compile + BOTH subjects' seed banks uploaded (the stream
    # round-robins subjects, so one warmup batch leaves the second subject's
    # bank transfer inside the timed region)
    for _ in range(2):
        jax.block_until_ready(next(it)["image"])
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(next(it)["image"])
    dt = time.perf_counter() - t0
    vols = batch * iters / dt
    tag = "+artifacts" if artifacts else ""
    print(
        json.dumps(
            {
                "device": DEVICE,
                "metric": f"end-to-end stream{tag} {shape_edge}^3 volumes/sec/device",
                "value": vols,
                "unit": "vol/s/device",
                "vs_baseline": vols / REFERENCE_VOLS_PER_SEC,
            }
        )
    )


def _device():
    """Check for a GPU and print what the run is on; returns the record."""
    from fetalsyngen_tpu.accelerator import device_record, nvidia_smi_cards, require_gpu

    devices = require_gpu(jax.devices())
    for line in nvidia_smi_cards():
        print(line, flush=True)
    record = device_record(devices)
    print(json.dumps({"device": record}), flush=True)
    return record


DEVICE: dict = {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--artifacts", action="store_true", help="bench the SR-artifact pipeline")
    ap.add_argument("--stream", action="store_true", help="bench the end-to-end input stream")
    ap.add_argument(
        "--no-artifacts", action="store_true",
        help="with --stream: disable the SR-artifact chain (core pipeline only)",
    )
    ap.add_argument("--samples", type=int, default=3)
    args = ap.parse_args()

    DEVICE.update(_device())
    enable_compile_cache()
    if args.artifacts:
        bench_artifacts(args.shape, args.samples)
        return
    if args.stream:
        bench_stream(args.shape, args.batch, args.iters, artifacts=not args.no_artifacts)
        return

    from fetalsyngen_tpu.generator.config import GeneratorCfg, IntensityCfg
    from fetalsyngen_tpu.generator.pipeline import _synth_core
    from fetalsyngen_tpu.parallel.input_pipeline import _production_scopes
    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    shape = (args.shape,) * 3
    labels = tuple([0] + list(range(10, 50)))
    gen_classes = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
    cfg = GeneratorCfg(
        shape=shape,
        resolution=(0.5, 0.5, 0.5),
        intensity=IntensityCfg(1, 6, labels, gen_classes),
    )

    seeds_np, seg_np = phantom_seeds_and_seg(shape)
    B = args.batch
    seeds = jnp.broadcast_to(jnp.asarray(seeds_np, jnp.int32), (B, *shape))
    segs = jnp.broadcast_to(jnp.asarray(seg_np, jnp.int32), (B, *shape))

    # production generation mode: bf16 matmul operands + bf16 intermediate
    # storage (the stream path, input_pipeline._gen_batch, generates with
    # the same scopes). tests/test_pipeline.py pins bf16-vs-f32 quality.
    def core(k, sd, sg):
        with _production_scopes():
            out, seg, _, _ = _synth_core(
                k, sd, sg, jnp.zeros((), jnp.float32), (), cfg, (), False
            )
        return out.astype(jnp.float32), seg

    @jax.jit
    def batch(key, seeds, segs):
        return jax.vmap(core)(jax.random.split(key, B), seeds, segs)

    jax.block_until_ready(batch(jax.random.PRNGKey(0), seeds, segs))
    t0 = time.perf_counter()
    for i in range(args.iters):
        jax.block_until_ready(batch(jax.random.PRNGKey(1 + i), seeds, segs))
    dt = time.perf_counter() - t0
    vols_per_sec = B * args.iters / dt

    result = {
        "device": DEVICE,
        "metric": f"randomized {args.shape}^3 volumes/sec/device",
        "value": vols_per_sec,
        "unit": "vol/s/device",
        "vs_baseline": vols_per_sec / REFERENCE_VOLS_PER_SEC,
    }
    print(json.dumps(result), flush=True)

    # single-volume generation latency p50: one jitted call per volume,
    # each timed to block_until_ready on the host clock
    @jax.jit
    def single(key, seed1, seg1):
        return core(key, seed1, seg1)

    for i in range(3):
        jax.block_until_ready(single(jax.random.PRNGKey(1000 + i), seeds[0], segs[0]))
    lats = []
    for i in range(15):
        t0 = time.perf_counter()
        jax.block_until_ready(single(jax.random.PRNGKey(2000 + i), seeds[0], segs[0]))
        lats.append(time.perf_counter() - t0)
    result["latency_p50_s"] = sorted(lats)[len(lats) // 2]
    result["latency_note"] = (
        "single-volume p50 over 15 draws; upstream reports 0.56-0.62 s "
        "(docs/datasets.md:76,131)"
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
