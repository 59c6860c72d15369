"""Smoke test of the generator on NVIDIA GPUs, through its normal entry points.

Run from the repository root:

    python chip_smoke.py              # every phase below, on one card
    python chip_smoke.py --chips 4    # the data-parallel path on four cards

One process drives the card(s); phases run in order and the first failure
exits non-zero. Each phase prints its checks, wall and compile seconds and
each card's peak memory. The last line is one JSON object naming the device
the run used. Without a GPU the run fails at the first phase and prints no
result.

Phases (one card): device, hat passes vs the NumPy reference at real widths
(with achieved bytes/s beside a device copy), separable vs exact warp at
256^3, the f32 contract GPU vs CPU at 128^3 plus bf16 scopes vs f32 at
256^3, the main path from ``configs/dataset/synth_train.yaml`` with
voxel-exact replay, the ``SyntheticStream`` with every motion tier pinned
once, and the fused generate+train step. ``--chips 4``: device, then the
three sharded programs of ``parallel/sharding.py`` / ``train/step.py`` on a
4-card mesh, each compared with the same keys on one card.

XLA's GPU autotuning is off (``--xla_gpu_autotune_level=0``) unless
``XLA_FLAGS`` sets a level: it would double a cold run's compile time, and
the timings printed here are informational, not a benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances. Hat passes: positions are f32 on both sides and differ only by
# floating-point contraction (an FMA on the GPU, separate mul/add in NumPy),
# ~1 ulp of the position (6e-5 voxel at 640 lanes).
HAT_LINEAR_REL = 1e-4  # max |out - ref| / volume range
# A nearest tap may flip only where the position sits within TIE_EPS voxel
# of k + 0.5, where that ulp decides the rounding; elsewhere it must match.
HAT_TIE_EPS = 1e-3
HAT_TIE_FLIP_FRAC = 1e-4  # the expected flip share is ~2 ulp/voxel ~ 1e-4
# Cross-backend f32 contract: both sides run every contraction at HIGHEST;
# what differs is reduction order and transcendental rounding (exp, log,
# pow, erf_inv) at the ulp level, amplified only by the final /max rescale.
F32_IMAGE_REL_L2 = 1e-4
# A label differs only where a warp position lands within an ulp of a
# nearest-tap tie.
F32_SEG_MISMATCH = 1e-4
# bf16 production scopes vs f32 (tests/test_pipeline.py): seg exact.
BF16_CORR, BF16_REL_L2 = 0.995, 3e-2
# Separable vs exact warp (tests/test_warp.py::test_separable_vs_exact_pipeline).
WARP_REL_MEAN, WARP_LABEL_AGREE = 0.02, 0.85
# Output range: the [0, 1] rescale divides in f32 ((x - lo) / (hi - lo) on
# the host, x / peak on the device), which can round the extreme voxel a
# few ulp past an end; nothing else may leave [0, 1].
RANGE_SLACK = 2.0**-21  # 4 ulp at 1.0
# Generator seed, so a run repeats its draws.
SEED = 0
# 4 cards vs 1: each card's volume against the same key on one card;
# the loss's all-reduce sums 4 partial means in another order.
SHARD_REL_L2, SHARD_SEG_MISMATCH, SHARD_LOSS_REL = 1e-5, 1e-5, 1e-4

_COMPILE = {"backend": 0.0, "cache_load": 0.0}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def _listen(event, secs, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE["backend"] += secs
    elif event == "/jax/compilation_cache/cache_retrieval_time_sec":
        _COMPILE["cache_load"] += secs


def check(name: str, ok: bool, detail: str) -> None:
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


@contextlib.contextmanager
def phase(name: str, devices=None):
    log(f"== phase {name}")
    c0 = dict(_COMPILE)
    t0 = time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    comp = _COMPILE["backend"] - c0["backend"]
    load = _COMPILE["cache_load"] - c0["cache_load"]
    peaks = ""
    if devices:
        peaks = " ".join(
            f"{d.id}:{(d.memory_stats() or {}).get('peak_bytes_in_use', 0) / 2**30:.2f}GiB"
            for d in devices
        )
    log(f"   {name}: wall {wall:.1f}s, compile {comp:.1f}s, cache loads {load:.1f}s,"
        f" peak bytes in use so far [{peaks}]")


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _time(fn, reps=5, inner=1):
    """Median seconds per ``fn()`` call (already compiled): ``inner`` calls
    queued back to back, then blocked, so a short kernel is not timed as
    the host's dispatch-and-sync round trip."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn()
        _block(out)
        ts.append((time.perf_counter() - t0) / inner)
    return float(np.median(ts))


def smooth_volume(shape, seed, lo=0.1, hi=0.9):
    """Band-limited float32 volume in [lo, hi]: products of low-frequency
    sinusoids per axis (cheap on the host at any size)."""
    rng = np.random.default_rng(seed)
    axes = []
    for n in shape:
        t = np.arange(n, dtype=np.float32)
        f = rng.uniform(2 * np.pi / 80, 2 * np.pi / 30, 2).astype(np.float32)
        p = rng.uniform(0, 2 * np.pi, 2).astype(np.float32)
        axes.append((np.sin(f[0] * t + p[0]), np.cos(f[1] * t + p[1])))
    a = axes[0][0][:, None, None] * axes[1][0][None, :, None] * axes[2][1][None, None, :]
    b = axes[0][1][:, None, None] * axes[2][0][None, None, :] + axes[1][1][None, :, None]
    v = a + 0.5 * b  # in [-1.5, 1.5]
    return (lo + (hi - lo) * (v + 1.5) / 3.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    """All JAX devices must be GPUs; print the card, versions and settings."""
    import jax
    import jaxlib

    from fetalsyngen_tpu.accelerator import nvidia_smi_cards, require_gpu
    from fetalsyngen_tpu.compile_cache import enable_compile_cache

    devices = require_gpu(jax.devices())
    for line in nvidia_smi_cards():
        log(line)
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"{len(devices)} x {devices[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_compile_cache()}")
    jax.monitoring.register_event_duration_secs_listener(_listen)
    return devices


def _hat_case(name, fn, srcs, coefs, disp, shape, modes, out_len=None, copy_fn=None):
    """Run one hat pass on the card, check it against the NumPy reference,
    time it and a same-size copy, and print the bytes/s of both."""
    from fetalsyngen_tpu.testing import hat_pass_reference, hat_positions_reference

    outs = _block(fn())
    outs = outs if isinstance(outs, tuple) else (outs,)
    pos = hat_positions_reference(
        np.asarray(coefs) if not isinstance(coefs, tuple) else coefs,
        None if disp is None else np.asarray(disp), shape, out_len,
    )
    for src, out, nearest in zip(srcs, outs, modes):
        ref = hat_pass_reference(np.asarray(src), None, None, shape, nearest, out_len, pos=pos)
        got = np.asarray(out, np.float32)
        if nearest:
            bad = got.reshape(pos.shape) != ref.reshape(pos.shape)
            tie = np.abs(pos - np.floor(pos) - 0.5) < HAT_TIE_EPS
            check(f"{name} nearest", not (bad & ~tie).any()
                  and bad.mean() <= HAT_TIE_FLIP_FRAC,
                  f"mismatch {bad.mean():.2e} (all at ties: {not (bad & ~tie).any()})")
        else:
            rng_ = float(np.ptp(np.asarray(src)))
            err = float(np.max(np.abs(got - ref)))
            check(f"{name} linear", err <= HAT_LINEAR_REL * rng_,
                  f"max err {err:.3e} <= {HAT_LINEAR_REL:g} x range {rng_:.3f}")
    t = _time(fn, inner=20)
    n_out = int(np.prod(outs[0].shape))
    nbytes = sum(int(s.size) * 4 for s in srcs) + len(outs) * n_out * 4
    if disp is not None and np.ndim(disp) == 3:
        nbytes += int(np.size(disp)) * 4
    src0 = srcs[0]
    tc = _time(lambda: copy_fn(src0), inner=20)
    copy_rate = 2 * int(src0.size) * 4 / tc
    log(f"   {name}: {t * 1e3:.3f} ms, {nbytes / t / 1e9:.1f} GB/s "
        f"(read src + disp, write out); copy of one source: {tc * 1e3:.3f} ms, "
        f"{copy_rate / 1e9:.1f} GB/s; ratio {nbytes / t / copy_rate:.2f}")


def phase_hat(edge=256, lanes=640, ns=96):
    """hat_pass / hat_pass_pair vs the NumPy reference in the three
    geometries the generator runs them in."""
    import jax
    import jax.numpy as jnp

    from fetalsyngen_tpu.ops.warp import FIELD_LIM, hat_pass, hat_pass_pair

    copy_fn = jax.jit(lambda x: x + 1.0)
    sh = (edge,) * 3
    img = jnp.asarray(smooth_volume(sh, 1))
    lab = jnp.asarray(np.floor(smooth_volume(sh, 2) * 8.0).astype(np.float32))
    disp = np.clip(
        (smooth_volume(sh, 3, -1.0, 1.0) * 12.0), -FIELD_LIM, FIELD_LIM
    ).astype(np.float32)
    disp_d = jnp.asarray(disp)

    # deform field pass: unit slope + L20*i + displacement volume
    c_f = (0.04, 0.0, 1.0, 0.0)
    _hat_case(
        f"field {edge}^3 pair", lambda: hat_pass_pair(img, lab, c_f, disp_d, sh),
        (img, lab), c_f, disp, sh, (False, True), copy_fn=copy_fn,
    )
    _hat_case(
        f"field {edge}^3 single", lambda: hat_pass(img, c_f, disp_d, sh, False),
        (img,), c_f, disp, sh, (False,), copy_fn=copy_fn,
    )
    # affine U (two row terms, non-unit slope, resized axis) and L passes
    c_u = (0.12, -0.07, 0.97, 3.0)
    out_len = edge - 16
    _hat_case(
        f"affine-U {edge}^3 pair",
        lambda: hat_pass_pair(img, lab, c_u, None, sh, out_len=out_len),
        (img, lab), c_u, None, sh, (False, True), out_len=out_len, copy_fn=copy_fn,
    )
    c_l = (0.1, -0.08, 1.0, 0.0)
    _hat_case(
        f"affine-L {edge}^3 single", lambda: hat_pass(lab, c_l, None, sh, True),
        (lab,), c_l, None, sh, (True,), copy_fn=copy_fn,
    )
    del img, lab, disp_d

    # scanner passes at the 640 tier: per-slice (ns, 4) coefficient tables
    # (dv/du deviations) and a (3, lanes) lane-affine table (dz deviation)
    rng = np.random.default_rng(4)
    shp = (ns, lanes, lanes)
    xa = jnp.asarray(smooth_volume(shp, 5))
    xb = jnp.asarray(smooth_volume(shp, 6, 0.0, 1.0))
    tab = np.stack(
        [np.zeros(ns), rng.uniform(-0.05, 0.05, ns), rng.uniform(0.97, 1.03, ns),
         rng.uniform(-20, 20, ns)], -1,
    ).astype(np.float32)
    tab_d = jnp.asarray(tab)
    _hat_case(
        f"scanner per-slice {ns}x{lanes}^2 pair",
        lambda: hat_pass_pair(xa, xb, tab_d, None, shp, modes=(False, False)),
        (xa, xb), tab, None, shp, (False, False), copy_fn=copy_fn,
    )
    shz = (lanes // 10, lanes, lanes)
    za = jnp.asarray(smooth_volume(shz, 7))
    zb = jnp.asarray(smooth_volume(shz, 8, 0.0, 1.0))
    lt = np.stack(
        [rng.uniform(-0.02, 0.02, lanes), rng.uniform(-0.02, 0.02, lanes),
         rng.uniform(-8, 8, lanes)]
    ).astype(np.float32)
    lt_d = jnp.asarray(lt)
    c0 = (0.0, 0.0, 1.0, 0.0)
    _hat_case(
        f"scanner lane-affine {shz[0]}x{lanes}^2 pair",
        lambda: hat_pass_pair(za, zb, c0, lt_d, shz, modes=(False, False)),
        (za, zb), c0, lt, shz, (False, False), copy_fn=copy_fn,
    )


def phase_warp(cfg, image, labels):
    """deform_stage: default separable warp vs the exact trilinear gather,
    on a real image and its anatomical label map."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from fetalsyngen_tpu.generator.params import sample_params
    from fetalsyngen_tpu.generator.pipeline import deform_stage

    sh = cfg.shape
    base = dataclasses.replace(
        cfg, deform=dataclasses.replace(cfg.deform, warp_impl="separable")
    )
    exact = dataclasses.replace(
        cfg, deform=dataclasses.replace(cfg.deform, warp_impl="exact")
    )
    vol = jnp.asarray(image, jnp.float32)
    seg = jnp.asarray(labels, jnp.int32)
    key = jax.random.PRNGKey(0)
    run = jax.jit(deform_stage, static_argnums=(2,))
    p = sample_params(key, base, {"deform_apply": True, "flip": False})
    o1, s1, _ = _block(run(key, p, base, vol, seg, None))
    o2, s2, _ = _block(run(key, p, exact, vol, seg, None))
    o1, o2, s1, s2 = map(np.asarray, (o1, o2, s1, s2))
    mask = (o1 != 0) & (o2 != 0)
    rel = float((np.abs(o1 - o2)[mask] / np.abs(o2[mask]).max()).mean())
    check("separable vs exact image", rel < WARP_REL_MEAN,
          f"mean rel err {rel:.4f} < {WARP_REL_MEAN}")
    agree = float((s1 == s2).mean())
    check("separable vs exact labels", agree > WARP_LABEL_AGREE,
          f"agreement {agree:.4f} > {WARP_LABEL_AGREE}")
    t_sep = _time(lambda: run(key, p, base, vol, seg, None), 3)
    t_ex = _time(lambda: run(key, p, exact, vol, seg, None), 3)
    log(f"   deform_stage {sh[0]}^3: separable {t_sep * 1e3:.2f} ms, exact {t_ex * 1e3:.2f} ms")


def _core(cfg, key, seeds, seg):
    import jax.numpy as jnp

    from fetalsyngen_tpu.generator.pipeline import _synth_core

    out, sg, _, _ = _synth_core(key, seeds, seg, jnp.zeros((), jnp.float32), (), cfg, (), False)
    return out, sg


def phase_f32_contract(cfg, edge_small=128):
    """The f32 contract across backends, and the bf16 scopes against it."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from fetalsyngen_tpu.ops.linops import precision_scope, storage_scope
    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    small = (edge_small,) * 3
    cfg_s = dataclasses.replace(
        cfg, shape=small, deform=dataclasses.replace(cfg.deform, size=small)
    )
    seeds_np, seg_np = phantom_seeds_and_seg(small, seed=1)
    cpu = jax.devices("cpu")[0]
    outs = {}
    with jax.default_matmul_precision("highest"):
        for name, dev in (("gpu", jax.devices()[0]), ("cpu", cpu)):
            args = jax.device_put(
                (jax.random.PRNGKey(3), seeds_np.astype(np.int32), seg_np.astype(np.int32)), dev
            )
            t0 = time.perf_counter()
            o, s = _block(_core(cfg_s, *args))
            outs[name] = (np.asarray(o, np.float32), np.asarray(s))
            log(f"   synth core {edge_small}^3 on {name}: {time.perf_counter() - t0:.1f}s incl. compile")
    (og, sg), (oc, sc) = outs["gpu"], outs["cpu"]
    rel = float(np.linalg.norm(og - oc) / (np.linalg.norm(oc) + 1e-12))
    check("f32 GPU vs CPU image", rel <= F32_IMAGE_REL_L2, f"rel L2 {rel:.3e} <= {F32_IMAGE_REL_L2:g}")
    mis = float((sg != sc).mean())
    check("f32 GPU vs CPU labels", mis <= F32_SEG_MISMATCH, f"mismatch {mis:.3e} <= {F32_SEG_MISMATCH:g}")

    seeds_np, seg_np = phantom_seeds_and_seg(cfg.shape, seed=2)
    seeds, seg = jnp.asarray(seeds_np, jnp.int32), jnp.asarray(seg_np, jnp.int32)
    key = jax.random.PRNGKey(77)
    of, sf = _block(_core(cfg, key, seeds, seg))
    with precision_scope(jax.lax.Precision.DEFAULT), storage_scope(jnp.bfloat16):
        ob, sb = _block(_core(cfg, key, seeds, seg))
    check("bf16 scopes labels", bool(np.array_equal(np.asarray(sb), np.asarray(sf))), "voxel-exact vs f32")
    a = np.asarray(ob, np.float32).ravel()
    b = np.asarray(of, np.float32).ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    rel = float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))
    check("bf16 scopes image", corr > BF16_CORR and rel < BF16_REL_L2,
          f"corr {corr:.5f} > {BF16_CORR}, rel L2 {rel:.4f} < {BF16_REL_L2}")


def force_all_artifacts(generator):
    """All four SR artifacts on for every sample."""
    a = generator.artifacts
    a["blur_cortex"].prob = 1.0
    a["struct_noise"].prob = 1.0
    a["simulate_motion"].prob = 1.0
    a["boundaries"].prob_no_mask = 0.0
    a["boundaries"].prob_halo = 1.0
    a["boundaries"].prob_fuzzy = 1.0
    return generator


def _check_sample(name, image, label, allowed):
    image = np.asarray(image)
    finite = bool(np.isfinite(image).all())
    lo, hi = float(np.nanmin(image)), float(np.nanmax(image))
    check(f"{name} image", finite and lo >= -RANGE_SLACK and hi <= 1.0 + RANGE_SLACK,
          f"finite {finite}, range [{lo!r}, {hi!r}] within [0, 1] +- {RANGE_SLACK:.2g}")
    labs = set(np.unique(np.asarray(label)).tolist())
    check(f"{name} labels", labs <= allowed, f"{sorted(labs)} within the input dseg labels")


def _artifacts_on(meta: dict) -> list:
    """Names of the SR artifacts a sample's genparams record as applied."""
    on = []
    if meta.get("blur_cortex", {}).get("nblur") is not None:
        on.append("blur_cortex")
    if any(v is not None for v in meta.get("struct_noise", {}).values()):
        on.append("struct_noise")
    sm = meta.get("simulate_motion", {})
    if sm:
        on.append(f"simulate_motion(res_slice {sm['resolution_slice']:.2f}, "
                  f"{sm['nstacks']} stacks)")
    if meta.get("boundaries", {}).get("no_mask_on") is False:
        on.append("boundaries")
    return on


def phase_main_path(ds, ds_forced, allowed, n=3):
    """load_and_instantiate(synth_train.yaml) -> sample_with_meta -> replay."""
    from fetalsyngen_tpu.io import native

    lib = native.get_lib()
    log(f"   NIfTI reader: {'native C++ ' + str(native._LIB_PATH) if lib else 'Python fallback'}")
    runs = [("default", ds)] * n + [("all-artifacts", ds_forced)]
    for i, (name, d) in enumerate(runs):
        t0 = time.perf_counter()
        item = d.sample_with_meta(0)
        t1 = time.perf_counter()
        log(f"   sample {i} ({name}): {t1 - t0:.1f}s, artifacts on: "
            f"{_artifacts_on(item['generation_params']['artifacts'])}")
        _check_sample(f"sample {i}", item["image"], item["label"], allowed)
        rep = d.sample_with_meta(0, genparams=item["generation_params"])
        same = np.array_equal(rep["image"], item["image"]) and np.array_equal(
            rep["label"], item["label"])
        diff = float(np.max(np.abs(rep["image"] - item["image"])))
        check(f"sample {i} replay", same, f"voxel-exact (max |diff| {diff:.3e}), "
              f"{time.perf_counter() - t1:.1f}s")


def tier_pins(stream) -> dict:
    """``simulate_motion`` genparams pins routing every sample of a stream
    batch to one motion-engine variant: the small px frame (when the stream
    has one) and each static tier. A tier t serves slice FOVs up to t, so a
    slice resolution of ``diag / (t - 16)`` voxels lands in tier t; the
    small frame needs ``rs * small >= diag`` and a gap over 2 px."""
    cfg = stream.cfg
    res = float(cfg.resolution[0])
    diag = float(np.sqrt(sum(s * s for s in cfg.shape) / 2.0))
    pins = {}
    if stream.small_cube is not None:
        rs = 1.2 * diag / stream.small_cube * res
        pins[f"small{stream.small_cube}"] = {"resolution_slice": rs, "gap": 3.5 * rs}
    for t in stream.cubes:
        pins[f"tier{t}"] = {"resolution_slice": diag / (t - 16) * res}
    return pins


def phase_stream(ds, allowed, batch=4, n=3):
    """SyntheticStream at default artifact probabilities, then every motion
    tier pinned once through genparams."""
    import jax
    import jax.numpy as jnp

    from fetalsyngen_tpu.parallel.input_pipeline import SyntheticStream

    stream = SyntheticStream(ds, batch_size=batch, seed=0, prefetch=True)
    log(f"   tiers {stream.cubes}, small frame {stream.small_cube}, ns_grid {stream.ns_grid}")
    it = iter(stream)
    for i in range(n):
        t0 = time.perf_counter()
        b = next(it)
        _block(b["image"])
        log(f"   batch {i}: {time.perf_counter() - t0:.1f}s, motion "
            f"{b['meta']['scanner']['motion_on'].tolist()}")
        check(f"batch {i} shape", b["image"].shape == (batch, *ds.generator.cfg.shape),
              str(b["image"].shape))
        _check_sample(f"batch {i}", b["image"], b["label"], allowed)
    meta = b["meta"]
    mega, megasegs, hi = stream._stack_banks(list(meta["resident"]))
    pack = {k: jnp.asarray(v) for k, v in meta["pack"].items()}
    compiled = stream._batch_fn.lower(
        jnp.asarray(meta["sub"]), mega, megasegs, hi,
        jnp.asarray(meta["subj"], jnp.int32), pack,
    ).compile()
    log(f"   batch program memory_analysis: {compiled.memory_analysis()}")

    for name, pin in tier_pins(stream).items():
        s = SyntheticStream(
            ds, batch_size=batch, seed=0, prefetch=False,
            genparams={"artifact_params": {"simulate_motion": pin}},
        )
        # pins change only the host-packed geometry: run the batch program
        # already compiled above instead of building (and compiling) a twin
        s._batch_fn = stream._batch_fn
        t0 = time.perf_counter()
        b = next(iter(s))
        _block(b["image"])
        p = b["meta"]["pack"]
        if name.startswith("small"):
            routed = bool(p["small"].all())
        else:
            want = s.cubes.index(int(name[4:]))
            routed = bool((p["tier_idx"] == want).all() and not p["small"].any())
        check(f"pinned {name}", routed and bool(b["meta"]["scanner"]["motion_on"].all()),
              f"every sample routed to {name}, {time.perf_counter() - t0:.1f}s")
        _check_sample(f"pinned {name}", b["image"], b["label"], allowed)
        del b
    del it


def _phantom_batch(edge, B, seed=0):
    import jax.numpy as jnp

    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    seeds_np, seg_np = phantom_seeds_and_seg((edge,) * 3, seed=seed)
    seeds = jnp.broadcast_to(jnp.asarray(seeds_np, jnp.int32), (B, *seeds_np.shape))
    segs = jnp.broadcast_to(jnp.asarray(seg_np, jnp.int32), (B, *seg_np.shape))
    return seeds, segs


def phase_consumer(cfg, batch=2, steps=3, channels=(8, 16, 32)):
    """The fused generate+train step on a one-card mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fetalsyngen_tpu.parallel.sharding import data_mesh, shard_batch
    from fetalsyngen_tpu.train.step import create_train_state, make_sharded_train_step
    from fetalsyngen_tpu.train.unet import UNet3D

    mesh = data_mesh(jax.devices()[:1])
    model = UNet3D(channels=channels, n_classes=8)
    state, tx = create_train_state(jax.random.PRNGKey(0), model, cfg.shape)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = make_sharded_train_step(mesh, model, tx, cfg)
    seeds, segs = _phantom_batch(cfg.shape[0], batch)
    seeds, segs = shard_batch(mesh, seeds), shard_batch(mesh, segs)
    key = jax.random.PRNGKey(1)
    for i in range(steps):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        state, loss = step(state, shard_batch(mesh, jax.random.split(sub, batch)), seeds, segs)
        loss = float(loss)
        check(f"train step {i}", bool(np.isfinite(loss)), f"loss {loss:.4f}, {time.perf_counter() - t0:.1f}s")


def _compare_volumes(name, got_img, got_lab, ref_img, ref_lab):
    gi, ri = np.asarray(got_img, np.float32), np.asarray(ref_img, np.float32)
    exact = np.array_equal(gi, ri) and np.array_equal(np.asarray(got_lab), np.asarray(ref_lab))
    rel = float(np.linalg.norm(gi - ri) / (np.linalg.norm(ri) + 1e-12))
    mis = float((np.asarray(got_lab) != np.asarray(ref_lab)).mean())
    check(name, exact or (rel <= SHARD_REL_L2 and mis <= SHARD_SEG_MISMATCH),
          f"{'bit-equal' if exact else 'not bit-equal'}: rel L2 {rel:.2e}, label mismatch {mis:.2e}")


def _check_placement(name, arr, devices):
    devs = [s.device for s in arr.addressable_shards]
    check(f"{name} placement", len(set(devs)) == len(devices) == len(devs),
          f"one shard per card: {[d.id for d in devs]}")


def phase_data_parallel(devices, ds, n=4, artifact_cube=(384,), channels=(4, 8)):
    """make_sharded_generator, make_sharded_artifact_generator and
    make_sharded_train_step on an n-card mesh, batch n (one volume per
    card), each compared with the same keys on one card."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fetalsyngen_tpu.generator.artifacts.batched import pack_motion
    from fetalsyngen_tpu.parallel.input_pipeline import SyntheticStream
    from fetalsyngen_tpu.parallel.sharding import (
        data_mesh, make_sharded_artifact_generator, make_sharded_generator, shard_batch,
    )
    from fetalsyngen_tpu.train.step import create_train_state, make_sharded_train_step
    from fetalsyngen_tpu.train.unet import UNet3D

    cfg = ds.generator.cfg
    mesh, mesh1 = data_mesh(devices[:n]), data_mesh(devices[:1])
    seeds, segs = _phantom_batch(cfg.shape[0], n)
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    sh = lambda m, x: shard_batch(m, x)  # noqa: E731

    gen, gen1 = make_sharded_generator(mesh, cfg), make_sharded_generator(mesh1, cfg)
    t0 = time.perf_counter()
    imgs, labs = _block(gen(sh(mesh, keys), sh(mesh, seeds), sh(mesh, segs)))
    log(f"   sharded generator: {time.perf_counter() - t0:.1f}s incl. compile")
    _check_placement("sharded generator", imgs, devices[:n])
    for i in range(n):
        ri, rl = gen1(*(sh(mesh1, a[i : i + 1]) for a in (keys, seeds, segs)))
        _compare_volumes(f"generator card {i}", imgs[i], labs[i], ri[0], rl[0])

    gen_cfg = SyntheticStream(ds, batch_size=n, prefetch=False)
    sm = ds.generator.artifacts["simulate_motion"]
    pack = pack_motion(np.random.default_rng(5), n, cfg.shape, float(cfg.resolution[0]),
                       sm, artifact_cube, gen_cfg.ns_grid)
    art = jax.jit(make_sharded_artifact_generator(
        mesh, ds.generator, cfg.shape, artifact_cube, gen_cfg.ns_grid))
    art1 = jax.jit(make_sharded_artifact_generator(
        mesh1, ds.generator, cfg.shape, artifact_cube, gen_cfg.ns_grid))
    shard_pack = lambda m, sl: {k: sh(m, np.asarray(v)[sl]) for k, v in pack.items()}  # noqa: E731
    t0 = time.perf_counter()
    imgs, labs = _block(art(sh(mesh, keys), sh(mesh, seeds), sh(mesh, segs),
                            shard_pack(mesh, slice(None))))
    log(f"   sharded artifact generator (tiers {artifact_cube}): "
        f"{time.perf_counter() - t0:.1f}s incl. compile, motion {pack['motion_on'].tolist()}")
    _check_placement("sharded artifact generator", imgs, devices[:n])
    for i in range(n):
        sl = slice(i, i + 1)
        ri, rl = art1(sh(mesh1, keys[sl]), sh(mesh1, seeds[sl]), sh(mesh1, segs[sl]),
                      shard_pack(mesh1, sl))
        _compare_volumes(f"artifact generator card {i}", imgs[i], labs[i], ri[0], rl[0])
    del imgs, labs, ri, rl

    model = UNet3D(channels=channels, n_classes=8)
    losses = {}
    for name, m in (("4-card", mesh), ("1-card", mesh1)):
        state, tx = create_train_state(jax.random.PRNGKey(0), model, cfg.shape)
        state = jax.device_put(state, NamedSharding(m, P()))
        step = make_sharded_train_step(m, model, tx, cfg)
        t0 = time.perf_counter()
        state, loss = step(state, sh(m, keys), sh(m, seeds), sh(m, segs))
        losses[name] = float(loss)
        log(f"   train step {name}: loss {losses[name]:.6f}, {time.perf_counter() - t0:.1f}s incl. compile")
        del state
    rel = abs(losses["4-card"] - losses["1-card"]) / abs(losses["1-card"])
    check("train step loss 4-card vs 1-card", np.isfinite(losses["4-card"]) and rel <= SHARD_LOSS_REL,
          f"rel diff {rel:.2e} <= {SHARD_LOSS_REL:g}")
    for d in devices[:n]:
        st = d.memory_stats() or {}
        log(f"   card {d.id} memory_stats: peak {st.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB, "
            f"in use {st.get('bytes_in_use', 0) / 2**30:.2f} GiB, limit {st.get('bytes_limit', 0) / 2**30:.2f} GiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run the data-parallel path on four cards (and nothing else)")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    # Autotuning the 256^3 convolutions and GEMMs is most of a cold compile
    # (minutes for the train step alone); the checks here do not depend on
    # the chosen algorithms, so keep XLA's default picks unless told otherwise.
    flags = os.environ.get("XLA_FLAGS", "")
    if "autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_gpu_autotune_level=0".strip()

    with phase("device"):
        devices = phase_device()
    if len(devices) < args.chips:
        raise RuntimeError(f"--chips {args.chips} needs {args.chips} cards, found {len(devices)}")
    devices = devices[: args.chips]

    from fetalsyngen_tpu.accelerator import device_record
    from fetalsyngen_tpu.config import load_and_instantiate
    from fetalsyngen_tpu.io import nifti

    config = "configs/dataset/synth_train.yaml"
    ds = load_and_instantiate(config)
    ds.generator._rng = np.random.default_rng(SEED)
    if args.chips == 4:
        with phase("data-parallel x4", devices):
            phase_data_parallel(devices, ds)
    else:
        allowed = set(np.unique(nifti.load_ras(str(ds.segm_paths[0])).data).tolist())
        cfg = ds.generator.cfg
        with phase("hat passes", devices):
            phase_hat()
        with phase("warp", devices):
            phase_warp(
                cfg, nifti.load_ras(str(ds.img_paths[0])).data,
                nifti.load_ras(str(ds.segm_paths[0])).data,
            )
        with phase("f32 contract", devices):
            phase_f32_contract(cfg)
        with phase("main path", devices):
            forced = load_and_instantiate(config)
            forced.generator._rng = np.random.default_rng(SEED + 1)
            force_all_artifacts(forced.generator)
            phase_main_path(ds, forced, allowed)
        with phase("stream", devices):
            phase_stream(ds, allowed)
        with phase("consumer", devices):
            phase_consumer(cfg)
    log(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
