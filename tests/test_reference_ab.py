"""A/B tests against the ACTUAL reference implementation (torch CPU).

Every other parity test in this suite compares our JAX kernels against
independently re-written NumPy references (``tests/np_reference.py``). These
tests close the remaining gap in that chain: they import the reference's own
pure-torch code from ``/root/reference`` (``fetalsyngen/utils/generation.py``
imports cleanly with CPU torch — no CUDA, no MONAI on those paths) and assert
our kernels and the exact-path pipeline reproduce *it*, not our re-statement
of it.

Covered:
- kernel level: ``make_affine_matrix``, ``fast_3D_interp_torch``
  (linear + nearest incl. out-of-bounds), ``myzoom_torch``,
  ``gaussian_blur_3d`` (reference ``utils/generation.py:39-110,204-397``);
- stage level: the full ``SpatialDeformation.deform`` (affine + nonlinear +
  margin shift, reference ``deformation/affine_nonrigid.py:86-366``) driven
  by the reference's own class, with the low-res displacement field
  transplanted from our PRNG stream so both sides warp with the same field;
- pipeline level: our jitted exact-path ``synth_sample`` vs a torch chain
  composed from the reference's own kernels following the reference stage
  laws (``rand_gmm.py:146-149``, ``synthseg.py:50-114,144-188,206-275``,
  ``model.py:94-229``), with all voxel noise fields transplanted.

RNG note: the two implementations draw voxel fields from different RNGs
(torch global vs ``jax.random``), so exact A/B requires pinning the scalar
genparams AND feeding the reference the same field realizations; the
transplant direction is JAX -> torch (fields are pure data to both).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REFERENCE = Path("/root/reference")

torch = pytest.importorskip("torch")
if not (REFERENCE / "fetalsyngen" / "utils" / "generation.py").exists():
    pytest.skip("reference checkout not available", allow_module_level=True)

if str(REFERENCE) not in sys.path:
    sys.path.insert(0, str(REFERENCE))

import fetalsyngen.utils.generation as ref_gen  # noqa: E402
from fetalsyngen.generator.deformation.affine_nonrigid import (  # noqa: E402
    SpatialDeformation as RefSpatialDeformation,
)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x).copy())


# ---------------------------------------------------------------------------
# Kernel-level A/B
# ---------------------------------------------------------------------------


def test_make_affine_matrix_matches_reference():
    from fetalsyngen_tpu.ops.affine import make_affine_matrix

    rng = np.random.default_rng(0)
    for _ in range(5):
        rot = rng.uniform(-0.4, 0.4, 3)
        sh = rng.uniform(-0.05, 0.05, 3)
        s = rng.uniform(0.8, 1.2, 3)
        ours = np.asarray(make_affine_matrix(jnp.asarray(rot), jnp.asarray(sh), jnp.asarray(s)))
        theirs = ref_gen.make_affine_matrix(rot, sh, s)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def _coords(rng, shape, n, spill=3.0):
    """Random sample coordinates spilling ``spill`` voxels out of bounds."""
    return tuple(
        rng.uniform(-spill, shape[d] - 1 + spill, size=n).astype(np.float32)
        for d in range(3)
    )


def test_trilinear_interp_matches_reference_linear():
    from fetalsyngen_tpu.ops.interp import trilinear_interp

    rng = np.random.default_rng(1)
    shape = (19, 23, 17)
    vol = rng.normal(size=shape).astype(np.float32) * 50
    x, y, z = _coords(rng, shape, (11, 13, 7))

    ours = np.asarray(
        trilinear_interp(jnp.asarray(vol), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    )
    theirs = ref_gen.fast_3D_interp_torch(_t(vol), _t(x), _t(y), _t(z), "linear").numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-4)


def test_trilinear_interp_matches_reference_default_value():
    from fetalsyngen_tpu.ops.interp import trilinear_interp

    rng = np.random.default_rng(2)
    shape = (9, 8, 10)
    vol = rng.normal(size=shape).astype(np.float32)
    x, y, z = _coords(rng, shape, (50,), spill=6.0)
    ours = np.asarray(
        trilinear_interp(
            jnp.asarray(vol), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), default_value=-7.5
        )
    )
    theirs = ref_gen.fast_3D_interp_torch(
        _t(vol), _t(x), _t(y), _t(z), "linear", default_value_linear=-7.5
    ).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_nearest_interp_matches_reference():
    from fetalsyngen_tpu.ops.interp import nearest_interp

    rng = np.random.default_rng(3)
    shape = (14, 11, 16)
    vol = rng.integers(0, 40, size=shape).astype(np.float32)
    x, y, z = _coords(rng, shape, (9, 9, 9))
    # keep coordinates away from exact .5 boundaries: torch.round and
    # jnp.round both round-half-to-even, but float noise near the boundary is
    # not what this test is about
    x, y, z = (np.where(np.abs(c - np.round(c)) < 1e-3, c + 0.01, c) for c in (x, y, z))

    ours = np.asarray(
        nearest_interp(jnp.asarray(vol), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    )
    theirs = ref_gen.fast_3D_interp_torch(_t(vol), _t(x), _t(y), _t(z), "nearest").numpy()
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("factor", [(0.63, 1.41, 0.89), (0.5, 0.5, 0.5), (1.9, 0.71, 1.0)])
def test_zoom_matches_myzoom(factor):
    from fetalsyngen_tpu.ops.interp import zoom

    rng = np.random.default_rng(4)
    shape = (21, 18, 25)
    vol = rng.normal(size=shape).astype(np.float32)
    factor = np.asarray(factor)
    out_shape = tuple(np.round(np.array(shape) * factor).astype(int).tolist())

    ours = np.asarray(zoom(jnp.asarray(vol), out_shape, jnp.asarray(factor, dtype=jnp.float32)))
    theirs = ref_gen.myzoom_torch(_t(vol), factor).numpy()
    assert theirs.shape == out_shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


def test_zoom_matches_myzoom_with_channels():
    """The deformation-field use: (D, H, W, 3) low-res field upsample."""
    from fetalsyngen_tpu.ops.interp import zoom

    rng = np.random.default_rng(5)
    small = rng.normal(size=(4, 5, 3, 3)).astype(np.float32)
    out_shape = (40, 44, 36)
    factor = np.array(out_shape) / np.array(small.shape[:3])

    ours = np.asarray(zoom(jnp.asarray(small), out_shape, jnp.asarray(factor, dtype=jnp.float32)))
    theirs = ref_gen.myzoom_torch(_t(small), factor).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=2e-4)


def test_gaussian_blur_matches_reference():
    from fetalsyngen_tpu.ops.blur import gaussian_blur_3d

    rng = np.random.default_rng(6)
    vol = rng.normal(size=(24, 20, 22)).astype(np.float32) * 10
    for stds in [(1.3, 0.0, 2.1), (0.6, 0.6, 0.6), (0.0, 0.0, 0.0)]:
        half_len = int(np.ceil(3 * max(stds))) or 1
        ours = np.asarray(
            gaussian_blur_3d(jnp.asarray(vol), jnp.asarray(stds, dtype=jnp.float32), half_len)
        )
        theirs = ref_gen.gaussian_blur_3d(_t(vol), np.asarray(stds), "cpu").numpy()
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-3)


def test_gaussian_blur_mm_matches_reference():
    """The Toeplitz-matmul blur (production path) vs the reference conv."""
    from fetalsyngen_tpu.ops.linops import gaussian_blur_mm

    rng = np.random.default_rng(7)
    vol = rng.normal(size=(24, 20, 22)).astype(np.float32) * 10
    stds = (1.7, 0.9, 0.0)
    half_len = int(np.ceil(3 * max(stds)))
    ours = np.asarray(
        gaussian_blur_mm(jnp.asarray(vol), jnp.asarray(stds, dtype=jnp.float32), half_len)
    )
    theirs = ref_gen.gaussian_blur_3d(_t(vol), np.asarray(stds), "cpu").numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# Stage-level A/B: SpatialDeformation (the reference's own class)
# ---------------------------------------------------------------------------

SHAPE = (40, 44, 36)


def _deform_cfg(nonlinear: bool):
    from fetalsyngen_tpu.generator.config import DeformCfg, GeneratorCfg, IntensityCfg

    labels = tuple(range(8))
    return GeneratorCfg(
        shape=SHAPE,
        resolution=(0.5, 0.5, 0.5),
        intensity=IntensityCfg(1, 2, labels, labels),
        deform=DeformCfg(
            max_rotation=20.0,
            max_shear=0.02,
            max_scaling=0.1,
            size=SHAPE,
            prob=1.0,
            nonlinear_transform=nonlinear,
            nonlin_scale_min=0.03,
            nonlin_scale_max=0.15,
            nonlin_std_max=4.0,
            flip_prb=0.5,
            margin_shift=True,
            warp_impl="exact",
        ),
    )


def _ref_spatial_deformation(nonlinear: bool) -> RefSpatialDeformation:
    return RefSpatialDeformation(
        max_rotation=20.0,
        max_shear=0.02,
        max_scaling=0.1,
        size=list(SHAPE),
        prob=1.0,
        nonlinear_transform=nonlinear,
        nonlin_scale_min=0.03,
        nonlin_scale_max=0.15,
        nonlin_std_max=4.0,
        flip_prb=0.5,
        device="cpu",
    )


def _phantom(shape):
    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    seeds, seg = phantom_seeds_and_seg(shape, seed=0)
    rng = np.random.default_rng(11)
    out = (seg * 30.0 + rng.normal(size=shape) * 5.0).astype(np.float32)
    return out, seg.astype(np.int32)


def _nonlin_field_from_key(key, cfg, size_F_small):
    """Reproduce the pipeline's raw N(0,1) low-res field (logical corner)."""
    from fetalsyngen_tpu.generator.params import field_key

    smax = cfg.deform.small_field_max()
    raw = jax.random.normal(field_key(key, "field_nonlin"), (3, *smax), jnp.float32)
    s0, s1, s2 = (int(v) for v in size_F_small)
    return np.asarray(raw)[:, :s0, :s1, :s2]


@pytest.mark.parametrize("nonlinear,flip", [(False, False), (True, False), (True, True)])
def test_deform_stage_matches_reference_class(nonlinear, flip, monkeypatch):
    """Full SpatialDeformation.deform A/B with a transplanted field."""
    from fetalsyngen_tpu.generator.pipeline import synth_sample

    cfg = _deform_cfg(nonlinear)
    out_np, seg_np = _phantom(SHAPE)
    key = jax.random.PRNGKey(42)

    rng = np.random.default_rng(12)
    rotations = rng.uniform(-20, 20, 3) / 180.0 * np.pi
    shears = rng.uniform(-0.02, 0.02, 3)
    scalings = 1.0 + rng.uniform(-0.1, 0.1, 3)
    nonlin_scale = np.array([0.12])
    size_F_small = np.round(nonlin_scale * np.array(SHAPE)).astype(int).tolist()
    nonlin_std = 3.0

    overrides = {
        "deform_apply": True,
        "flip": flip,
        "rotations": rotations.astype(np.float32),
        "shears": shears.astype(np.float32),
        "scalings": scalings.astype(np.float32),
        "nonlin_scale": np.float32(nonlin_scale[0]),
        "nonlin_std": np.float32(nonlin_std),
        "size_F_small": np.asarray(size_F_small, np.int32),
    }
    ours_out, ours_seg, _, _ = synth_sample(
        key,
        None,
        jnp.asarray(seg_np),
        cfg=cfg,
        overrides=overrides,
        intensity_prior=jnp.asarray(out_np),
        stages=("deform",),
    )

    # --- reference side: same scalars via genparams, same field via randn patch
    ref_sd = _ref_spatial_deformation(nonlinear)
    genparams = {
        "affine": {"rotations": rotations, "shears": shears, "scalings": scalings},
        "flip": flip,
    }
    if nonlinear:
        genparams["non_rigid"] = {
            "nonlin_scale": nonlin_scale,
            "nonlin_std": nonlin_std,
            "size_F_small": size_F_small,
        }
        field = _nonlin_field_from_key(key, cfg, size_F_small)  # (3, s0, s1, s2)
        field_t = torch.as_tensor(np.moveaxis(field, 0, -1).copy())
        orig_randn = torch.randn

        def randn_patch(*args, **kwargs):
            shape = list(args[0]) if len(args) == 1 and isinstance(args[0], (list, tuple)) else list(args)
            if shape == list(field_t.shape):
                return field_t.clone()
            return orig_randn(*args, **kwargs)

        monkeypatch.setattr(torch, "randn", randn_patch)
    else:
        # the reference applies the nonlinear branch iff the flag is on; no
        # non_rigid genparams needed
        pass

    _, ref_seg, ref_out, _ = ref_sd.deform(
        image=None,
        segmentation=_t(seg_np),
        output=_t(out_np),
        genparams=genparams,
    )
    ref_out = ref_out.numpy()
    ref_seg = ref_seg.numpy()

    ours_out = np.asarray(ours_out)
    ours_seg = np.asarray(ours_seg)

    # linear warp: identical math, f32 vs f64 affine products -> tiny coord
    # jitter; values live on a 0..~220 scale
    assert np.mean(np.abs(ours_out - ref_out)) < 0.02
    assert np.max(np.abs(ours_out - ref_out)) < 1.5
    # nearest warp: label flips only possible where the coordinate sits
    # within float error of a .5 boundary
    mismatch = np.mean(ours_seg != ref_seg)
    assert mismatch < 2e-3, f"seg mismatch fraction {mismatch}"


# ---------------------------------------------------------------------------
# Pipeline-level A/B: exact path vs torch-composed reference chain
# ---------------------------------------------------------------------------


def _torch_reference_chain(key, cfg, seeds_np, seg_np, ov):
    """Compose the reference pipeline from the reference's own kernels.

    Stage laws restated from (and cited to) the reference source; every voxel
    field is transplanted from the JAX PRNG stream so the comparison is about
    the *transform math*, not RNG:

    - intensity: ``mus[seeds] + sigmas[seeds] * N(0,1)``, clamp >= 0
      (``rand_gmm.py:146-149``);
    - deform: ``SpatialDeformation.deform`` — the reference's own class;
    - gamma: ``300 * (x / 300) ** gamma`` (``synthseg.py:263-275``);
    - bias: ``x * exp(myzoom(bf_std * N(0,1) at bf_size))``
      (``synthseg.py:144-188``);
    - resample: blur-std law + ``gaussian_blur_3d`` + linear interp onto the
      ``np.arange`` product grid (``synthseg.py:50-107``);
    - noise at low res, clamp >= 0 (``synthseg.py:206-235``; order per
      ``model.py:193-207``);
    - resize back: ``myzoom_torch(x, 1/factors) / max`` (``synthseg.py:109-114``).
    """
    from fetalsyngen_tpu.generator.params import field_key

    shape = seeds_np.shape

    # --- intensity (transplanted field)
    noise = np.asarray(jax.random.normal(field_key(key, "field_intensity"), shape, jnp.float32))
    mus, sigmas = np.asarray(ov["mus"]), np.asarray(ov["sigmas"])
    out = mus[seeds_np] + sigmas[seeds_np] * noise
    out = np.maximum(out, 0.0).astype(np.float32)

    # --- deform via the reference class (field transplanted)
    ref_sd = _ref_spatial_deformation(True)
    field = _nonlin_field_from_key(key, cfg, ov["size_F_small"])
    field_t = torch.as_tensor(np.moveaxis(field, 0, -1).copy())
    orig_randn = torch.randn
    try:
        def randn_patch(*args, **kwargs):
            s = list(args[0]) if len(args) == 1 and isinstance(args[0], (list, tuple)) else list(args)
            if s == list(field_t.shape):
                return field_t.clone()
            return orig_randn(*args, **kwargs)

        torch.randn = randn_patch
        genparams = {
            "affine": {
                "rotations": np.asarray(ov["rotations"], np.float64),
                "shears": np.asarray(ov["shears"], np.float64),
                "scalings": np.asarray(ov["scalings"], np.float64),
            },
            "non_rigid": {
                "nonlin_scale": np.array([float(ov["nonlin_scale"])]),
                "nonlin_std": float(ov["nonlin_std"]),
                "size_F_small": [int(v) for v in ov["size_F_small"]],
            },
            "flip": bool(ov["flip"]),
        }
        _, seg_t, out_t, _ = ref_sd.deform(
            image=None, segmentation=_t(seg_np), output=_t(out), genparams=genparams
        )
    finally:
        torch.randn = orig_randn

    # --- gamma
    out_t = 300.0 * (out_t / 300.0) ** float(ov["gamma"])

    # --- bias field (transplanted)
    bmax = cfg.bias_field.small_field_max(shape)
    bf_size = [int(v) for v in ov["bf_size"]]
    raw_bias = np.asarray(jax.random.normal(field_key(key, "field_bias"), bmax, jnp.float32))
    small = float(ov["bf_std"]) * raw_bias[: bf_size[0], : bf_size[1], : bf_size[2]]
    bf = torch.exp(ref_gen.myzoom_torch(_t(small), np.array(shape) / np.array(bf_size)))
    out_t = out_t * bf

    # --- resample: blur + downsample grid
    spacing = np.asarray(ov["spacing"], np.float64)
    input_res = np.asarray(cfg.resolution, np.float64)
    stds = float(ov["blur_mult"]) * np.log(5) / np.pi * spacing / input_res
    stds[spacing <= input_res] = 0.0
    blurred = ref_gen.gaussian_blur_3d(out_t.float(), stds, "cpu")

    new_size = (np.array(shape) * input_res / spacing).astype(int)
    factors = new_size / np.array(shape)
    delta = (1.0 - factors) / (2.0 * factors)
    vs = [
        np.arange(delta[d], delta[d] + new_size[d] / factors[d], 1 / factors[d])[: new_size[d]]
        for d in range(3)
    ]
    II, JJ, KK = np.meshgrid(*vs, sparse=False, indexing="ij")
    resized = ref_gen.fast_3D_interp_torch(blurred, _t(II).float(), _t(JJ).float(), _t(KK).float(), "linear")

    # --- noise at low res (transplanted corner)
    raw_noise = np.asarray(jax.random.normal(field_key(key, "field_noise"), shape, jnp.float32))
    corner = raw_noise[: new_size[0], : new_size[1], : new_size[2]]
    resized = resized + float(ov["noise_std"]) * _t(corner)
    resized[resized < 0] = 0

    # --- resize back + /max
    back = ref_gen.myzoom_torch(resized, 1 / factors)
    back = back / torch.max(back)
    return back.numpy(), seg_t.numpy()


@pytest.mark.slow
def test_full_pipeline_exact_path_matches_torch_composed_reference():
    from fetalsyngen_tpu.generator.config import (
        BiasFieldCfg,
        GammaCfg,
        NoiseCfg,
        ResampleCfg,
    )
    from fetalsyngen_tpu.generator.pipeline import synth_sample

    cfg = _deform_cfg(True)
    import dataclasses

    cfg = dataclasses.replace(
        cfg,
        gamma=GammaCfg(prob=1.0, gamma_std=0.1),
        bias_field=BiasFieldCfg(prob=1.0, scale_min=0.02, scale_max=0.06, std_min=0.01, std_max=0.3),
        resample=ResampleCfg(prob=1.0, min_resolution=0.5, max_resolution=1.5),
        noise=NoiseCfg(prob=1.0, std_min=5.0, std_max=15.0),
    )

    from fetalsyngen_tpu.testing import phantom_seeds_and_seg

    seeds_np, seg_np = phantom_seeds_and_seg(SHAPE, seed=3)
    seeds_np = seeds_np.astype(np.int64) % 8  # compact label table
    seg_np = seg_np.astype(np.int32)

    key = jax.random.PRNGKey(1234)
    rng = np.random.default_rng(99)
    nlabels = 8
    ov = {
        "mus": (25.0 + 200.0 * rng.random(nlabels)).astype(np.float32),
        "sigmas": (5.0 + 20.0 * rng.random(nlabels)).astype(np.float32),
        "deform_apply": True,
        "flip": True,
        "rotations": (rng.uniform(-20, 20, 3) / 180 * np.pi).astype(np.float32),
        "shears": rng.uniform(-0.02, 0.02, 3).astype(np.float32),
        "scalings": (1 + rng.uniform(-0.1, 0.1, 3)).astype(np.float32),
        "nonlin_scale": np.float32(0.12),
        "nonlin_std": np.float32(3.0),
        "size_F_small": np.round(0.12 * np.array(SHAPE)).astype(np.int32),
        "gamma_apply": True,
        "gamma": np.float32(1.08),
        "bf_apply": True,
        "bf_scale": np.float32(0.05),
        "bf_std": np.float32(0.2),
        "bf_size": np.maximum(np.round(0.05 * np.array(SHAPE)), 1).astype(np.int32),
        "resample_apply": True,
        "spacing": np.asarray([1.1, 1.1, 1.1], np.float32),
        "blur_mult": np.float32(1.0),
        "noise_apply": True,
        "noise_std": np.float32(8.0),
    }

    ours_out, ours_seg, _, _ = synth_sample(
        key, jnp.asarray(seeds_np, jnp.int32), jnp.asarray(seg_np), cfg=cfg, overrides=ov
    )
    ours_out = np.asarray(ours_out)
    ours_seg = np.asarray(ours_seg)

    ref_out, ref_seg = _torch_reference_chain(key, cfg, seeds_np, seg_np, ov)

    assert ref_out.shape == ours_out.shape
    # final image is /max-normalized to [0, 1]
    diff = np.abs(ours_out - ref_out)
    assert np.mean(diff) < 1e-3, f"mean abs diff {np.mean(diff)}"
    assert np.quantile(diff, 0.999) < 1e-2, f"p99.9 diff {np.quantile(diff, 0.999)}"
    mismatch = np.mean(ours_seg != ref_seg)
    assert mismatch < 2e-3, f"seg mismatch fraction {mismatch}"


# ---------------------------------------------------------------------------
# Real anatomy: moved to tests/test_real_anatomy.py — it runs from the
# in-repo data/ fixture and must not skip with this module when the
# reference checkout (needed here for torch A/B) is absent.
# ---------------------------------------------------------------------------
