"""Hat passes (``ops.warp.hat_pass`` / ``hat_pass_pair``) vs the NumPy
reference ``testing.hat_pass_reference``.

Driven with LARGE global shears (|pos - lane| ~ 100 voxels) and every
position form the warp and scanner use: scalar coefficients, per-slice
coefficient tables, a displacement volume and a per-lane affine
displacement table, in both interpolation modes and under the bf16 storage
scope. Positions are float32 on both sides; linear outputs agree to float
contraction, nearest outputs up to rare round-half flips.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import fetalsyngen_tpu.ops.warp as W
from fetalsyngen_tpu.testing import hat_pass_reference

# D=128 rows drive the large row term; W=256 lanes
SHAPE = (128, 32, 256)


def _vol(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random(shape, np.float32))


def _smooth_disp(scale, seed=1, out_len=SHAPE[2]):
    from scipy.ndimage import zoom as ndzoom

    rng = np.random.default_rng(seed)
    coarse = rng.normal(0, scale, (8, 4, 8))
    fac = (SHAPE[0] / 8, SHAPE[1] / 4, out_len / 8)
    return jnp.asarray(np.clip(ndzoom(coarse, fac, order=1), -14, 14).astype(np.float32))


def _check(out, vol, coefs, disp, shape, nearest, out_len=None, atol=5e-5):
    ref = hat_pass_reference(vol, coefs, disp, shape, nearest, out_len=out_len)
    out = np.asarray(out, np.float32)
    assert out.shape == ref.shape
    if nearest:
        # ties at pos == k + 0.5 may round either way under contraction
        assert np.mean(out == ref) > 0.999
    else:
        np.testing.assert_allclose(out, ref, atol=atol)


# Coefficient sets covering the failure classes of a windowed resampler:
#   - big POSITIVE / NEGATIVE global row shear (|pos - lane| up to ~115)
#   - the same with a resized output axis (out_len != W)
#   - a non-unit lane slope with a large offset
CASES = [
    ("pos-shear", (0.9, 0.1, 1.0, 0.0), None),
    ("neg-shear", (-0.9, -0.1, 1.0, 0.0), None),
    ("pos-shear-resized", (0.9, 0.1, 1.3, 0.0), 192),
    ("neg-shear-resized", (-0.9, -0.1, 0.8, 40.0), 320),
    ("scaled-lane", (0.5, 0.05, 1.1, -20.0), None),
]


@pytest.mark.parametrize("name,coefs,out_len", CASES)
def test_hat_pass_matches_reference_at_large_shear(name, coefs, out_len):
    v = _vol()
    disp = _smooth_disp(4.0, out_len=out_len or SHAPE[2])
    out = W.hat_pass(v, coefs, disp, SHAPE, False, out_len=out_len)
    _check(out, v, coefs, disp, SHAPE, False, out_len=out_len)


@pytest.mark.parametrize("ck", [1.0, 1.1])
@pytest.mark.parametrize("modes", [(False, True), (False, False)])
def test_hat_pair_matches_reference_at_large_shear(modes, ck):
    va, vb = _vol(2), _vol(3)
    disp = _smooth_disp(4.0, seed=4)
    coefs = (0.8, 0.05, ck, 5.0)
    oa, ob = W.hat_pass_pair(va, vb, coefs, disp, SHAPE, modes=modes)
    _check(oa, va, coefs, disp, SHAPE, modes[0])
    _check(ob, vb, coefs, disp, SHAPE, modes[1])


def test_hat_pass_nearest_large_shear():
    v = _vol(5)
    coefs = (0.9, 0.0, 1.0, -40.0)
    out = W.hat_pass(v, coefs, None, SHAPE, True)
    _check(out, v, coefs, None, SHAPE, True)


def test_hat_pass_bf16_storage_io():
    """Under the stream storage scope the pass reads/writes bf16 while the
    position and lerp math stay f32 — values track the f32 reference to
    bf16 rounding (~0.4% rel)."""
    from fetalsyngen_tpu.ops.linops import storage_scope

    v = _vol(7)
    disp = _smooth_disp(4.0, seed=8)
    coefs = (0.6, 0.05, 1.0, 2.0)
    ref = hat_pass_reference(v, coefs, disp, SHAPE, False)
    with storage_scope(jnp.bfloat16):
        got = W.hat_pass(v, coefs, disp, SHAPE, False)
        oa, ob = W.hat_pass_pair(v, _vol(9), coefs, disp, SHAPE, modes=(False, False))
    assert got.dtype == jnp.bfloat16
    assert oa.dtype == jnp.bfloat16 and ob.dtype == jnp.bfloat16
    for o in (got, oa):
        np.testing.assert_allclose(np.asarray(o, np.float32), ref, atol=2e-2, rtol=2e-2)


# Per-slice (D, 4) coefficient tables: the scanner's dv/du deviation passes.
SHAPE_PS = (16, 128, 256)


@pytest.mark.parametrize("pair", [False, True])
def test_hat_pass_per_slice_coefs(pair):
    rng = np.random.default_rng(11)
    v = _vol(11, SHAPE_PS)
    tab = np.stack(
        [
            np.zeros(16),
            rng.uniform(-0.3, 0.3, 16),
            rng.uniform(0.8, 1.2, 16),
            rng.uniform(-30, 30, 16),
        ],
        -1,
    ).astype(np.float32)
    if pair:
        vb = _vol(12, SHAPE_PS)
        oa, ob = W.hat_pass_pair(v, vb, jnp.asarray(tab), None, SHAPE_PS)
        _check(oa, v, tab, None, SHAPE_PS, False)
        _check(ob, vb, tab, None, SHAPE_PS, True)
    else:
        out = W.hat_pass(v, jnp.asarray(tab), None, SHAPE_PS, False)
        _check(out, v, tab, None, SHAPE_PS, False)


def test_hat_pass_lane_affine_with_saturated_lanes():
    """A (3, W) per-lane affine displacement (the scanner's dz pass) where a
    band of lanes saturates at the low edge for every row."""
    shape = (4, 64, 256)
    rng = np.random.default_rng(21)
    v = _vol(21, shape)
    A = np.zeros((3, 256), np.float32)
    A[0] = rng.uniform(-0.01, 0.01, 256)
    A[1] = rng.uniform(-0.01, 0.01, 256)
    A[2, :200] = rng.uniform(-10, 10, 200)
    A[2, 200:] = -300.0  # lanes 200.. fully saturate low
    out = W.hat_pass(v, (0.0, 0.0, 1.0, 0.0), jnp.asarray(A), shape, False)
    _check(out, v, (0.0, 0.0, 1.0, 0.0), A, shape, False)
    np.testing.assert_array_equal(
        np.asarray(out)[..., 200:], np.broadcast_to(np.asarray(v)[..., :1], (4, 64, 56))
    )


def test_hat_pair_displacement_volume():
    """(linear, nearest) pair with a rough per-voxel displacement volume
    (the deform field passes, clipped to +-FIELD_LIM)."""
    shape = (16, 128, 256)
    rng = np.random.default_rng(15)
    va, vb = _vol(13, shape), _vol(14, shape)
    disp = np.clip(rng.normal(0, 4.0, shape), -W.FIELD_LIM, W.FIELD_LIM).astype(np.float32)
    coefs = (0.1, 0.05, 1.0, 5.0)
    oa, ob = W.hat_pass_pair(va, vb, coefs, jnp.asarray(disp), shape, modes=(False, True))
    _check(oa, va, coefs, disp, shape, False)
    _check(ob, vb, coefs, disp, shape, True)
