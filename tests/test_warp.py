"""Separable warp correctness: identity exactness + equivalence vs exact trilinear."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fetalsyngen_tpu.ops.affine import make_affine_matrix
from fetalsyngen_tpu.ops.interp import nearest_interp, trilinear_interp
from fetalsyngen_tpu.ops.warp import (
    hat_pass,
    warp_affine_separable,
    warp_displacement_separable,
)

RNG = np.random.default_rng(5)
SHAPE = (40, 40, 40)


def smooth_volume(shape=SHAPE, seed=0):
    """Band-limited random volume (so interpolation differences are small)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.normal(size=shape), 2.0).astype(np.float32)


def exact_affine_warp(vol, M, t, nearest=False):
    """Clamped (edge-replicating) exact warp — the boundary behavior of the
    separable passes; scipy map_coordinates(mode='nearest') implements it."""
    from scipy.ndimage import map_coordinates

    D, H, W = vol.shape
    i, j, k = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
    x = M[0, 0] * i + M[0, 1] * j + M[0, 2] * k + t[0]
    y = M[1, 0] * i + M[1, 1] * j + M[1, 2] * k + t[1]
    z = M[2, 0] * i + M[2, 1] * j + M[2, 2] * k + t[2]
    order = 0 if nearest else 1
    return map_coordinates(
        vol.astype(np.float64), np.stack([x, y, z]), order=order, mode="nearest"
    ).astype(np.float32)


class TestHatPass:
    def test_linear_pass_with_disp(self):
        """hat_pass(unit slope + disp) == clamped 1-D lerp along last axis."""
        vol = RNG.normal(size=(4, 6, 32)).astype(np.float32)
        disp = RNG.uniform(-5, 5, size=(4, 6, 32)).astype(np.float32)
        got = np.asarray(
            hat_pass(jnp.asarray(vol), (0.0, 0.0, 1.0, 0.0), jnp.asarray(disp), (4, 6, 32), False)
        )
        k = np.arange(32)[None, None, :]
        c = np.clip(k + disp, 0, 31)
        f = np.clip(np.floor(c), 0, 30).astype(int)
        w = c - f
        want = np.take_along_axis(vol, f, 2) * (1 - w) + np.take_along_axis(vol, f + 1, 2) * w
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_affine_pass_scale(self):
        """hat_pass with non-unit slope == clamped lerp at scaled coords."""
        vol = RNG.normal(size=(4, 4, 24)).astype(np.float32)
        got = np.asarray(
            hat_pass(jnp.asarray(vol), (0.0, 0.0, 1.1, -2.0), None, (4, 4, 24), False)
        )
        k = np.arange(24, dtype=np.float64)
        c = np.clip(1.1 * k - 2.0, 0, 23)
        f = np.clip(np.floor(c), 0, 22).astype(int)
        w = (c - f)[None, None, :]
        want = np.take(vol, f, 2) * (1 - w) + np.take(vol, f + 1, 2) * w
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestAffineSeparable:
    def test_identity_exact(self):
        vol = RNG.normal(size=SHAPE).astype(np.float32)
        out = np.asarray(
            warp_affine_separable(jnp.asarray(vol), jnp.eye(3), jnp.zeros(3))
        )
        np.testing.assert_allclose(out, vol, rtol=1e-5, atol=1e-5)

    def test_pure_translation_exact(self):
        """Integer translation: every pass lands on grid points -> exact."""
        vol = RNG.normal(size=SHAPE).astype(np.float32)
        t = np.array([3.0, -2.0, 5.0])
        out = np.asarray(warp_affine_separable(jnp.asarray(vol), jnp.eye(3), jnp.asarray(t)))
        want = exact_affine_warp(vol, np.eye(3), t)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)

    @staticmethod
    def interior_mask(M, t, shape, margin=2.0):
        """Voxels whose composite sample position is strictly interior
        (boundary clamp semantics legitimately differ between resamplers;
        the pipeline zeroes OOB voxels via the composite mask anyway)."""
        D, H, W = shape
        i, j, k = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
        x = M[0, 0] * i + M[0, 1] * j + M[0, 2] * k + t[0]
        y = M[1, 0] * i + M[1, 1] * j + M[1, 2] * k + t[1]
        z = M[2, 0] * i + M[2, 1] * j + M[2, 2] * k + t[2]
        return (
            (x > margin) & (x < D - 1 - margin)
            & (y > margin) & (y < H - 1 - margin)
            & (z > margin) & (z < W - 1 - margin)
        )

    def test_rotation_close_to_trilinear(self):
        """Sheared-trilinear kernel tracks trilinear on smooth data.

        The multi-pass kernel smooths slightly more than one trilinear tap, so
        pointwise agreement tightens as the data gets smoother; on
        sigma=3-smoothed noise the interior agreement must be high.
        """
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(11)
        vol = gaussian_filter(rng.normal(size=SHAPE), 3.0).astype(np.float32)
        rot = np.array([0.2, -0.15, 0.1])
        A = np.asarray(make_affine_matrix(rot, np.zeros(3), np.ones(3)))
        c = (np.array(SHAPE) - 1) / 2
        t = c - A @ c
        got = np.asarray(warp_affine_separable(jnp.asarray(vol), jnp.asarray(A), jnp.asarray(t)))
        want = exact_affine_warp(vol, A, t)
        mask = self.interior_mask(A, t, SHAPE)
        g, w = got[mask], want[mask]
        corr = np.corrcoef(g, w)[0, 1]
        assert corr > 0.97, corr
        scale = np.abs(w).max()
        assert np.abs(g - w).mean() / scale < 0.025

    def test_nearest_labels_mostly_equal(self):
        labels = RNG.integers(0, 8, size=SHAPE).astype(np.int32)
        from scipy.ndimage import grey_dilation

        # make labels spatially coherent
        labels = grey_dilation(labels, size=(5, 5, 5)).astype(np.float32)
        rot = np.array([0.15, 0.1, -0.1])
        A = np.asarray(make_affine_matrix(rot, np.zeros(3), np.ones(3)))
        c = (np.array(SHAPE) - 1) / 2
        t = c - A @ c
        got = np.asarray(
            warp_affine_separable(jnp.asarray(labels), jnp.asarray(A), jnp.asarray(t), nearest=True)
        )
        want = exact_affine_warp(labels, A, t, nearest=True)
        sl = (slice(3, -3),) * 3
        agreement = (got[sl] == want[sl]).mean()
        assert agreement > 0.93, agreement


class TestDisplacementSeparable:
    def test_zero_displacement_identity(self):
        vol = RNG.normal(size=SHAPE).astype(np.float32)
        z = jnp.zeros(SHAPE, jnp.float32)
        out = np.asarray(warp_displacement_separable(jnp.asarray(vol), z, z, z))
        np.testing.assert_allclose(out, vol, rtol=1e-5, atol=1e-5)

    def test_smooth_field_close_to_exact(self):
        from scipy.ndimage import gaussian_filter

        vol = smooth_volume(seed=1)
        rng = np.random.default_rng(2)
        d = [
            gaussian_filter(rng.normal(size=SHAPE), 6.0).astype(np.float32) * 18
            for _ in range(3)
        ]
        got = np.asarray(
            warp_displacement_separable(jnp.asarray(vol), *(jnp.asarray(x) for x in d))
        )
        D, H, W = SHAPE
        i, j, k = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
        x = np.clip(i + d[0], 0, D - 1)
        y = np.clip(j + d[1], 0, H - 1)
        z = np.clip(k + d[2], 0, W - 1)
        want = np.asarray(
            trilinear_interp(jnp.asarray(vol), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
        )
        sl = (slice(4, -4),) * 3
        err = np.abs(got[sl] - want[sl])
        scale = np.abs(want[sl]).max()
        assert err.max() / scale < 0.06, err.max() / scale
        assert (err / scale).mean() < 0.005


class TestPipelineWarpEquivalence:
    def test_separable_vs_exact_pipeline(self):
        """Full deform stage: separable output stays close to exact trilinear."""
        from dataclasses import replace

        from fetalsyngen_tpu.generator.config import DeformCfg, GeneratorCfg, IntensityCfg
        from fetalsyngen_tpu.generator.params import sample_params
        from fetalsyngen_tpu.generator.pipeline import deform_stage

        shape = (32, 32, 32)
        labels = tuple([0] + list(range(10, 50)))
        gcls = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
        base = GeneratorCfg(
            shape=shape,
            intensity=IntensityCfg(1, 6, labels, gcls),
            deform=DeformCfg(size=shape, warp_impl="separable"),
        )
        exact = replace(base, deform=replace(base.deform, warp_impl="exact"))

        vol = jnp.asarray(smooth_volume(shape, seed=3) * 100 + 100)
        seg = jnp.asarray((smooth_volume(shape, seed=4) > 0).astype(np.int32))
        key = jax.random.PRNGKey(0)
        p = sample_params(key, base, {"deform_apply": True, "flip": False})

        o1, s1, _ = deform_stage(key, p, base, vol, seg, None)
        o2, s2, _ = deform_stage(key, p, exact, vol, seg, None)
        o1, o2 = np.asarray(o1), np.asarray(o2)
        mask = (o1 != 0) & (np.asarray(o2) != 0)
        rel = np.abs(o1 - o2)[mask] / np.abs(o2[mask]).max()
        assert rel.mean() < 0.02, rel.mean()
        # binary labels from thresholded noise are a worst case (boundary
        # voxels everywhere at 32^3); anatomical labels agree far higher —
        # see TestAffineSeparable.test_nearest_labels_mostly_equal.
        agree = (np.asarray(s1) == np.asarray(s2)).mean()
        assert agree > 0.85, agree


class TestZoomFirstRigid:
    """warp_rigid_zoom_first vs the ANALYTIC map ``V[A q + t]``.

    A linear field makes every chain of linear interpolations exact wherever
    no tap clamps, so the zoom-first path must track the analytic value
    closely on the interior. (The zoom-LAST pair warp is the wrong yardstick
    here: for downsampling maps whose output FOV exceeds the input cube its
    shear intermediates clip rotated corners — the very effect the
    zoom-first ordering exists to avoid; measured error ~1.0 vs ~0.06 on
    the same map.)"""

    CUBE, S = 64, 48

    def _setup(self, seed, scale, rotate=True):
        from scipy.spatial.transform import Rotation

        from fetalsyngen_tpu.ops.warp import decompose_affine_paeth_host

        rng = np.random.default_rng(seed)
        R = Rotation.random(random_state=rng).as_matrix() if rotate else np.eye(3)
        A = scale * R
        c_in, c_out = (self.CUBE - 1) / 2.0, (self.S - 1) / 2.0
        t = c_in - A @ np.full(3, c_out) + rng.uniform(-2, 2, 3)
        return A, t, decompose_affine_paeth_host(A, t, self.CUBE)

    def _linear_case(self, seed, scale, rotate, tol):
        from fetalsyngen_tpu.ops.warp import warp_rigid_zoom_first

        cube, S = self.CUBE, self.S
        i, j, k = np.meshgrid(*[np.arange(cube)] * 3, indexing="ij")
        lin = (0.3 * i + 0.5 * j - 0.2 * k + 7.0).astype(np.float32)
        A, t, (q_idx, ang, s, dlt) = self._setup(seed, scale, rotate)
        got = np.asarray(
            warp_rigid_zoom_first(
                jnp.asarray(lin), q_idx, jnp.asarray(ang), jnp.float32(s),
                jnp.asarray(dlt), out_size=S,
            )
        )
        qq = np.stack(
            np.meshgrid(*[np.arange(S)] * 3, indexing="ij"), 0
        ).astype(np.float64)
        coords = np.einsum("ij,jabc->iabc", A, qq) + t[:, None, None, None]
        gt = 0.3 * coords[0] + 0.5 * coords[1] - 0.2 * coords[2] + 7.0
        sl = slice(8, S - 8)
        inb = ((coords > 1) & (coords < cube - 2)).all(0)[sl, sl, sl]
        err = np.abs((got[sl, sl, sl] - gt[sl, sl, sl]) * inb).max()
        assert err < tol, err

    @pytest.mark.parametrize("seed,scale", [(0, 1.4), (1, 1.25), (2, 1.9)])
    def test_linear_field_rotated(self, seed, scale):
        # residual shear clamping at the small-frame corners bounds the
        # interior error at ~0.06 on a field spanning ~[-40, 40]
        self._linear_case(seed, scale, rotate=True, tol=0.15)

    @pytest.mark.parametrize("scale", [1.3, 1.8])
    def test_linear_field_pure_zoom_exact(self, scale):
        # no rotation -> no shear clamping anywhere -> exact to float eps
        self._linear_case(5, scale, rotate=False, tol=1e-3)

    def test_outperm_matches_default(self):
        from fetalsyngen_tpu.ops.warp import warp_rigid_zoom_first

        vol = smooth_volume((self.CUBE,) * 3, seed=3)
        _, _, (q_idx, ang, s, dlt) = self._setup(4, 1.5)
        base = np.asarray(
            warp_rigid_zoom_first(
                jnp.asarray(vol), q_idx, jnp.asarray(ang), jnp.float32(s),
                jnp.asarray(dlt), out_size=self.S,
            )
        )
        perm = np.asarray(
            warp_rigid_zoom_first(
                jnp.asarray(vol), q_idx, jnp.asarray(ang), jnp.float32(s),
                jnp.asarray(dlt), out_size=self.S, out_perm=(1, 2, 0),
            )
        )
        np.testing.assert_allclose(perm, np.transpose(base, (1, 2, 0)), atol=1e-5)
