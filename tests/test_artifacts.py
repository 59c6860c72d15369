"""Artifact engine tests: transforms algebra, noise fields, morphology, scanner."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fetalsyngen_tpu.generator.artifacts.scanner as sc
from fetalsyngen_tpu.generator.artifacts.motion import sample_motion
from fetalsyngen_tpu.generator.artifacts.psf import get_psf, resolution2sigma
from fetalsyngen_tpu.generator.artifacts.quality import (
    BlurCortex,
    ReconMergeParams,
    SimulatedBoundaries,
    StructNoise,
    StructNoiseMergeParams,
    masked_random_centers,
)
from fetalsyngen_tpu.generator.artifacts.transforms import (
    RigidTransform,
    axisangle2mat,
    interleave_index,
    mat2axisangle,
    random_init_stack_transforms,
    reset_transform,
)
from fetalsyngen_tpu.ops.morphology import ball_dilate, box_sum, dilate, erode
from fetalsyngen_tpu.ops.noise import fractal_noise_3d, mog_3d, perlin_noise_3d

RNG = np.random.default_rng(0)


class TestTransforms:
    def test_axisangle_roundtrip(self):
        ax = np.concatenate([RNG.normal(0, 1, (10, 3)), RNG.normal(0, 5, (10, 3))], -1).astype(
            np.float32
        )
        back = mat2axisangle(axisangle2mat(ax))
        np.testing.assert_allclose(back, ax, rtol=1e-4, atol=1e-4)

    def test_compose_inv_identity(self):
        ax = np.concatenate([RNG.normal(0, 1, (5, 3)), RNG.normal(0, 5, (5, 3))], -1).astype(
            np.float32
        )
        t = RigidTransform(ax)
        ident = t.compose(t.inv()).matrix()
        for m in ident:
            np.testing.assert_allclose(m[:, :3], np.eye(3), atol=1e-5)
            np.testing.assert_allclose(m[:, 3], 0, atol=1e-4)

    def test_compose_matches_reference_convention(self):
        """trans-first composition: x -> R1 R2 (x + t2 + R2^T t1)."""
        a = RigidTransform(np.array([[0.1, 0.2, -0.1, 1.0, 2.0, 3.0]], np.float32))
        b = RigidTransform(np.array([[-0.2, 0.05, 0.3, -1.0, 0.5, 2.0]], np.float32))
        x = RNG.normal(0, 10, (1, 3)).astype(np.float32)
        m_ab = a.compose(b).matrix()[0]
        ma, mb = a.matrix()[0], b.matrix()[0]
        # apply b then a: y = Ra ((Rb (x + tb)) + ta)
        y1 = ma[:, :3] @ (mb[:, :3] @ (x[0] + mb[:, 3]) + ma[:, 3])
        y2 = m_ab[:, :3] @ (x[0] + m_ab[:, 3])
        np.testing.assert_allclose(y1, y2, rtol=1e-4, atol=1e-4)

    def test_stack_transforms(self):
        rng = np.random.default_rng(3)
        t = random_init_stack_transforms(10, 2.0, False, 3.0, rng)
        ax = t.axisangle()
        assert ax.shape == (10, 6)
        np.testing.assert_allclose(np.diff(ax[:, 5]), 2.0, atol=1e-5)  # gap spacing
        r = reset_transform(t)
        assert np.allclose(r.axisangle()[:, :5], 0)

    def test_interleave(self):
        assert interleave_index(6, 2) == [0, 3, 1, 4, 2, 5]

    def test_motion_trajectories(self):
        rng = np.random.default_rng(1)
        ts = np.arange(20) * 1.5
        m = sample_motion(ts, rng)
        mats = m.matrix()
        assert mats.shape == (20, 3, 4)
        # first time point is the identity (re-referenced)
        np.testing.assert_allclose(mats[0, :, :3], np.eye(3), atol=1e-5)
        np.testing.assert_allclose(mats[0, :, 3], 0, atol=1e-5)
        # rotations are valid (orthonormal)
        for m3 in mats[:5, :, :3]:
            np.testing.assert_allclose(m3 @ m3.T, np.eye(3), atol=1e-4)


class TestPSF:
    def test_psf_matches_reference_shape_rules(self):
        psf = get_psf(res_ratio=(1.5, 1.5, 3.0))
        assert psf.ndim == 3
        np.testing.assert_allclose(psf.sum(), 1.0, rtol=1e-5)
        # symmetric, centered peak
        assert psf[tuple(s // 2 for s in psf.shape)] == psf.max()

    def test_sigma_constants(self):
        sx, sy, sz = resolution2sigma((1.0, 1.0, 3.0))
        assert sz == pytest.approx(3.0 / (2 * np.sqrt(2 * np.log(2))))
        assert sx == pytest.approx(1.2067091288 * 1.0 / (2 * np.sqrt(2 * np.log(2))))


class TestNoise:
    def test_perlin_shape_range(self):
        n = np.asarray(perlin_noise_3d(jax.random.PRNGKey(0), (32, 32, 32), (2, 2, 2)))
        assert n.shape == (32, 32, 32)
        assert np.isfinite(n).all()
        assert abs(n.mean()) < 0.2  # zero-mean-ish
        assert 0.05 < n.std() < 0.6

    def test_fractal_normalized(self):
        n = np.asarray(
            fractal_noise_3d(jax.random.PRNGKey(1), (32, 32, 32), (1, 1, 1), octaves=2)
        )
        assert n.min() >= 0 and n.max() <= 1 and n.max() > 0.9

    @pytest.mark.parametrize(
        "shape,res", [((32, 32, 32), (2, 2, 2)), ((64, 32, 16), (4, 2, 1))]
    )
    def test_perlin_matches_corner_blend_spec(self, shape, res):
        """The separable-matmul Perlin == the naive 8-corner fade blend.

        Spec below is the textbook corner form (reference ``utils.py:224-327``
        semantics: wrapped lattice, fade weights, gradient dot products); the
        production path evaluates the algebraically-factored per-axis matmul
        chain (``ops/noise._perlin_axis_mats``)."""

        def fade(t):
            return t * t * t * (t * (t * 6 - 15) + 10)

        cells = tuple(s // r for s, r in zip(shape, res))
        k1, k2 = jax.random.split(jax.random.PRNGKey(17))
        theta = 2 * np.pi * np.asarray(jax.random.uniform(k1, res))
        phi = 2 * np.pi * np.asarray(jax.random.uniform(k2, res))
        g = np.stack(
            [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)]
        )
        loc = [(np.arange(shape[d]) % cells[d]) / cells[d] for d in range(3)]
        d0, d1, d2 = np.ix_(loc[0], loc[1], loc[2])
        t0, t1, t2 = fade(d0), fade(d1), fade(d2)
        i0 = [np.arange(shape[d]) // cells[d] for d in range(3)]

        def corner(a, b, c):
            gi = [
                gc[np.ix_((i0[0] + a) % res[0], (i0[1] + b) % res[1], (i0[2] + c) % res[2])]
                for gc in g
            ]
            return gi[0] * (d0 - a) + gi[1] * (d1 - b) + gi[2] * (d2 - c)

        n = 0.0
        for a in (0, 1):
            wa = (1 - t0) if a == 0 else t0
            for b in (0, 1):
                wb = (1 - t1) if b == 0 else t1
                for c in (0, 1):
                    wc = (1 - t2) if c == 0 else t2
                    n = n + wa * wb * wc * corner(a, b, c)
        got = np.asarray(perlin_noise_3d(jax.random.PRNGKey(17), shape, res))
        np.testing.assert_allclose(got, n, atol=2e-5)

    def test_fast_samplers_match_laws(self):
        """gamma_int / poisson_icdf / beta_int follow the target laws
        (moment checks against closed forms at n=20000)."""
        from fetalsyngen_tpu.ops.rand import beta_int, gamma_int, poisson_icdf

        n = 20000
        g = np.asarray(gamma_int(jax.random.PRNGKey(0), 3, (n,)))
        assert abs(g.mean() - 3.0) < 0.05 and abs(g.var() - 3.0) < 0.2
        p = np.asarray(poisson_icdf(jax.random.PRNGKey(1), 100.0, (n,), kmax=224))
        assert abs(p.mean() - 100.0) < 0.35 and abs(p.var() - 100.0) < 5.0
        p8 = np.asarray(poisson_icdf(jax.random.PRNGKey(2), 8.0, (n,), kmax=64))
        assert abs(p8.mean() - 8.0) < 0.1 and abs(p8.var() - 8.0) < 0.5
        b = np.asarray(beta_int(jax.random.PRNGKey(3), 2, 5, (n,)))
        # Beta(2,5): mean 2/7, var ab/((a+b)^2 (a+b+1)) = 10/392
        assert abs(b.mean() - 2 / 7) < 0.01
        assert abs(b.var() - 10 / 392) < 0.003
        assert b.min() >= 0 and b.max() <= 1

    def test_topk_flat_matches_exact(self):
        """Blocked two-stage top-k == exact lax.top_k on a realistic
        cortex-shell mask (foreground spans many flat blocks)."""
        from fetalsyngen_tpu.generator.artifacts.quality import topk_flat

        n = 128 * 128 * 128  # > 4096 * 256 -> blocked path
        rng = np.random.default_rng(0)
        # shell-like sparse foreground across the volume's middle band
        fg = np.zeros(n, bool)
        fg[rng.choice(n // 2, 60_000, replace=False) + n // 4] = True
        scores = jnp.where(
            jnp.asarray(fg), jax.random.uniform(jax.random.PRNGKey(3), (n,)), -jnp.inf
        )
        v_e, i_e = jax.lax.top_k(scores, 200)
        v_b, i_b = topk_flat(scores, 200)
        np.testing.assert_array_equal(np.asarray(i_e), np.asarray(i_b))
        np.testing.assert_array_equal(np.asarray(v_e), np.asarray(v_b))

    def test_mog_matches_manual(self):
        centers = jnp.asarray([[8.0, 8.0, 8.0], [2.0, 12.0, 4.0]])
        sigmas = jnp.asarray([[3.0, 3.0, 3.0], [2.0, 2.0, 2.0]])
        got = np.asarray(mog_3d((16, 16, 16), centers, sigmas))
        i, j, k = np.meshgrid(*[np.arange(16.0)] * 3, indexing="ij")
        want = np.zeros((16, 16, 16))
        for c, s in zip(np.asarray(centers), np.asarray(sigmas)):
            want += np.exp(
                -(((i - c[0]) / s[0]) ** 2 + ((j - c[1]) / s[1]) ** 2 + ((k - c[2]) / s[2]) ** 2)
                / 2
            )
        np.testing.assert_allclose(got, np.clip(want, 0, 1), rtol=1e-4, atol=1e-5)


class TestMorphology:
    def test_erode_dilate_match_scipy(self):
        from scipy.ndimage import binary_dilation, binary_erosion

        mask = (RNG.random((24, 24, 24)) > 0.7).astype(np.int32)
        cube = np.ones((3, 3, 3), bool)
        got_d = np.asarray(dilate(jnp.asarray(mask), 3))
        want_d = binary_dilation(mask, cube).astype(np.int32)
        np.testing.assert_array_equal(got_d, want_d)
        got_e = np.asarray(erode(jnp.asarray(mask), 3))
        want_e = binary_erosion(mask, cube).astype(np.int32)
        np.testing.assert_array_equal(got_e, want_e)

    def test_ball_dilate_matches_scipy(self):
        from scipy.ndimage import binary_dilation

        mask = np.zeros((24, 24, 24), np.int32)
        mask[12, 12, 12] = 1
        mask[5, 6, 7] = 1
        r = 4
        x, y, z = np.ogrid[-r : r + 1, -r : r + 1, -r : r + 1]
        ball = (x**2 + y**2 + z**2) <= r * r
        got = np.asarray(ball_dilate(jnp.asarray(mask), r))
        want = binary_dilation(mask, ball).astype(np.int32)
        np.testing.assert_array_equal(got, want)

    def test_box_sum(self):
        x = RNG.random((10, 10, 10)).astype(np.float32)
        got = np.asarray(box_sum(jnp.asarray(x), 3))
        from scipy.ndimage import uniform_filter

        want = uniform_filter(x, 3, mode="constant") * 27
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestCenters:
    def test_masked_random_centers(self):
        mask = jnp.zeros((16, 16, 16), jnp.int32).at[4:8, 4:8, 4:8].set(1)
        centers, valid = masked_random_centers(jax.random.PRNGKey(0), mask, 10, 6)
        centers, valid = np.asarray(centers), np.asarray(valid)
        assert valid.sum() == 6
        for c in centers[valid]:
            assert (c >= 4).all() and (c < 8).all()


# Small static scanner grids for CPU tests — threaded as explicit parameters
# (tiers / ns_grid), never by mutating module globals.
T_CUBE = 64
T_NSG = 32


class TestResolutionSampling:
    """The scanner's (res_slice, res_recon, thickness, gap) marginals must
    match the reference laws (``simulate_reco.py:163-191``)."""

    # default.yaml scanner params (configs/dataset/generator/default.yaml:95+)
    DEFAULT_SP = dict(
        resolution_slice_fac_min=0.5, resolution_slice_fac_max=2.0,
        resolution_slice_max=1.5, slice_thickness_min=1.5, slice_thickness_max=3.5,
        gap_min=1.5, gap_max=5.5, min_num_stack=2, max_num_stack=6,
        max_num_slices=250, noise_sigma_min=0.0, noise_sigma_max=0.1,
        TR_min=1.0, TR_max=2.0, prob_void=0.2, prob_gamma=0.1, gamma_std=0.05,
    )

    def test_marginals_match_reference_laws(self):
        sp = sc.ScannerParams(**self.DEFAULT_SP)
        scn = sc.Scanner(sp)
        res = 0.5
        rng = np.random.default_rng(0)
        draws = [scn.get_resolution({"resolution": res}, rng) for _ in range(4000)]

        # draw-for-draw equality with the reference formula sequence
        ref = np.random.default_rng(0)
        for d in draws:
            res_s = ref.uniform(
                sp.resolution_slice_fac_min * res,
                min(sp.resolution_slice_fac_max * res, sp.resolution_slice_max),
            )
            res_r = res + ref.uniform(0.0, 1.0) * (res_s - res)  # == U(res, res_s)
            thick = ref.uniform(sp.slice_thickness_min, sp.slice_thickness_max)
            gap = ref.uniform(sp.gap_min, sp.gap_max)
            assert d["resolution_slice"] == pytest.approx(res_s)
            assert d["resolution_recon"] == pytest.approx(res_r)
            assert d["slice_thickness"] == pytest.approx(thick)
            assert d["gap"] == pytest.approx(gap)

        # marginal ranges: res_slice spans BELOW the volume resolution
        # (default config: U(0.25, 1.0) at res = 0.5), res_recon sits between
        # res and res_slice per draw
        rss = np.array([d["resolution_slice"] for d in draws])
        rrs = np.array([d["resolution_recon"] for d in draws])
        assert rss.min() < res < rss.max()
        assert rss.min() == pytest.approx(0.25, abs=0.01)
        assert rss.max() == pytest.approx(1.0, abs=0.01)
        lo, hi = np.minimum(res, rss), np.maximum(res, rss)
        assert ((rrs >= lo - 1e-12) & (rrs <= hi + 1e-12)).all()
        assert (rrs != res).any()  # recon resolution actually randomized

    def test_configured_resolution_recon_pins(self):
        """``params.resolution_recon`` set -> no draw (simulate_reco.py:174-175);
        the reference's SimulateMotion pins it this way (artifacts.py:402)."""
        sp = sc.ScannerParams(**self.DEFAULT_SP, resolution_recon=0.5)
        d = sc.Scanner(sp).get_resolution({"resolution": 0.5}, np.random.default_rng(1))
        assert d["resolution_recon"] == 0.5

    def test_genparams_pins(self):
        """Pins are honored under both our key and the reference's
        ``resolution_slice_fac`` spelling (simulate_reco.py:163-170 uses the
        value directly as the slice resolution), without desynchronizing
        later draws."""
        sp = sc.ScannerParams(**self.DEFAULT_SP)
        scn = sc.Scanner(sp)
        base = scn.get_resolution({"resolution": 0.5}, np.random.default_rng(3))
        for pin_key in ("resolution_slice", "resolution_slice_fac"):
            d = scn.get_resolution(
                {"resolution": 0.5}, np.random.default_rng(3), {pin_key: 0.33}
            )
            assert d["resolution_slice"] == 0.33
            assert d["slice_thickness"] == base["slice_thickness"]
            assert d["gap"] == base["gap"]
            # recon draw rescaled onto the pinned interval
            assert 0.33 <= d["resolution_recon"] <= 0.5

    def test_slice_grid_tiers(self):
        """Tier selection covers the reference's dynamic slice FOV
        (simulate_reco.py:349-354) and honors ``slice_size``."""
        shape = (256, 256, 256)
        assert sc.slice_grid(shape, 1.0) == 384
        assert sc.slice_grid(shape, 2.0) == 384
        assert sc.slice_grid(shape, 0.7) == 512
        assert sc.slice_grid(shape, 0.5) == 640
        assert sc.slice_grid(shape, 0.3) == 640  # capped at the largest tier
        assert sc.slice_grid(shape, 1.0, slice_size=500) == 512
        assert sc.slice_grid((64, 64, 64), 1.0, tiers=(64, 96)) == 96

    @pytest.mark.slow
    def test_scan_below_volume_resolution(self):
        """A full motion sim with res_slice < res (rs = 0.7) runs through the
        larger tier and reconstructs sanely."""
        from scipy.ndimage import gaussian_filter

        from fetalsyngen_tpu.testing import phantom_seeds_and_seg

        shape = (64, 64, 64)
        _, seg = phantom_seeds_and_seg(shape, seed=1)
        out = gaussian_filter(
            (seg > 0).astype(np.float32) * 100 + (seg > 2) * 80, 1.5
        ).astype(np.float32)
        sm = sc.SimulateMotion(
            prob=1.0,
            tiers=(64, 96),
            ns_grid=T_NSG,
            scanner_params=sc.ScannerParams(
                0.5, 1.5, 2.0, 1.0, 1.5, 1.0, 1.5, 1, 2, 200, 0, 0.0, 1, 1,
                0.0, 0.0, 0.05, None, False, 0.0,
            ),
            recon_params=sc.ReconParams(
                0.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.1, 0.4, 0.0,
                ReconMergeParams(
                    "perlin", perlin_res_list=[1], perlin_octaves_list=[1],
                    perlin_persistence=0.5, perlin_lacunarity=2,
                    perlin_increase_size=0.25,
                ),
            ),
        )
        pins = {"resolution_slice": 0.35, "slice_thickness": 1.5, "gap": 1.0}
        o, meta = sm(
            out, seg.astype(np.int32), genparams=pins, resolution=(0.5, 0.5, 0.5),
            rng=np.random.default_rng(5), key=jax.random.PRNGKey(5),
        )
        assert meta["resolution_slice"] == 0.35
        assert sc.slice_grid(shape, 0.7, tiers=(64, 96)) == 96  # the tier it ran on
        o = np.asarray(o)
        assert np.isfinite(o).all()
        c = np.corrcoef(o[8:56, 8:56, 8:56].ravel(), out[8:56, 8:56, 8:56].ravel())[0, 1]
        assert c > 0.85, c


@pytest.mark.slow
class TestScanner:
    def test_motion_sim_runs_and_reconstructs(self):
        from scipy.ndimage import gaussian_filter

        from fetalsyngen_tpu.testing import phantom_seeds_and_seg

        shape = (64, 64, 64)
        _, seg = phantom_seeds_and_seg(shape, seed=1)
        out = gaussian_filter((seg > 0).astype(np.float32) * 100 + (seg > 2) * 80, 1.5).astype(
            np.float32
        )
        sm = sc.SimulateMotion(
            prob=1.0,
            tiers=(T_CUBE,),
            ns_grid=T_NSG,
            scanner_params=sc.ScannerParams(
                1.0, 1.5, 2.0, 1.0, 1.5, 1.0, 1.5, 1, 2, 200, 0, 0.0, 1, 1, 0.0, 0.0, 0.05,
                None, False, 0.0,
            ),
            recon_params=sc.ReconParams(
                0.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.1, 0.4, 0.0,
                ReconMergeParams(
                    "perlin", perlin_res_list=[1], perlin_octaves_list=[1],
                    perlin_persistence=0.5, perlin_lacunarity=2, perlin_increase_size=0.25,
                ),
            ),
        )
        # pin the acquisition geometry (dense sampling: gap < thickness) so
        # the quality bar below is about the engine, not the draw
        pins = {"resolution_slice": 0.5, "slice_thickness": 1.5, "gap": 1.0}
        o, meta = sm(out, seg.astype(np.int32), genparams=pins,
                     resolution=(0.5, 0.5, 0.5),
                     rng=np.random.default_rng(1), key=jax.random.PRNGKey(1))
        o = np.asarray(o)
        assert np.isfinite(o).all()
        c = np.corrcoef(o[8:56, 8:56, 8:56].ravel(), out[8:56, 8:56, 8:56].ravel())[0, 1]
        assert c > 0.9, c
        assert meta["nstacks"] >= 1

        # dict-alone replay: fresh call with ONLY the metadata (no rng/key)
        # must reproduce the exact volume (the rng_key contract); a pinned
        # scalar is honored without desynchronizing later draws.
        o2, meta2 = sm(out, seg.astype(np.int32), genparams=meta, resolution=(0.5, 0.5, 0.5))
        np.testing.assert_allclose(np.asarray(o2), o, rtol=1e-5, atol=1e-5)
        assert meta2["resolution_slice"] == meta["resolution_slice"]
        o3, meta3 = sm(
            out, seg.astype(np.int32),
            genparams={**meta, "slice_thickness": meta["slice_thickness"] * 1.3},
            resolution=(0.5, 0.5, 0.5),
        )
        assert meta3["slice_thickness"] == pytest.approx(meta["slice_thickness"] * 1.3)
        assert meta3["gap"] == meta["gap"]  # later draws unaffected by the pin
        assert not np.allclose(np.asarray(o3), o)


@pytest.mark.slow
class TestSliceAcqParity:
    """Voxel-level A/B of the dense acquisition/adjoint vs the reference's
    executable spec — the sparse-COO CPU fallback of ``slice_acq_cuda``
    (reference ``slice_acq.py:272-430, 499-546``), reimplemented in NumPy
    (``np_reference.psf_slice_acquisition_ref`` / ``psf_slice_adjoint_ref``).

    The spec ROUNDS footprint coordinates where our engine interpolates, so
    agreement is tolerance-bounded, not bitwise (the reference CPU/CUDA pair
    differs by the same class of error)."""

    @pytest.fixture(scope="class")
    def stack_ab(self):
        from scipy.ndimage import gaussian_filter

        from fetalsyngen_tpu.generator.artifacts.motion import sample_motion
        from fetalsyngen_tpu.generator.artifacts.transforms import (
            random_init_stack_transforms,
        )

        rng = np.random.default_rng(7)
        shape = (48, 48, 48)
        base = np.zeros(shape, np.float32)
        base[10:38, 12:36, 11:37] = 100.0
        vol = gaussian_filter(
            base + rng.normal(0, 5, shape).astype(np.float32) * (base > 0), 1.0
        ).astype(np.float32)
        mask = (vol > 5).astype(np.float32)

        res, res_s, thick, gap = 0.5, 0.6, 1.5, 1.2
        rs, gap_vox = res_s / res, gap / res
        ns = min(int(max(shape) * res / gap) + 2, T_NSG)
        t_init = random_init_stack_transforms(ns, gap, False, 3.0, rng)
        t_target = sample_motion(np.arange(ns) * 1.0, rng).compose(t_init)
        mats_vox = t_target.matrix(True).copy()
        mats_vox[:, :, 3] /= res

        geo = sc._stack_geometry(t_init.matrix(True)[0, :, :3], mats_vox, shape, ns, T_CUBE, T_NSG)
        z0 = float((T_CUBE - 1) / 2.0 - (ns - 1) / 2.0 * gap_vox)
        sig = jnp.asarray(
            [sc.GAUSSIAN_FWHM * thick / res, sc.SINC_FWHM * rs, sc.SINC_FWHM * rs],
            jnp.float32,
        )
        q_idx, w_ang, w_scl, w_dlt = geo["fwd"]
        slices, valid = sc._acquire_stack(
            jnp.asarray(vol), jnp.asarray(mask),
            jnp.int32(q_idx), jnp.asarray(w_ang), jnp.float32(w_scl), jnp.asarray(w_dlt),
            jnp.asarray(geo["G"]), jnp.float32(rs), jnp.float32(gap_vox), jnp.float32(z0),
            sig, jnp.float32(0.15), jnp.int32(ns),
            jax.random.PRNGKey(0), jnp.float32(1.0), jnp.asarray(False), jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(0.1), cube=T_CUBE, ns_grid=T_NSG,
        )
        return dict(
            vol=vol, shape=shape, ns=ns, rs=rs, gap_vox=gap_vox, z0=z0,
            thick=thick, res=res, mats_vox=mats_vox, geo=geo,
            slices=np.asarray(slices), valid=np.asarray(valid) > 0,
            slices_dev=slices,
        )

    def test_forward_matches_reference_spec(self, stack_ab):
        from fetalsyngen_tpu.generator.artifacts.psf import get_psf
        from np_reference import psf_slice_acquisition_ref

        s = stack_ab
        psf = get_psf(res_ratio=(s["rs"], s["rs"], s["thick"] / s["res"]))
        ref = psf_slice_acquisition_ref(
            s["mats_vox"][: s["ns"]], s["vol"], psf, (T_CUBE, T_CUBE), s["rs"]
        )
        corrs, rels = [], []
        for n in range(s["ns"]):
            if not s["valid"][n]:
                continue
            r, o = ref[n], s["slices"][n]
            m = r > r.max() * 0.05
            if m.sum() < 50:
                continue
            corrs.append(np.corrcoef(o[m].ravel(), r[m].ravel())[0, 1])
            rels.append(np.abs(o[m] - r[m]).mean() / (np.abs(r[m]).mean() + 1e-9))
        assert len(corrs) >= 10
        assert min(corrs) > 0.98, min(corrs)
        assert np.median(rels) < 0.08, np.median(rels)
        assert max(rels) < 0.2, max(rels)

    def test_adjoint_matches_reference_spec(self, stack_ab):
        from fetalsyngen_tpu.generator.artifacts.psf import get_psf
        from np_reference import psf_slice_adjoint_ref

        s = stack_ab
        geo = s["geo"]
        sig_rec = jnp.asarray(
            [sc.GAUSSIAN_FWHM * s["thick"] / s["res"], sc.SINC_FWHM * s["rs"]], jnp.float32
        )
        i_q, i_ang, i_scl, i_dlt = sc.decompose_affine_paeth_host(
            geo["Minv"], -geo["Minv"] @ geo["t_stack"], T_CUBE
        )
        v_s, w_s = sc._recon_stack(
            s["slices_dev"], jnp.asarray(s["valid"].astype(np.float32)),
            jnp.asarray(geo["G"]), jnp.float32(s["rs"]), jnp.float32(s["gap_vox"]),
            jnp.float32(s["z0"]), sig_rec,
            jnp.int32(i_q), jnp.asarray(i_ang), jnp.float32(i_scl), jnp.asarray(i_dlt),
            cube=T_CUBE, ns_grid=T_NSG, out_shape=s["shape"],
        )
        ours_v, ours_w = np.asarray(v_s), np.asarray(w_s)
        recon_ours = np.where(ours_w > 1e-2, ours_v / np.where(ours_w > 1e-2, ours_w, 1), 0)

        psf_rec = get_psf(res_ratio=(s["rs"], s["rs"], s["thick"] / s["res"]))
        ref_in = s["slices"][: s["ns"]] * s["valid"][: s["ns"], None, None]
        ref_vol, ref_w = psf_slice_adjoint_ref(
            s["mats_vox"][: s["ns"]], psf_rec, ref_in, s["shape"], s["rs"], equalize=True
        )
        m = (ref_w > 0.5) & (ours_w > 0.5)
        assert m.sum() > 5000
        c = np.corrcoef(recon_ours[m].ravel(), ref_vol[m].ravel())[0, 1]
        rel = np.abs(recon_ours[m] - ref_vol[m]).mean() / (np.abs(ref_vol[m]).mean() + 1e-9)
        assert c > 0.97, c
        assert rel < 0.15, rel


@pytest.mark.slow
class TestQualityArtifacts:
    def test_blur_cortex(self):
        from fetalsyngen_tpu.testing import phantom_seeds_and_seg

        _, seg = phantom_seeds_and_seg((64, 64, 64), seed=1)
        out = np.abs(RNG.normal(100, 30, (64, 64, 64))).astype(np.float32)
        bc = BlurCortex(prob=1.0, cortex_label=2, nblur_min=5, nblur_max=20)
        o, m = bc(out, seg.astype(np.int32), rng=np.random.default_rng(2), key=jax.random.PRNGKey(2))
        assert np.isfinite(np.asarray(o)).all() and m["nblur"] is not None
        assert not np.allclose(np.asarray(o), out)

    def test_blur_cortex_sigma_untruncated(self):
        """The blur-sigma draw is the reference's unclipped gamma(2, 1)
        (artifacts.py:104): P(sigma > 3) ~ 0.20 per axis, so the old
        np.clip(std, 0, 3) altered ~a fifth of draws. Checks the draw
        distribution (KS vs the gamma CDF) and that the blur operator
        actually supports tail sigmas (half_len covers sigma ~ 8)."""
        from scipy import stats
        from scipy.ndimage import gaussian_filter1d

        from fetalsyngen_tpu.ops.linops import toeplitz_blur_matrix

        bc = BlurCortex(prob=1.0, cortex_label=2, nblur_min=3, nblur_max=6)
        from fetalsyngen_tpu.testing import phantom_seeds_and_seg

        _, seg = phantom_seeds_and_seg((32, 32, 32), seed=1)
        out = np.abs(RNG.normal(100, 30, (32, 32, 32))).astype(np.float32)
        stds = []
        for i in range(60):
            _, m = bc(out, seg.astype(np.int32), rng=np.random.default_rng(1000 + i),
                      key=jax.random.PRNGKey(i))
            stds.extend(m["std_blurs"])
        stds = np.array(stds)
        assert stds.max() > 3.0  # the clip is gone (P(all<3) ~ 3e-15)
        assert stats.kstest(stds, stats.gamma(a=2, scale=1).cdf).pvalue > 0.01

        # operator supports the tail: sigma = 8 row matches scipy
        M = np.asarray(toeplitz_blur_matrix(jnp.float32(8.0), 128, 25))
        delta = np.zeros(128, np.float32)
        delta[64] = 1.0
        want = gaussian_filter1d(delta, 8.0, truncate=3.0)
        got = M @ delta
        np.testing.assert_allclose(got, want / want.sum() * got.sum(), atol=2e-3)

    def test_boundaries_mask_zeroes_background(self):
        from fetalsyngen_tpu.testing import phantom_seeds_and_seg

        _, seg = phantom_seeds_and_seg((64, 64, 64), seed=1)
        out = np.abs(RNG.normal(100, 30, (64, 64, 64))).astype(np.float32)
        sb = SimulatedBoundaries(0.0, 0.0, 0.0)
        o, m = sb(out, seg.astype(np.int32), rng=np.random.default_rng(3), key=jax.random.PRNGKey(3))
        o = np.asarray(o)
        assert o[0, 0, 0] == 0.0  # background masked
        inner = np.asarray(seg) > 0
        np.testing.assert_allclose(o[inner], out[inner], rtol=1e-6)
