"""SR-quality artifact transforms: BlurCortex, StructNoise, SimulatedBoundaries.

Reference parity with ``fetalsyngen/generator/augmentation/artifacts.py``:
per-call scalar randomness is drawn host-side (NumPy Generator — matching the
reference's np.random usage), voxel fields run jitted on device. Each class is
callable as ``artifact(output, seg, genparams=..., resolution=..., key=...,
rng=...)`` and returns ``(output, metadata)`` like the reference.

Design notes: center picking from masks (``torch.multinomial`` /
``randperm`` over ``torch.where`` results, reference ``artifacts.py:110-113,
514-517, 565-567``) is replaced by weighted reservoir-style top-k over masked
random keys — fixed-shape, fully on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.linops import gaussian_blur_mm
from ...ops.morphology import ball_dilate, box_sum, dilate, erode
from ...ops.noise import fractal_noise_3d, mog_3d


# --------------------------------------------------------------------------
# config dataclasses (schema parity with reference artifacts/utils.py:41-78)
# --------------------------------------------------------------------------

@dataclass
class StructNoiseMergeParams:
    merge_type: str
    gauss_nloc_min: int | None = None
    gauss_nloc_max: int | None = None
    gauss_sigma_mu: float | None = None
    gauss_sigma_std: float | None = None
    perlin_res_list: list | None = None
    perlin_octaves_list: list | None = None
    perlin_persistence: float | None = None
    perlin_lacunarity: int | None = None
    perlin_increase_size: float | None = None


@dataclass
class ReconMergeParams:
    merge_type: str
    gauss_ngaussians_min: int | None = None
    gauss_ngaussians_max: int | None = None
    perlin_res_list: list | None = None
    perlin_octaves_list: list | None = None
    perlin_persistence: float | None = None
    perlin_lacunarity: int | None = None
    perlin_increase_size: float | None = None


def topk_flat(scores, k: int, block_k: int = 8):
    """Top-k over a flat volume-scale score vector via a per-block prefilter.

    A two-stage form — top-``block_k`` within each of 4096 contiguous
    blocks, then an exact top-k over the 32k survivors — gives IDENTICAL
    output to ``lax.top_k`` unless more than ``block_k`` of the k winners share one block.
    For the random/Gumbel scores used here the winners are uniform over the
    foreground's blocks (any mask spanning >~100 of the 4096 blocks puts the
    collision probability below 1e-5; ``tests/test_artifacts.py``
    ``test_topk_flat_matches_exact`` pins equality on a realistic mask).
    ``approx_max_k`` is NOT equivalent: its per-bin top-1 collapses small
    contiguous regions to fewer centers than requested.
    """
    n = scores.shape[0]
    R = 4096
    if n % R or n // R < 256:  # tiny inputs (tests): exact path
        return jax.lax.top_k(scores, k)
    v_b, i_b = jax.lax.top_k(scores.reshape(R, n // R), block_k)
    base = jnp.arange(R, dtype=jnp.int32)[:, None] * (n // R)
    flat_idx = (base + i_b).reshape(-1)
    v, i = jax.lax.top_k(v_b.reshape(-1), k)
    return v, jnp.take(flat_idx, i)


def masked_random_centers(key, mask, n_max, n_valid):
    """Pick up to ``n_max`` random voxel coordinates inside ``mask``.

    Fixed-shape replacement for ``multinomial``/``randperm``-over-``where``:
    top-k over random keys masked to the foreground (see :func:`topk_flat`).
    Returns (centers (n_max, 3) float32, valid (n_max,) bool).
    """
    shape = mask.shape
    flat = mask.reshape(-1) > 0
    scores = jnp.where(flat, jax.random.uniform(key, flat.shape), -1.0)
    _, idx = topk_flat(scores, n_max)
    picked_valid = jnp.take(flat, idx)
    k_iota = jnp.arange(n_max) < n_valid
    valid = picked_valid & k_iota
    i = idx // (shape[1] * shape[2])
    rem = idx % (shape[1] * shape[2])
    j = rem // shape[2]
    k = rem % shape[2]
    centers = jnp.stack([i, j, k], -1).astype(jnp.float32)
    return centers, valid


# --------------------------------------------------------------------------
# BlurCortex (reference artifacts.py:24-133)
# --------------------------------------------------------------------------

class BlurCortex:
    """Local cortex blurring (imprecise-reconstruction look)."""

    MAX_BLUR = 200

    def __init__(
        self,
        prob: float,
        cortex_label: int,
        nblur_min: int,
        nblur_max: int,
        sigma_gamma_loc: float = 3,
        sigma_gamma_scale: float = 1,
        std_blur_shape: float = 2,
        std_blur_scale: float = 1,
    ):
        self.prob = prob
        self.cortex_label = cortex_label
        self.nblur_min = nblur_min
        self.nblur_max = nblur_max
        self.sigma_gamma_loc = sigma_gamma_loc
        self.sigma_gamma_scale = sigma_gamma_scale
        self.std_blur_shape = std_blur_shape
        self.std_blur_scale = std_blur_scale

    @staticmethod
    @partial(jax.jit, static_argnames=("nmax",))
    def _apply(key, output, seg, cortex_label, nblur, std_blurs, sigmas, nmax):
        shape = output.shape
        cortex = (seg == cortex_label).astype(jnp.float32)
        # frontal-lobe bias (blur_proba, artifacts.py:64-81): MoG of two
        # frontal anchors modulates the center-sampling probability.
        x, y, z = shape
        prob_field = mog_3d(
            shape,
            jnp.array([[0.0, y, z / 2.0], [x, y, z / 2.0]], jnp.float32),
            jnp.array([[x / 5.0] * 3, [y / 5.0] * 3], jnp.float32),
        )
        # weighted sampling: keys ~ U^(1/w) trick for weighted top-k
        w = jnp.where(cortex.reshape(-1) > 0, prob_field.reshape(-1), 0.0)
        u = jax.random.uniform(key, w.shape, minval=1e-7)
        scores = jnp.where(w > 0, jnp.log(u) / jnp.maximum(w, 1e-8), -jnp.inf)
        _, idx = topk_flat(scores, nmax)
        valid = (jnp.arange(nmax) < nblur) & jnp.isfinite(jnp.take(scores, idx))
        i = idx // (shape[1] * shape[2])
        rem = idx % (shape[1] * shape[2])
        centers = jnp.stack([i, rem // shape[2], rem % shape[2]], -1).astype(jnp.float32)

        gaussian = mog_3d(shape, centers, sigmas, valid)
        # Toeplitz matmuls. half_len = 25 covers 3 sigma of the
        # unclipped gamma(2, 1) draw out to sigma ~ 8.3 (P ~ 2e-3); the band
        # width does not change the matmul cost.
        blurred = gaussian_blur_mm(output, std_blurs, 25)
        return output * (1 - gaussian) + blurred * gaussian

    def __call__(self, output, seg, genparams=None, rng=None, key=None, **kw):
        genparams = {k: v for k, v in (genparams or {}).items() if v is not None}  # _validated_genparams parity (reference model.py:85-92)
        rng = rng or np.random.default_rng()
        if rng.random() < self.prob or len(genparams) > 0:
            # draw-then-override: pinned genparams must not skip rng draws,
            # or the host stream desynchronizes for later values
            nblur = int(rng.integers(self.nblur_min, self.nblur_max))
            _pin = genparams.get("nblur")
            nblur = int(_pin) if _pin is not None else nblur
            # unclipped gamma draw, matching the reference
            # (np.random.gamma(2, 1, 3), artifacts.py:104); the blur
            # operator's half-length covers the practical gamma tail
            std_blurs = rng.gamma(self.std_blur_shape, self.std_blur_scale, 3)
            sigmas = rng.gamma(self.sigma_gamma_loc, self.sigma_gamma_scale, (self.MAX_BLUR, 3))
            key = key if key is not None else jax.random.PRNGKey(int(rng.integers(2**31)))
            out = self._apply(
                key,
                jnp.asarray(output, jnp.float32),
                jnp.asarray(seg),
                jnp.int32(self.cortex_label),
                jnp.int32(nblur),
                jnp.asarray(std_blurs, jnp.float32),
                jnp.asarray(np.maximum(sigmas, 1e-2), jnp.float32),
                nmax=self.MAX_BLUR,
            )
            return out, {"nblur": nblur, "std_blurs": std_blurs.tolist()}
        return output, {"nblur": None}


# --------------------------------------------------------------------------
# StructNoise (reference artifacts.py:136-342)
# --------------------------------------------------------------------------

class StructNoise:
    """Spatially-varying multi-scale noise in the white matter."""

    MAX_LOC = 20

    def __init__(
        self,
        prob: float,
        wm_label: int,
        std_min: float,
        std_max: float,
        merge_params: StructNoiseMergeParams,
        nstages_min: int = 1,
        nstages_max: int = 5,
    ):
        self.prob = prob
        self.wm_label = wm_label
        self.std_min = std_min
        self.std_max = std_max
        self.nstages_min = nstages_min
        self.nstages_max = nstages_max
        self.merge_params = merge_params

    @staticmethod
    @partial(jax.jit, static_argnames=("shape", "nmax"))
    def _multiscale_noise(key, shape, nstages, nmax):
        """Pyramid noise (artifacts.py:308-322): accumulate randn at doubling
        scales with trilinear upsampling (align_corners=False equivalent:
        myzoom-style zoom).

        ``nstages`` is TRACED (randomized per sample): the pyramid always
        spans ``nmax`` (static) doublings and stages outside the last
        ``nstages`` are gated off — one compiled program serves every draw.
        """
        from ...ops.linops import zoom_mm

        cur_shape = tuple(max(s // 2**nmax, 1) for s in shape)
        noise = jnp.zeros(cur_shape, jnp.float32)
        for k in range(nmax):
            gate = ((nmax - k) <= nstages).astype(jnp.float32)
            noise = noise + gate * jax.random.normal(
                jax.random.fold_in(key, k), cur_shape
            )
            next_shape = tuple(max(s // 2 ** (nmax - 1 - k), 1) for s in shape)
            factor = jnp.array(
                [n / c for n, c in zip(next_shape, cur_shape)], jnp.float32
            )
            noise = zoom_mm(noise, next_shape, factor)
            cur_shape = next_shape
        return noise / jnp.max(jnp.abs(noise))

    def __call__(self, output, seg, genparams=None, rng=None, key=None, **kw):
        genparams = {k: v for k, v in (genparams or {}).items() if v is not None}  # _validated_genparams parity (reference model.py:85-92)
        rng = rng or np.random.default_rng()
        if rng.random() < self.prob or "nloc" in genparams or "nstages" in genparams:
            # draw-then-override (see BlurCortex)
            nstages = int(rng.integers(self.nstages_min, self.nstages_max))
            _pin = genparams.get("nstages")
            nstages = int(_pin) if _pin is not None else nstages
            noise_std = self.std_min + (self.std_max - self.std_min) * rng.random()
            key = key if key is not None else jax.random.PRNGKey(int(rng.integers(2**31)))
            output = jnp.asarray(output, jnp.float32)
            seg = jnp.asarray(seg)

            noise = self._multiscale_noise(
                jax.random.fold_in(key, 1), output.shape, jnp.int32(nstages),
                self.nstages_max,
            )
            noisy = jnp.clip(output + noise_std * noise, 0, output.max() * 2)

            meta = {"nstages": nstages, "noise_std": noise_std}
            mp = self.merge_params
            if mp.merge_type == "perlin":
                # draw-then-override: the draws must happen even when pinned
                # or the host stream desynchronizes for later values
                res = int(rng.choice(mp.perlin_res_list))
                octave = int(rng.choice(mp.perlin_octaves_list))
                # tolerate explicit None pins (treated as "not pinned")
                _pin_res = genparams.get("res")
                _pin_oct = genparams.get("octave")
                res = int(_pin_res) if _pin_res is not None else res
                octave = int(_pin_oct) if _pin_oct is not None else octave
                weight = fractal_noise_3d(
                    jax.random.fold_in(key, 2),
                    output.shape,
                    (res, res, res),
                    octaves=jnp.int32(octave),
                    persistence=mp.perlin_persistence,
                    lacunarity=mp.perlin_lacunarity,
                    increase=mp.perlin_increase_size,
                    max_octaves=int(max(mp.perlin_octaves_list)),
                )
                meta.update({"res": res, "octave": octave})
            else:  # gaussian
                # draw-then-override (see perlin branch)
                nloc = int(rng.integers(mp.gauss_nloc_min, mp.gauss_nloc_max))
                _pin = genparams.get("nloc")
                nloc = int(_pin) if _pin is not None else nloc
                wm = (seg == self.wm_label).astype(jnp.int32)
                centers, valid = masked_random_centers(
                    jax.random.fold_in(key, 3), wm, self.MAX_LOC, nloc
                )
                sigmas = np.clip(
                    mp.gauss_sigma_mu + mp.gauss_sigma_std * rng.standard_normal((self.MAX_LOC, 1)),
                    1,
                    40,
                )
                weight = mog_3d(output.shape, centers, jnp.asarray(sigmas, jnp.float32), valid)
                meta["nloc"] = nloc

            mask = (seg > 0).astype(jnp.float32)
            output = (1 - mask * weight) * output + mask * weight * noisy
            return output, meta
        return output, {}


# --------------------------------------------------------------------------
# SimulatedBoundaries (reference artifacts.py:428-604)
# --------------------------------------------------------------------------

class SimulatedBoundaries:
    """No-mask / halo / fuzzy-boundary masking of the skull-stripped volume."""

    MAX_CENTERS = 160
    MAX_DILATE = 24

    def __init__(self, prob_no_mask: float, prob_if_mask_halo: float, prob_if_mask_fuzzy: float):
        self.prob_no_mask = prob_no_mask
        self.prob_halo = prob_if_mask_halo
        self.prob_fuzzy = prob_if_mask_fuzzy

    @staticmethod
    @jax.jit
    def _fuzzy_once(key, mask):
        """One fuzzy-boundary round (artifacts.py:501-522): random 90% of the
        dilation shell dropped, neighbor-count filtered, then closing."""
        shell = (dilate(mask, 7) - mask).astype(jnp.int32)
        keep = jax.random.uniform(key, mask.shape) < 0.1  # keep 10% of shell
        shell = shell * keep
        dsamp = (box_sum(shell.astype(jnp.float32), 3) > 3).astype(jnp.int32)
        return erode(dilate(jnp.clip(mask + dsamp, 0, 1), 5), 5)

    def __call__(self, output, seg, genparams=None, rng=None, key=None, **kw):
        genparams = {k: v for k, v in (genparams or {}).items() if v is not None}  # _validated_genparams parity (reference model.py:85-92)
        rng = rng or np.random.default_rng()
        key = key if key is not None else jax.random.PRNGKey(int(rng.integers(2**31)))
        seg = jnp.asarray(seg)
        output = jnp.asarray(output, jnp.float32)
        mask = (seg > 0).astype(jnp.int32)

        no_mask_on = bool(rng.random() < self.prob_no_mask)
        halo_on = fuzzy_on = None
        meta = {"no_mask_on": no_mask_on, "halo_on": None, "fuzzy_on": None}
        if no_mask_on:
            return output, meta

        halo_on = bool(rng.random() < self.prob_halo)
        fuzzy_on = bool(rng.random() < self.prob_fuzzy)
        meta.update({"halo_on": halo_on, "fuzzy_on": fuzzy_on})

        if halo_on:
            mask = ball_dilate(mask, int(rng.integers(5, 15)))

        if fuzzy_on:
            n_generate_fuzzy = int(rng.integers(2, 5))
            n_centers = min(int(rng.poisson(100)), self.MAX_CENTERS)
            base_sigma = max(int(rng.poisson(8)), 1)

            mask_modif = mask
            for r in range(n_generate_fuzzy):
                mask_modif = self._fuzzy_once(jax.random.fold_in(key, 10 + r), mask_modif)

            added = ((mask_modif - mask) > 0).astype(jnp.int32)
            centers, valid = masked_random_centers(
                jax.random.fold_in(key, 20), added, self.MAX_CENTERS, n_centers
            )
            sigmas = base_sigma + 10 * rng.beta(2, 5, (self.MAX_CENTERS, 1))
            mog = mog_3d(mask.shape, centers, jnp.asarray(sigmas, jnp.float32), valid)
            surf_proba = jnp.where(added > 0, mog, 0.0)

            # dilation stack intersected with the fuzzy mask (artifacts.py:582-602)
            n_dilate = min(6 * (n_generate_fuzzy - 1), self.MAX_DILATE)
            levels = jnp.clip(
                jnp.round(surf_proba * (n_dilate + 2) - 1).astype(jnp.int32), 0, None
            )
            # cumulative halo index: voxel kept if its dilation level >= required
            cur = mask
            reach = jnp.where(mask > 0, 0, self.MAX_DILATE + 10)
            for i in range(n_dilate):
                cur = ball_dilate(cur, 1) if i >= 2 else cur
                reach = jnp.where((reach > i) & (cur > 0), i, reach)
            # voxel included if the dilation step that reaches it <= its level
            mask = ((reach <= levels) & (mask_modif > 0)).astype(jnp.int32) | mask

        return output * mask, meta
