"""Public generator API: reference-parity classes over the jitted pipeline.

``FetalSynthGen`` mirrors the reference orchestrator
(``fetalsyngen/generator/model.py:27-276``): same constructor shape (driven by
the same Hydra YAML schema), same ``generate``/``augment``/``sample`` methods,
same nested genparams dicts for replay. The component classes
(``ImageFromSeeds``, ``SpatialDeformation``, ``RandResample``, ``RandBiasField``,
``RandNoise``, ``RandGamma``) keep the reference's constructor signatures but
act as config carriers: all voxel math happens in the single jitted pipeline
(:mod:`fetalsyngen_tpu.generator.pipeline`), not in per-class ``__call__``s —
that is the jit-once redesign.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Any, Iterable

import jax
import jax.numpy as jnp
import numpy as np

from ..io import nifti
from .config import (
    BiasFieldCfg,
    DeformCfg,
    GammaCfg,
    GeneratorCfg,
    IntensityCfg,
    NoiseCfg,
    ResampleCfg,
)
from .params import genparams_to_dict, overrides_from_genparams
from .pipeline import synth_sample


def _key_data(key: jax.Array) -> np.ndarray:
    """Raw uint32 words of a PRNG key (handles typed and legacy keys)."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(key))
    return np.asarray(key)


class _HostSeedCache:
    """Byte-budgeted LRU of decoded host seed volumes.

    The reference re-reads 4 seed NIfTIs from disk per sample
    (``rand_gmm.py:90-97``) — the hot IO path flagged in SURVEY §7. Caching
    the decoded arrays keeps repeated samples of the same subject from
    touching disk. Eviction is by BYTES, not entry count (one 256^3 int16
    volume is ~33 MB; an unbounded count cap could eat several GB of host
    RAM) — the same discipline as the HBM ``SeedBankCache``.
    """

    def __init__(self, max_bytes: int = 2_000_000_000, loader=None):
        self.max_bytes = int(max_bytes)
        self._loader = loader or (
            lambda p: np.ascontiguousarray(nifti.load_ras(p).data.astype(np.int16))
        )
        self._cache: collections.OrderedDict[str, np.ndarray] = collections.OrderedDict()
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, path: str) -> np.ndarray:
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        arr = self._loader(path)
        self._cache[path] = arr
        self._bytes += arr.nbytes
        while self._bytes > self.max_bytes and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._bytes -= evicted.nbytes
        return arr


_SEED_CACHE = _HostSeedCache()


def _load_seed_cached(path: str) -> np.ndarray:
    """Host-side seed volume load (RAS-oriented), byte-budget cached."""
    return _SEED_CACHE.get(path)


class ImageFromSeeds:
    """Seed loading + GMM intensity config (reference ``rand_gmm.py:9-99``)."""

    def __init__(
        self,
        min_subclusters: int,
        max_subclusters: int,
        seed_labels: Iterable[int],
        generation_classes: Iterable[int],
        meta_labels: int = 4,
    ):
        self.cfg = IntensityCfg(
            min_subclusters=min_subclusters,
            max_subclusters=max_subclusters,
            seed_labels=tuple(int(x) for x in seed_labels),
            generation_classes=tuple(int(x) for x in generation_classes),
            meta_labels=meta_labels,
        )

    def load_seeds(
        self,
        seeds: dict[int, dict[int, Path]],
        genparams: dict | None = None,
        rng: np.random.Generator | None = None,
    ) -> tuple[np.ndarray, dict]:
        """Select subcluster counts per meta-label and sum the seed volumes.

        Mirrors ``ImageFromSeeds.load_seeds`` (``rand_gmm.py:51-99``): per
        meta-label draw ``n ~ U{min..max}``, load ``seeds[n][mlabel]``,
        orient RAS, and sum.
        """
        genparams = genparams or {}
        rng = rng or np.random.default_rng()
        # restrict the draw to subclass counts actually present in the seed
        # tree (the reference crashes on a partial tree whose subclasses_{n}
        # dirs don't span min..max; drawing from the intersection keeps the
        # same distribution on full trees and degrades gracefully on partial
        # trees — including gapped ones like {1, 3} or ranges disjoint from
        # the config range)
        avail = sorted(seeds.keys())
        opts = [
            n for n in avail
            if self.cfg.min_subclusters <= n <= self.cfg.max_subclusters
        ] or avail
        if "mlabel2subclusters" in genparams:
            m2s = {int(k): int(v) for k, v in genparams["mlabel2subclusters"].items()}
        else:
            m2s = {
                ml: int(rng.choice(opts))
                for ml in range(1, self.cfg.meta_labels + 1)
            }
        total: np.ndarray | None = None
        for ml in range(1, self.cfg.meta_labels + 1):
            vol = _load_seed_cached(str(seeds[m2s[ml]][ml]))
            total = vol.copy() if total is None else total + vol
        return total, {"mlabel2subclusters": m2s}


class SpatialDeformation:
    """Config carrier (reference ``affine_nonrigid.py:12-62``)."""

    def __init__(
        self,
        max_rotation: float,
        max_shear: float,
        max_scaling: float,
        size: Iterable[int],
        prob: float,
        nonlinear_transform: bool,
        nonlin_scale_min: float,
        nonlin_scale_max: float,
        nonlin_std_max: float,
        flip_prb: float,
        device: str | None = None,
    ):
        del device  # JAX manages placement
        self.cfg = DeformCfg(
            max_rotation=max_rotation,
            max_shear=max_shear,
            max_scaling=max_scaling,
            size=tuple(int(s) for s in size),
            prob=prob,
            nonlinear_transform=nonlinear_transform,
            nonlin_scale_min=nonlin_scale_min,
            nonlin_scale_max=nonlin_scale_max,
            nonlin_std_max=nonlin_std_max,
            flip_prb=flip_prb,
        )


class RandResample:
    def __init__(self, prob: float, min_resolution: float, max_resolution: float):
        self.cfg = ResampleCfg(prob=prob, min_resolution=min_resolution, max_resolution=max_resolution)


class RandBiasField:
    def __init__(self, prob: float, scale_min: float, scale_max: float, std_min: float, std_max: float):
        self.cfg = BiasFieldCfg(
            prob=prob, scale_min=scale_min, scale_max=scale_max, std_min=std_min, std_max=std_max
        )


class RandNoise:
    def __init__(self, prob: float, std_min: float, std_max: float):
        self.cfg = NoiseCfg(prob=prob, std_min=std_min, std_max=std_max)


class RandGamma:
    def __init__(self, prob: float, gamma_std: float):
        self.cfg = GammaCfg(prob=prob, gamma_std=gamma_std)


class FetalSynthGen:
    """Reference-parity synthetic generator (``model.py:27-276``)."""

    def __init__(
        self,
        shape: Iterable[int],
        resolution: Iterable[float],
        intensity_generator: ImageFromSeeds,
        spatial_deform: SpatialDeformation,
        resampler: RandResample,
        bias_field: RandBiasField,
        noise: RandNoise,
        gamma: RandGamma,
        device: str | None = None,
        blur_cortex: Any | None = None,
        struct_noise: Any | None = None,
        simulate_motion: Any | None = None,
        boundaries: Any | None = None,
        seed: int | None = None,
    ):
        del device
        self.intensity_generator = intensity_generator
        self.cfg = GeneratorCfg(
            shape=tuple(int(s) for s in shape),
            resolution=tuple(float(r) for r in resolution),
            intensity=intensity_generator.cfg,
            deform=spatial_deform.cfg,
            resample=resampler.cfg,
            bias_field=bias_field.cfg,
            noise=noise.cfg,
            gamma=gamma.cfg,
        )
        self.artifacts = {
            "blur_cortex": blur_cortex,
            "struct_noise": struct_noise,
            "simulate_motion": simulate_motion,
            "boundaries": boundaries,
        }
        self._rng = np.random.default_rng(seed)

    def _next_key(self) -> jax.Array:
        return jax.random.PRNGKey(int(self._rng.integers(0, 2**31 - 1)))

    def _resolve_key(self, genparams: dict, key: jax.Array | None) -> jax.Array:
        if key is not None:
            return key
        if "key" in genparams:
            return jnp.asarray(np.asarray(genparams["key"], dtype=np.uint32))
        return self._next_key()

    def _prepare_intensity(self, image, seeds, genparams, key):
        """Load+select seed volumes, or fall back to image-as-intensity.

        Returns (seed_arr, selected_seeds, image_as_intensity).
        """
        if seeds is not None:
            seed_rng = np.random.default_rng(_key_data(key).tolist())
            seed_vol, selected_seeds = self.intensity_generator.load_seeds(
                seeds, genparams.get("selected_seeds", {}), rng=seed_rng
            )
            return jnp.asarray(seed_vol, jnp.int32), selected_seeds, False
        if image is None:
            raise ValueError(
                "If no seeds are passed, an image must be loaded to be used as intensity prior!"
            )
        return None, {}, True

    def _apply_artifacts(self, out, seg, genparams_artifacts: dict, key: jax.Array):
        """Run the configured SR-artifact chain (reference model.py:210-220)."""
        artifact_meta = {}
        artifact_tags = {
            "blur_cortex": 301,
            "struct_noise": 302,
            "simulate_motion": 303,
            "boundaries": 304,
        }
        for name, artifact in self.artifacts.items():
            if artifact is not None:
                akey = jax.random.fold_in(key, artifact_tags[name])
                # host-side scalar draws are keyed off the sample key so the
                # whole sample (incl. artifact gates) replays from (key, genparams)
                arng = np.random.default_rng(_key_data(akey).tolist())
                out, meta = artifact(
                    out,
                    seg,
                    genparams=genparams_artifacts.get(name, {}),
                    resolution=self.cfg.resolution,
                    key=akey,
                    rng=arng,
                )
                artifact_meta[name] = meta
        return out, artifact_meta

    def _check_shape(self, segmentation) -> None:
        """Fail fast on a volume/config shape mismatch.

        The reference adapts to the input volume's shape at runtime
        (``deformation/affine_nonrigid.py:105`` uses ``output.shape``); this
        framework compiles static-shape programs for ``cfg.shape`` by
        design, so a mismatched volume is a configuration error — raise a
        clear one instead of a reshape failure deep in the warp kernels.
        """
        got = tuple(np.asarray(segmentation).shape)
        want = tuple(self.cfg.shape)
        if got != want:
            raise ValueError(
                f"generator is configured for shape {want} but the input "
                f"volume is {got}. This framework compiles static-shape "
                "programs: set the generator config's `shape` (and "
                "`spatial_deform.size`) to the data's shape, or resample the "
                "data (scripts/resample.py)."
            )

    def generate(
        self,
        image: np.ndarray | None,
        segmentation: np.ndarray,
        seeds: dict[int, dict[int, Path]] | None,
        genparams: dict | None = None,
        key: jax.Array | None = None,
    ):
        """Intensity synthesis + spatial deformation only (reference
        ``model.py:94-159``). Returns (output, segmentation, image, params).
        """
        from .pipeline import STAGES_GENERATE

        self._check_shape(segmentation)
        genparams = dict(genparams or {})
        key = self._resolve_key(genparams, key)
        seed_arr, selected_seeds, image_as_intensity = self._prepare_intensity(
            image, seeds, genparams, key
        )
        overrides = overrides_from_genparams(genparams)
        seg_arr = jnp.asarray(np.asarray(segmentation), jnp.int32)
        img_arr = jnp.asarray(np.asarray(image), jnp.float32) if image is not None else None

        if image_as_intensity:
            lo, hi = jnp.min(img_arr), jnp.max(img_arr)
            base = (img_arr - lo) / jnp.where(hi > lo, hi - lo, 1.0) * 255.0
            out, seg, img, p = synth_sample(
                key, None, seg_arr, image=img_arr, cfg=self.cfg,
                overrides=overrides, intensity_prior=base, stages=STAGES_GENERATE,
            )
        else:
            out, seg, img, p = synth_sample(
                key, seed_arr, seg_arr, image=img_arr, cfg=self.cfg,
                overrides=overrides, stages=STAGES_GENERATE,
            )
        full = genparams_to_dict(p)
        params_out = {
            "key": _key_data(key).tolist(),
            "selected_seeds": selected_seeds,
            "seed_intensities": full["seed_intensities"],
            "deform_params": full["deform_params"],
        }
        return out, seg, img, params_out

    def augment(
        self,
        image: np.ndarray | jnp.ndarray,
        segmentation: np.ndarray | jnp.ndarray,
        genparams: dict | None = None,
        key: jax.Array | None = None,
    ):
        """Intensity augmentations + SR artifacts on a given image (reference
        ``model.py:161-229``). Returns (output, params).
        """
        from .pipeline import STAGES_AUGMENT

        self._check_shape(segmentation)
        genparams = dict(genparams or {})
        key = self._resolve_key(genparams, key)
        overrides = overrides_from_genparams(genparams)
        seg_arr = jnp.asarray(np.asarray(segmentation), jnp.int32)
        img_arr = jnp.asarray(np.asarray(image), jnp.float32)

        out, _, _, p = synth_sample(
            key, None, seg_arr, cfg=self.cfg, overrides=overrides,
            intensity_prior=img_arr, stages=STAGES_AUGMENT,
        )
        # read the same key augment writes below ("artifacts"), so replaying
        # augment's own returned dict pins the artifact draws; the legacy
        # "artifact_params" spelling is accepted for compatibility
        out, artifact_meta = self._apply_artifacts(
            out,
            seg_arr,
            genparams.get("artifacts", genparams.get("artifact_params", {})),
            key,
        )
        full = genparams_to_dict(p)
        params_out = {
            "key": _key_data(key).tolist(),
            "gamma_params": full["gamma_params"],
            "bf_params": full["bf_params"],
            "resample_params": full["resample_params"],
            "noise_params": full["noise_params"],
            "artifacts": artifact_meta,
        }
        return out, params_out

    def sample(
        self,
        image: np.ndarray | None,
        segmentation: np.ndarray,
        seeds: dict[int, dict[int, Path]] | None,
        genparams: dict | None = None,
        key: jax.Array | None = None,
    ):
        """Generate one synthetic sample (reference ``model.py:231-276``).

        Args:
            image: optional intensity prior / co-deformed volume (D,H,W).
            segmentation: (D,H,W) int label volume (RAS).
            seeds: ``{n_subclusters: {meta_label: path}}`` dict, or None to
                use ``image`` as the intensity prior.
            genparams: reference-style nested genparams dict for replay.
                A ``"key"`` entry (uint32 pair) replays voxel noise too.
            key: explicit PRNG key (overrides the internal stream).

        Returns:
            (output, segmentation, image, genparams_out) — arrays are jnp,
            genparams_out is a host dict that fully replays this sample when
            passed back (same voxel noise via the stored key).
        """
        self._check_shape(segmentation)
        genparams = dict(genparams or {})
        key = self._resolve_key(genparams, key)
        seed_arr, selected_seeds, image_as_intensity = self._prepare_intensity(
            image, seeds, genparams, key
        )
        overrides = overrides_from_genparams(genparams)
        seg_arr = jnp.asarray(np.asarray(segmentation), jnp.int32)
        img_arr = jnp.asarray(np.asarray(image), jnp.float32) if image is not None else None

        if image_as_intensity:
            # reference model.py:131-139: rescale image to [0, 255] as output
            lo, hi = jnp.min(img_arr), jnp.max(img_arr)
            base = (img_arr - lo) / jnp.where(hi > lo, hi - lo, 1.0) * 255.0
            out, seg, img, p = synth_sample(
                key, None, seg_arr, image=img_arr, cfg=self.cfg,
                overrides=overrides, intensity_prior=base,
            )
        else:
            out, seg, img, p = synth_sample(
                key, seed_arr, seg_arr, image=img_arr, cfg=self.cfg, overrides=overrides
            )

        # SR artifacts (optional; applied post-augmentation like model.py:210-220)
        out, artifact_meta = self._apply_artifacts(
            out, seg, genparams.get("artifacts", {}), key
        )

        params_out = {
            "key": _key_data(key).tolist(),
            "selected_seeds": selected_seeds,
            **genparams_to_dict(p),
            "artifacts": artifact_meta,
        }
        return out, seg, img, params_out
