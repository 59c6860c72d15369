"""High-throughput input pipeline: device-resident seed banks + prefetch.

SURVEY §7 hard-part #5: the reference re-reads 4 seed NIfTIs from disk per
sample inside forked DataLoader workers (``rand_gmm.py:90-97``,
``test_dl.py:17-23``) — host IO can starve the device. This pipeline:

1. **Device seed banks.** All (n_subclusters, meta_label) seed variants of a
   subject are decoded once, stacked into an int8 array
   ``(n_options, 4, D, H, W)``, and cached in HBM. Per-sample seed
   composition (pick a subcluster count per meta-label and SUM the four
   volumes — ``load_seeds``) becomes a jitted device op, so drawing a new
   sample needs zero host IO.
2. **Async prefetch.** Batches are generated one step ahead of consumption
   (``prefetch``), so generation overlaps the consumer (training step).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..generator.config import GeneratorCfg
from ..generator.pipeline import _synth_core
from ..io import nifti


def _production_scopes():
    """The stream's bf16 production scopes, env-gated for perf attribution
    and emergency rollback (``FSG_STREAM_BF16=0`` -> plain f32 contract)."""
    if os.environ.get("FSG_STREAM_BF16", "1") == "0":
        return contextlib.nullcontext()
    from ..ops.linops import precision_scope, storage_scope

    stack = contextlib.ExitStack()
    stack.enter_context(precision_scope(jax.lax.Precision.DEFAULT))
    stack.enter_context(storage_scope(jnp.bfloat16))
    return stack


@partial(jax.jit, static_argnames=())
def compose_seeds(bank: jnp.ndarray, choices: jnp.ndarray) -> jnp.ndarray:
    """Sum per-meta-label seed variants chosen from the bank (device-side
    equivalent of ``ImageFromSeeds.load_seeds``).

    Gather FIRST (int8, 4 volumes), widen after: upcasting the whole bank
    before the gather would read/write n_options x 4 volumes at 4 bytes
    instead of the 4 chosen ones at 1 byte.

    Args:
        bank: (n_options, 4, D, H, W) int8 — all subcluster variants.
        choices: (4,) int32 — variant index per meta-label (0-based).

    Returns:
        (D, H, W) int32 summed seed volume.
    """
    picked = jnp.take_along_axis(bank, choices[:, None, None, None][None], axis=0)[0]
    return picked.astype(jnp.int32).sum(axis=0)


class SeedBankCache:
    """Host->HBM seed bank LRU cache keyed by subject name.

    Eviction is by a BYTE budget, not a subject count: a full bank is
    ``n_options * 4 * D*H*W`` int8 (~400 MB for 6 options at 256^3), and
    the device also holds the pipeline buffers — a count-based cap could
    silently eat several GB of device memory.
    """

    def __init__(self, seed_paths: dict, max_bytes: int = 1_200_000_000):
        self.seed_paths = seed_paths
        self.max_bytes = max_bytes
        self._cache: collections.OrderedDict[str, jnp.ndarray] = collections.OrderedDict()
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def options(self, name: str) -> list[int]:
        return sorted(self.seed_paths[name].keys())

    def _load_all(self, name: str) -> np.ndarray:
        """Decode every (option, meta-label) seed volume for one subject.

        The hot path uses the native C++ batch loader (zlib + pthread pool,
        ``io/native``) with RAS reorientation applied host-side; falls back to
        the pure-Python reader when the native library is unavailable.
        """
        from ..io import native

        per_sub = self.seed_paths[name]
        opts = self.options(name)
        paths = [str(per_sub[n][m]) for n in opts for m in range(1, 5)]
        shape = None
        arrs = None
        if native.available():
            probe = nifti.load(paths[0])
            raw = native.load_labels_batch(paths, probe.data.shape)
            if raw is not None:
                arrs = [
                    nifti.to_ras(a, probe.affine)[0].astype(np.int8) for a in raw
                ]
        if arrs is None:
            arrs = [nifti.load_ras(p).data.astype(np.int8) for p in paths]
        n_m = 4
        return np.stack(
            [np.stack(arrs[i * n_m : (i + 1) * n_m]) for i in range(len(opts))]
        )

    def bank(self, name: str) -> jnp.ndarray:
        if name in self._cache:
            self._cache.move_to_end(name)
            return self._cache[name]
        vols = self._load_all(name)
        arr = jnp.asarray(vols)
        self._cache[name] = arr
        self._bytes += vols.nbytes
        while self._bytes > self.max_bytes and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._bytes -= evicted.size  # int8: 1 byte/elem
        return arr


@partial(jax.jit, static_argnames=("lo", "hi", "B", "cfg"))
def _gen_batch(sub, bank, seg, lo, hi, B, cfg):
    """One fused device program: draw per-sample keys + subcluster choices,
    compose seeds from the bank, run the batched pipeline, scale to [0,1].

    The synth core runs in the stream's bf16 production mode (default-
    precision matmuls + bf16 intermediate storage; outputs rescaled in f32) —
    see ``linops.storage_scope`` and ``tests/test_pipeline.py``'s
    bf16-vs-f32 quality pin. The replay-faithful dataset path stays f32.
    """
    keys = jax.random.split(sub, B)
    choices = jax.random.randint(jax.random.fold_in(sub, 1), (B, 4), lo, hi)

    def one(key, ch):
        seeds = compose_seeds(bank, ch)
        with _production_scopes():
            out, seg_o, _, _ = _synth_core(
                key, seeds, seg, jnp.zeros((), jnp.float32), (), cfg, (), False
            )
        out = out.astype(jnp.float32)
        peak = jnp.max(out)
        out = out / jnp.where(peak > 0, peak, 1.0)
        return out, seg_o

    return jax.vmap(one)(keys, choices)


def _make_batch_fn(
    cfg, shape, qa, sm, cube: int, ns_grid: int, B: int, lo: int,
    small_cube: int | None = None, split_dz: bool = False,
    coarse_w: bool = False,
):
    """Build the fused per-batch program: seed composition from a multi-
    subject bank, the batched synth pipeline, and (when configured) the FULL
    SR-artifact chain — blur_cortex -> struct_noise -> simulate_motion ->
    boundaries, then the [0, 1] rescale — matching the reference's dataset
    path (``fetalsyngen/generator/model.py:210-220``, ``datasets.py:311``).

    The synth core is vmapped (small per-sample footprint); the artifact
    chain runs under ``lax.map`` so only one sample's scanner buffers are
    live at a time.
    """
    from ..generator.artifacts.batched import (
        apply_post_motion,
        apply_pre_motion,
        motion_t,
    )

    has_quality = qa is not None and (
        qa.blur_cortex is not None or qa.struct_noise is not None or qa.boundaries is not None
    )
    has_motion = sm is not None

    def fn(sub, mega, segs, hi, subj, pack):
        S, n_opt = mega.shape[0], mega.shape[1]
        keys = jax.random.split(sub, B)
        u = jax.random.uniform(jax.random.fold_in(sub, 2), (B, 4))

        def synth_one(key, sj, uu):
            hi_s = hi[sj]
            ch = lo + jnp.floor(uu * (hi_s - lo).astype(jnp.float32)).astype(jnp.int32)
            ch = jnp.clip(ch, lo, hi_s - 1)
            flat = mega.reshape(S * n_opt, 4, *shape)
            picked = flat[sj * n_opt + ch, jnp.arange(4)]
            seeds = picked.astype(jnp.int32).sum(axis=0)
            seg = segs[sj].astype(jnp.int32)
            # bf16 production mode (see _gen_batch); f32 out for the
            # artifact chain's boundaries
            with _production_scopes():
                out, seg_o, _, _ = _synth_core(
                    key, seeds, seg, jnp.zeros((), jnp.float32), (), cfg, (), False
                )
            return out.astype(jnp.float32), seg_o

        outs, segs_o = jax.vmap(synth_one)(keys, subj, u)

        if has_quality or has_motion:

            def art_one(args):
                key, o, sg, row = args
                ka = jax.random.fold_in(key, 77)
                # per-sample artifact-gate pins (present only when the stream
                # was given genparams; absent -> trace identical to unpinned)
                gates = row.get("gates") if isinstance(row, dict) else None
                # stream-only default-precision matmuls AND bf16
                # intermediate storage (half the HBM traffic on the
                # bandwidth-bound shear/zoom/spread chains): the artifact
                # chain's outputs receive Rician noise/gamma/voids anyway
                # and the stream is documented non-replay-exact — see
                # linops.precision_scope / linops.storage_scope.
                with _production_scopes():
                    if has_quality:
                        o = apply_pre_motion(ka, o, sg, qa, gates=gates)
                    if has_motion:
                        o = motion_t(
                            jax.random.fold_in(ka, 303), o, sg, row, sm, shape,
                            cube, ns_grid, small_cube=small_cube,
                            split_dz=split_dz, coarse_w=coarse_w,
                        )
                    if has_quality:
                        o = apply_post_motion(ka, o, sg, qa, gates=gates)
                return o

            outs = jax.lax.map(art_one, (keys, outs, segs_o, pack))

        peak = jnp.max(outs, axis=(1, 2, 3), keepdims=True)
        outs = outs / jnp.where(peak > 0, peak, 1.0)
        return outs, segs_o

    return jax.jit(fn)


class SyntheticStream:
    """Iterator of device-generated batches from a ``FetalSynthDataset``.

    Each batch mixes subjects per ELEMENT from a device-resident multi-
    subject seed bank (the reference's DataLoader mixes subjects per sample,
    ``test_dl.py:17-23``), composes per-sample seeds on device, and runs the
    jitted batched pipeline — including the generator's SR-artifact chain
    when ``artifacts`` is enabled (in-program randomness; see
    ``generator/artifacts/batched.py`` for the documented deviations vs the
    replay-faithful host path). With ``prefetch=True`` the next batch is
    generated while the caller consumes the current one.

    Every batch carries a ``"meta"`` record; :meth:`replay_batch` /
    :meth:`replay_sample` re-create it (or one element) voxel-exactly — the
    stream analog of the dataset path's genparams replay contract
    (reference ``datasets.py:256-327``, docs "Fixed Image Generation").

    Args:
        artifacts: apply the generator's configured SR artifacts inside the
            batch program (default True — matching the reference's dataset
            path). Generators with no artifacts configured are unaffected.
        mix_subjects: number of subjects resident on device at once (batch
            elements draw uniformly among them). The resident set rotates
            round-robin by one subject per batch, so the stream still sweeps
            the whole dataset.
        genparams: optional generation-parameter pins applied to EVERY
            sample the stream produces — the stream's convergence with the
            dataset path's genparams contract (reference
            ``docs/datasets.md`` "Fixed Image Generation"). Honored keys,
            all under ``genparams["artifact_params"]``:
            ``simulate_motion: {resolution_slice | resolution_slice_fac,
            slice_thickness, gap, apply}`` pins the scanner geometry draws
            (draw-then-override) and the motion gate; presence of a
            non-empty ``blur_cortex`` / ``struct_noise`` / ``boundaries``
            dict forces that artifact's gate ON (``{"apply": False}``
            forces it OFF). The effective per-sample scalars are recorded
            in each batch's ``meta["scanner"]``. Pins beyond these (full
            parameter replay) remain the dataset path's surface.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        seed: int = 0,
        prefetch: bool = True,
        artifacts: bool = True,
        mix_subjects: int = 2,
        cube: int | None = None,
        ns_grid: int | None = None,
        small_tier: bool = True,
        dz_split: bool = True,
        coarse_w: bool = True,
        genparams: dict | None = None,
    ):
        self.dataset = dataset
        self.cfg: GeneratorCfg = dataset.generator.cfg
        self.batch_size = batch_size
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.PRNGKey(seed)
        self._banks = SeedBankCache(dataset.seed_paths)
        self._names = sorted(dataset.seed_paths.keys())
        self._segs = {}
        self._i = 0

        # genparams pins (see class docstring): scanner scalar pins go to
        # pack_motion; quality-gate pins become a per-sample (3,) int32 row
        gp = {k: v for k, v in (genparams or {}).items() if v is not None}
        ap = {
            k: v
            for k, v in (gp.get("artifact_params", {}) or {}).items()
            if v is not None
        }
        self.genparams = gp
        self._sm_gp = dict(ap.get("simulate_motion", {}) or {}) or None

        def _gate_of(name: str) -> int:
            sub = ap.get(name)
            if sub is None:
                return -1
            sub = {k: v for k, v in sub.items() if v is not None}
            if not sub:
                return -1
            return 0 if sub.get("apply") is False else 1

        g = [_gate_of(n) for n in ("blur_cortex", "struct_noise", "boundaries")]
        self._gates = (
            np.asarray(g, np.int32) if any(x >= 0 for x in g) else None
        )

        gen_art = getattr(dataset.generator, "artifacts", {}) or {}
        self._sm = gen_art.get("simulate_motion") if artifacts else None
        if artifacts:
            from ..generator.artifacts.batched import QualityArtifacts

            self._qa = QualityArtifacts.from_generator(dataset.generator)
        else:
            self._qa = None
        shape = tuple(self.cfg.shape)
        tiers = self._sm.tiers if self._sm is not None else (384, 512, 640)
        if cube is None:
            if self._sm is not None:
                # full-law tier coverage: one engine branch per static tier
                # the config's res_slice range can need (slice_grid law,
                # scanner.py:126-145; reference simulate_reco.py:142-191).
                # Each sample routes through its own tier via lax.switch, so
                # no draw is clamped (the r3 single-tier stream clamped ~20%
                # of default-config draws to the 384 tier's floor).
                from ..generator.artifacts.scanner import slice_grid

                sp = self._sm.scanner_args
                res0 = float(self.cfg.resolution[0])
                rs_lo = float(sp.resolution_slice_fac_min)
                rs_hi = min(
                    float(sp.resolution_slice_fac_max),
                    float(sp.resolution_slice_max) / res0,
                )
                t_small = slice_grid(shape, rs_hi, sp.slice_size, tiers)
                t_big = slice_grid(shape, rs_lo, sp.slice_size, tiers)
                cubes = tuple(t for t in sorted(tiers) if t_small <= t <= t_big)
            else:
                t = min((c for c in tiers if c >= max(shape)), default=max(tiers))
                cubes = (int(t),)
        elif isinstance(cube, (tuple, list)):
            cubes = tuple(int(c) for c in cube)
        else:
            cubes = (int(cube),)
        self.cubes = cubes
        # legacy attribute: int when single-tier, tuple otherwise (both are
        # accepted by pack_motion / motion_t)
        self.cube = cubes[0] if len(cubes) == 1 else cubes
        if ns_grid is None:
            # shape-aware slice grid: the scanner never produces more than
            # ns = max(shape) * res / gap_min + 2 slices per stack
            # (scanner.py Scanner.scan, reference simulate_reco.py:349-354),
            # so padding the slice axis to a static 128 wastes 25-50% of
            # every slice-space pass at the default config (<= 87 slices at
            # shape 256, res 0.5, gap >= 1.5). Use the smallest 32-multiple
            # that covers the config's worst case, capped at the engine
            # default. The one pass with the slice axis on LANES pads to 128
            # internally (_recon_one), so 32-granularity is safe.
            ns_grid = getattr(self._sm, "ns_grid", 128)
            if self._sm is not None:
                sp = self._sm.scanner_args
                res0 = float(self.cfg.resolution[0])
                need = int(max(shape) * res0 / float(sp.gap_min)) + 2
                ns_grid = min(ns_grid, max(64, -(-need // 32) * 32))
        self.ns_grid = int(ns_grid)
        self._shape = shape
        # small px-frame tier: the smallest 128-multiple buffer holding the
        # volume; samples whose res_slice draw covers the FOV at that size
        # run the motion engine there (~(small/cube)^3 the cost)
        sc = ((max(shape) + 127) // 128) * 128
        if os.environ.get("FSG_SMALL_TIER", "1") == "0":
            small_tier = False
        self.small_cube = sc if (small_tier and sc < self.cubes[0]) else None
        # dz-split motion engine (stream-only; scanner._extract_pair /
        # _recon_one docstrings): per-slice z translation rides the
        # extraction/placement matmuls, hat passes carry tilt only.
        # FSG_DZ_SPLIT=1/0 forces it on/off regardless of the argument.
        env_split = os.environ.get("FSG_DZ_SPLIT")
        if env_split in ("0", "1"):
            dz_split = env_split == "1"
        self.dz_split = bool(dz_split)
        # coarse recon-weight chain (stream-only approximation; see
        # scanner._recon_one ``coarse_inv``). FSG_COARSE_W=1/0 forces it.
        env_cw = os.environ.get("FSG_COARSE_W")
        if env_cw in ("0", "1"):
            coarse_w = env_cw == "1"
        self.coarse_w = bool(coarse_w)
        self.mix_subjects = max(1, min(int(mix_subjects), len(self._names)))
        self._resident: list[str] = []
        self._mega = None
        self._megasegs = None
        self._hi = None
        self._batch_fn = None

    def _seg(self, name: str) -> jnp.ndarray:
        if name not in self._segs:
            idx = [self.dataset._sub_ses_idx(i) for i in range(len(self.dataset.sub_ses))].index(
                name
            )
            self._segs[name] = jnp.asarray(
                nifti.load_ras(str(self.dataset.segm_paths[idx])).data.astype(np.int16)
            )
        return self._segs[name]

    def _stack_banks(self, names: list[str]):
        """Stack per-subject banks/segs into the batch program's mega inputs.

        Deterministic in ``names`` (banks decode from disk), so a replay can
        rebuild byte-identical program inputs from the resident list alone.
        """
        banks = [self._banks.bank(n) for n in names]
        n_opt = max(b.shape[0] for b in banks)
        padded = [
            b
            if b.shape[0] == n_opt
            else jnp.concatenate([b, jnp.repeat(b[-1:], n_opt - b.shape[0], 0)])
            for b in banks
        ]
        mega = jnp.stack(padded)
        megasegs = jnp.stack([self._seg(n) for n in names])
        hi = jnp.asarray(
            [min(self.cfg.intensity.max_subclusters, b.shape[0]) for b in banks],
            jnp.int32,
        )
        return mega, megasegs, hi

    def _rotate_residents(self):
        """Advance the resident subject set by one (round-robin) and restack
        the device mega-bank. Stacking device-cached banks is an HBM-to-HBM
        copy (~ms); host IO only happens on a cache miss."""
        want = [
            self._names[(self._i + j) % len(self._names)]
            for j in range(self.mix_subjects)
        ]
        self._i += 1
        if want == self._resident:
            return
        self._resident = want
        self._mega, self._megasegs, self._hi = self._stack_banks(want)

    def _generate(self):
        B = self.batch_size
        if self._mega is None or len(self._names) > self.mix_subjects:
            self._rotate_residents()
        lo = max(self.cfg.intensity.min_subclusters - 1, 0)
        if self._batch_fn is None:
            self._batch_fn = _make_batch_fn(
                self.cfg, self._shape, self._qa, self._sm, self.cube,
                self.ns_grid, B, lo, small_cube=self.small_cube,
                split_dz=self.dz_split, coarse_w=self.coarse_w,
            )

        self._key, sub = jax.random.split(self._key)
        scanner_rec = None
        if self._sm is not None:
            from ..generator.artifacts.batched import pack_motion

            pack_host = pack_motion(
                self._rng, B, self._shape, float(self.cfg.resolution[0]),
                self._sm, self.cube, self.ns_grid, small_cube=self.small_cube,
                genparams=self._sm_gp, with_record=True,
            )
            scanner_rec = pack_host.pop("_record")
            if self._gates is not None:
                pack_host["gates"] = np.broadcast_to(self._gates, (B, 3)).copy()
            pack = jax.tree.map(jnp.asarray, pack_host)
        else:
            pack_host = {}
            if self._gates is not None:
                pack_host["gates"] = np.broadcast_to(self._gates, (B, 3)).copy()
            pack = jax.tree.map(jnp.asarray, pack_host)

        # subject per batch ELEMENT (host draw, so the per-sample subject
        # names are known without a device fetch)
        subj = self._rng.integers(0, len(self._resident), B)

        # ONE device call per batch: key split, subcluster choices, seed
        # composition, the batched pipeline, the artifact chain, and [0,1]
        # scaling all live in a single jitted program.
        images, labels = self._batch_fn(
            sub, self._mega, self._megasegs, self._hi,
            jnp.asarray(subj, jnp.int32), pack,
        )
        # replay metadata: the batch program is a pure function of
        # (sub, resident subject list, subj, pack); everything else (seed
        # banks, segs) decodes deterministically from disk. See replay_batch.
        meta = {
            "sub": np.asarray(sub),
            "resident": tuple(self._resident),
            "subj": np.asarray(subj, np.int64),
            "pack": {k: np.asarray(v) for k, v in pack_host.items()},
            "batch_size": B,
        }
        if scanner_rec is not None:
            # effective per-sample scanner scalars (mm) — the pinned values
            # when genparams pins are active (see class docstring)
            meta["scanner"] = scanner_rec
        return {
            "image": images,
            "label": labels,
            "name": tuple(self._resident[int(s)] for s in subj),
            "meta": meta,
        }

    def replay_batch(self, meta: dict) -> dict:
        """Re-generate a batch voxel-exactly from its ``meta`` record.

        The batch program is deterministic in ``(sub, resident, subj, pack)``
        — the only host draws — plus the on-disk seed/seg volumes, so
        re-running the SAME jitted program on the rebuilt inputs reproduces
        every element bit-for-bit (same compiled executable, same inputs).
        Works on a fresh ``SyntheticStream`` in a new process as long as the
        stream configuration (batch size, cfg, artifact settings, tier
        geometry) matches the producing stream; the dataset path's genparams
        dict remains the cross-implementation replay surface
        (reference contract ``datasets.py:256-327``).
        """
        B = int(meta["batch_size"])
        if B != self.batch_size:
            raise ValueError(
                f"meta was produced with batch_size={B}, this stream uses "
                f"{self.batch_size}; construct a stream with batch_size={B}"
            )
        lo = max(self.cfg.intensity.min_subclusters - 1, 0)
        if self._batch_fn is None:
            self._batch_fn = _make_batch_fn(
                self.cfg, self._shape, self._qa, self._sm, self.cube,
                self.ns_grid, B, lo, small_cube=self.small_cube,
                split_dz=self.dz_split, coarse_w=self.coarse_w,
            )
        mega, megasegs, hi = self._stack_banks(list(meta["resident"]))
        pack = {k: jnp.asarray(v) for k, v in meta["pack"].items()}
        subj = np.asarray(meta["subj"])
        images, labels = self._batch_fn(
            jnp.asarray(meta["sub"]), mega, megasegs, hi,
            jnp.asarray(subj, jnp.int32), pack,
        )
        return {
            "image": images,
            "label": labels,
            "name": tuple(meta["resident"][int(s)] for s in subj),
            "meta": meta,
        }

    def replay_sample(self, meta: dict, index: int) -> dict:
        """Reproduce ONE element of a recorded batch (see :meth:`replay_batch`).

        Re-runs the batch program (per-element programs would trace a second
        executable whose reductions may associate differently; re-running the
        recorded batch guarantees bitwise equality) and slices out ``index``.
        """
        batch = self.replay_batch(meta)
        return {
            "image": batch["image"][index],
            "label": batch["label"][index],
            "name": batch["name"][index],
        }

    def __iter__(self):
        if not self.prefetch:
            while True:
                yield self._generate()

        q: collections.deque = collections.deque()
        lock = threading.Lock()

        def producer():
            batch = self._generate()
            with lock:
                q.append(batch)

        t = threading.Thread(target=producer)
        t.start()
        while True:
            t.join()
            with lock:
                batch = q.popleft()
            t = threading.Thread(target=producer)
            t.start()
            yield batch
