"""Batched, fully-traced SR artifacts for the production stream.

The host-orchestrated artifact classes (:mod:`.quality`, :mod:`.scanner`)
follow the reference's per-sample call structure — host scalar draws, one
device program per artifact. That is the replay-faithful path, but it costs
one host->device dispatch (and host sync) per artifact per sample.

This module re-expresses the same artifact *laws* (distributions cited to the
reference below) as traced functions whose randomness comes from
``jax.random`` inside the program, gated per sample with ``lax.cond`` so a
sample that drew an artifact OFF pays (almost) nothing. The production
stream (:mod:`fetalsyngen_tpu.parallel.input_pipeline`) folds them into its
batch programs; the reference applies the same artifact chain inside the
dataset path (``fetalsyngen/generator/model.py:210-220``).

Chain order matches the reference orchestrator: blur_cortex -> struct_noise
-> simulate_motion -> boundaries (``model.py:210-220``), with the [0, 1]
rescale after all artifacts (``datasets.py:311-312``).

Known deviations vs the host path (documented, stream-only):
- randomness comes from the sample key, not a host NumPy stream -> stream
  samples are NOT replayable through the *genparams dict* (that surface
  belongs to the dataset path); the stream has its own voxel-exact replay
  via each batch's ``meta`` record (``SyntheticStream.replay_batch`` /
  ``replay_sample`` re-run the recorded program inputs bit-for-bit);
- the scanner packs each sample's geometry into the smallest of a static
  set of grid tiers covering its ``res_slice`` draw (the stream derives the
  tier set from the config's full range, so no draw is clamped for ranges
  covered by the tier set — the default config; a draw whose required grid
  exceeds the largest tier is clamped to it, a documented residual
  deviation) and routes
  batches through per-tier ``lax.switch`` branches — same law as the host
  path's per-scan ``slice_grid``, realised with static shapes;
- zero-valid-slice stacks are dropped instead of redrawn (the reference
  retry, ``simulate_reco.py:366``, virtually never fires for brain-centered
  stacks); the overflow-stack discard IS replicated;
- the recon WEIGHT field rides pooled grids (``scanner._recon_one``
  ``coarse_inv``; ``SyntheticStream(coarse_w=...)`` / ``FSG_COARSE_W``):
  geometry-only, error confined to thin slab-edge bands, corr > 0.99 vs the
  exact chain (same bar as the small-frame / dz-split approximations);
- slice validity comes from a 4x-coarse warped-mask z-profile
  (``scanner._valid_coarse``) instead of the exact per-slice mask masses —
  the threshold is relative, so only band-edge slices near the cut can
  flip (A/B-tested in ``tests/test_batched_artifacts.py``).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...ops.linops import gaussian_blur_mm
from ...ops.morphology import box_sum
from ...ops.noise import fractal_noise_3d, mog_3d
from ...ops.rand import beta_int, gamma_fast, poisson_icdf
from .quality import (
    BlurCortex,
    SimulatedBoundaries,
    StructNoise,
    masked_random_centers,
)
from .scanner import (
    _BLUR_HALF,
    _acquire_one,
    _coarse_mask,
    _extract_pair,
    _finalize_traced,
    _pad_centered,
    _recon_one,
    _slice_artifacts,
    _slice_coef_tables,
    _valid_coarse,
)

MAX_HALO_RADIUS = 14  # randint(5, 15) upper bound (artifacts.py:499)
MAX_FUZZY_ROUNDS = 4  # randint(2, 5) upper bound (artifacts.py:560)
MAX_DILATE = 18  # 6 * (n_fuzzy - 1) <= 18 (artifacts.py:582)


# ---------------------------------------------------------------------------
# traced morphology helpers
# ---------------------------------------------------------------------------


def sq_edt(mask: jnp.ndarray, max_radius: int) -> jnp.ndarray:
    """Squared Euclidean distance transform, exact up to ``max_radius``.

    Three 1-D min-plus passes with parabolic increments (the same identity
    :func:`ops.morphology.ball_dilate` uses) — but returning the distance
    field so the ball radius can be TRACED: ``dilate_r(mask) == sq_edt <= r^2``.
    All values are small exact integers, so the ~6*max_radius roll+min
    passes run in int16 (half the HBM traffic of f32; sentinel 20000 keeps
    ``shifted + off^2`` < 32767).
    """
    big = jnp.int16(20000)
    d2 = jnp.where(mask > 0, jnp.int16(0), big)
    for axis in range(3):
        idx = lax.broadcasted_iota(jnp.int32, d2.shape, axis)
        acc = d2
        for off in range(-max_radius, max_radius + 1):
            if off == 0:
                continue
            shifted = jnp.roll(d2, off, axis=axis)
            ok = (idx - off >= 0) & (idx - off < d2.shape[axis])
            acc = jnp.minimum(
                acc, jnp.where(ok, shifted + jnp.int16(off * off), big)
            )
        d2 = acc
    return d2


def ball_dilate_traced(mask: jnp.ndarray, radius: jnp.ndarray, max_radius: int) -> jnp.ndarray:
    """Euclidean-ball dilation with a TRACED radius (<= ``max_radius``)."""
    return (
        sq_edt(mask, max_radius) <= (radius * radius).astype(jnp.int16)
    ).astype(jnp.int32)


def _dilate1(mask: jnp.ndarray) -> jnp.ndarray:
    """Unit-ball (6-neighborhood) dilation via rolls — cheap inner step.

    Preserves the input dtype (the dilate ladder runs it in int8 — 4x less
    roll traffic than int32)."""
    out = mask
    zero = jnp.zeros((), mask.dtype)
    for axis in range(3):
        idx = lax.broadcasted_iota(jnp.int32, mask.shape, axis)
        for off in (-1, 1):
            ok = (idx - off >= 0) & (idx - off < mask.shape[axis])
            out = jnp.maximum(out, jnp.where(ok, jnp.roll(mask, off, axis=axis), zero))
    return out


# ---------------------------------------------------------------------------
# BlurCortex, traced (laws: reference artifacts.py:83-133; quality.BlurCortex)
# ---------------------------------------------------------------------------


def _weighted_centers(key, w_flat, shape, nmax):
    """Weighted sampling without replacement: keys ~ log(U)/w top-k
    (blocked two-stage form, see :func:`quality.topk_flat`)."""
    from .quality import topk_flat

    u = jax.random.uniform(key, w_flat.shape, minval=1e-7)
    scores = jnp.where(w_flat > 0, jnp.log(u) / jnp.maximum(w_flat, 1e-8), -jnp.inf)
    _, idx = topk_flat(scores, nmax)
    finite = jnp.isfinite(jnp.take(scores, idx))
    i = idx // (shape[1] * shape[2])
    rem = idx % (shape[1] * shape[2])
    centers = jnp.stack([i, rem // shape[2], rem % shape[2]], -1).astype(jnp.float32)
    return centers, finite


def _pin_gate(drawn, gate):
    """Combine a drawn artifact gate with an optional per-sample pin.

    ``gate`` is a traced int32 scalar: ``-1`` keeps the drawn gate, ``0``
    forces OFF, ``1`` forces ON (the stream analog of the reference's
    "non-empty genparams forces the artifact" contract,
    ``fetalsyngen/generator/model.py:210-220``). ``None`` (the unpinned
    default) leaves the trace byte-identical to the pre-pinning program so
    cached executables stay valid.
    """
    if gate is None:
        return drawn
    return jnp.where(gate >= 0, gate > 0, drawn)


def blur_cortex_t(key: jax.Array, out: jnp.ndarray, seg: jnp.ndarray, bc: BlurCortex,
                  gate=None):
    """Traced BlurCortex: gate ~ U < prob; nblur ~ U{nmin..nmax-1};
    std_blurs ~ Gamma(2, 1)^3; center sigmas ~ Gamma(3, 1) (artifacts.py:104,
    110); frontal-lobe-biased weighted centers."""
    kg, kn, ks, kc, kb = jax.random.split(key, 5)
    on = _pin_gate(jax.random.uniform(kg) < bc.prob, gate)

    def apply(out):
        shape = out.shape
        nblur = jax.random.randint(kn, (), bc.nblur_min, bc.nblur_max)
        std_blurs = gamma_fast(kb, bc.std_blur_shape, (3,)) * bc.std_blur_scale
        sigmas = jnp.maximum(
            gamma_fast(ks, bc.sigma_gamma_loc, (bc.MAX_BLUR, 3))
            * bc.sigma_gamma_scale,
            1e-2,
        )
        cortex = (seg == bc.cortex_label).astype(jnp.float32)
        x, y, z = shape
        prob_field = mog_3d(
            shape,
            jnp.array([[0.0, y, z / 2.0], [x, y, z / 2.0]], jnp.float32),
            jnp.array([[x / 5.0] * 3, [y / 5.0] * 3], jnp.float32),
        )
        w = jnp.where(cortex.reshape(-1) > 0, prob_field.reshape(-1), 0.0)
        centers, finite = _weighted_centers(kc, w, shape, bc.MAX_BLUR)
        valid = (jnp.arange(bc.MAX_BLUR) < nblur) & finite
        gaussian = mog_3d(shape, centers, sigmas, valid)
        blurred = gaussian_blur_mm(out, std_blurs, 25)
        return out * (1 - gaussian) + blurred * gaussian

    return lax.cond(on, apply, lambda o: o, out)


# ---------------------------------------------------------------------------
# StructNoise, traced (laws: reference artifacts.py:136-342; quality.StructNoise)
# ---------------------------------------------------------------------------


def struct_noise_t(key: jax.Array, out: jnp.ndarray, seg: jnp.ndarray, sn: StructNoise,
                   gate=None):
    kg, kn, kstd, k1, k2, k3, ksig = jax.random.split(key, 7)
    on = _pin_gate(jax.random.uniform(kg) < sn.prob, gate)
    mp = sn.merge_params

    def apply(out):
        shape = out.shape
        nstages = jax.random.randint(kn, (), sn.nstages_min, sn.nstages_max)
        noise_std = sn.std_min + (sn.std_max - sn.std_min) * jax.random.uniform(kstd)
        noise = StructNoise._multiscale_noise.__wrapped__(
            k1, shape, nstages, sn.nstages_max
        )
        noisy = jnp.clip(out + noise_std * noise, 0, out.max() * 2)

        if mp.merge_type == "perlin":
            # res is a static lattice period: lax.switch over one branch per
            # listed variant — only the DRAWN variant's noise is computed
            # (jnp.select would evaluate all of them every sample)
            ridx = jax.random.randint(k2, (), 0, len(mp.perlin_res_list))
            octave = jnp.asarray(mp.perlin_octaves_list)[
                jax.random.randint(k3, (), 0, len(mp.perlin_octaves_list))
            ]
            weight = lax.switch(
                ridx,
                [
                    (lambda r=r: fractal_noise_3d(
                        ksig,
                        shape,
                        (int(r), int(r), int(r)),
                        octaves=octave,
                        persistence=mp.perlin_persistence,
                        lacunarity=mp.perlin_lacunarity,
                        increase=mp.perlin_increase_size,
                        max_octaves=int(max(mp.perlin_octaves_list)),
                    ))
                    for r in mp.perlin_res_list
                ],
            )
        else:  # gaussian
            nloc = jax.random.randint(k2, (), mp.gauss_nloc_min, mp.gauss_nloc_max)
            wm = (seg == sn.wm_label).astype(jnp.int32)
            centers, valid = masked_random_centers(k3, wm, sn.MAX_LOC, nloc)
            sigmas = jnp.clip(
                mp.gauss_sigma_mu
                + mp.gauss_sigma_std * jax.random.normal(ksig, (sn.MAX_LOC, 1)),
                1,
                40,
            )
            weight = mog_3d(shape, centers, sigmas, valid)

        mask = (seg > 0).astype(jnp.float32)
        return (1 - mask * weight) * out + mask * weight * noisy

    return lax.cond(on, apply, lambda o: o, out)


# ---------------------------------------------------------------------------
# SimulatedBoundaries, traced (laws: reference artifacts.py:428-604)
# ---------------------------------------------------------------------------


def boundaries_t(key: jax.Array, out: jnp.ndarray, seg: jnp.ndarray, sb: SimulatedBoundaries,
                 gate=None):
    knm, kh, kf, khr, kn1, kn2, kn3, kc, kbeta = jax.random.split(key, 9)
    # gate pin semantics: ON forces the masking path (no_mask_on=False),
    # OFF forces the pass-through (no_mask_on=True); sub-gates stay drawn
    no_mask_on = jax.random.uniform(knm) < sb.prob_no_mask
    if gate is not None:
        no_mask_on = jnp.where(gate >= 0, gate == 0, no_mask_on)
    halo_on = jax.random.uniform(kh) < sb.prob_halo
    fuzzy_on = jax.random.uniform(kf) < sb.prob_fuzzy
    mask0 = (seg > 0).astype(jnp.int32)

    def halo(mask):
        radius = jax.random.randint(khr, (), 5, MAX_HALO_RADIUS + 1)
        return ball_dilate_traced(mask, radius, MAX_HALO_RADIUS)

    def fuzzy(mask):
        n_fuzzy = jax.random.randint(kn1, (), 2, MAX_FUZZY_ROUNDS + 1)
        n_centers = jnp.minimum(poisson_icdf(kn2, 100.0, kmax=224), sb.MAX_CENTERS)
        base_sigma = jnp.maximum(poisson_icdf(kn3, 8.0, kmax=64), 1)

        mask_modif = mask
        for r in range(MAX_FUZZY_ROUNDS):
            # cond (not where): under the stream's sequential lax.map the
            # skipped rounds' morphology is actually not computed
            mask_modif = lax.cond(
                r < n_fuzzy,
                lambda m, r=r: SimulatedBoundaries._fuzzy_once.__wrapped__(
                    jax.random.fold_in(key, 10 + r), m
                ),
                lambda m: m,
                mask_modif,
            )

        added = ((mask_modif - mask) > 0).astype(jnp.int32)
        centers, valid = masked_random_centers(kc, added, sb.MAX_CENTERS, n_centers)
        sigmas = base_sigma.astype(jnp.float32) + 10 * beta_int(
            kbeta, 2, 5, (sb.MAX_CENTERS, 1)
        )
        mog = mog_3d(mask.shape, centers, sigmas, valid)
        surf_proba = jnp.where(added > 0, mog, 0.0)

        n_dilate = jnp.minimum(6 * (n_fuzzy - 1), MAX_DILATE)
        levels = jnp.clip(
            jnp.round(surf_proba * (n_dilate + 2) - 1).astype(jnp.int32), 0, None
        )
        cur = mask.astype(jnp.int8)
        reach = jnp.where(mask > 0, 0, MAX_DILATE + 10).astype(jnp.int8)

        def ladder_chunk(c0, cur, reach):
            for i in range(c0, c0 + 6):
                grow = (i >= 2) & (i < n_dilate)
                cur = jnp.where(grow, _dilate1(cur), cur)
                reach = jnp.where(
                    (reach > i) & (cur > 0) & (i < n_dilate), jnp.int8(i), reach
                )
            return cur, reach

        # chunks past n_dilate are exact no-ops (every update is gated on
        # i < n_dilate) — cond them away so the rolls don't run
        for c0 in (0, 6, 12):
            cur, reach = lax.cond(
                c0 < n_dilate,
                lambda cr, c0=c0: ladder_chunk(c0, *cr),
                lambda cr: cr,
                (cur, reach),
            )
        return ((reach <= levels) & (mask_modif > 0)).astype(jnp.int32) | mask

    def masked(out):
        mask = lax.cond(halo_on, halo, lambda m: m, mask0)
        mask = lax.cond(fuzzy_on, fuzzy, lambda m: m, mask)
        return out * mask

    return lax.cond(no_mask_on, lambda o: o, masked, out)


# ---------------------------------------------------------------------------
# full quality chain (pre-motion part + post-motion part)
# ---------------------------------------------------------------------------


@dataclass
class QualityArtifacts:
    """The generator's configured artifact objects (config carriers)."""

    blur_cortex: BlurCortex | None = None
    struct_noise: StructNoise | None = None
    boundaries: SimulatedBoundaries | None = None

    @classmethod
    def from_generator(cls, generator) -> "QualityArtifacts":
        a = generator.artifacts
        return cls(
            blur_cortex=a.get("blur_cortex"),
            struct_noise=a.get("struct_noise"),
            boundaries=a.get("boundaries"),
        )


# ---------------------------------------------------------------------------
# SimulateMotion, batched: host geometry packer + fully-traced scan engine
# ---------------------------------------------------------------------------


def _acquire_one_small(
    vol_p, q_idx, angles, wscale, wdelta, G, gap_px, z0, sig_px,
    thr_frac, ns_count, key, gamma, gamma_on, sigma, void_prob, threshold,
    S: int, ns_grid: int, coarse_mask, split_dz: bool = False,
):
    """One stack's acquisition in the SMALL isotropic slice-pixel frame.

    Stream-only fast path for samples whose drawn ``res_slice`` makes the
    slice FOV fit a ``S``-cube in px units (``rs * S >= diag``, ~half of
    default draws): the whole stack frame lives in ISOTROPIC px units on an
    ``S`` buffer, so every pass runs at ~(S/cube)^3 the cost of the big
    frame. The rigid warp uses the zoom-FIRST ordering
    (:func:`ops.warp.warp_rigid_zoom_first`) — content shrinks by ``rs``
    before the rotation shears, so nothing clips — and the acquisition PSF
    (z thickness + in-plane sinc, both in px here) composes into the warp's
    final diagonal contractions. Downstream (extract / artifacts / coarse
    validity / recon) reuses the shared helpers with ``rs = 1`` px params.
    """
    from ...ops.linops import toeplitz_blur_matrix
    from ...ops.warp import warp_rigid_zoom_first

    c_s = (S - 1) / 2.0
    post = tuple(toeplitz_blur_matrix(sig_px[i], S, _BLUR_HALF) for i in range(3))
    Wv = warp_rigid_zoom_first(
        vol_p, q_idx, angles, wscale, wdelta, out_size=S, post=post,
        out_perm=(1, 2, 0), emit_f32=False,
    )
    # px frame: rs = 1, c_ss = the S-buffer center (same laws as the big
    # engine — shared helper so they cannot diverge)
    dz, dv_tab, du_tab = _slice_coef_tables(G, 1.0, c_s, z0, gap_px, ns_grid)
    slices, _ = _extract_pair(
        Wv, None, gap_px, z0, dz, dv_tab, du_tab, S, ns_grid, split_dz=split_dz
    )
    valid_f = _valid_coarse(
        coarse_mask, q_idx, angles, wscale, wdelta, G, thr_frac, ns_count,
        S, ns_grid, zoom_first=True,
    )
    slices = _slice_artifacts(
        key, slices, valid_f, gamma, gamma_on, sigma, void_prob, threshold,
        fast=True,
    )
    return slices, valid_f


def _identity_stack_row(ns_grid: int):
    """Inert per-stack geometry for motion-OFF samples / padding."""
    eye = np.eye(3, 4, dtype=np.float32)[None].repeat(ns_grid, 0)
    return dict(
        q_idx=0, angles=np.zeros(3, np.float32), wscale=1.0,
        wdelta=np.zeros(3, np.float32), G=eye, Grec=eye, Greset=eye,
        scal=np.array([0.2, 1.0, 0.0, 0.0], np.float32),
        qinv=0, iang=np.zeros(3, np.float32), iscl=1.0,
        idlt=np.zeros(3, np.float32), dz_ok=0.0,
        cqinv=0, ciang=np.zeros(3, np.float32), ciscl=1.0,
        cidlt=np.zeros(3, np.float32),
    )


def _coarse_inv_decomp(A, t, cube_s: int) -> tuple:
    """Decompose the stack->recon inverse map for the COARSE weight chain.

    The chain runs on the stack frame pooled by ``f = cube_s // 128`` and
    the recon frame pooled by ``g = 2`` (``scanner._recon_one``
    ``coarse_inv``). Pooled-grid coordinates relate to fine ones by
    ``p_f = f p_c + (f-1)/2``, so the fine map ``p_in = A q + t`` becomes
    ``p_in_c = (A g/f) q_c + (A ((g-1)/2) 1 + t - ((f-1)/2) 1) / f`` —
    still rotation-times-isotropic-scale, decomposed on the 128 grid.
    """
    from ...ops.warp import decompose_affine_paeth_host

    f = max(1, cube_s // 128)
    g = 2
    A = np.asarray(A, np.float64)
    t = np.asarray(t, np.float64)
    ones = np.ones(3)
    A_c = A * (g / f)
    t_c = (A @ (ones * (g - 1) / 2.0) + t - ones * (f - 1) / 2.0) / f
    return decompose_affine_paeth_host(A_c, t_c, 128)


def _dz_split_ok(G, Grec, ns, gap_u, margin: float = 2.05) -> float:
    """1.0 when the dz-split's slice attribution is provably exact for this
    stack (see ``scanner._extract_pair`` ``split_dz``): every pair of slice
    plane centers — acquisition AND recon tables — stays separated by more
    than ``margin`` frame units, so both interpolation taps of any plane
    are nearest to their own slice. Real fetal motion crosses planes often
    (interleaved acquisition), so this engages on the calmer stacks only.
    """
    if ns < 2:
        return 1.0
    for tab in (G, Grec):
        pos = np.sort(tab[:ns, 0, 3])
        if np.min(np.diff(pos)) <= margin:
            return 0.0
    return 1.0 if gap_u > margin else 0.0


def pack_motion(
    rng, B: int, shape, res: float, sm, cube: int | tuple, ns_grid: int,
    small_cube: int | None = None, genparams: dict | None = None,
    with_record: bool = False,
) -> dict:
    """Host geometry for one batch of the traced motion engine.

    Mirrors ``Scanner.scan``'s host work (``scanner.py``: init transforms,
    recorded-trajectory motion, interleave, frame decomposition, slice affine
    tables) for ``Kb = max_num_stack`` attempt stacks per motion-ON sample,
    plus the reconstructor's host draws (``recon_psf``). The acceptance /
    overflow /merge logic runs ON DEVICE in :func:`_motion_scan` from this
    packed state — one geometry transfer and zero mid-scan host syncs per
    batch.

    ``cube`` may be a TUPLE of static grid tiers (like the host path's
    per-scan ``slice_grid`` tiers, ``scanner.py:126-145``): each sample's
    geometry is packed in the smallest tier covering its ``res_slice`` draw
    and ``row["tier_idx"]`` routes it through the matching :func:`motion_t`
    branch — serving the FULL reference ``res_slice`` law
    (``simulate_reco.py:142-191``). Draws below even the largest tier are
    clamped to ``diag/max(cube) * res`` (never binds for the default config
    with the default 384/512/640 tiers; documented residual deviation
    otherwise — e.g. a legacy single-tier int ``cube``).

    ``small_cube``: when set, samples whose slice FOV fits a ``small_cube``
    buffer in px units (``rs * small_cube >= diag``) pack their geometry in
    the ISOTROPIC px frame (``fs = rs``) — gap/z0/sig and all affine tables
    in px — and set ``row["small"]`` so :func:`motion_t` routes them through
    the small-frame engine. Frame-unit row values are mode-dependent; the
    schema is identical for both modes.

    ``genparams``: optional pins for the scanner's geometry draws —
    ``resolution_slice`` (or ``resolution_slice_fac``), ``slice_thickness``,
    ``gap`` — applied draw-then-override (like the host path,
    ``scanner.py`` ``Scanner.get_resolution``) so the host RNG consumption
    is identical pinned or not; a non-empty dict also forces the motion gate
    ON for every sample (reference contract: non-empty artifact genparams
    skip the probability gate, ``fetalsyngen/generator/artifacts.py``
    SimulateMotion). With ``with_record=True`` the returned dict carries a
    host-only ``"_record"`` entry with the per-sample effective scalars
    (resolution_slice / slice_thickness / gap in mm, motion_on) — pop it
    before shipping the pack to the device program.
    """
    from .scanner import (
        GAUSSIAN_FWHM,
        SINC_FWHM,
        _slice_affine_table,
        _stack_geometry,
    )
    from .transforms import (
        RigidTransform,
        interleave_index,
        random_angle,
        random_init_stack_transforms,
        reset_transform,
    )
    from ...ops.warp import decompose_affine_paeth_host
    from .motion import sample_motion

    from .scanner import slice_grid

    sp, rp = sm.scanner_args, sm.recon_args
    Kb = int(sp.max_num_stack)
    cubes = (int(cube),) if isinstance(cube, (int, np.integer)) else tuple(int(c) for c in cube)
    diag = float(np.sqrt(sum(s * s for s in shape) / 2.0))
    rs_min = diag / max(cubes)
    c_vol = (np.asarray(shape) - 1) / 2.0
    mp = rp.merge_params
    # _validated_genparams parity (reference model.py:85-92): None values
    # are "not pinned"
    gp = {k: v for k, v in (genparams or {}).items() if v is not None}
    # stream gate-pin extension: {"apply": True/False} forces the motion gate
    # without pinning any scalar; any other non-empty dict forces ON
    # (reference parity: non-empty genparams skip the probability gate)
    apply_pin = gp.pop("apply", None)
    force_on = bool(gp) or apply_pin is True
    force_off = apply_pin is False
    pin_res_s = gp.get("resolution_slice")
    if pin_res_s is None and gp.get("resolution_slice_fac") is not None:
        pin_res_s = float(gp["resolution_slice_fac"]) * res

    rows: dict[str, list] = collections.defaultdict(list)
    record: dict[str, list] = collections.defaultdict(list)
    for _ in range(B):
        on = (rng.random() < sm.prob or force_on) and not force_off
        if not on:
            record["resolution_slice"].append(np.nan)
            record["slice_thickness"].append(np.nan)
            record["gap"].append(np.nan)
            record["motion_on"].append(False)
            st = _identity_stack_row(ns_grid)
            for k, v in st.items():
                rows[k].append([v] * Kb)
            rows["motion_on"].append(False)
            rows["small"].append(False)
            rows["tier_idx"].append(0)
            rows["rs"].append(1.0)
            rows["gap_vox"].append(1.0)
            rows["z0"].append(0.0)
            rows["ns"].append(1)
            rows["num_stacks"].append(0)
            rows["sig"].append(np.zeros(3, np.float32))
            rows["sig_rec"].append(np.zeros(2, np.float32))
            for name, val in (
                ("smooth_on", False), ("merge_on", False), ("rm_on", False),
                ("rm_ratio", 0.0), ("mis_on", False), ("mis_idx", 0),
                ("ngauss", 1), ("mres_idx", 0), ("octave", 1),
            ):
                rows[name].append(val)
            rows["gsigmas"].append(np.full((8, 1), 20.0, np.float32))
            continue

        # draw-then-override: pinned genparams must not skip rng draws
        # (host-path parity, scanner.py Scanner.get_resolution)
        res_s = float(
            rng.uniform(
                sp.resolution_slice_fac_min * res,
                min(sp.resolution_slice_fac_max * res, sp.resolution_slice_max),
            )
        )
        if pin_res_s is not None:
            res_s = float(pin_res_s)
        res_s = max(res_s, rs_min * res)  # largest-tier clamp (documented)
        s_thick = float(rng.uniform(sp.slice_thickness_min, sp.slice_thickness_max))
        if gp.get("slice_thickness") is not None:
            s_thick = float(gp["slice_thickness"])
        gap = float(rng.uniform(sp.gap_min, sp.gap_max))
        if gp.get("gap") is not None:
            gap = float(gp["gap"])
        record["resolution_slice"].append(res_s)
        record["slice_thickness"].append(s_thick)
        record["gap"].append(gap)
        record["motion_on"].append(True)
        rs = res_s / res
        gap_vox = gap / res
        ns = min(int(max(shape) * res / gap) + 2, ns_grid)
        # per-sample tier: smallest static grid covering this draw's slice
        # FOV (the host path's slice_grid law, scanner.py:126-145)
        cube_t = slice_grid(shape, rs, sp.slice_size, cubes) if len(cubes) > 1 else cubes[0]
        tier_idx = cubes.index(cube_t)
        # small-frame eligibility: the in-plane slice FOV (diag voxels) and
        # the z slice span must both fit the small buffer in px units, AND
        # the slice gap must exceed 2 px — _extract_pair's n_near
        # factorization is only EXACT for gap > 2 (scanner.py), and in px
        # units gap/res_slice can dip below 2 where gap/res never does
        small = bool(
            small_cube is not None
            and small_cube < cube_t
            and rs * small_cube >= diag
            and (ns - 1) * gap_vox / rs <= small_cube - 12
            and gap_vox / rs > 2.0
            and max(shape) <= small_cube
        )
        cube_s = small_cube if small else cube_t
        fs = rs if small else 1.0  # frame unit in voxels (px frame <=> fs=rs)
        gap_u = gap_vox / fs
        z0 = (cube_s - 1) / 2.0 - (ns - 1) / 2.0 * gap_u
        num_stacks = int(rng.integers(sp.min_num_stack, sp.max_num_stack + 1))
        # res_recon pinned to res (reference SimulateMotion, artifacts.py:402);
        # sigmas in frame units (voxels big / px small)
        sig = np.array(
            [GAUSSIAN_FWHM * s_thick / res / fs, SINC_FWHM * rs / fs,
             SINC_FWHM * rs / fs], np.float32
        )
        sig_rec = np.array(
            [GAUSSIAN_FWHM * s_thick / res / fs, SINC_FWHM * rs / fs], np.float32
        )

        per_stack: dict[str, list] = collections.defaultdict(list)
        for _k in range(Kb):
            t_init = random_init_stack_transforms(
                ns, gap_vox * res, sp.restrict_transform, sp.txy, rng
            )
            ts = np.arange(ns) * rng.uniform(sp.TR_min, sp.TR_max)
            t_motion = sample_motion(ts, rng)
            ilv = interleave_index(ns, int(rng.integers(2, int(np.sqrt(ns)) + 1)))
            t_motion = t_motion[np.asarray(ilv)]
            t_target = t_motion.compose(t_init)
            mats_vox = t_target.matrix(True).copy()
            mats_vox[:, :, 3] /= res
            geo = _stack_geometry(
                t_init.matrix(True)[0, :, :3], mats_vox, shape, ns, cube_s,
                ns_grid, fs=fs,
            )
            gamma_on = rng.random() < sp.prob_gamma
            gamma = float(np.exp(sp.gamma_std * rng.standard_normal()))
            sigma = float(rng.uniform(sp.noise_sigma_min, sp.noise_sigma_max))
            thr_frac = float(rng.uniform(0.1, 0.3))

            mats_rec = mats_vox.copy()
            if rng.random() < rp.prob_misreg_stack:
                off = RigidTransform(
                    np.concatenate(
                        [
                            np.broadcast_to(random_angle(1, True, rng), (ns, 3)),
                            np.stack(
                                [
                                    np.full(ns, rng.uniform(-rp.txy, rp.txy), np.float32),
                                    np.full(ns, rng.uniform(-rp.txy, rp.txy), np.float32),
                                    np.zeros(ns, np.float32),
                                ],
                                -1,
                            ),
                        ],
                        -1,
                    ).astype(np.float32)
                )
                mats_rec[:ns] = off.compose(RigidTransform(mats_rec[:ns])).matrix(True)
            if small:
                Grec = _slice_affine_table(
                    mats_rec, geo["Minv"], c_vol, c_vol, ns, ns_grid, fs=fs,
                    c_frame=(cube_s - 1) / 2.0,
                )
            else:
                Grec = _slice_affine_table(
                    mats_rec, geo["Minv"], geo["t_stack"], c_vol, ns, ns_grid
                )
            mats_reset = reset_transform(t_init).matrix(True).copy()
            mats_reset[:, :, 3] /= res
            if small:
                Greset = _slice_affine_table(
                    mats_reset, geo["Minv"], c_vol, c_vol, ns, ns_grid, fs=fs,
                    c_frame=(cube_s - 1) / 2.0,
                )
                # inverse px-frame -> recon map: isotropic scale 1/fs
                c_sv = np.full(3, (cube_s - 1) / 2.0)
                A_inv = geo["Minv"] / fs
                t_inv = c_sv - geo["Minv"] @ c_vol / fs
            else:
                Greset = _slice_affine_table(
                    mats_reset, geo["Minv"], geo["t_stack"], c_vol, ns, ns_grid
                )
                # inverse stack->recon map (res_recon == res: scale 1, same grid)
                A_inv = geo["Minv"]
                t_inv = -geo["Minv"] @ geo["t_stack"]
            qinv, iang, iscl, idlt = decompose_affine_paeth_host(
                A_inv, t_inv, cube_s
            )
            cqinv, ciang, ciscl, cidlt = _coarse_inv_decomp(A_inv, t_inv, cube_s)
            qi, ang, ws, wd = geo["fwd"]
            for name, val in (
                ("q_idx", qi), ("angles", ang), ("wscale", ws), ("wdelta", wd),
                ("G", geo["G"]), ("Grec", Grec), ("Greset", Greset),
                ("scal", np.array([thr_frac, gamma, 1.0 if gamma_on else 0.0, sigma], np.float32)),
                ("qinv", qinv), ("iang", iang), ("iscl", iscl), ("idlt", idlt),
                ("cqinv", cqinv), ("ciang", ciang), ("ciscl", ciscl),
                ("cidlt", cidlt),
                ("dz_ok", _dz_split_ok(geo["G"], Grec, ns, gap_u)),
            ):
                per_stack[name].append(val)
        for k, v in per_stack.items():
            rows[k].append(v)

        rows["motion_on"].append(True)
        rows["small"].append(small)
        rows["tier_idx"].append(tier_idx)
        rows["rs"].append(rs)
        rows["gap_vox"].append(gap_u)
        rows["z0"].append(z0)
        rows["ns"].append(ns)
        rows["num_stacks"].append(num_stacks)
        rows["sig"].append(sig)
        rows["sig_rec"].append(sig_rec)
        rows["smooth_on"].append(bool(rng.random() < rp.prob_smooth))
        rm_on = bool(rng.random() < rp.prob_rm_slices)
        rows["rm_on"].append(rm_on)
        rows["rm_ratio"].append(
            float(rng.uniform(rp.rm_slices_min, rp.rm_slices_max)) if rm_on else 0.0
        )
        rows["mis_on"].append(bool(rng.random() < rp.prob_misreg_slice))
        rows["mis_idx"].append(int(rng.integers(Kb * ns_grid)))
        rows["merge_on"].append(bool(rng.random() < rp.prob_merge))
        if mp.merge_type == "gaussian":
            rows["ngauss"].append(
                int(rng.integers(mp.gauss_ngaussians_min, mp.gauss_ngaussians_max))
            )
            rows["mres_idx"].append(0)
            rows["octave"].append(1)
        else:
            rows["ngauss"].append(1)
            rows["mres_idx"].append(int(rng.integers(len(mp.perlin_res_list))))
            rows["octave"].append(int(rng.choice(mp.perlin_octaves_list)))
        rows["gsigmas"].append(
            np.clip(20 + 10 * rng.standard_normal((8, 1)), 5, 40).astype(np.float32)
        )

    out = {}
    int_keys = {"q_idx", "qinv", "cqinv", "ns", "num_stacks", "mis_idx", "ngauss", "mres_idx", "octave", "tier_idx"}
    bool_keys = {"motion_on", "small", "smooth_on", "merge_on", "rm_on", "mis_on"}
    for k, v in rows.items():
        arr = np.asarray(v)
        if k in int_keys:
            arr = arr.astype(np.int32)
        elif k in bool_keys:
            arr = arr.astype(bool)
        else:
            arr = arr.astype(np.float32)
        out[k] = arr
    if with_record:
        out["_record"] = {
            k: np.asarray(v, bool if k == "motion_on" else np.float32)
            for k, v in record.items()
        }
    return out


def motion_t(key, out, seg, row, sm, shape, cube: int | tuple, ns_grid: int,
             small_cube: int | None = None, split_dz: bool = False,
             coarse_w: bool = False):
    """Traced SimulateMotion for ONE sample from packed host geometry.

    A single ``lax.scan`` over ``Kb`` attempt stacks fuses acquisition,
    validity, the reference's acceptance/overflow logic
    (``simulate_reco.py:366-440``), and reconstruction accumulation — one
    stack's slices live at a time (never the full (Kb, NS, SS, SS) block).
    Stacks beyond the accepted count skip their compute via ``lax.cond``
    (the scan is sequential, so the cond actually saves the work).

    ``cube`` may be a TUPLE of static grid tiers: one engine branch compiles
    per tier and ``row["tier_idx"]`` (packed host-side from the slice-FOV
    law, see :func:`pack_motion`) routes each sample through the smallest
    covering tier via ``lax.switch`` — only the selected branch executes, so
    a sample pays its own tier's cost. This serves the reference's full
    ``res_slice`` law (``simulate_reco.py:142-191,349-354``) instead of
    clamping high-FOV draws to one static tier.

    ``small_cube``: enables the SMALL px-frame engine — samples packed with
    ``row["small"]`` route through :func:`_acquire_one_small` and a px-unit
    :func:`_recon_one` on a ``small_cube`` buffer (~(small/cube)^3 the
    cost); each frame variant compiles once under the same switch.

    Stream deviations vs the host path (documented in the module docstring):
    zero-valid stacks drop instead of redrawing; ``rm_slices`` is per-slice
    Bernoulli(ratio) instead of an exact global count; the misregistered
    slice is a uniform (stack, slice) pick that only fires if that slice is
    valid.
    """
    sp, rp = sm.scanner_args, sm.recon_args
    mp = rp.merge_params
    max_slices = float(sp.max_num_slices)

    def run(out, cube, small):
        vol_p = _pad_centered(out, cube)
        # coarse-validity mode: the full-res mask never enters the per-stack
        # chains (see _acquire_one/_valid_coarse) — one pooled copy per
        # sample serves every stack
        cmask = _coarse_mask(_pad_centered((seg > 0).astype(jnp.float32), cube))
        sidx = jnp.arange(ns_grid)

        def body(carry, xs):
            count, total, stopped, v_acc, w_acc = carry
            st, k = xs
            active = (count < row["num_stacks"]) & (~stopped)

            def do(args):
                v_acc, w_acc = args
                skey = jax.random.fold_in(key, 100 + k)
                # traced per-stack dz-split flag (pack-time separation proof,
                # _dz_split_ok); a stack taking the misregistered-slice swap
                # falls back to exact — the swap moves one plane at runtime,
                # invalidating the pack-time separation check
                hit_stack = row["mis_on"] & (row["mis_idx"] // ns_grid == k)
                split_f = (
                    st["dz_ok"] * (1.0 - hit_stack.astype(jnp.float32))
                    if split_dz
                    else False
                )
                if small:
                    slices, valid = _acquire_one_small(
                        vol_p, st["q_idx"], st["angles"], st["wscale"],
                        st["wdelta"], st["G"], row["gap_vox"], row["z0"],
                        row["sig"], st["scal"][0], row["ns"], skey,
                        st["scal"][1], st["scal"][2] > 0.5, st["scal"][3],
                        sp.prob_void, sp.slice_noise_threshold, cube, ns_grid,
                        cmask, split_dz=split_f,
                    )
                else:
                    slices, valid = _acquire_one(
                        vol_p, None, st["q_idx"], st["angles"], st["wscale"],
                        st["wdelta"], st["G"], row["rs"], row["gap_vox"], row["z0"],
                        row["sig"], st["scal"][0], row["ns"], skey, st["scal"][1],
                        st["scal"][2] > 0.5, st["scal"][3], sp.prob_void,
                        sp.slice_noise_threshold, cube, ns_grid, coarse_mask=cmask,
                        split_dz=split_f,
                    )
                nv = jnp.sum(valid)
                overflow = (nv > 0) & (total + nv >= max_slices)
                ok = (nv > 0) & (~overflow)
                rm = jax.random.bernoulli(
                    jax.random.fold_in(key, 200 + k), row["rm_ratio"], (ns_grid,)
                )
                keep = valid * (1.0 - rm.astype(jnp.float32) * row["rm_on"])
                hit = (
                    hit_stack
                    & ((sidx == row["mis_idx"] % ns_grid) & (valid > 0))
                )
                grec = jnp.where(hit[:, None, None], st["Greset"], st["Grec"])
                rs_u = jnp.float32(1.0) if small else row["rs"]
                use_coarse = (
                    coarse_w
                    and cube % 128 == 0
                    and all(s % 2 == 0 for s in shape)
                )
                v_s, w_s = _recon_one(
                    slices, jnp.where(ok, keep, 0.0), grec, rs_u,
                    row["gap_vox"], row["z0"], row["sig_rec"], st["qinv"],
                    st["iang"], st["iscl"], st["idlt"], cube, ns_grid, shape,
                    split_dz=split_f,
                    coarse_inv=(
                        (st["cqinv"], st["ciang"], st["ciscl"], st["cidlt"])
                        if use_coarse
                        else None
                    ),
                )
                return v_acc + v_s, w_acc + w_s, ok, overflow, nv

            def skip(args):
                v_acc, w_acc = args
                return (
                    v_acc, w_acc, jnp.asarray(False), jnp.asarray(False),
                    jnp.float32(0.0),
                )

            v_acc, w_acc, ok, overflow, nv = lax.cond(active, do, skip, (v_acc, w_acc))
            return (
                count + ok.astype(jnp.int32),
                total + nv * ok.astype(jnp.float32),
                stopped | overflow,
                v_acc,
                w_acc,
            ), None

        zeros = jnp.zeros(shape, jnp.float32)
        stack_keys = ("q_idx", "angles", "wscale", "wdelta", "G", "Grec",
                      "Greset", "scal", "qinv", "iang", "iscl", "idlt",
                      "cqinv", "ciang", "ciscl", "cidlt", "dz_ok")
        xs = ({k: row[k] for k in stack_keys}, jnp.arange(row["q_idx"].shape[0]))
        (count, _, _, value, weight), _ = lax.scan(
            body,
            (jnp.int32(0), jnp.float32(0.0), jnp.asarray(False), zeros, zeros),
            xs,
        )

        kmw = jax.random.fold_in(key, 305)
        if mp.merge_type == "perlin":
            # one branch per static lattice period; only the drawn one runs
            mw = lax.switch(
                row["mres_idx"],
                [
                    (lambda r=r: fractal_noise_3d(
                        kmw, shape, (int(r), int(r), int(r)), octaves=row["octave"],
                        persistence=mp.perlin_persistence,
                        lacunarity=mp.perlin_lacunarity,
                        increase=mp.perlin_increase_size,
                        max_octaves=int(max(mp.perlin_octaves_list)),
                    ))
                    for r in mp.perlin_res_list
                ],
            )
        else:
            centers, cvalid = masked_random_centers(
                kmw, (seg > 0).astype(jnp.int32), 8, row["ngauss"]
            )
            mw = mog_3d(shape, centers, row["gsigmas"], cvalid)
        recon = _finalize_traced(
            value, weight, out, row["smooth_on"], row["merge_on"], mw
        )
        # no accepted stack (all-zero validity, rare): fall back to the input
        # (the host path redraws; one inert draw is the stream's equivalent)
        return jnp.where(count > 0, recon, out)

    cubes = (int(cube),) if isinstance(cube, (int, np.integer)) else tuple(int(c) for c in cube)

    def on(o):
        branches = []
        has_small = small_cube is not None and small_cube < min(cubes)
        if has_small:
            branches.append(lambda x: run(x, small_cube, True))
        branches.extend(lambda x, c=c: run(x, c, False) for c in cubes)
        if len(branches) == 1:
            return branches[0](o)
        tier = row["tier_idx"] if "tier_idx" in row else jnp.int32(0)
        if has_small:
            idx = jnp.where(row["small"], 0, 1 + tier)
        else:
            idx = tier
        return lax.switch(idx, branches, o)

    return lax.cond(row["motion_on"], on, lambda o: o, out)


def apply_pre_motion(key, out, seg, qa: QualityArtifacts, gates=None):
    """blur_cortex + struct_noise (reference chain order model.py:210-220).

    ``gates``: optional (3,) int32 per-sample pins
    (blur_cortex, struct_noise, boundaries) — see :func:`_pin_gate`.
    """
    if qa.blur_cortex is not None:
        out = blur_cortex_t(jax.random.fold_in(key, 301), out, seg, qa.blur_cortex,
                            gate=None if gates is None else gates[0])
    if qa.struct_noise is not None:
        out = struct_noise_t(jax.random.fold_in(key, 302), out, seg, qa.struct_noise,
                             gate=None if gates is None else gates[1])
    return out


def apply_post_motion(key, out, seg, qa: QualityArtifacts, gates=None):
    """boundaries — runs after simulate_motion in the reference chain."""
    if qa.boundaries is not None:
        out = boundaries_t(jax.random.fold_in(key, 304), out, seg, qa.boundaries,
                           gate=None if gates is None else gates[2])
    return out
