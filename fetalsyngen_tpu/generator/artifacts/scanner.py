"""Motion simulation: slice acquisition + PSF reconstruction.

Reference behavior: ``Scanner.scan`` + ``PSFReconstructor``
(``fetalsyngen/generator/artifacts/simulate_reco.py:57-774``) backed by the
``slice_acq_cuda`` extension (``svort/slice_acquisition/slice_acq_cuda_kernel.cu``):
one GPU thread per slice pixel gathers the volume under a rigidly-transformed
PSF footprint; the adjoint scatters with atomicAdd + weight equalization.

Re-design as dense separable passes — no scatter, no free-form gather.
Per stack:

  acquisition:  (V, brain mask) --traced rigid pair warp--> stack frame
                --PSF blur (V only) + xy scale (matmuls)-->
                --per-slice motion pair passes--> (slices, mask slices)
                --device validity from mask-slice mass--> (+ gamma/Rician/void)
  reconstruction: (slices, keep mask) --inverse motion pair passes--> stack
                grid --recon-PSF blur + inverse xy scale--> --inverse rigid
                pair warp--> accumulate (value, weight) over stacks -->
                equalize --> smooth --> merge with GT

Every arrow is a separable matmul or a row-local hat pass (ops/warp.py).
The factored acquisition (rotate-blur-sample) is mathematically the
reference's PSF model: sampling a slice-frame-oriented Gaussian PSF equals
sampling the volume rotated into the slice frame and blurred axis-aligned.
The z extraction/placement passes (lane slope ``gap_vox`` resp.
``1/gap_vox``) are factored into unit-slope deviation hats + affine interp
MATMULS (``_extract_pair``/``_recon_one`` docstrings), so the resolution
change is a matmul.

Dispatch structure: the WHOLE multi-stack scan is ONE jitted call
(`_acquire_stacks`, a ``lax.map`` over a packed per-stack geometry batch)
and the whole reconstruction another (`_recon_stacks`, accumulating
value/weight sums and finalizing in-program), so a sample costs two
dispatches whatever its stack count. Per-stack single-dispatch jits
(`_acquire_stack`, `_recon_stack`) remain for the A/B parity tests —
arbitrary stack orientations run through a ``lax.switch`` over the 24 cube
rotations plus traced shear passes (``ops.warp.warp_rigid_pair_traced``),
and the per-slice motion fields are built ON DEVICE from (NS, 3, 4) affine
tables instead of shipping host-built fields.

Parity with the reference per-stack loop (``simulate_reco.py:366-440``):
slice validity comes from PSF-free mask-slice acquisition (``:385-420``),
zero-valid-slice stacks are redrawn (``:366`` retry), the stack that would
exceed ``max_num_slices`` is discarded (``:425-430``), and the recon uses the
distinct ``psf_rec`` (``:338-344``) including its in-plane spread. Standalone
``Scanner``/``PSFReconstructor`` classes mirror the reference API, including
``resolution_recon != resolution`` (logical-extent recon grid on the static
buffer).

Known deviations (documented): the slice FOV is a static tiered grid —
the smallest of ``tiers`` (default 384/512/640) covering the reference's
dynamic FOV
``ceil(sqrt(sum(sh^2)/2)/rs/32)*32`` (``simulate_reco.py:349-354``), so each
tier compiles once and extra FOV beyond the reference's ``ss`` is physically
inert (validity thresholds are ratios, recon placement is extent-agnostic);
slices are kept padded to ``ns_grid`` with a validity mask instead of
compacted (the stream sizes ``ns_grid`` to the config's worst case,
``max(shape)*res/gap_min + 2`` rounded to 32 — see
``parallel.input_pipeline.SyntheticStream``); merge-weight Gaussian centers
use a device top-k instead of
``randperm`` (same distribution class).

Replay: all host scalar draws derive from ``rng`` seeded by the artifact key;
the returned metadata embeds ``rng_key`` so a sample replays voxel-exactly
from the genparams dict alone (plus explicit pins for resolution_slice /
slice_thickness / gap, honored like the reference contract).

RNG-stream note: host draws are internally deterministic (seeded stream +
draw-then-override), but the *order* of draws diverges from the reference's
sequential loop — the v3 batch draws geometry for all ``Kb`` attempts per
round up front, consuming draws the reference's loop would never make once
``num_stacks``/overflow is hit. Same-seed outputs therefore differ from the
reference (and from the retired v2 path); replay from the returned metadata
is exact either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.linops import (
    apply_axis_matrix,
    interp_matrix,
    toeplitz_blur_matrix,
)
from ...ops.morphology import box_sum
from ...ops.noise import fractal_noise_3d, mog_3d
from ...ops.warp import (
    decompose_affine_paeth_host,
    hat_pass,
    hat_pass_pair,
    warp_rigid_pair_traced,
)
from .motion import sample_motion
from .psf import GAUSSIAN_FWHM, SINC_FWHM
from .quality import ReconMergeParams, masked_random_centers
from .transforms import (
    RigidTransform,
    interleave_index,
    random_angle,
    random_init_stack_transforms,
    reset_transform,
)

# Default static grid tiers. Each scan picks the smallest tier covering the reference's dynamic slice FOV
# ``ceil(sqrt(sum(sh^2)/2)/rs/32)*32`` (``simulate_reco.py:349-354``): 384
# covers every 256^3 case at rs >= 0.82, 512 down to rs >= 0.62, 640 down to
# rs = 0.49 (the default config's floor is rs = fac_min = 0.5). NS covers
# ns = max_dim*res/gap_min + 2 for gap >= 1.5mm; it is rs-independent.
DEFAULT_TIERS = (384, 512, 640)
NS = 128  # default max slices per stack (ns_grid)

_FLIP = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float32)
_BLUR_HALF = 12  # covers 3 sigma of the largest thickness/res ratio (3.5/0.5)


def slice_grid(shape, rs: float, slice_size: int | None = None, tiers=DEFAULT_TIERS) -> int:
    """Static stack-frame cube edge for one scan.

    Mirrors the reference's dynamic slice size
    (``simulate_reco.py:349-354``): ``ss = ceil(sqrt(sum(vs^2)/2)/rs/32)*32``
    when ``slice_size`` is unset, else ``slice_size`` itself — rounded UP to
    the smallest available tier so each tier compiles exactly once. FOV
    beyond the reference's ``ss`` is physically inert (ratio-based validity,
    extent-agnostic recon placement); a need above the largest tier is capped
    to it (documented deviation for configs below rs = 0.49).
    """
    if slice_size is not None:
        need = int(slice_size)
    else:
        need = int(np.ceil(np.sqrt(sum(s * s for s in shape) / 2.0) / rs / 32.0) * 32)
    need = max(need, max(shape))  # the cube also holds the padded volume
    for c in sorted(tiers):
        if c >= need:
            return int(c)
    return int(max(tiers))


@dataclass
class ScannerParams:
    """Schema parity with reference ``artifacts/utils.py:10-38``."""

    resolution_slice_fac_min: float
    resolution_slice_fac_max: float
    resolution_slice_max: float
    slice_thickness_min: float
    slice_thickness_max: float
    gap_min: float
    gap_max: float
    min_num_stack: int
    max_num_stack: int
    max_num_slices: int
    noise_sigma_min: float
    noise_sigma_max: float
    TR_min: float
    TR_max: float
    prob_void: float
    prob_gamma: float
    gamma_std: float
    slice_size: int | None = None
    restrict_transform: bool = False
    txy: float = 3.0
    resolution_recon: float | None = None
    slice_noise_threshold: float = 0.1


@dataclass
class ReconParams:
    """Schema parity with reference ``artifacts/utils.py:67-78``."""

    prob_misreg_slice: float
    slices_misreg_ratio: float
    prob_misreg_stack: float
    txy: float
    prob_smooth: float
    prob_rm_slices: float
    rm_slices_min: float
    rm_slices_max: float
    prob_merge: float
    merge_params: ReconMergeParams


# ---------------------------------------------------------------------------
# Device helpers (traced; shapes static)
# ---------------------------------------------------------------------------


def _pad_centered(vol: jnp.ndarray, cube: int) -> jnp.ndarray:
    """Zero-pad to a centered (cube, cube, cube) buffer."""
    pads = []
    for s in vol.shape:
        lo = (cube - s) // 2
        pads.append((lo, cube - s - lo))
    return jnp.pad(vol, pads)


def _slice_coef_tables(G, rs, c_ss, z0, gap, ns_grid):
    """(dz dict, dv_tab, du_tab) for one stack's extraction — shared by the
    big voxel-frame (``_acquire_one``) and small px-frame
    (``batched._acquire_one_small``) acquisition paths so the dz/dv/du laws
    cannot diverge between the two engines."""
    nidx = jnp.arange(ns_grid, dtype=jnp.float32)
    dv_tab, du_tab = _inplane_coef_tables(G, rs, c_ss, 1.0)
    dz = {
        "coef": jnp.stack(
            [G[:, 0, 1], G[:, 0, 2], G[:, 0, 3] - (z0 + nidx * gap)], -1
        ),
        "rs": rs,
        "c_ss": c_ss,
    }
    return dz, dv_tab, du_tab


def _inplane_coef_tables(G, rs, c_ss, sign: float):
    """(NS, 4) per-slice coefficient tables for the dv/du hat passes.

    The in-plane deviations are AFFINE per slice, so each pass's position is
    ``pos = cj*row_j + ck*lane + bias`` with per-slice scalars — expressed
    as the hat pass's per-slice coef-table form (``hat_pass_pair``), no
    materialized displacement volume. ``sign=+1`` gives the acquisition
    deviation, ``-1`` the reconstruction inverse (pos = lane -+ dev).

    dv pass runs on (n, u, v) layout (row_j = u, lane = v):
      pos = v + sign*[(a-1)(v-c) + b(u-c) + (g-c)/rs],
      a = G[n,1,1], b = G[n,1,2], g = G[n,1,3].
    du pass runs on (n, v, u) layout (row_j = v, lane = u), rows 2 of G.
    """
    z = jnp.zeros_like(G[:, 0, 0])

    def tab(a, b, g):
        ck = 1.0 + sign * (a - 1.0)
        cj = sign * b
        bias = sign * (-(a - 1.0) * c_ss - b * c_ss + (g - c_ss) / rs)
        return jnp.stack([z, cj, ck, bias], -1)

    dv_tab = tab(G[:, 1, 1], G[:, 1, 2], G[:, 1, 3])
    du_tab = tab(G[:, 2, 2], G[:, 2, 1], G[:, 2, 3])
    return dv_tab, du_tab


def _extract_pair(Wv, Wm, gap_vox, z0, dz, dv, du, cube, ns_grid, split_dz=False):
    """Sample NS slices from (volume, mask) stack frames with shared motion.

    The z extraction ``out(n) = V[z0 + gap_vox*n + dz(n)]`` has lane slope
    ``gap_vox`` (3-11 at default configs). It is factored into a slope-1
    deviation pass and a resolution-changing matmul:

      1. a unit-slope deviation pass ``V'[z] = V[z + dz(n_near(z))]`` where
         ``n_near(z)`` is the NEAREST slice index of z, and
      2. an affine interpolation matmul ``out(n) = V'[z0 + gap_vox*n]`` on
         ``interp_matrix``.

    For ``gap_vox > 2`` the factorization is EXACT (not first-order): both
    integer-z taps of step 2 lie within half a gap of slice n, so
    ``n_near`` maps them to n and step 1 already displaced them by exactly
    ``dz(n)``. (Interleaved acquisition makes dz(n) non-smooth across n, so
    exactness per-slice matters; a linear-in-n resampling of dz would mix
    adjacent slices' motion states.) Default configs give
    ``gap_vox = gap/res >= 3``.

    ``split_dz`` (stream-only dz-split): the per-slice plane-center
    TRANSLATION ``t(n) = G[n, 0, 3] - (z0 + gap*n)`` moves out of the hat
    pass into the extraction matmul (``Mzn = interp_matrix(G[:, 0, 3])``),
    leaving a TILT-only deviation. Fidelity: at each slice's plane center the tilt deviation is zero, so
    the factorization degenerates to ONE interpolation (the reference's
    direct sampling) instead of the exact path's hat+matmul composition;
    the z-lane -> slice attribution becomes nearest-by-actual-position,
    which hands a z-lane the neighbouring slice's TILT when motion pushes
    two slice planes within ~a voxel of each other. Real fetal motion
    crosses slice planes constantly (interleaved acquisition + recorded
    trajectories), so ``split_dz`` accepts a TRACED per-stack flag — the
    packer (``batched.pack_motion``) raises it only for stacks whose plane
    positions stay separated (attribution provably exact); the tables
    blend so a zero flag reproduces the exact path bit-for-bit in the same
    program. A/B-bounded vs the exact engine in
    ``tests/test_batched_artifacts.py``.
    """
    pair = Wm is not None
    x = Wv  # already (v, u, z): the rigid warp emits out_perm=(1, 2, 0)
    m = Wm
    lanes = jnp.arange(cube, dtype=jnp.float32)
    nidx = jnp.arange(ns_grid, dtype=jnp.float32)
    rs, c_ss = dz["rs"], dz["c_ss"]
    use_split = split_dz is not False and split_dz is not None
    if use_split:
        # okf in {0., 1.}: 1 -> dz-split tables, 0 -> exact tables (the
        # blend is affine in okf, so both modes live in ONE program and a
        # per-stack traced flag costs no extra branch)
        okf = jnp.asarray(split_dz, jnp.float32)
        # plane-center positions (padded table rows replicate the last real
        # slice's geometry — argmin ties resolve to the real row)
        pos_n = z0 + gap_vox * nidx + dz["coef"][:, 2] * okf
        n_near_b = jnp.clip(
            jnp.round((lanes - z0) / gap_vox), 0, ns_grid - 1
        ).astype(jnp.int32)
        n_near_s = jnp.argmin(
            jnp.abs(lanes[:, None] - pos_n[None, :]), axis=1
        ).astype(jnp.int32)
        n_near = jnp.where(okf > 0.5, n_near_s, n_near_b)
        Mzn = interp_matrix(pos_n, cube)
    else:
        okf = None
        n_near = jnp.clip(
            jnp.round((lanes - z0) / gap_vox), 0, ns_grid - 1
        ).astype(jnp.int32)
        Mzn = interp_matrix(z0 + gap_vox * nidx, cube)
    # dz is affine per slice (dz = a1*vn + a2*un + a3), so dz(n_near(z)) is
    # a row gather of the coefficient table feeding the hat pass's
    # LANE-AFFINE table form (disp = A0[z]*row_i + A1[z]*row_j + A2[z],
    # rows = (v, u)) — no cube^3 displacement volume is ever materialized.
    # A gather, not a one-hot contraction: an f32 contraction at default
    # precision may run in TF32 and round the coefficients.
    a123 = dz["coef"][n_near]  # (cube, 3)
    # with the split engaged (okf = 1) the a3 translation rides Mzn and the
    # hat pass keeps the tilt only (zero at the plane center v = u = c_ss)
    a3_eff = a123[:, 2] * (1.0 - okf) if use_split else a123[:, 2]
    dz_tab = jnp.stack(
        [
            a123[:, 0] * rs,
            a123[:, 1] * rs,
            a3_eff - (a123[:, 0] + a123[:, 1]) * rs * c_ss,
        ]
    )  # (3, cube)
    from ...ops.linops import einsum_store
    if pair:
        x, m = hat_pass_pair(
            x, m, (0.0, 0.0, 1.0, 0.0), dz_tab, (cube, cube, cube), modes=(False, False)
        )
        # n-extraction emitting (n, u, v) directly — the relayout rides the
        # matmul epilogue instead of a separate full-volume transpose
        m = einsum_store("oi,jki->okj", Mzn, m)
    else:
        x = hat_pass(x, (0.0, 0.0, 1.0, 0.0), dz_tab, (cube, cube, cube), False)
    x = einsum_store("oi,jki->okj", Mzn, x)  # (n, u, v)
    # dv/du are per-slice AFFINE — coef-table passes, no displacement volume
    if pair:
        x, m = hat_pass_pair(
            x, m, dv, None, (ns_grid, cube, cube), modes=(False, False)
        )
        m = jnp.transpose(m, (0, 2, 1))
    else:
        x = hat_pass(x, dv, None, (ns_grid, cube, cube), False)
    x = jnp.transpose(x, (0, 2, 1))  # (n, v, u)
    if pair:
        x, m = hat_pass_pair(
            x, m, du, None, (ns_grid, cube, cube), modes=(False, False)
        )
    else:
        x = hat_pass(x, du, None, (ns_grid, cube, cube), False)
    return x, m


def _slice_artifacts(
    key, slices, valid, gamma, gamma_on, sigma, void_prob, threshold, fast=False
):
    """Per-slice gamma, Rician noise, and signal voids
    (reference ``simulate_reco.py:210-298``), over the VALID slices.

    ``fast`` (stream-only, like the coarse-validity mode): draw ONE normal
    field and take the Rician quadrature partner as a large-offset roll of
    it — pointwise the two components are still independent N(0, sigma)
    samples (distinct indices of an iid field), only a long-range noise-field
    correlation is introduced. Halves the per-stack threefry cost, which is
    the largest non-matmul item in the acquisition.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    vmask = valid[:, None, None]
    # gamma (simulate_reco.py:210-234): normalization max over kept slices
    g = 300.0 * jnp.power(jnp.maximum(slices, 0.0) / 300.0, gamma)
    g = g / jnp.maximum(jnp.max(g * vmask), 1e-6)
    slices = jnp.where(gamma_on, g, slices)
    # Rician noise over voxels above threshold (simulate_reco.py:236-256);
    # both components from one threefry call
    if fast:
        n1 = jax.random.normal(k1, slices.shape) * sigma
        n12 = jnp.stack([n1, jnp.roll(n1, (1, slices.shape[1] // 2), (0, 1))])
    else:
        n12 = jax.random.normal(k1, (2,) + slices.shape) * sigma
    noisy = jnp.sqrt((slices + n12[0]) ** 2 + n12[1] ** 2)
    slices = jnp.where(slices > threshold, noisy, slices)
    # signal voids (simulate_reco.py:258-298)
    n = slices.shape[0]
    on = jax.random.uniform(k3, (n, 1, 1)) < void_prob
    h = w = slices.shape[1]
    y = jnp.linspace(-(h - 1) / 2, (h - 1) / 2, h)[None, :, None]
    x = jnp.linspace(-(w - 1) / 2, (w - 1) / 2, w)[None, None, :]
    ku = jax.random.uniform(k4, (6, n, 1, 1))
    yc = (ku[0] - 0.5) * (h - 1)
    xc = (ku[1] - 0.5) * (w - 1)
    theta = 2 * jnp.pi * ku[2]
    xv = jnp.cos(theta) * (x - xc) - jnp.sin(theta) * (y - yc)
    yv = jnp.sin(theta) * (x - xc) + jnp.cos(theta) * (y - yc)
    a = 30 + ku[3] * 90
    A = ku[4] * 0.5 + 0.5
    sx = ku[5] * 30 + 39
    sy = a**2 / sx
    mask = 1 - A * jnp.exp(-0.5 / sx**2 * xv**2 - 0.5 / sy**2 * yv**2)
    return jnp.where(on, slices * mask, slices)


def _coarse_mask(mask_p: jnp.ndarray, f: int = 4) -> jnp.ndarray:
    """Box-mean pool the PADDED cube mask by ``f`` for coarse validity.

    Pooling the padded cube (not the raw volume) makes the coarse grid's
    voxel centers land exactly on ``f*i + (f-1)/2`` fine positions, so the
    coarse center ``(S/f - 1)/2`` maps to the fine center ``(S-1)/2`` and
    every centered stage of the rigid warp stays aligned without offset
    corrections (only the final zoom's delta needs rescaling — see
    :func:`_valid_coarse`).
    """
    # reduce_window pools in place, with no 6-D (c, f, c, f, c, f) reshape
    # intermediate
    return jax.lax.reduce_window(
        mask_p, 0.0, jax.lax.add, (f, f, f), (f, f, f), "VALID"
    ) * (1.0 / (f * f * f))


def _valid_coarse(
    cmask, q_idx, angles, wscale, wdelta, G, thr_frac, ns_count,
    cube: int, ns_grid: int, f: int = 4, zoom_first: bool = False,
):
    """Slice-validity flags from a coarse warped mask z-profile.

    The exact path derives validity from per-slice masses of the fully
    warped+extracted mask stack — but the threshold is RELATIVE
    (``nnz > max(nnz) * thr_frac``, ``simulate_reco.py:408-420``), so any
    mass-preserving stage (in-plane scale, dv/du deviations) cancels out.
    What remains is the z-profile of the rigidly warped mask sampled at each
    slice plane's center ``z = G[n, 0, 3]`` — computed here on an
    ``f``-times-coarser grid (~1-2% of the exact cost). STREAM-ONLY
    approximation (host path keeps the exact pair chain): through-plane
    tilt within a slice is collapsed to the plane center, which can flip a
    band-edge slice whose mass sits at the threshold.
    """
    delta_c = (wdelta + ((f - 1) / 2.0) * (wscale - 1.0)) / f
    if zoom_first:
        # small-frame mode (wscale = rs > 1): the zoom-last path's shears
        # would clip the rotated coarse mask inside the small coarse buffer;
        # the zoom-first ordering shrinks content before rotating
        from ...ops.warp import warp_rigid_zoom_first

        wm = warp_rigid_zoom_first(cmask, q_idx, angles, wscale, delta_c)
    else:
        wm, _ = warp_rigid_pair_traced(
            cmask, None, q_idx, angles, wscale, delta_c, modes=(False, False)
        )
    prof = jnp.sum(wm, (1, 2))  # (cube/f,) z mass profile
    pos_c = (G[:, 0, 3] - (f - 1) / 2.0) / f
    Mz = interp_matrix(pos_c, cube // f)  # (ns_grid, cube/f)
    from ...ops.linops import _prec

    nnz = jnp.matmul(Mz, prof, precision=_prec())
    arange_n = jnp.arange(ns_grid)
    nnz = nnz * (arange_n < ns_count)
    thr = jnp.max(nnz) * thr_frac
    valid = nnz > thr
    first = jnp.min(jnp.where(valid, arange_n, ns_grid))
    last = jnp.max(jnp.where(valid, arange_n, -1))
    valid = (arange_n >= first) & (arange_n <= last) & (arange_n < ns_count)
    return valid.astype(jnp.float32)


def _acquire_one(
    vol_p,
    mask_p,
    q_idx,
    angles,
    wscale,
    wdelta,
    G,
    rs,
    gap_vox,
    z0,
    sig,
    thr_frac,
    ns_count,
    key,
    gamma,
    gamma_on,
    sigma,
    void_prob,
    threshold,
    cube: int,
    ns_grid: int,
    coarse_mask=None,
    split_dz: bool = False,
):
    """One stack's acquisition, traced (inputs already padded to the cube).

    Returns (slices (NS, SS, SS), valid (NS,) f32). Mirrors the reference
    stack-loop body (``simulate_reco.py:366-424``).

    ``coarse_mask`` (from :func:`_coarse_mask`) switches validity to the
    coarse z-profile proxy (:func:`_valid_coarse`) and drops the mask
    operand from every full-resolution pass — the stream's fast mode.
    """
    # acquisition PSF blur (volume only; mask slices are PSF-free,
    # simulate_reco.py:399-407) + xy scale to slice-pixel spacing. Blur and
    # scale are separable per-axis operators IN THE STACK FRAME — exactly
    # the frame the rigid warp's final zoom matmuls emit — so they compose
    # into the warp's three volume contractions (small matrix products; see
    # warp_rigid_pair_traced post_a/post_b) instead of paying 5 more.
    from ...ops.linops import _prec

    c_ss = (cube - 1) / 2.0
    lanes = jnp.arange(cube, dtype=jnp.float32)
    scale_m = interp_matrix((lanes - c_ss) * rs + c_ss, cube)
    sb1 = jnp.matmul(scale_m, toeplitz_blur_matrix(sig[1], cube, _BLUR_HALF), precision=_prec())
    sb2 = jnp.matmul(scale_m, toeplitz_blur_matrix(sig[2], cube, _BLUR_HALF), precision=_prec())
    fast = coarse_mask is not None
    # emit_f32=False: under the stream's storage scope the warp may hand the
    # extract chain bf16 (the hat passes read and write the storage dtype); outside a
    # scope this is a no-op and the host path stays f32
    Wv, Wm = warp_rigid_pair_traced(
        vol_p, None if fast else mask_p, q_idx, angles, wscale, wdelta,
        modes=(False, False),
        post_a=(toeplitz_blur_matrix(sig[0], cube, _BLUR_HALF), sb1, sb2),
        post_b=None if fast else (None, scale_m, scale_m),
        out_perm=(1, 2, 0),  # emit (v, u, z) for the extract chain
        emit_f32=False,
    )

    # dz kept in per-slice affine-coefficient form (see _extract_pair);
    # dv/du as per-slice coef TABLES (no displacement volumes at all)
    dz, dv_tab, du_tab = _slice_coef_tables(G, rs, c_ss, z0, gap_vox, ns_grid)

    slices, mslices = _extract_pair(
        Wv, Wm, gap_vox, z0, dz, dv_tab, du_tab, cube, ns_grid,
        split_dz=split_dz,
    )

    if fast:
        valid_f = _valid_coarse(
            coarse_mask, q_idx, angles, wscale, wdelta, G, thr_frac, ns_count,
            cube, ns_grid,
        )
    else:
        # validity from the PSF-free mask-slice mass (simulate_reco.py:408-420)
        arange_n = jnp.arange(ns_grid)
        nnz = jnp.sum(mslices, (1, 2)) * (arange_n < ns_count)
        thr = jnp.max(nnz) * thr_frac
        valid = nnz > thr
        first = jnp.min(jnp.where(valid, arange_n, ns_grid))
        last = jnp.max(jnp.where(valid, arange_n, -1))
        valid = (arange_n >= first) & (arange_n <= last) & (arange_n < ns_count)
        valid_f = valid.astype(jnp.float32)

    slices = _slice_artifacts(
        key, slices, valid_f, gamma, gamma_on, sigma, void_prob, threshold,
        fast=fast,
    )
    return slices, valid_f


@partial(jax.jit, static_argnames=("cube", "ns_grid"))
def _acquire_stack(
    vol, mask, q_idx, angles, wscale, wdelta, G, rs, gap_vox, z0, sig,
    thr_frac, ns_count, key, gamma, gamma_on, sigma, void_prob, threshold,
    cube: int, ns_grid: int,
):
    """Single-stack acquisition program (kept for the A/B parity tests;
    the production path batches stacks through :func:`_acquire_stacks`).
    Replay-faithful: pinned to f32 semantics (``linops.f32_scope``)."""
    from ...ops.linops import f32_scope

    with f32_scope():
        return _acquire_one(
            _pad_centered(vol, cube), _pad_centered(mask, cube),
            q_idx, angles, wscale, wdelta, G, rs, gap_vox, z0, sig,
            thr_frac, ns_count, key, gamma, gamma_on, sigma, void_prob,
            threshold, cube, ns_grid,
        )


@partial(jax.jit, static_argnames=("cube", "ns_grid"))
def _acquire_stacks(
    vol,
    mask,
    q_idx,      # (K,) int32 quarter-turn indices
    angles,     # (K, 3) residual Euler angles
    wscale,     # (K,) isotropic zoom
    wdelta,     # (K, 3) shifts
    G,          # (K, NS, 3, 4) per-slice affine tables
    scal,       # (K, 4) packed [thr_frac, gamma, gamma_on, sigma]
    attempt_id, # (K,) int32 — key = fold_in(key, 100 + attempt_id)
    rs,
    gap_vox,
    z0,
    sig,
    ns_count,
    key,
    void_prob,
    threshold,
    cube: int,
    ns_grid: int,
):
    """ALL stacks of one scan in a single XLA program.

    ``lax.map`` over the packed per-stack geometry: the volume pads once and
    every stack reuses it; one dispatch and one packed argument transfer
    serve every stack of the scan.

    Returns (slices (K, NS, SS, SS), valid (K, NS)).
    """
    from ...ops.linops import f32_scope

    def _run():
        vol_p = _pad_centered(vol, cube)
        mask_p = _pad_centered(mask, cube)

        def body(per_stack):
            qi, ang, ws, wd, g, sc_, aid = per_stack
            skey = jax.random.fold_in(key, 100 + aid)
            return _acquire_one(
                vol_p, mask_p, qi, ang, ws, wd, g, rs, gap_vox, z0, sig,
                sc_[0], ns_count, skey, sc_[1], sc_[2] > 0.5, sc_[3],
                void_prob, threshold, cube, ns_grid,
            )

        return jax.lax.map(body, (q_idx, angles, wscale, wdelta, G, scal, attempt_id))

    # replay-faithful host program: pin f32 semantics (linops.f32_scope)
    with f32_scope():
        return _run()


def _recon_one(
    slices,
    keep_f,
    Grec,
    rs,
    gap_vox,
    z0,
    sig_rec,
    qinv_idx,
    inv_angles,
    inv_scale,
    inv_delta,
    cube: int,
    ns_grid: int,
    out_shape: tuple,
    split_dz: bool = False,
    coarse_inv=None,
):
    """One stack's reconstruction placement, traced.

    Returns (value, weight) on the recon grid (``out_shape`` corner of the
    static buffer). Mirrors ``PSFreconstruction``/adjoint placement
    (``simulate_reco.py:38-54, 769``) with the recon PSF spread.

    ``split_dz`` (stream-only dz-split, mirror of ``_extract_pair``'s): the
    per-slice plane-center translation ``t(n) = Grec[n,0,3] - base_z(n)``
    moves out of the slice-index hat pass into the n->z placement matmul
    (column-shifted hats: slice n places about its ACTUAL center
    ``Grec[n,0,3]``), leaving a tilt-only deviation. The lane-n pass's
    blocks span up to 128 slices, so its tap spread currently covers the
    whole stack's translation range — the split removes it. Placement
    columns use hat falloff (no edge clamp): z rows outside the slab get
    zero weight, matching the reference adjoint's PSF falloff
    (``simulate_reco.py:38-54``) rather than interp_matrix's row clamping.

    ``coarse_inv`` (stream-only): ``(cqinv, ciang, ciscl, cidlt)`` from
    ``batched._coarse_inv_decomp`` switches the WEIGHT chain onto pooled
    grids — stack frame pooled by ``f = cube // 128`` (always a 128 cube),
    recon frame pooled by 2 — with the final weight bilinearly upsampled to
    ``out_shape``. The weight field is a function of geometry and
    ``keep_f`` only (never of image data) and is smooth at the pooling
    scale except within ~gap of dropped-slice dips, so ``value/weight``
    stays within a test-pinned bound of the exact chain while the weight's
    share of the recon cost (half the dz pair pass, one of the two Mn2z
    einsums/spreads, and half the final rigid pair warp) drops to the 128^3
    grid. Requires ``cube % 128 == 0`` and even ``out_shape``.
    """
    c_ss = (cube - 1) / 2.0
    lanes = jnp.arange(cube, dtype=jnp.float32)
    nidx = jnp.arange(ns_grid, dtype=jnp.float32)
    base_z = z0 + nidx * gap_vox
    # every deviation is affine per slice: dv/du as per-slice coef tables
    # (sign -1: inverse deviations), dz as the hat pass's lane-affine table
    # (slice index n is the LANE axis of its pass, rows = (u, v))
    g1, g2, g3 = Grec[:, 0, 1], Grec[:, 0, 2], Grec[:, 0, 3]
    use_split = split_dz is not False and split_dz is not None
    okf = jnp.asarray(split_dz, jnp.float32) if use_split else None
    t_eff = (g3 - base_z) * (1.0 - okf) if use_split else (g3 - base_z)
    dzr_tab = jnp.stack(
        [
            -g2 * rs / gap_vox,
            -g1 * rs / gap_vox,
            (-t_eff + (g1 + g2) * rs * c_ss) / gap_vox,
        ]
    )  # (3, ns_grid) — with the split engaged the translation rides Mn2z
    dv_tab, du_tab = _inplane_coef_tables(Grec, rs, c_ss, -1.0)

    from ...ops.linops import _prec

    inv_scale_m = interp_matrix((lanes - c_ss) / rs + c_ss, cube)
    sigz_m = toeplitz_blur_matrix(sig_rec[0], cube, _BLUR_HALF)
    # in-plane recon blur composes with the inverse scale: one matmul/axis
    inv_scale_blur_m = jnp.matmul(
        inv_scale_m, toeplitz_blur_matrix(sig_rec[1], cube, _BLUR_HALF),
        precision=_prec(),
    )

    masked = slices * keep_f[:, None, None]

    # First-order inverse motion, applied IN SLICE SPACE (mirrors the
    # forward chain in reverse: du, dv in-plane passes on the (NS, SS, SS)
    # stacks — 3x less data than the recon cube — then the slice-index
    # deviation pass, then the affine n->z placement as an interp
    # matmul). The per-slice deviations are used DIRECTLY (no resampling of
    # the non-smooth interleaved motion states across slice indices); the
    # z placement's lane slope 1/gap_vox lives entirely in the matmul, so
    # every hat pass is slope-1 (see _extract_pair).
    #
    # The WEIGHT field skips the in-plane passes exactly: it is constant per
    # slice (a broadcast of keep_f), and an edge-clamped hat pass maps a
    # constant row to itself — w only starts changing at the slice-index
    # deviation pass, where adjacent slices' weights mix.
    x = hat_pass(masked, du_tab, None, (ns_grid, cube, cube), False)
    x = jnp.transpose(x, (0, 2, 1))  # (n, u, v)
    x = hat_pass(x, dv_tab, None, (ns_grid, cube, cube), False)
    x = jnp.transpose(x, (1, 2, 0))  # (u, v, n)
    # This is the one pass with the slice axis last: a 32-granular ns_grid
    # pads up to a multiple of 128 here. Padded lanes carry zero value and
    # zero keep weight — exactly what a 128 slice grid holds beyond ns — so
    # the output on the real lanes is bit-identical to running at
    # ns_grid=128 (the edge clamp sits at the same padded lane).
    nsp = -(-ns_grid // 128) * 128
    keep_l = keep_f
    dzr_l = dzr_tab
    if nsp != ns_grid:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, nsp - ns_grid)))
        keep_l = jnp.pad(keep_f, (0, nsp - ns_grid))
        dzr_l = jnp.pad(dzr_tab, ((0, 0), (0, nsp - ns_grid)))
    if coarse_inv is None:
        w = jnp.broadcast_to(
            keep_l[None, None, :], (cube, cube, nsp)
        ).astype(jnp.float32)
        x, w = hat_pass_pair(
            x, w, (0.0, 0.0, 1.0, 0.0), dzr_l,
            (cube, cube, nsp), modes=(False, False),
        )
    else:
        x = hat_pass(x, (0.0, 0.0, 1.0, 0.0), dzr_l, (cube, cube, nsp), False)
        w = None
    if nsp != ns_grid:
        x = x[..., :ns_grid]
        if w is not None:
            w = w[..., :ns_grid]
    # n->z placement and the z-thickness recon PSF act on the same axis in
    # the same frame — one composed (cube, ns_grid) matmul for both, whose
    # einsum emits (z, v, u) directly (no separate transpose).
    if use_split:
        # column-shifted placement hats: with the split engaged slice n's
        # hat (width gap_vox in z) centers on its actual plane
        # z = Grec[n,0,3]; with okf = 0 the centers are base_z and this is
        # exactly interp_matrix((lanes-z0)/gap, ns_grid). Rows outside the
        # nominal slab keep the exact operator's EDGE-CLAMP semantics
        # (interp_matrix clips coords to [0, ns-1], replicating the first /
        # last slice) — a plain hat falloff there diverges from the exact
        # engine wherever ns_grid's slab does not cover the whole frame.
        centers = base_z + (g3 - base_z) * okf
        d = (lanes[:, None] - centers[None, :]) / gap_vox
        Mplace = jnp.maximum(0.0, 1.0 - jnp.abs(d))
        qz = (lanes - z0) / gap_vox
        colsn = jax.lax.broadcasted_iota(jnp.int32, (cube, ns_grid), 1)
        Mplace = jnp.where(
            (qz < 0)[:, None],
            (colsn == 0).astype(jnp.float32),
            jnp.where(
                (qz > ns_grid - 1)[:, None],
                (colsn == ns_grid - 1).astype(jnp.float32),
                Mplace,
            ),
        )
        Mn2z = jnp.matmul(sigz_m, Mplace, precision=_prec())
    else:
        Mn2z = jnp.matmul(
            sigz_m, interp_matrix((lanes - z0) / gap_vox, ns_grid), precision=_prec()
        )
    # Mn2z -> spread -> rigid pair is one matmul-only segment: under the
    # stream's storage scope it stays bf16 end-to-end (the rigid warp casts
    # its inputs to the storage dtype itself and emits f32 at its boundary)
    from ...ops.linops import einsum_store

    x = einsum_store("oi,jki->okj", Mn2z, x)  # (z, v, u)

    def spread(y, m):
        # in-plane recon PSF (simulate_reco.py:338-344): sinc fused with the
        # inverse xy scale (2 contractions; the z part rode Mn2z above)
        y = apply_axis_matrix(y, m, 1)
        y = apply_axis_matrix(y, m, 2)
        return y

    if coarse_inv is None:
        w = einsum_store("oi,jki->okj", Mn2z, w)
        x, w = spread(x, inv_scale_blur_m), spread(w, inv_scale_blur_m)
        v_s, w_s = warp_rigid_pair_traced(
            x, w, qinv_idx, inv_angles, inv_scale, inv_delta,
            out_shape=out_shape, modes=(False, False),
        )
        return v_s, w_s

    # --- coarse weight chain (see docstring) -------------------------------
    x = spread(x, inv_scale_blur_m)
    v_s, _ = warp_rigid_pair_traced(
        x, None, qinv_idx, inv_angles, inv_scale, inv_delta,
        out_shape=out_shape, modes=(False, False),
    )

    f = max(1, cube // 128)
    cc = cube // f
    cqinv, ciang, ciscl, cidlt = coarse_inv
    # coarse (u, v) slice-index deviation pass: the pooled row index maps to
    # fine rows by u_f = f u_c + (f-1)/2, so the lane-affine table scales by
    # f with the center offset folded into the constant
    h = (f - 1) / 2.0
    dzr_c = jnp.stack(
        [dzr_l[0] * f, dzr_l[1] * f, dzr_l[2] + (dzr_l[0] + dzr_l[1]) * h]
    )
    w_c = jnp.broadcast_to(keep_l[None, None, :], (cc, cc, nsp)).astype(
        jnp.float32
    )
    w_c = hat_pass(w_c, (0.0, 0.0, 1.0, 0.0), dzr_c, (cc, cc, nsp), False)
    if nsp != ns_grid:
        w_c = w_c[..., :ns_grid]
    # fine-frame positions of the coarse lanes (identical for every axis
    # of the cube); used for the n->z placement (z axis) and the inverse
    # scale (in-plane axes). The blur kernels narrow to sigma/f.
    lane_f = f * jnp.arange(cc, dtype=jnp.float32) + h
    sigz_c = toeplitz_blur_matrix(sig_rec[0] / f, cc, _BLUR_HALF)
    if use_split:
        d_c = (lane_f[:, None] - centers[None, :]) / gap_vox
        Mp_c = jnp.maximum(0.0, 1.0 - jnp.abs(d_c))
        qz_c = (lane_f - z0) / gap_vox
        colsn_c = jax.lax.broadcasted_iota(jnp.int32, (cc, ns_grid), 1)
        Mp_c = jnp.where(
            (qz_c < 0)[:, None],
            (colsn_c == 0).astype(jnp.float32),
            jnp.where(
                (qz_c > ns_grid - 1)[:, None],
                (colsn_c == ns_grid - 1).astype(jnp.float32),
                Mp_c,
            ),
        )
        Mn2z_c = jnp.matmul(sigz_c, Mp_c, precision=_prec())
    else:
        Mn2z_c = jnp.matmul(
            sigz_c, interp_matrix((lane_f - z0) / gap_vox, ns_grid),
            precision=_prec(),
        )
    w_c = einsum_store("oi,jki->okj", Mn2z_c, w_c)  # (z_c, v_c, u_c)
    # coarse inverse-scale + in-plane PSF: coarse out lane -> fine position
    # -> fine source -> coarse source
    src_c = ((lane_f - c_ss) / rs + c_ss - h) / f
    m_c = jnp.matmul(
        interp_matrix(src_c, cc),
        toeplitz_blur_matrix(sig_rec[1] / f, cc, _BLUR_HALF),
        precision=_prec(),
    )
    w_c = spread(w_c, m_c)
    os_c = tuple(s // 2 for s in out_shape)
    w_c, _ = warp_rigid_pair_traced(
        w_c, None, cqinv, ciang, ciscl, cidlt, out_shape=os_c,
        modes=(False, False),
    )
    # bilinear upsample (recon frame pooled by 2): fine voxel p reads coarse
    # (p - 0.5) / 2, edge-clamped
    w_s = w_c
    for ax in range(3):
        up = interp_matrix(
            (jnp.arange(out_shape[ax], dtype=jnp.float32) - 0.5) / 2.0,
            os_c[ax],
        )
        w_s = apply_axis_matrix(w_s, up, ax)
    return v_s, w_s


@partial(jax.jit, static_argnames=("cube", "ns_grid", "out_shape"))
def _recon_stack(
    slices, keep_f, Grec, rs, gap_vox, z0, sig_rec,
    qinv_idx, inv_angles, inv_scale, inv_delta,
    cube: int, ns_grid: int, out_shape: tuple,
):
    """Single-stack reconstruction program (kept for the A/B parity tests;
    the production path batches stacks through :func:`_recon_stacks`).
    Replay-faithful: pinned to f32 semantics (``linops.f32_scope``)."""
    from ...ops.linops import f32_scope

    with f32_scope():
        return _recon_one(
            slices, keep_f, Grec, rs, gap_vox, z0, sig_rec,
            qinv_idx, inv_angles, inv_scale, inv_delta, cube, ns_grid, out_shape,
        )


@partial(jax.jit, static_argnames=("cube", "ns_grid", "out_shape"))
def _recon_stacks(
    slices,      # (K, NS, SS, SS)
    keep_f,      # (K, NS) — zero rows make a stack inert (no value, no weight)
    Grec,        # (K, NS, 3, 4)
    qinv_idx,    # (K,)
    inv_angles,  # (K, 3)
    inv_scale,   # (K,)
    inv_delta,   # (K, 3)
    rs,
    gap_vox,
    z0,
    sig_rec,
    volume_gt,
    smooth_on,
    merge_on,
    merge_weight,
    extent,      # (3,) int32 recon corner extent (out == 0 beyond it)
    cube: int,
    ns_grid: int,
    out_shape: tuple,
):
    """ALL stacks' reconstruction + equalize/smooth/merge in ONE program.

    ``lax.map`` over packed per-stack state; value/weight accumulate in the
    loop carry so the (K, D, H, W) per-stack grids never materialize.
    Replay-faithful: pinned to f32 semantics (``linops.f32_scope``).
    """
    from ...ops.linops import f32_scope

    _scope = f32_scope()

    def body(carry, per_stack):
        v_acc, w_acc = carry
        s, k, g, qi, ia, isc, idl = per_stack
        v_s, w_s = _recon_one(
            s, k, g, rs, gap_vox, z0, sig_rec, qi, ia, isc, idl,
            cube, ns_grid, out_shape,
        )
        return (v_acc + v_s, w_acc + w_s), None

    with _scope:
        zeros = jnp.zeros(out_shape, jnp.float32)
        (value, weight), _ = jax.lax.scan(
            body, (zeros, zeros),
            (slices, keep_f, Grec, qinv_idx, inv_angles, inv_scale, inv_delta),
        )
        out = _finalize_traced(
            value, weight, volume_gt, smooth_on, merge_on, merge_weight
        )
        ii = jax.lax.broadcasted_iota(jnp.int32, out_shape, 0)
        jj = jax.lax.broadcasted_iota(jnp.int32, out_shape, 1)
        kk = jax.lax.broadcasted_iota(jnp.int32, out_shape, 2)
        corner = (ii < extent[0]) & (jj < extent[1]) & (kk < extent[2])
        return jnp.where(corner, out, 0.0)


def _finalize_traced(value, weight, volume_gt, smooth_on, merge_on, merge_weight):
    """Equalize, optional box smooth, merge with GT
    (``simulate_reco.py:584-709``)."""
    ok = weight > 1e-2
    recon = jnp.where(ok, value / jnp.where(ok, weight, 1.0), 0.0)
    smoothed = box_sum(recon, 3) / 27.0
    recon = jnp.where(smooth_on, smoothed, recon)
    return jnp.where(merge_on, merge_weight * recon + (1 - merge_weight) * volume_gt, recon)



# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def _key_words(key) -> np.ndarray:
    """Raw uint32 words of a PRNG key (typed or legacy)."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(key))
    return np.asarray(key)


def _axis_affine(R_xyz: np.ndarray, t_xyz: np.ndarray, in_center, out_center):
    """xyz-space rigid (x fastest) -> axis-space affine mapping output grid
    indices to input grid indices: p_in = M q_out + t."""
    M = _FLIP @ R_xyz @ _FLIP
    t = np.asarray(in_center) - M @ np.asarray(out_center) + _FLIP @ t_xyz
    return M.astype(np.float32), t.astype(np.float32)


def _stack_geometry(Rb, mats_vox, shape, ns, cube, ns_grid, fs: float = 1.0):
    """Host geometry for one stack: frame map, traced-warp split, slice table.

    ``Rb``: the stack-init rotation (xyz space); ``mats_vox``: per-slice
    trans-first rigids with voxel-unit translations.

    ``fs != 1`` (stream small-frame mode): the stack frame's units are
    ``fs`` voxels (slice px) on a ``cube`` buffer — the forward map gains
    an isotropic scale ``fs`` and the slice table's translations rescale
    (the ``fs == 1`` branch is bit-identical to the original path, which
    the host goldens pin).
    """
    c_vol = (np.asarray(shape) - 1) / 2.0
    c_stack = np.full(3, (cube - 1) / 2.0)
    M = _FLIP @ Rb @ _FLIP
    A = fs * M if fs != 1.0 else M
    t_stack = c_vol - A @ c_stack
    # fwd map on the zero-PADDED cube: p_pad = A q + t_stack + off
    off = np.array([(cube - s) // 2 for s in shape], np.float64)
    fwd = decompose_affine_paeth_host(A, t_stack + off, cube)
    Minv_np = np.linalg.inv(M)
    if fs == 1.0:
        G = _slice_affine_table(mats_vox, Minv_np, t_stack, c_vol, ns, ns_grid)
    else:
        G = _slice_affine_table(
            mats_vox, Minv_np, c_vol, c_vol, ns, ns_grid, fs=fs,
            c_frame=(cube - 1) / 2.0,
        )
    return dict(M=M, t_stack=t_stack, Minv=Minv_np, G=G, fwd=fwd)


def _slice_affine_table(mats_vox, Minv_np, t_stack, c_vol, ns, ns_grid, fs=1.0, c_frame=0.0):
    """(ns_grid, 3, 4) axis-space affines: slice-local coords -> stack frame.

    Vectorized over the slice axis (one einsum batch instead of ``ns_grid``
    small host matmuls — the batched stream packer builds B*Kb of these
    tables per batch, so the loop form was a host hot spot).

    ``fs``/``c_frame`` (stream small-frame mode): emit the translation
    column in a stack frame whose units are ``fs`` voxels about center
    ``c_frame`` (pass ``t_stack = c_vol``) — the linear block is
    dimensionless and identical in both conventions, so only the
    translation rescales: ``t_px = Minv(ta - c_vol)/fs + c_frame``.
    """
    idx = np.minimum(np.arange(ns_grid), ns - 1)
    Rn = mats_vox[idx, :, :3].astype(np.float64)  # (NS, 3, 3)
    tn = mats_vox[idx, :, 3].astype(np.float64)  # (NS, 3)
    # _axis_affine(Rn, Rn @ tn, c_vol, 0) rows: M = F Rn F, t = c_vol + F Rn tn
    Ma = np.einsum("ij,njk,kl->nil", _FLIP.astype(np.float64), Rn, _FLIP.astype(np.float64))
    ta = c_vol + np.einsum("ij,njk,nk->ni", _FLIP.astype(np.float64), Rn, tn)
    G = np.empty((ns_grid, 3, 4), np.float32)
    G[:, :, :3] = np.einsum("ij,njk->nik", Minv_np, Ma)
    G[:, :, 3] = np.einsum("ij,nj->ni", Minv_np, ta - t_stack) / fs + c_frame
    return G


def _gt_to_recon(vol, seg, res: float, res_r: float):
    """Resample (volume, seg) to the recon grid (simulate_reco.py:319-333):
    center-aligned spacing ``res_r``, stored in the ``extent`` corner of the
    same static buffer (zeros beyond). Linear for the volume, nearest for seg.
    """
    from ...ops.linops import apply_separable

    shape = vol.shape
    scale = res_r / res
    Ms_lin, Ms_nst, extent = [], [], []
    for s in shape:
        nr = max(int(s * res / res_r), 1)
        extent.append(nr)
        c_rec = (nr - 1) / 2.0
        c_v = (s - 1) / 2.0
        coords = jnp.asarray(c_v + (np.arange(s) - c_rec) * scale, jnp.float32)
        Ms_lin.append(interp_matrix(coords, s, out_valid=nr))
        idx = jnp.clip(jnp.round(coords), 0, s - 1).astype(jnp.int32)
        cols = jax.lax.broadcasted_iota(jnp.int32, (s, s), 1)
        rows = jax.lax.broadcasted_iota(jnp.int32, (s, 1), 0)
        Ms_nst.append((cols == idx[:, None]).astype(jnp.float32) * (rows < nr))
    return (
        apply_separable(vol, tuple(Ms_lin)),
        apply_separable(seg, tuple(Ms_nst)),
        tuple(extent),
    )


class Scanner:
    """Reference-parity scanner (``simulate_reco.py:57-466``).

    ``scan(data, genparams)`` simulates multi-stack slice acquisition from
    ``data`` = {volume, mask, seg, resolution[, resolution_recon]} and returns
    the data dict extended with device slice stacks, validity masks, and the
    host-side transform state the reconstructor needs.
    """

    def __init__(
        self,
        params: ScannerParams | None = None,
        tiers: tuple = DEFAULT_TIERS,
        ns_grid: int = NS,
        **kw,
    ):
        self.p = params if params is not None else ScannerParams(**kw)
        self.tiers = tuple(tiers)
        self.ns_grid = int(ns_grid)

    def get_resolution(self, data, rng, genparams=None):
        """Sample res_slice / res_recon / thickness / gap
        (``simulate_reco.py:142-191``); genparams entries pin the draws.

        Laws (matching the reference formulas exactly):
        ``res_slice ~ U(fac_min*res, min(fac_max*res, res_max))`` — which at
        the default config spans **below** the volume resolution (0.25 mm at
        res = 0.5); ``res_recon = params.resolution_recon`` if configured
        (the reference's own ``SimulateMotion`` pins it to ``res``,
        ``artifacts.py:402``) else ``~ U(res, res_slice)``
        (``simulate_reco.py:174-177``). The pin key ``resolution_slice_fac``
        is honored as the reference spells it (``simulate_reco.py:163-170``
        uses the value directly as the slice resolution) alongside our
        ``resolution_slice``.
        """
        genparams = genparams or {}
        sp = self.p
        res = float(data["resolution"])
        # draw-then-override: pinned genparams must not skip rng draws, or
        # the host stream desynchronizes for every later value (breaking
        # rng_key replay)
        res_s = float(
            rng.uniform(
                sp.resolution_slice_fac_min * res,
                min(sp.resolution_slice_fac_max * res, sp.resolution_slice_max),
            )
        )
        pin = genparams.get("resolution_slice", genparams.get("resolution_slice_fac"))
        if pin is not None:
            res_s = float(pin)
        if sp.resolution_recon is not None:
            res_r = float(sp.resolution_recon)
        else:
            # draw a unit variate so a res_slice pin rescales the same draw
            # (stream length stays fixed; value law matches U(res, res_slice))
            res_r = res + float(rng.uniform(0.0, 1.0)) * (res_s - res)
        res_r = float(genparams.get("resolution_recon", res_r))
        s_thick = float(rng.uniform(sp.slice_thickness_min, sp.slice_thickness_max))
        s_thick = float(genparams.get("slice_thickness", s_thick))
        gap = float(rng.uniform(sp.gap_min, sp.gap_max))
        gap = float(genparams.get("gap", gap))
        data.update(
            resolution_slice=res_s, slice_thickness=s_thick, gap=gap, resolution_recon=res_r
        )
        return data

    def scan(self, data: dict, genparams: dict | None = None, rng=None, key=None):
        genparams = genparams or {}
        rng = rng or np.random.default_rng()
        key = key if key is not None else jax.random.PRNGKey(int(rng.integers(2**31)))
        sp = self.p

        data = self.get_resolution(data, rng, genparams)
        res = float(data["resolution"])
        res_r = data["resolution_recon"]
        res_s = data["resolution_slice"]
        s_thick = data["slice_thickness"]
        gap = data["gap"]

        vol = jnp.asarray(data["volume"], jnp.float32)
        mask = jnp.asarray(data["mask"], jnp.float32)
        shape = vol.shape

        # GT at recon resolution (simulate_reco.py:319-333): logical-extent
        # corner of the same static buffer when res_r != res.
        if res_r != res:
            volume_gt, seg_gt, recon_extent = _gt_to_recon(
                vol, jnp.asarray(data["seg"], jnp.float32), res, res_r
            )
        else:
            volume_gt, seg_gt = vol, jnp.asarray(data["seg"], jnp.float32)
            recon_extent = shape
        data["volume_gt"] = volume_gt
        data["seg_gt"] = seg_gt
        data["recon_extent"] = tuple(int(x) for x in recon_extent)

        rs = res_s / res
        gap_vox = gap / res
        cube = slice_grid(shape, rs, sp.slice_size, self.tiers)
        ns_grid = self.ns_grid
        ns = min(int(max(shape) * res / gap) + 2, ns_grid)
        num_stacks = int(rng.integers(sp.min_num_stack, sp.max_num_stack + 1))

        # acquisition PSF sigmas in stack-frame voxel units (z, y, x)
        sig = jnp.asarray(
            [GAUSSIAN_FWHM * s_thick / res, SINC_FWHM * rs, SINC_FWHM * rs], jnp.float32
        )
        c_vol = (np.asarray(shape) - 1) / 2.0
        c_stack = np.full(3, (cube - 1) / 2.0)
        z0 = float(c_stack[0] - (ns - 1) / 2.0 * gap_vox)

        # Batched stack acquisition (dispatch structure v3): every round
        # draws a fixed-width batch of Kb attempts on the host, ships ONE
        # packed geometry transfer, and runs ONE compiled program
        # (`_acquire_stacks`); acceptance/retry/overflow logic then replays
        # the reference's sequential semantics (simulate_reco.py:366-440)
        # over the fetched validity table. Kb is static (per config), so
        # the program compiles once.
        Kb = int(sp.max_num_stack)
        stacks = []  # list of per-stack dicts
        total_slices = 0
        attempts = 0
        overflow = False
        while (
            len(stacks) < num_stacks
            and not overflow
            and attempts <= 50 * sp.max_num_stack
        ):
            batch = []
            for _ in range(Kb):
                attempts += 1
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
                    t_init.matrix(True)[0, :, :3], mats_vox, shape, ns, cube, ns_grid
                )
                gamma_on = rng.random() < sp.prob_gamma
                gamma = float(np.exp(sp.gamma_std * rng.standard_normal()))
                sigma = float(rng.uniform(sp.noise_sigma_min, sp.noise_sigma_max))
                thr_frac = float(rng.uniform(0.1, 0.3))
                batch.append(
                    dict(
                        geo=geo,
                        mats_vox=mats_vox,
                        t_init=t_init,
                        scal=(thr_frac, gamma, 1.0 if gamma_on else 0.0, sigma),
                        attempt=attempts,
                    )
                )

            fwd = [b["geo"]["fwd"] for b in batch]
            slices_b, valid_b = _acquire_stacks(
                vol,
                mask,
                jnp.asarray(np.array([f[0] for f in fwd], np.int32)),
                jnp.asarray(np.stack([f[1] for f in fwd]).astype(np.float32)),
                jnp.asarray(np.array([f[2] for f in fwd], np.float32)),
                jnp.asarray(np.stack([f[3] for f in fwd]).astype(np.float32)),
                jnp.asarray(np.stack([b["geo"]["G"] for b in batch])),
                jnp.asarray(np.array([b["scal"] for b in batch], np.float32)),
                jnp.asarray(np.array([b["attempt"] for b in batch], np.int32)),
                jnp.float32(rs),
                jnp.float32(gap_vox),
                jnp.float32(z0),
                sig,
                jnp.int32(ns),
                key,
                jnp.float32(sp.prob_void),
                jnp.float32(sp.slice_noise_threshold),
                cube=cube,
                ns_grid=ns_grid,
            )
            valids = np.asarray(valid_b) > 0  # one host sync per round

            for i, b in enumerate(batch):
                nvalid = int(valids[i].sum())
                if nvalid == 0:
                    continue  # reference retry (simulate_reco.py:410-415)
                if (
                    sp.max_num_slices is not None
                    and total_slices + nvalid >= sp.max_num_slices
                ):
                    # overflowing stack discarded (simulate_reco.py:425-430)
                    overflow = True
                    break
                geo = b["geo"]
                stacks.append(
                    dict(
                        slices=slices_b[i],
                        valid=valids[i],
                        mats_vox=b["mats_vox"],
                        t_init=b["t_init"],
                        M=geo["M"],
                        Minv=geo["Minv"],
                        t_stack=geo["t_stack"],
                        ns=ns,
                    )
                )
                total_slices += nvalid
                if len(stacks) >= num_stacks:
                    break

        data.update(
            stacks=stacks,
            total_slices=total_slices,
            rs=rs,
            gap_vox=gap_vox,
            z0=z0,
            ns=ns,
            c_vol=c_vol,
            c_stack=c_stack,
            shape=tuple(shape),
            key=key,
            kb=Kb,  # static recon batch width (one compiled recon program)
            cube=cube,
            ns_grid=ns_grid,
        )
        return data


class PSFReconstructor:
    """Reference-parity PSF reconstructor (``simulate_reco.py:469-774``)."""

    def __init__(self, params: ReconParams | None = None, **kw):
        self.p = params if params is not None else ReconParams(**kw)
        self._seeds: dict = {}

    def sample_seeds(self, rng, genparams=None):
        """(``simulate_reco.py:523-560``) — genparams entries pin the draws."""
        genparams = genparams or {}
        rp = self.p
        s: dict = {}
        s["smooth_volume_on"] = bool(rng.random() < rp.prob_smooth)
        s["rm_slices_on"] = bool(rng.random() < rp.prob_rm_slices)
        s["misreg_slice_on"] = bool(rng.random() < rp.prob_misreg_slice)
        # draw-then-override throughout: pinned genparams must not skip rng
        # draws or the host stream desynchronizes (breaking rng_key replay)
        ratio = (
            float(rng.uniform(rp.rm_slices_min, rp.rm_slices_max))
            if s["rm_slices_on"]
            else None
        )
        if genparams.get("rm_slices_ratio") is not None:
            ratio = float(genparams["rm_slices_ratio"])
        s["rm_slices_ratio"] = ratio
        s["misreg_stack_on"] = []
        s["merge_volume_on"] = bool(rng.random() < rp.prob_merge)
        mp = rp.merge_params
        # tolerate None pins (a caller may pass a dict with explicit Nones):
        # draw-then-override where None falls back to the draw
        def pin(name, drawn):
            v = genparams.get(name)
            return int(v) if v is not None else int(drawn)

        if mp.merge_type == "gaussian":
            s["merge_type"] = "gaussian"
            ng = rng.integers(mp.gauss_ngaussians_min, mp.gauss_ngaussians_max)
            s["ngaussians_merge"] = pin("ngaussians_merge", ng)
        else:
            s["merge_type"] = "perlin"
            pres = rng.choice(mp.perlin_res_list)
            octv = rng.choice(mp.perlin_octaves_list)
            s["res"] = pin("res", pres)
            s["octave"] = pin("octave", octv)
        self._seeds = s
        return s

    def get_seeds(self) -> dict:
        return dict(self._seeds)

    def recon_psf(self, data: dict, genparams: dict | None = None, rng=None):
        rng = rng or np.random.default_rng()
        rp = self.p
        s = self.sample_seeds(rng, genparams)
        key = data["key"]
        res = float(data["resolution"])
        res_r = data["resolution_recon"]
        res_s = data["resolution_slice"]
        s_thick = data["slice_thickness"]
        shape = data["shape"]
        c_vol = data["c_vol"]
        c_stack = data["c_stack"]
        stacks = data["stacks"]
        cube = int(data["cube"])
        ns_grid = int(data["ns_grid"])

        # recon PSF sigmas at recon-voxel units (simulate_reco.py:338-344)
        sig_rec = jnp.asarray(
            [GAUSSIAN_FWHM * s_thick / res_r, SINC_FWHM * res_s / res_r], jnp.float32
        )

        # global random slice removal across all valid slices
        # (kept_slices_idx, simulate_reco.py:711-728)
        valid_flat = np.concatenate([st["valid"] for st in stacks]) if stacks else np.zeros(0, bool)
        keep_flat = valid_flat.copy()
        if s["rm_slices_on"] and s["rm_slices_ratio"] is not None and valid_flat.any():
            vidx = np.nonzero(valid_flat)[0]
            n_rm = int(len(vidx) * s["rm_slices_ratio"])
            keep_flat[rng.permutation(vidx)[:n_rm]] = False

        # one misregistered slice (misregister_slices, simulate_reco.py:629-647)
        misreg_slice_global = -1
        if s["misreg_slice_on"] and valid_flat.any():
            vidx = np.nonzero(valid_flat)[0]
            n_mis = max(int(rp.slices_misreg_ratio * len(vidx)), 0)
            cand = rng.permutation(vidx)[:n_mis][:1]  # reference keeps [:1]
            if len(cand):
                misreg_slice_global = int(cand[0])

        # Per-stack host geometry (rng draw ORDER preserved vs the reference
        # loop), packed for the single batched device call below.
        scale = res_r / res
        extent = data["recon_extent"]
        c_rec = (np.asarray(extent, np.float64) - 1) / 2.0
        Grec_l, keep_l, qinv_l, iang_l, iscl_l, idlt_l, rows = [], [], [], [], [], [], []
        offset = 0
        for st in stacks:
            ns = st["ns"]
            mats_rec = st["mats_vox"].copy()
            # slice swap first (reference order), then per-stack offset
            j = misreg_slice_global - offset
            if 0 <= j < ns_grid:
                mats_rec[j] = reset_transform(st["t_init"])[min(j, ns - 1)].matrix(True)[0]
                mats_rec[j, :, 3] /= res
            misreg_stack = bool(rng.random() < rp.prob_misreg_stack)
            s["misreg_stack_on"].append(misreg_stack)
            if misreg_stack:
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

            Grec_l.append(
                _slice_affine_table(mats_rec, st["Minv"], st["t_stack"], c_vol, ns, ns_grid)
            )
            keep_l.append(keep_flat[offset : offset + ns_grid].astype(np.float32))
            offset += ns_grid

            # inverse stack map placing the stack frame on the recon grid:
            # recon index i sits at volume coordinate c_vol + (i - c_rec)*scale
            # (center-aligned, matching the reference's grid_sample resample),
            # and p_stack = Minv (q_vol - t_stack).
            A_full = st["Minv"] * scale
            t_full = st["Minv"] @ (c_vol - scale * c_rec - st["t_stack"])
            qinv_idx, i_ang, i_scl, i_dlt = decompose_affine_paeth_host(A_full, t_full, cube)
            qinv_l.append(qinv_idx)
            iang_l.append(i_ang)
            iscl_l.append(i_scl)
            idlt_l.append(i_dlt)
            rows.append(st["slices"])

        # pad to a FIXED batch width (one compiled program for any stack
        # count, zero stacks included): keep == 0 rows add no value/weight
        # merge weights (get_merging_weights, simulate_reco.py:649-691)
        mp = rp.merge_params
        meta_merge: dict = {}
        if s["merge_volume_on"]:
            if s["merge_type"] == "perlin":
                mw = fractal_noise_3d(
                    jax.random.fold_in(key, 7),
                    shape,
                    (s["res"], s["res"], s["res"]),
                    octaves=jnp.int32(s["octave"]),
                    persistence=mp.perlin_persistence,
                    lacunarity=mp.perlin_lacunarity,
                    increase=mp.perlin_increase_size,
                    max_octaves=int(max(mp.perlin_octaves_list)),
                )
            else:
                ng = s["ngaussians_merge"]
                centers, cvalid = masked_random_centers(
                    jax.random.fold_in(key, 8),
                    (data["seg_gt"] > 0).astype(jnp.int32),
                    8,
                    ng,
                )
                sigmas = np.clip(20 + 10 * rng.standard_normal((8, 1)), 5, 40)
                mw = mog_3d(shape, centers, jnp.asarray(sigmas, jnp.float32), cvalid)
        else:
            mw = jnp.zeros(shape, jnp.float32)

        # ONE batched device call: all stacks' placement + equalize/smooth/
        # merge. Padded to the static width recorded by the scanner so a
        # single compiled program serves every stack count (keep == 0 rows
        # are inert: zero value AND zero weight).
        Kb = int(data.get("kb") or max(len(stacks), 1))
        Kb = max(Kb, len(stacks), 1)
        npad = Kb - len(stacks)
        zrow = jnp.zeros((ns_grid, cube, cube), jnp.float32)
        slices_b = jnp.stack(rows + [zrow] * npad)
        keep_b = np.stack(keep_l + [np.zeros(ns_grid, np.float32)] * npad)
        Grec_b = np.stack(
            Grec_l + [np.eye(3, 4, dtype=np.float32)[None].repeat(ns_grid, 0)] * npad
        )
        qinv_b = np.array(qinv_l + [0] * npad, np.int32)
        iang_b = np.stack(iang_l + [np.zeros(3, np.float32)] * npad).astype(np.float32)
        iscl_b = np.array(iscl_l + [1.0] * npad, np.float32)
        idlt_b = np.stack(idlt_l + [np.zeros(3, np.float32)] * npad).astype(np.float32)
        extent = data["recon_extent"]

        out = _recon_stacks(
            slices_b,
            jnp.asarray(keep_b),
            jnp.asarray(Grec_b),
            jnp.asarray(qinv_b),
            jnp.asarray(iang_b),
            jnp.asarray(iscl_b),
            jnp.asarray(idlt_b),
            jnp.float32(data["rs"]),
            jnp.float32(data["gap_vox"]),
            jnp.float32(data["z0"]),
            sig_rec,
            data["volume_gt"],
            jnp.asarray(s["smooth_volume_on"]),
            jnp.asarray(s["merge_volume_on"]),
            mw,
            jnp.asarray(np.array(extent, np.int32)),
            cube=cube,
            ns_grid=ns_grid,
            out_shape=tuple(shape),
        )
        return out, mw


class SimulateMotion:
    """Reference-parity motion artifact (``artifacts.py:345-425``).

    ``resolution_recon`` is pinned to the volume resolution exactly as the
    reference's own ``SimulateMotion`` does (``artifacts.py:402``:
    ``self.scanner_args.resolution_recon = res_``) — the random
    ``resolution_recon ~ U(res, res_slice)`` draw (``simulate_reco.py:174-177``)
    only fires for a standalone :class:`Scanner` whose params leave it unset,
    again matching the reference.
    """

    def __init__(
        self,
        prob: float,
        scanner_params: ScannerParams,
        recon_params: ReconParams,
        tiers: tuple = DEFAULT_TIERS,
        ns_grid: int = NS,
    ):
        self.prob = prob
        self.scanner_args = scanner_params
        self.recon_args = recon_params
        self.tiers = tuple(tiers)
        self.ns_grid = int(ns_grid)

    def __call__(
        self, output, seg, genparams=None, resolution=(0.5, 0.5, 0.5), rng=None, key=None, **kw
    ):
        genparams = {
            k: v for k, v in (genparams or {}).items() if v is not None
        }  # _validated_genparams parity (reference model.py:85-92)
        if "rng_seed" in genparams:
            # dict-alone replay: the recorded internal seed + key reproduce
            # every draw regardless of the caller's rng/key
            key = jnp.asarray(np.asarray(genparams["rng_key"], np.uint32))
            seed = int(genparams["rng_seed"])
        else:
            rng = rng or np.random.default_rng()
            if rng.random() >= self.prob and not genparams:
                return output, {}
            seed = int(rng.integers(2**63))
            if key is None:
                key = jax.random.PRNGKey(int(rng.integers(2**31)))
        rng = np.random.default_rng(seed)  # internal stream, replayable

        res = float(resolution[0])
        # reference artifacts.py:402 pins resolution_recon to the volume res
        sp = ScannerParams(**{**self.scanner_args.__dict__, "resolution_recon": res})
        scanner = Scanner(sp, tiers=self.tiers, ns_grid=self.ns_grid)
        recon = PSFReconstructor(self.recon_args)

        data = {
            "resolution": res,
            "volume": jnp.asarray(output, jnp.float32),
            "mask": (jnp.asarray(seg) > 0).astype(jnp.float32),
            "seg": jnp.asarray(seg, jnp.float32),
        }
        d_scan = scanner.scan(data, genparams, rng=rng, key=key)
        out, _ = recon.recon_psf(d_scan, genparams, rng=rng)

        meta = {
            "rng_seed": seed,
            "rng_key": _key_words(key).tolist(),
            "resolution_recon": d_scan["resolution_recon"],
            "resolution_slice": d_scan["resolution_slice"],
            "slice_thickness": d_scan["slice_thickness"],
            "gap": d_scan["gap"],
            "nstacks": len(d_scan["stacks"]),
            "total_slices": d_scan["total_slices"],
        }
        meta.update(recon.get_seeds())
        return out, meta
