"""Procedural test/bench data: standalone stand-ins for BIDS volumes.

Also builds a tiny on-disk mini-BIDS tree (:func:`build_bids_tree`) with the
same layout as the reference's in-repo ``data/`` fixture
(``sub-*/anat/*_T2w.nii.gz``, ``*_dseg.nii.gz``,
``derivatives/seeds/subclasses_N/sub-*/anat/*_mlabel_M.nii.gz``) from
procedural volumes — packaged so examples and installed-package users can run
the full dataset API without external data or a repo checkout — and holds
the NumPy reference of the warp's hat pass (:func:`hat_pass_reference`),
shared by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXTURE_SHAPE = (64, 64, 64)
FIXTURE_SUBJECTS = ("sub-aaa", "sub-bbb")
FIXTURE_N_SUBCLASSES = (1, 2)


def make_phantom(rng: np.random.Generator, shape=FIXTURE_SHAPE):
    """Sphere-in-sphere phantom: seg labels 0..7, plausible T2w-ish image."""
    zz = np.stack(
        np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    )
    r = np.sqrt((zz**2).sum(0))
    seg = np.zeros(shape, dtype=np.int16)
    seg[r < 0.9] = 1  # CSF
    seg[r < 0.7] = 2  # GM
    seg[r < 0.5] = 3  # WM
    seg[r < 0.2] = 4  # deep
    img = (seg.astype(np.float32) * 60 + rng.normal(0, 5, shape)).clip(0, 255)
    return img.astype(np.float32), seg


def build_bids_tree(
    root: Path, rng: np.random.Generator | None = None, shape=FIXTURE_SHAPE
) -> Path:
    """Write a complete mini-BIDS tree (images, dseg, seed derivative tree)."""
    from .io import nifti

    rng = rng or np.random.default_rng(7)
    affine = np.diag([0.5, 0.5, 0.5, 1.0])
    for sub in FIXTURE_SUBJECTS:
        anat = root / sub / "anat"
        anat.mkdir(parents=True, exist_ok=True)
        img, seg = make_phantom(rng, shape)
        nifti.save(anat / f"{sub}_T2w.nii.gz", img, affine)
        nifti.save(anat / f"{sub}_dseg.nii.gz", seg, affine)
        for n_sub in FIXTURE_N_SUBCLASSES:
            for mlabel in range(1, 5):
                sdir = root / "derivatives" / "seeds" / f"subclasses_{n_sub}" / sub / "anat"
                sdir.mkdir(parents=True, exist_ok=True)
                # seeds for meta-label m live in [10*m, 10*m + n_sub)
                seed = np.zeros(shape, dtype=np.int8)
                region = seg == mlabel
                labels = 10 * mlabel + rng.integers(0, n_sub, size=int(region.sum()))
                seed[region] = labels.astype(np.int8)
                nifti.save(sdir / f"{sub}_dseg_mlabel_{mlabel}.nii.gz", seed, affine)
    return root


def phantom_seeds_and_seg(shape=(256, 256, 256), seed: int = 0, n_subclusters: int = 3):
    """Procedural (seeds, segmentation) pair shaped like real preprocessed data.

    Concentric-ellipsoid anatomy with per-meta-label subcluster seeds in the
    reference's label layout (meta-label m -> labels ``10*m .. 10*m+n-1``,
    ``rand_gmm.py:77``) and a FeTA-like 0..7 segmentation.
    """
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    # random ellipsoid radii per call for variety
    scales = 0.8 + 0.2 * rng.random(3)
    r = np.sqrt(sum((g / s) ** 2 for g, s in zip(grids, scales)))

    seg = np.zeros(shape, dtype=np.int16)
    radii = [0.95, 0.8, 0.62, 0.45, 0.3, 0.18, 0.08]
    for lab, rad in enumerate(radii, start=1):
        seg[r < rad] = lab

    # meta-label partition: skull/extra (4), CSF (1), GM (2), WM (3)
    meta = np.zeros(shape, dtype=np.int16)
    meta[(seg == 1) | (seg == 4)] = 1
    meta[(seg == 2) | (seg == 6)] = 2
    meta[(seg == 3) | (seg == 5) | (seg == 7)] = 3
    meta[(r >= 0.95) & (r < 1.05)] = 4

    seeds = np.zeros(shape, dtype=np.int16)
    mask = meta > 0
    sub = rng.integers(0, n_subclusters, size=int(mask.sum()))
    seeds[mask] = (10 * meta[mask] + sub).astype(np.int16)
    return seeds, seg


def hat_positions_reference(coefs, disp, shape, out_len=None) -> np.ndarray:
    """(D*H, out_len) float32 sample positions of one hat pass, evaluated in
    the same order as ``ops.warp`` (see :func:`hat_pass_reference`)."""
    D, H, W = shape
    OW = W if out_len is None else out_len
    f32 = np.float32
    c = np.asarray(coefs, f32)
    c = np.repeat(c, H, axis=0) if c.ndim == 2 else c[None, :]
    rows = np.arange(D * H, dtype=f32)
    ri = np.floor(rows / f32(H))[:, None]
    rj = rows[:, None] - ri * f32(H)
    lanes = np.arange(OW, dtype=f32)[None, :]
    pos = c[:, 0:1] * ri + c[:, 1:2] * rj + c[:, 2:3] * lanes + c[:, 3:4]
    if disp is not None:
        d = np.asarray(disp, f32)
        if d.ndim == 2 and d.shape[0] == 3:
            pos = pos + d[0][None, :] * ri + d[1][None, :] * rj + d[2][None, :]
        else:
            pos = pos + d.reshape(D * H, OW)
    return pos


def hat_pass_reference(vol, coefs, disp, shape, nearest, out_len=None, pos=None):
    """NumPy reference for ``ops.warp.hat_pass``: resample the LAST axis of
    ``vol`` (D, H, W) at ``pos = ci*i + cj*j + ck*k + bias [+ disp]``.

    Edge-clamped two-tap interpolation, linear or nearest (round half to
    even, like ``jnp.round``). ``coefs`` is a 4-tuple or a per-slice (D, 4)
    table; ``disp`` is None, a (D, H, out_len) displacement volume or a
    (3, out_len) per-lane affine table ``A0*i + A1*j + A2``. Positions are
    float32 (:func:`hat_positions_reference`, or ``pos`` when given), so the
    reference and the device pass differ only by floating-point contraction.
    """
    D, H, W = shape
    OW = W if out_len is None else out_len
    f32 = np.float32
    x = np.asarray(vol, f32).reshape(D * H, W)
    if pos is None:
        pos = hat_positions_reference(coefs, disp, shape, out_len)
    cl = np.clip(pos, 0, W - 1)
    r = np.arange(D * H)[:, None]
    if nearest:
        out = x[r, np.rint(cl).astype(np.int64)]
    else:
        fl = np.clip(np.floor(cl), 0, W - 2)
        w = cl - fl
        fi = fl.astype(np.int64)
        out = x[r, fi] * (f32(1) - w) + x[r, fi + 1] * w
    out = np.where(pos <= 0, x[:, :1], out)
    out = np.where(pos >= W - 1, x[:, W - 1 :], out)
    return out.astype(f32).reshape(D, H, OW)
