"""NumPy golden implementations of the reference's voxel math.

These re-state the *semantics* of ``fetalsyngen/utils/generation.py`` (the
torch kernels) in plain NumPy so the JAX ops can be validated voxel-level
against an independent implementation — the kernel-equivalence strategy the
reference itself uses via ``fast_3D_interp_torch_test`` (``generation.py:291-307``).
"""

import numpy as np


def trilinear_ref(X, II, JJ, KK, default_value=0.0):
    """fast_3D_interp_torch linear-mode semantics (generation.py:227-288)."""
    D, H, W = X.shape
    ok = (II > 0) & (JJ > 0) & (KK > 0) & (II <= D - 1) & (JJ <= H - 1) & (KK <= W - 1)
    IIv, JJv, KKv = II[ok], JJ[ok], KK[ok]

    fx = np.floor(IIv).astype(int)
    cx = np.minimum(fx + 1, D - 1)
    wcx = IIv - fx
    wfx = 1 - wcx
    fy = np.floor(JJv).astype(int)
    cy = np.minimum(fy + 1, H - 1)
    wcy = JJv - fy
    wfy = 1 - wcy
    fz = np.floor(KKv).astype(int)
    cz = np.minimum(fz + 1, W - 1)
    wcz = KKv - fz
    wfz = 1 - wcz

    c000 = X[fx, fy, fz]
    c100 = X[cx, fy, fz]
    c010 = X[fx, cy, fz]
    c110 = X[cx, cy, fz]
    c001 = X[fx, fy, cz]
    c101 = X[cx, fy, cz]
    c011 = X[fx, cy, cz]
    c111 = X[cx, cy, cz]

    c00 = c000 * wfx + c100 * wcx
    c01 = c001 * wfx + c101 * wcx
    c10 = c010 * wfx + c110 * wcx
    c11 = c011 * wfx + c111 * wcx
    c0 = c00 * wfy + c10 * wcy
    c1 = c01 * wfy + c11 * wcy
    c = c0 * wfz + c1 * wcz

    Y = np.full(II.shape, default_value, dtype=np.float64)
    Y[ok] = c
    return Y


def nearest_ref(X, II, JJ, KK):
    """fast_3D_interp_torch nearest-mode semantics (generation.py:211-225)."""
    D, H, W = X.shape
    IIr = np.clip(np.round(II), 0, D - 1).astype(int)
    JJr = np.clip(np.round(JJ), 0, H - 1).astype(int)
    KKr = np.clip(np.round(KK), 0, W - 1).astype(int)
    return X[IIr, JJr, KKr]


def gaussian_kernel_ref(sigma):
    """make_gaussian_kernel semantics (generation.py:74-81)."""
    sl = int(np.ceil(3 * sigma))
    ts = np.linspace(-sl, sl, 2 * sl + 1)
    gauss = np.exp(-((ts / sigma) ** 2) / 2)
    return gauss / gauss.sum()


def gaussian_blur_ref(x, stds):
    """gaussian_blur_3d semantics (generation.py:84-110): separable 'same' conv."""
    out = x.astype(np.float64)
    for axis in range(3):
        if stds[axis] > 0:
            k = gaussian_kernel_ref(stds[axis])
            half = len(k) // 2
            padded = np.zeros(
                tuple(s + 2 * half if a == axis else s for a, s in enumerate(out.shape))
            )
            sl = tuple(
                slice(half, half + out.shape[a]) if a == axis else slice(None) for a in range(3)
            )
            padded[sl] = out
            new = np.zeros_like(out)
            for t in range(len(k)):
                shifted = np.take(padded, np.arange(out.shape[axis]) + t, axis=axis)
                # correlation == convolution for symmetric kernels
                new += k[t] * shifted
            out = new
    return out


def zoom_ref(X, factor):
    """myzoom_torch semantics (generation.py:310-397)."""
    X = np.asarray(X, dtype=np.float64)
    squeeze = X.ndim == 3
    if squeeze:
        X = X[..., None]
    factor = np.asarray(factor, dtype=np.float64)
    delta = (1.0 - factor) / (2.0 * factor)
    newsize = np.round(np.array(X.shape[:-1]) * factor).astype(int)

    vs = []
    for d in range(3):
        v = np.arange(delta[d], delta[d] + newsize[d] / factor[d], 1 / factor[d])[: newsize[d]]
        v = np.clip(v, 0, X.shape[d] - 1)
        vs.append(v)

    out = X
    for d in range(3):
        v = vs[d]
        f = np.floor(v).astype(int)
        c = np.minimum(f + 1, X.shape[d] - 1)
        wc = v - f
        wf = 1 - wc
        lo = np.take(out, f, axis=d)
        hi = np.take(out, c, axis=d)
        shape = [1] * out.ndim
        shape[d] = -1
        out = lo * wf.reshape(shape) + hi * wc.reshape(shape)
    if squeeze:
        out = out[..., 0]
    return out


def make_affine_matrix_ref(rot, sh, s):
    """make_affine_matrix semantics (generation.py:39-71)."""
    Rx = np.array(
        [[1, 0, 0], [0, np.cos(rot[0]), -np.sin(rot[0])], [0, np.sin(rot[0]), np.cos(rot[0])]]
    )
    Ry = np.array(
        [[np.cos(rot[1]), 0, np.sin(rot[1])], [0, 1, 0], [-np.sin(rot[1]), 0, np.cos(rot[1])]]
    )
    Rz = np.array(
        [[np.cos(rot[2]), -np.sin(rot[2]), 0], [np.sin(rot[2]), np.cos(rot[2]), 0], [0, 0, 1]]
    )
    SHx = np.array([[1, 0, 0], [sh[1], 1, 0], [sh[2], 0, 1]])
    SHy = np.array([[1, sh[0], 0], [0, 1, 0], [0, sh[2], 1]])
    SHz = np.array([[1, 0, sh[0]], [0, 1, sh[1]], [0, 0, 1]])
    A = SHx @ SHy @ SHz @ Rx @ Ry @ Rz
    A = A * np.asarray(s)[:, None]
    return A


# ---------------------------------------------------------------------------
# Slice-acquisition executable spec (reference slice_acq.py:272-430, 499-546)
# ---------------------------------------------------------------------------

def psf_slice_acquisition_ref(transforms, vol, psf, slice_shape, res_slice, need_weight=False):
    """``slice_acquisition_torch`` CPU semantics in NumPy.

    transforms: (N, 3, 4) xyz-space trans-first rigids (p = R (x + t)),
    translations in VOXEL units; vol: (D, H, W) with axes (z, y, x);
    psf: (pz, py, px) kernel; slice pixels at ``res_slice`` voxel spacing.
    The reference accumulates the rotated PSF footprint at ROUNDED voxel
    positions and normalizes by accumulated weight (slice_acq.py:270-309,425).
    """
    D, H, W = vol.shape
    shift = (np.array([W, H, D], np.float64) - 1) / 2.0  # xyz
    pk = np.argwhere(psf > 0)
    psf_xyz = np.flip((pk - (np.array(psf.shape) - 1) / 2.0), -1).astype(np.float64)
    psf_v = psf[psf > 0].astype(np.float64)
    ss = tuple(slice_shape)
    pix = np.argwhere(np.ones((1, *ss), bool))
    pix_xyz = np.flip((pix - (np.array((1, *ss)) - 1) / 2.0) * res_slice, -1)
    out = np.zeros((len(transforms), *ss), np.float64)
    wout = np.zeros_like(out)
    volf = vol.reshape(-1).astype(np.float64)
    for i, T in enumerate(np.asarray(transforms, np.float64)):
        R, t = T[:, :3], T[:, 3]
        sl = (R @ (pix_xyz + t).T).T
        po = (R @ psf_xyz.T).T
        pos = shift + po[None] + sl[:, None]  # (npix, npsf, 3)
        inside = np.all((pos > 0) & (pos < 2 * shift), -1)
        idx = np.rint(pos).astype(np.int64)
        flat = (idx[..., 0] + idx[..., 1] * W + idx[..., 2] * (H * W)).clip(0, volf.size - 1)
        val = np.where(inside, volf[flat] * psf_v[None], 0.0)
        w = np.where(inside, psf_v[None], 0.0)
        s, ws = val.sum(1), w.sum(1)
        m = ws > 1e-2
        s[m] = s[m] / ws[m]
        s[~m] = 0.0
        out[i] = s.reshape(ss)
        wout[i] = ws.reshape(ss)
    return (out, wout) if need_weight else out


def psf_slice_adjoint_ref(transforms, psf, slices, vol_shape, res_slice, equalize=True):
    """``slice_acquisition_adjoint_torch`` CPU semantics in NumPy
    (slice_acq.py:499-546): scatter PSF-weighted slice values, optionally
    equalize by scattered weight."""
    D, H, W = vol_shape
    shift = (np.array([W, H, D], np.float64) - 1) / 2.0
    pk = np.argwhere(psf > 0)
    psf_xyz = np.flip((pk - (np.array(psf.shape) - 1) / 2.0), -1).astype(np.float64)
    psf_v = psf[psf > 0].astype(np.float64)
    ss = slices.shape[-2:]
    pix = np.argwhere(np.ones((1, *ss), bool))
    pix_xyz = np.flip((pix - (np.array((1, *ss)) - 1) / 2.0) * res_slice, -1)
    vol = np.zeros(D * H * W, np.float64)
    wvol = np.zeros_like(vol)
    for i, T in enumerate(np.asarray(transforms, np.float64)):
        R, t = T[:, :3], T[:, 3]
        sl = (R @ (pix_xyz + t).T).T
        po = (R @ psf_xyz.T).T
        pos = shift + po[None] + sl[:, None]
        inside = np.all((pos > 0) & (pos < 2 * shift), -1)
        idx = np.rint(pos).astype(np.int64)
        flat = (idx[..., 0] + idx[..., 1] * W + idx[..., 2] * (H * W)).clip(0, vol.size - 1)
        sv = slices[i].reshape(-1)
        np.add.at(vol, flat[inside], (psf_v[None] * sv[:, None])[inside])
        np.add.at(wvol, flat[inside], np.broadcast_to(psf_v[None], inside.shape)[inside])
    vol = vol.reshape(D, H, W)
    wvol = wvol.reshape(D, H, W)
    if equalize:
        m = wvol > 1e-2
        vol[m] = vol[m] / wvol[m]
        vol[~m] = 0.0
    return vol, wvol
