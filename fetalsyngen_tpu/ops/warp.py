"""3D warps as separable axis passes: triangular hat passes + matmuls.

The reference warps volumes with one trilinear gather at arbitrary coordinates
(``fast_3D_interp_torch``, ``generation.py:204-288``). This module factors the
warp into single-axis resampling passes instead:

1. **UL factorization.** The affine map ``o -> A o + t`` factors as
   ``A = U L`` (upper x unit-lower). A triangular map warps EXACTLY as a
   sequence of single-axis resampling passes (each pass's sample position
   depends only on axes not yet resampled), so the full affine warp is five
   axis passes with closed-form positions: U's z/y/x passes then L's y/z
   passes. Sampling positions compose exactly; interpolation is one linear
   kernel per pass (a "sheared trilinear" kernel overall — equivalence vs.
   exact trilinear is bounded in tests/test_warp.py).
2. **Nonrigid stage.** ``out(o) = W(o + F(o))`` for the smooth bounded
   low-frequency field: three more axis passes using the displacement volumes
   at grid points (first-order triangular inverse; error O(|F|^2/L) voxels).
3. **Hat pass.** Each axis pass samples, per output element, the edge-clamped
   two-tap linear (or nearest) interpolant of its own source row at
   ``pos = ci*row_i + cj*row_j + ck*lane + bias (+ disp)``: a row-local
   ``take_along_axis`` plus a lerp, which XLA compiles to one memory-bound
   fusion. Passes without a displacement or row_i term run as batched
   matmuls against banded (J, K, S) operators instead.

Boundary semantics: positions are edge-clamped (reference ``myzoom``-style);
the reference's linear-mode OOB zeroing is applied by the pipeline via a
closed-form composite mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Hat passes
# ---------------------------------------------------------------------------


def _hat_pass_jnp(x2d, pos, nearest):
    """Edge-clamped two-tap resample of each row of ``x2d`` at ``pos``."""
    S = x2d.shape[1]
    sat_lo = pos <= 0.0
    sat_hi = pos >= S - 1.0
    c = jnp.clip(pos, 0, S - 1)
    if nearest:
        idx = jnp.round(c).astype(jnp.int32)
        out = jnp.take_along_axis(x2d, idx, axis=1)
    else:
        f = jnp.clip(jnp.floor(c), 0, S - 2)
        w = (c - f).astype(jnp.float32)  # position precision stays f32
        fi = f.astype(jnp.int32)
        g0 = jnp.take_along_axis(x2d, fi, axis=1).astype(jnp.float32)
        g1 = jnp.take_along_axis(x2d, fi + 1, axis=1).astype(jnp.float32)
        out = (g0 * (1.0 - w) + g1 * w).astype(x2d.dtype)
    out = jnp.where(sat_lo, x2d[:, :1], out)
    out = jnp.where(sat_hi, x2d[:, S - 1 :][:, :1], out)
    return out


def _pass_positions(coefs, disp, shape, out_len):
    """(D*H, out_len) f32 sample positions of one axis pass.

    ``coefs`` is a 4-tuple ``(ci, cj, ck, bias)`` or a per-slice (D, 4)
    table; ``disp`` is None, a (D, H, out_len) displacement volume, or a
    (3, out_len) per-lane affine table ``disp = A0*row_i + A1*row_j + A2``.
    """
    D, H, _ = shape
    R = D * H
    if isinstance(coefs, jnp.ndarray) and coefs.ndim == 2:
        c = jnp.repeat(coefs.astype(jnp.float32), H, axis=0)
    else:
        c = jnp.stack([jnp.asarray(v, jnp.float32) for v in coefs])[None, :]
    rows = jnp.arange(R, dtype=jnp.float32)
    ri = jnp.floor(rows / H)[:, None]
    rj = rows[:, None] - ri * H
    lanes = jnp.arange(out_len, dtype=jnp.float32)[None, :]
    pos = c[:, 0:1] * ri + c[:, 1:2] * rj + c[:, 2:3] * lanes + c[:, 3:4]
    if disp is not None and disp.ndim == 2 and disp.shape[0] == 3:
        pos = pos + disp[0][None, :] * ri + disp[1][None, :] * rj + disp[2][None, :]
    elif disp is not None:
        pos = pos + disp.reshape(R, out_len)
    return pos


def hat_pass(vol, coefs, disp, shape, nearest, out_len=None):
    """Resample the LAST axis of ``vol`` (D, H, W) at affine(+disp) positions.

    pos(i, j, k) = c0*i + c1*j + c2*k + c3 [+ disp] in last-axis voxel units
    (see :func:`_pass_positions` for the coefficient and displacement forms);
    edge-clamped interpolation (linear or nearest). ``out_len`` optionally
    changes the resampled axis length (output (D, H, out_len)).

    Honors :func:`linops.storage_scope` (narrow source/output storage;
    position and lerp math stay f32). The scope is read HERE (caller trace
    time) and threaded into the jitted impl as a static arg — see
    ``linops.einsum_store`` on why.
    """
    from .linops import _store_dtype

    return _hat_pass_impl(
        vol, coefs, disp, shape, nearest, out_len=out_len, store=_store_dtype()
    )


@functools.partial(jax.jit, static_argnames=("shape", "nearest", "out_len", "store"))
def _hat_pass_impl(vol, coefs, disp, shape, nearest, out_len=None, store=None):
    D, H, W = shape
    OW = W if out_len is None else out_len
    x2d = vol.reshape(D * H, W).astype(store or jnp.float32)
    pos = _pass_positions(coefs, disp, shape, OW)
    return _hat_pass_jnp(x2d, pos, nearest).reshape(D, H, OW)


def hat_pass_pair(va, vb, coefs, disp, shape, out_len=None, modes=(False, True)):
    """One axis pass over TWO volumes sharing positions; per-operand mode
    (False = linear, True = nearest). Default (linear, nearest) serves the
    image+segmentation pair; (linear, linear) serves value+weight chains.
    Reads the storage scope like :func:`hat_pass`."""
    from .linops import _store_dtype

    return _hat_pass_pair_impl(
        va, vb, coefs, disp, shape, out_len=out_len, modes=tuple(modes),
        store=_store_dtype(),
    )


@functools.partial(
    jax.jit, static_argnames=("shape", "out_len", "modes", "store")
)
def _hat_pass_pair_impl(va, vb, coefs, disp, shape, out_len=None, modes=(False, True), store=None):
    D, H, W = shape
    OW = W if out_len is None else out_len
    dt = store or jnp.float32
    pos = _pass_positions(coefs, disp, shape, OW)
    a = _hat_pass_jnp(va.reshape(D * H, W).astype(dt), pos, modes[0])
    b = _hat_pass_jnp(vb.reshape(D * H, W).astype(dt), pos, modes[1])
    return a.reshape(D, H, OW), b.reshape(D, H, OW)


# ---------------------------------------------------------------------------
# UL factorization (A = U @ L, L unit-lower, U upper with diagonal)
# ---------------------------------------------------------------------------

def ul_decompose(A: jnp.ndarray):
    """Backward Doolittle: A = U L. Stable for near-identity affines."""
    A = jnp.asarray(A, jnp.float32)
    u22 = A[2, 2]
    l20 = A[2, 0] / u22
    l21 = A[2, 1] / u22
    u12 = A[1, 2]
    u11 = A[1, 1] - u12 * l21
    l10 = (A[1, 0] - u12 * l20) / u11
    u02 = A[0, 2]
    u01 = A[0, 1] - u02 * l21
    u00 = A[0, 0] - u01 * l10 - u02 * l20
    U = jnp.array([[u00, u01, u02], [0.0, u11, u12], [0.0, 0.0, u22]])
    L = jnp.array([[1.0, 0.0, 0.0], [l10, 1.0, 0.0], [l20, l21, 1.0]])
    return U, L


# Displacement fields are clipped to +-FIELD_LIM voxels: ~3.5 sigma of the
# largest default nonlin_std (4.0) — beyond the field's realizable range.
FIELD_LIM = 14.0


def warp_affine_separable(vol, A, t, nearest=False, out_shape=None):
    """``out[o] = V[A o + t]`` via five triangular hat passes (exact positions).

    Pass order (layouts in parentheses, gathered axis last):
      U-z (i,j,k) -> U-y (i,k,j) -> U-x (j,k,i) -> L-y (i,k,j) -> L-z (i,j,k).

    ``out_shape`` optionally differs from ``vol.shape`` (the output grid the
    map is evaluated on).
    """
    D, H, W = vol.shape
    OD, OH, OW = out_shape if out_shape is not None else (D, H, W)
    U, L = ul_decompose(A)
    t = jnp.asarray(t, jnp.float32)
    dt = vol.dtype
    v = vol.astype(jnp.float32)

    # U-stage: W1(p) = V[U p + t]  (shapes grow to the output grid axis-wise)
    x = hat_pass(v, (0.0, 0.0, U[2, 2], t[2]), None, (D, H, W), nearest, out_len=OW)
    x = jnp.transpose(x, (0, 2, 1))  # (i, k', j)
    x = hat_pass(x, (0.0, U[1, 2], U[1, 1], t[1]), None, (D, OW, H), nearest, out_len=OH)
    x = jnp.transpose(x, (2, 1, 0))  # (j', k', i)
    x = hat_pass(x, (U[0, 1], U[0, 2], U[0, 0], t[0]), None, (OH, OW, D), nearest, out_len=OD)

    # L-stage: out(o) = W1[L o]
    x = jnp.transpose(x, (2, 1, 0))  # (i', k', j')
    x = hat_pass(x, (L[1, 0], 0.0, 1.0, 0.0), None, (OD, OW, OH), nearest)
    x = jnp.transpose(x, (0, 2, 1))  # (i', j', k')
    x = hat_pass(x, (L[2, 0], L[2, 1], 1.0, 0.0), None, (OD, OH, OW), nearest)
    return x.astype(dt)


def warp_displacement_separable(vol, dx, dy, dz, nearest=False):
    """``out[o] = V[o + d(o)]`` for small smooth displacements (3 hat passes).

    Displacements are clipped to +-FIELD_LIM voxels.
    """
    D, H, W = vol.shape
    dt = vol.dtype
    lim = FIELD_LIM
    dx = jnp.clip(dx, -lim, lim)
    dy = jnp.clip(dy, -lim, lim)
    dz = jnp.clip(dz, -lim, lim)
    x = vol.astype(jnp.float32)
    x = hat_pass(x, (0.0, 0.0, 1.0, 0.0), dz, (D, H, W), nearest)
    x = jnp.transpose(x, (0, 2, 1))
    x = hat_pass(
        x, (0.0, 0.0, 1.0, 0.0), jnp.transpose(dy, (0, 2, 1)), (D, W, H), nearest
    )
    x = jnp.transpose(x, (2, 1, 0))  # (i, k, j) -> (j, k, i)
    x = hat_pass(
        x, (0.0, 0.0, 1.0, 0.0), jnp.transpose(dx, (1, 2, 0)), (H, W, D), nearest
    )
    return jnp.transpose(x, (2, 0, 1)).astype(dt)


# rotation axis -> rotated plane (for Paeth shear trios)
_PLANE = {0: (1, 2), 1: (2, 0), 2: (0, 1)}


# ---------------------------------------------------------------------------
# Traced rigid warps: quarter-turn lax.switch + UL passes
# ---------------------------------------------------------------------------
#
# A host-static rigid warp (np.rot90 quarter-turn choice + per-orientation
# trace; removed in round 2) retraced for every distinct stack orientation.
# For the scanner we need ONE compiled program serving
# every orientation: the 24 cube rotations become a ``lax.switch`` over
# transpose/flip branches (pure layout ops), and the residual rotation
# (every Euler angle <= 45 deg by construction) runs through the traced UL
# hat passes.

def _exact_quarter_np(V, P):
    S = V.shape[0]
    c = (S - 1) / 2.0
    q = np.indices(V.shape).astype(np.float64) - c
    i = np.rint(np.einsum("ab,b...->a...", P, q) + c).astype(int)
    return V[i[0], i[1], i[2]]


def _init_quarter_table():
    import itertools

    mats, ops = [], []
    probe = np.arange(4**3).reshape(4, 4, 4)
    layouts = [
        (tp, ax)
        for tp in itertools.permutations(range(3))
        for ax in itertools.chain.from_iterable(
            itertools.combinations(range(3), k) for k in range(4)
        )
    ]
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product([1, -1], repeat=3):
            P = np.zeros((3, 3))
            for a in range(3):
                P[a, perm[a]] = signs[a]
            if round(np.linalg.det(P)) != 1:
                continue
            want = _exact_quarter_np(probe, P)
            for tp, ax in layouts:
                cand = np.transpose(probe, tp)
                if ax:
                    cand = np.flip(cand, ax)
                if np.array_equal(cand, want):
                    mats.append(P.astype(np.float64))
                    ops.append((tp, tuple(ax)))
                    break
            else:  # pragma: no cover
                raise AssertionError(f"no layout op found for quarter turn {P}")
    return mats, ops


_QUARTER_MATS, _QUARTER_OPS = _init_quarter_table()
_QUARTER_STACK = np.stack(_QUARTER_MATS)  # (24, 3, 3)


def nearest_quarter_index(R) -> int:
    """Host: index of the cube rotation nearest (Frobenius) to ``R``."""
    R = np.asarray(R, np.float64)
    return int(np.argmax(np.einsum("kij,ij->k", _QUARTER_STACK, R)))


def quarter_matrix(idx: int) -> np.ndarray:
    return _QUARTER_MATS[idx]


def apply_quarter_turn(x: jnp.ndarray, idx) -> jnp.ndarray:
    """``out[q] = V[P_idx (q - c) + c]`` on a cube volume; ``idx`` is traced
    (one compiled switch serves all 24 orientations)."""
    branches = [
        (
            lambda v, tp=tp, ax=ax: jnp.flip(jnp.transpose(v, tp), ax)
            if ax
            else jnp.transpose(v, tp)
        )
        for tp, ax in _QUARTER_OPS
    ]
    return jax.lax.switch(idx, branches, x)


def decompose_rigid_host(R, t, in_center, out_center):
    """Host: split ``p_in = R q_out + t_c`` (about centers) into a quarter
    turn + near-identity residual for the UL-based pair warp.

    Returns (q_idx, A_res, t_res) with ``R = P[q_idx] @ A_res``; the warp
    contract downstream is ``out[q] = quarter(V)[A_res q + t_res]``.
    """
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    idx = nearest_quarter_index(R)
    P = _QUARTER_MATS[idx]
    A_res = P.T @ R
    c_in = np.asarray(in_center, np.float64)
    c_out = np.asarray(out_center, np.float64)
    # V[R (q - c_out) + c_in + t] == quarter(V)[A_res (q - c_out) + c_in + P^T t]
    t_res = c_in + P.T @ t - A_res @ c_out
    return idx, A_res.astype(np.float32), t_res.astype(np.float32)


def decompose_affine_paeth_host(A, t, cube):
    """Host: split an UNcentered ``p_in = A q_out + t`` (input = cube grid)
    into quarter turn + traced Euler angles + isotropic scale + shift for
    :func:`warp_rigid_pair_traced`.

    ``A`` must be rotation-times-isotropic-scale. Returns
    (q_idx, angles(3), scale, delta(3)) such that
    ``V[A q + t] == zoom_{scale, delta}( rot_{angles}( quarter_{q_idx}(V) ) )[q]``
    where rot samples ``Rx(a0) Ry(a1) Rz(a2)`` about the cube center and zoom
    samples axis coordinate ``scale * q + delta``.
    """
    A = np.asarray(A, np.float64)
    t = np.asarray(t, np.float64)
    s = float(np.cbrt(np.linalg.det(A)))
    R = A / s
    idx = nearest_quarter_index(R)
    P = _QUARTER_MATS[idx]
    R_res = P.T @ R
    from scipy.spatial.transform import Rotation as _Rotation

    angles = _Rotation.from_matrix(R_res).as_euler("XYZ")
    c = np.full(3, (cube - 1) / 2.0)
    t_res = P.T @ (t - c) + c
    # out[q] = quarter(V)[R_res (s q) + t_res] = W[s q + delta] with
    # W[p] = quarter(V)[R_res (p - c) + c]
    delta = R_res.T @ (t_res - c) + c
    return idx, angles.astype(np.float32), np.float32(s), delta.astype(np.float32)


def _shear_matrices(J, K, S, amount, bias, c_fix, modes, slope=1.0):
    """(J, K, S) banded per-row resampling operators
    ``M[j,k,s] = hat(pos(j,k) - s)``, ``pos = slope*k + amount*(j - c_fix) +
    bias``, edge-clamped; one matrix stack per distinct interpolation mode.
    """
    jj = jax.lax.broadcasted_iota(jnp.float32, (J, 1, 1), 0)
    kk = jax.lax.broadcasted_iota(jnp.float32, (1, K, 1), 1)
    ss = jax.lax.broadcasted_iota(jnp.float32, (1, 1, S), 2)
    pos = jnp.clip(slope * kk + amount * (jj - c_fix) + bias, 0.0, S - 1.0)
    out = {}
    for nearest in set(modes):
        if nearest:
            out[nearest] = (jnp.round(pos) == ss).astype(jnp.float32)
        else:
            out[nearest] = jnp.maximum(0.0, 1.0 - jnp.abs(pos - ss))
    return out


def _row_affine_matmul_pair(xa, xb, slope, amount, bias, modes, out_len=None, out_order="ijk"):
    """Resample the LAST axis of a pair at ``pos = slope*k + amount*row_j +
    bias`` (row_j = raw middle-axis index) via a batched matmul —
    identical semantics to a ``hat_pass_pair`` whose position map has no
    displacement and no row_i term.

    x layouts: (I, J, S) -> axes (i, j, k=resampled) emitted in
    ``out_order`` — a permutation string over "ijk"; a non-default order
    folds the caller's follow-up transpose into the matmul epilogue.
    ``xb=None`` runs the single-operand form (returns (oa, None)).
    """
    J, S = xa.shape[1], xa.shape[2]
    OK = S if out_len is None else out_len
    # raw row index: fold into the centered builder via bias' = bias + amount*c
    c_fix = (J - 1) / 2.0
    Ms = _shear_matrices(J, OK, S, amount, bias + amount * c_fix, c_fix, modes, slope=slope)
    from .linops import einsum_store

    # einsum_store: under the stream's bf16 storage scope the (J,K,S)
    # operator materializes in bf16 (the cast fuses into its elementwise
    # producer) and the pass intermediates stay bf16 — HALF the HBM traffic
    # of this bandwidth-bound stage. Nearest-mode one-hot rows and small-int
    # label values are exact in bf16; outside a scope the f32 contract is
    # untouched.
    spec = f"jks,ijs->{out_order}"
    oa = einsum_store(spec, Ms[modes[0]], xa)
    if xb is None:
        return oa, None
    ob = einsum_store(spec, Ms[modes[1]], xb)
    return oa, ob


def _shear_pass_pair_mm(va, vb, axis_move, axis_fix, amount, bias, modes, store=None):
    """Pair shear as a batched matmul (one (K,S) operator per axis_fix
    row, shared by both operands).

    pos[axis_move] = idx + amount * centered(axis_fix) + bias.
    ``vb=None`` runs the single-operand form (returns (oa, None)).
    """
    shape = va.shape
    axis_other = next(a for a in range(3) if a not in (axis_move, axis_fix))
    perm = (axis_other, axis_fix, axis_move)
    inv = tuple(np.argsort(perm))
    xa = jnp.transpose(va, perm)
    J, K = xa.shape[1], xa.shape[2]
    Ms = _shear_matrices(J, K, K, amount, bias, (shape[axis_fix] - 1) / 2.0, modes)
    from .linops import einsum_store

    oa = einsum_store("jks,ijs->ijk", Ms[modes[0]], xa, store=store)
    if vb is None:
        return jnp.transpose(oa, inv), None
    xb = jnp.transpose(vb, perm)
    ob = einsum_store("jks,ijs->ijk", Ms[modes[1]], xb, store=store)
    return jnp.transpose(oa, inv), jnp.transpose(ob, inv)


def _interp_or_nearest_matrix(coords, in_size, nearest):
    from .linops import interp_matrix

    if not nearest:
        return interp_matrix(coords, in_size)
    idx = jnp.clip(jnp.round(coords), 0, in_size - 1).astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, (coords.shape[0], in_size), 1)
    return (cols == idx[:, None]).astype(jnp.float32)


def warp_rigid_pair_traced(
    va, vb, q_idx, angles, scale, delta, out_shape=None, modes=(False, False),
    post_a=None, post_b=None, out_perm=None, emit_f32=True,
):
    """See :func:`_warp_rigid_pair_impl`; this wrapper reads the storage
    scope at caller trace time and threads it as a static jit arg.
    ``emit_f32=False`` lets a scoped caller keep the outputs in the storage
    dtype (when its consumers, e.g. the hat passes, accept bf16)."""
    from .linops import _store_dtype

    return _warp_rigid_pair_impl(
        va, vb, q_idx, angles, scale, delta, out_shape=out_shape, modes=modes,
        post_a=post_a, post_b=post_b, out_perm=out_perm, emit_f32=emit_f32,
        store=_store_dtype(),
    )


@functools.partial(
    jax.jit, static_argnames=("out_shape", "modes", "out_perm", "emit_f32", "store")
)
def _warp_rigid_pair_impl(
    va, vb, q_idx, angles, scale, delta, out_shape=None, modes=(False, False),
    post_a=None, post_b=None, out_perm=None, emit_f32=True, store=None,
):
    """``out[q] = V[A q + t]`` for two CUBE volumes with a fully TRACED
    rotation-times-isotropic-scale map (from
    :func:`decompose_affine_paeth_host`) — one compiled program serves every
    orientation.

    Pipeline: quarter-turn ``lax.switch`` -> per-axis Paeth shear trios
    (quarter alignment bounds every residual Euler angle well below 90 deg,
    so one trio per axis suffices) -> final separable zoom/shift matmuls.

    ``post_a``/``post_b``: optional per-axis operator matrices (each
    (out_dim, out_dim) or None) applied to the corresponding operand IN THE
    OUTPUT FRAME. They compose with the zoom matmuls (``P @ M`` is a small
    matrix product), so a caller's separable post-ops (e.g. the scanner's
    acquisition PSF blur + in-plane scale) ride the same three volume
    contractions instead of paying their own.

    ``out_perm=(1, 2, 0)`` emits the outputs pre-transposed to (axis1,
    axis2, axis0) by permuting the FINAL zoom einsum's output subscripts —
    the relayout rides the matmul epilogue instead of a separate
    full-volume transpose. Identical values.
    """
    from .linops import _prec, apply_axis_matrix, einsum_store

    cube = va.shape[0]
    out_shape = tuple(out_shape) if out_shape is not None else va.shape
    cc = (cube - 1) / 2.0
    # under a storage scope the quarter-turn relayout already writes the
    # narrow dtype; outputs are f32 when emit_f32 marks a segment boundary
    work_dt = store or jnp.float32
    out32 = emit_f32 or store is None
    a = apply_quarter_turn(va.astype(work_dt), q_idx)
    b = apply_quarter_turn(vb.astype(work_dt), q_idx) if vb is not None else None
    # Each per-axis rotation [[c,-s],[s,c]] on plane (u, v) factors as
    # diag(1/c, c) @ [[1, -s*c],[0, 1]] @ [[1, 0],[s/c, 1]] — TWO unit
    # shears instead of the Paeth trio's three, with the diagonal deferred.
    # Pulling every diagonal rightward through later unit shears conjugates
    # their amounts (amount * C[move]/C[fix], C = cumulative diagonal), and
    # the accumulated per-axis scales fold into the final zoom coords:
    # 6 volume contractions for the full rotation instead of 9.
    C = [jnp.float32(1.0)] * 3
    for axis in range(3):
        u_ax, v_ax = _PLANE[axis]
        th = angles[axis]
        c = jnp.cos(th)
        s = jnp.sin(th)
        C[u_ax] = C[u_ax] / c
        C[v_ax] = C[v_ax] * c
        amt_u = (-s * c) * C[u_ax] / C[v_ax]
        amt_v = (s / c) * C[v_ax] / C[u_ax]
        a, b = _shear_pass_pair_mm(a, b, u_ax, v_ax, amt_u, 0.0, modes, store=store)
        a, b = _shear_pass_pair_mm(a, b, v_ax, u_ax, amt_v, 0.0, modes, store=store)
    # out_perm folds the final relayout into the last einsum's output order
    last_spec = {None: None, (1, 2, 0): "oi,jki->koj"}[out_perm]
    for axis in range(3):
        coords = C[axis] * (
            scale * jnp.arange(out_shape[axis], dtype=jnp.float32) + delta[axis] - cc
        ) + cc
        M_raw = _interp_or_nearest_matrix(coords, cube, modes[0])
        Ma = M_raw
        if post_a is not None and post_a[axis] is not None:
            Ma = jnp.matmul(post_a[axis], Ma, precision=_prec())
        if axis == 2 and last_spec is not None:
            a = einsum_store(last_spec, Ma, a, out_f32=out32, store=store)
        else:
            a = apply_axis_matrix(a, Ma, axis, out_f32=out32 and axis == 2, store=store)
        if b is not None:
            Mb = (
                M_raw
                if modes[1] == modes[0]
                else _interp_or_nearest_matrix(coords, cube, modes[1])
            )
            if post_b is not None and post_b[axis] is not None:
                Mb = jnp.matmul(post_b[axis], Mb, precision=_prec())
            if axis == 2 and last_spec is not None:
                b = einsum_store(last_spec, Mb, b, out_f32=out32, store=store)
            else:
                b = apply_axis_matrix(b, Mb, axis, out_f32=out32 and axis == 2, store=store)
    return a, b


def warp_rigid_zoom_first(
    v, q_idx, angles, scale, delta, out_size=None, post=None, out_perm=None,
    emit_f32=True,
):
    """See :func:`_warp_rigid_zoom_first_impl`; wrapper reads the storage
    scope at caller trace time (static jit key — see linops.einsum_store)."""
    from .linops import _store_dtype

    return _warp_rigid_zoom_first_impl(
        v, q_idx, angles, scale, delta, out_size=out_size, post=post,
        out_perm=out_perm, emit_f32=emit_f32, store=_store_dtype(),
    )


@functools.partial(
    jax.jit, static_argnames=("out_size", "out_perm", "emit_f32", "store")
)
def _warp_rigid_zoom_first_impl(
    v, q_idx, angles, scale, delta, out_size=None, post=None, out_perm=None,
    emit_f32=True, store=None,
):
    """Single-operand rigid warp with the ZOOM FIRST: same map as
    :func:`warp_rigid_pair_traced` (``out[q] = V[A q + t]`` for
    rotation-times-isotropic-scale from :func:`decompose_affine_paeth_host`),
    but the isotropic scale is applied BEFORE the rotation shears.

    Why a second ordering exists: for downsampling maps (``scale > 1``, e.g.
    the scanner's small-frame acquisition where the stack frame lives in
    slice-pixel units), zoom-first means every shear runs on the SMALL
    ``out_size`` buffer instead of the large input cube — and the rotated
    content provably fits, because the output frame's FOV covers the
    input's rotated projection by construction (that is the caller's
    eligibility condition). Interpolation order differs from the zoom-last
    path, so results match to interpolation-noise (exactly for affine
    fields), not bitwise.

    Algebra: with ``R_res`` the residual rotation (Euler XYZ of ``angles``)
    and ``c_in/c_out`` the buffer centers, the zoom-last contract
    ``out[q] = quarter(V)[R_res(s q + delta - c_in) + c_in]`` re-factors as

        Z[p]   = quarter(V)[s p + d]
        out[q] = Z[R_res(q - c_out) + c_out]
        d      = R_res(delta - c_in + s c_out) + c_in - s c_out

    The centered rotation uses the same 6-unit-shear ladder with deferred
    per-axis diagonals ``C``; since no final zoom follows, the diagonals are
    applied as three per-axis interp matmuls — into which the caller's
    ``post`` operators (e.g. the scanner's acquisition PSF) compose for
    free. ``out_perm=(1, 2, 0)`` folds the final relayout like the pair
    warp does.
    """
    from .linops import _prec, apply_axis_matrix, einsum_store

    cube = v.shape[0]
    S = int(out_size) if out_size is not None else cube
    c_in = (cube - 1) / 2.0
    c_out = (S - 1) / 2.0
    work_dt = store or jnp.float32
    out32 = emit_f32 or store is None
    a = apply_quarter_turn(v.astype(work_dt), q_idx)

    # residual rotation matrix Rx(a0) Ry(a1) Rz(a2) (matches the shear
    # ladder's plane order) — tiny traced trig, device-side
    def rot_axis(axis, th):
        u_ax, v_ax = _PLANE[axis]
        R = jnp.eye(3)
        c, s = jnp.cos(th), jnp.sin(th)
        R = R.at[u_ax, u_ax].set(c).at[v_ax, v_ax].set(c)
        R = R.at[u_ax, v_ax].set(-s).at[v_ax, u_ax].set(s)
        return R

    hi = jax.lax.Precision.HIGHEST  # f32 3x3 products, never TF32
    R_res = jnp.matmul(
        jnp.matmul(rot_axis(0, angles[0]), rot_axis(1, angles[1]), precision=hi),
        rot_axis(2, angles[2]), precision=hi,
    )
    d = jnp.matmul(R_res, delta - c_in + scale * c_out, precision=hi) + c_in - scale * c_out

    # zoom: Z[p] = quarter(V)[scale * p + d], three per-axis matmuls from the
    # input cube onto the S-sized output frame
    lanes = jnp.arange(S, dtype=jnp.float32)
    for axis in range(3):
        M = _interp_or_nearest_matrix(scale * lanes + d[axis], cube, False)
        a = apply_axis_matrix(a, M, axis, store=store)

    # centered rotation: 6 unit shears with deferred diagonals (see
    # warp_rigid_pair_traced for the factorization)
    C = [jnp.float32(1.0)] * 3
    for axis in range(3):
        u_ax, v_ax = _PLANE[axis]
        th = angles[axis]
        c = jnp.cos(th)
        s = jnp.sin(th)
        C[u_ax] = C[u_ax] / c
        C[v_ax] = C[v_ax] * c
        amt_u = (-s * c) * C[u_ax] / C[v_ax]
        amt_v = (s / c) * C[v_ax] / C[u_ax]
        a, _ = _shear_pass_pair_mm(a, None, u_ax, v_ax, amt_u, 0.0, (False, False), store=store)
        a, _ = _shear_pass_pair_mm(a, None, v_ax, u_ax, amt_v, 0.0, (False, False), store=store)
    # deferred diagonals as per-axis interp matmuls; caller post operators
    # (PSF blur in the output frame) compose into the same contractions
    last_spec = {None: None, (1, 2, 0): "oi,jki->koj"}[out_perm]
    for axis in range(3):
        coords = C[axis] * (lanes - c_out) + c_out
        M = _interp_or_nearest_matrix(coords, S, False)
        if post is not None and post[axis] is not None:
            M = jnp.matmul(post[axis], M, precision=_prec())
        if axis == 2 and last_spec is not None:
            a = einsum_store(last_spec, M, a, out_f32=out32, store=store)
        else:
            a = apply_axis_matrix(a, M, axis, out_f32=out32 and axis == 2, store=store)
    return a


def warp_affine_field_separable(vol, A, t, Fx, Fy, Fz, nearest=False):
    """Fused affine + displacement warp: ``out[o] = V[A (o + F(o)) + t']``.

    Six passes instead of eight: the U-stage handles the affine exactly; the
    L-stage passes carry the displacement, using the identity
    ``U^{-1} (A F) = L F`` (so the per-pass displacement fields are just
    L-combinations of the raw field components evaluated on the output grid).
    Same first-order triangular approximation for the field as
    :func:`warp_displacement_separable`.
    """
    D, H, W = vol.shape
    U, L = ul_decompose(A)
    t = jnp.asarray(t, jnp.float32)
    dt = vol.dtype
    v = vol.astype(jnp.float32)
    lim = FIELD_LIM

    gx = jnp.clip(Fx, -lim, lim)
    gy = jnp.clip(L[1, 0] * Fx + Fy, -lim, lim)
    gz = jnp.clip(L[2, 0] * Fx + L[2, 1] * Fy + Fz, -lim, lim)

    # U-stage: W1(p) = V[U p + t]
    x = hat_pass(v, (0.0, 0.0, U[2, 2], t[2]), None, (D, H, W), nearest)
    x = jnp.transpose(x, (0, 2, 1))  # (i, k, j)
    x = hat_pass(x, (0.0, U[1, 2], U[1, 1], t[1]), None, (D, W, H), nearest)
    x = jnp.transpose(x, (2, 1, 0))  # (j, k, i)
    x = hat_pass(x, (U[0, 1], U[0, 2], U[0, 0], t[0]), None, (H, W, D), nearest)

    # L-stage with displacement: out(o) = W1[L o + g(o)]
    # y-pass (lanes j): pos = l10 i + j + gy
    x = jnp.transpose(x, (2, 1, 0))  # (i, k, j)
    x = hat_pass(
        x, (L[1, 0], 0.0, 1.0, 0.0), jnp.transpose(gy, (0, 2, 1)), (D, W, H), nearest
    )
    # z-pass (lanes k): pos = l20 i + l21 j + k + gz
    x = jnp.transpose(x, (0, 2, 1))  # (i, j, k)
    x = hat_pass(x, (L[2, 0], L[2, 1], 1.0, 0.0), gz, (D, H, W), nearest)
    # x-pass (lanes i): pos = i + gx
    x = jnp.transpose(x, (1, 2, 0))  # (j, k, i)
    x = hat_pass(
        x, (0.0, 0.0, 1.0, 0.0), jnp.transpose(gx, (1, 2, 0)), (H, W, D), nearest
    )
    return jnp.transpose(x, (2, 0, 1)).astype(dt)


def warp_affine_field_pair(va, vb, A, t, Fx, Fy, Fz):
    """Fused affine+field warp of (linear, nearest) volume pair — 6 shared
    passes (see :func:`warp_affine_field_separable`).

    Builds the L-mixed displacement combos at FULL resolution and transposes
    them into the pass layouts. The pipeline's hot path avoids this: it
    combines the SMALL fields before upsampling (zoom is linear, so the
    results agree to f32 association) and upsamples directly into each pass's
    layout — see :func:`warp_affine_field_pair_pre`.
    """
    U, L = ul_decompose(A)
    lim = FIELD_LIM
    gx = jnp.clip(Fx, -lim, lim)
    gy = jnp.clip(L[1, 0] * Fx + Fy, -lim, lim)
    gz = jnp.clip(L[2, 0] * Fx + L[2, 1] * Fy + Fz, -lim, lim)
    return warp_affine_field_pair_pre(
        va, vb, A, t,
        jnp.transpose(gy, (0, 2, 1)), gz, jnp.transpose(gx, (1, 2, 0)),
    )


def warp_affine_field_pair_pre(va, vb, A, t, gyT, gz, gxT):
    """Fused affine+field warp of a (linear, nearest) pair from
    PRE-COMBINED, PRE-LAYOUTED displacement fields:

    - ``gyT`` = clip(L10*Fx + Fy, +-FIELD_LIM) in (D, W, H) layout,
    - ``gz``  = clip(L20*Fx + L21*Fy + Fz, ...) in (D, H, W) layout,
    - ``gxT`` = clip(Fx, ...) in (H, W, D) layout,

    with L from :func:`ul_decompose`. The U-z and U-y passes carry no
    displacement and no row_i term, so they run as batched matmuls; the
    three displacement-carrying L passes are hat passes.

    The L-z pass's ``L21*j`` row term is peeled into its own row-affine
    matmul (``Y[i,j,k] = X[i,j,k + L21*j]`` then the hat pass samples
    ``Y[i, j, L20*i + k + gz]`` — positions compose exactly). Cost: one
    extra linear interpolation along k for the linear operand — the same
    sheared-kernel error class as the U-x split below. The nearest (label)
    operand likewise gains a chained rounding step:
    ``round(round(k + L21*j) + ...)`` instead of one round of the composed
    position, which can shift a label by one voxel near half-integer
    positions.
    """
    D, H, W = va.shape
    U, L = ul_decompose(A)
    t = jnp.asarray(t, jnp.float32)
    a = va.astype(jnp.float32)
    b = vb.astype(jnp.float32)
    modes = (False, True)

    def tp(x, p):
        return jnp.transpose(x, p)

    # U stage: every matmul emits the NEXT stage's layout directly via the
    # einsum output order (out_order) — no standalone pair transposes.
    # U-z: pos_k = U22*k + t2 (lanes only) — batched matmul, amount 0
    a, b = _row_affine_matmul_pair(a, b, U[2, 2], 0.0, t[2], modes, out_order="ikj")
    # U-y on (i, k, j): pos_j = U12*k + U11*j + t1 — batched matmul over k
    a, b = _row_affine_matmul_pair(a, b, U[1, 1], U[1, 2], t[1], modes, out_order="kji")
    # U-x: pos_i = U00*i + U01*j + U02*k + t0 has TWO row terms — split into
    # two single-row-term batched matmuls (i <- i + U02*k, then
    # i <- U00*i + U01*j + t0; compositions compose along the lane axis), so
    # the whole U stage is matmuls and only the three displacement passes
    # below are hat passes. Extra cost: one more interpolation along i
    # (same sheared-kernel error class the Paeth trios accept).
    a, b = _row_affine_matmul_pair(a, b, 1.0, U[0, 2], 0.0, modes, out_order="jik")  # (j,k,i), row k
    a, b = _row_affine_matmul_pair(a, b, U[0, 0], U[0, 1], t[0], modes, out_order="kij")  # (k,j,i), row j
    a, b = hat_pass_pair(a, b, (L[1, 0], 0.0, 1.0, 0.0), gyT, (D, W, H))
    a, b = tp(a, (0, 2, 1)), tp(b, (0, 2, 1))
    # L-z peel: k <- k + L21*j as a matmul, then the hat pass carries only
    # the L20*i term + the field
    a, b = _row_affine_matmul_pair(a, b, 1.0, L[2, 1], 0.0, modes, out_order="ijk")
    a, b = hat_pass_pair(a, b, (L[2, 0], 0.0, 1.0, 0.0), gz, (D, H, W))
    a, b = tp(a, (1, 2, 0)), tp(b, (1, 2, 0))
    a, b = hat_pass_pair(a, b, (0.0, 0.0, 1.0, 0.0), gxT, (H, W, D))
    return jnp.transpose(a, (2, 0, 1)), jnp.transpose(b, (2, 0, 1)).astype(vb.dtype)
