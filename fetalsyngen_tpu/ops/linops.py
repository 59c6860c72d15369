"""Separable voxel ops as dense matmuls — the pipeline's hot path.

Every separable 1-D operation in the pipeline (Gaussian blur, zoom,
anisotropic resample) is a banded linear operator along one axis,
implemented as a dense ``(out_dim, in_dim)`` matrix applied with
``dot_general``. For a 256^3 volume one axis pass is a
``256x256 @ 256x65536`` matmul (~4.3 GFLOP).

The small operator matrices are built per sample from *traced* parameters
(sigma, zoom factors, logical sizes), so one compiled program serves every
randomization draw.

Semantics match the reference kernels exactly:
- ``blur_matrix``      == truncated ``make_gaussian_kernel`` + 'same' conv
                          (``generation.py:74-110``);
- ``interp_matrix(oob_zero=True)``  == ``fast_3D_interp_torch`` linear-mode
                          per-axis factor on a product grid (``generation.py:227-288``);
- ``interp_matrix(oob_zero=False)`` == ``myzoom_torch`` clamped interpolation
                          (``generation.py:310-397``).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax import lax

_PREC = lax.Precision.HIGHEST
_PREC_OVERRIDE: lax.Precision | None = None


@contextlib.contextmanager
def precision_scope(prec: lax.Precision):
    """TRACE-time matmul precision override for a code region.

    The framework's numerical contract is f32 (``Precision.HIGHEST``; an
    f32 contraction left at default precision may run in TF32 on a GPU) —
    golden tests and the replay-faithful host artifact path depend on it.
    The batched artifact STREAM opts into ``Precision.DEFAULT`` (TF32 for
    f32 operands on a GPU; bf16 operands under :func:`storage_scope`)
    inside this scope: its outputs are synthetic degradations that immediately receive
    Rician noise/gamma/voids, so sub-percent matmul error is invisible,
    and the stream is documented as non-replay-exact anyway
    (``generator/artifacts/batched.py``). The scope only affects operations
    TRACED while it is active; independently-jitted host-path programs are
    untouched.
    """
    global _PREC_OVERRIDE
    old = _PREC_OVERRIDE
    _PREC_OVERRIDE = prec
    try:
        yield
    finally:
        _PREC_OVERRIDE = old


def _prec() -> lax.Precision:
    return _PREC if _PREC_OVERRIDE is None else _PREC_OVERRIDE


_STORE_OVERRIDE = None


@contextlib.contextmanager
def storage_scope(dtype):
    """TRACE-time INTERMEDIATE-STORAGE dtype override for a code region.

    ``precision_scope`` only changes how the matmuls compute — every pass
    still reads and writes f32 buffers, and the scanner's matmul chains
    move ~0.43 GB per 384^3 f32 touch. Under
    ``storage_scope(jnp.bfloat16)`` the chain helpers (:func:`axis_mm`,
    ``warp._shear_pass_pair_mm``, the scanner's Mn2z/spread contractions)
    keep intermediates in bf16: operands are cast INTO the matmuls (the
    convert fuses into the dot's operand read) and accumulation stays f32
    via ``preferred_element_type``, so only the storage narrows — half the
    memory traffic on every interior pass. Stage boundaries that feed
    non-matmul consumers (the recon accumulator) emit f32 through the
    producing matmul's epilogue (``out_f32=True``).

    STREAM-ONLY, like the precision override: relative error per pass is
    ~2^-9, the artifact outputs receive Rician noise/gamma afterwards, and
    the stream is documented non-replay-exact. Host-path programs trace
    outside the scope and are untouched.
    """
    global _STORE_OVERRIDE
    old = _STORE_OVERRIDE
    _STORE_OVERRIDE = dtype
    try:
        yield
    finally:
        _STORE_OVERRIDE = old


def _store_dtype():
    return _STORE_OVERRIDE


@contextlib.contextmanager
def f32_scope():
    """Suspend BOTH production scopes: the framework's f32/HIGHEST contract.

    Module-level jitted functions whose semantics must not depend on the
    caller's scope (replay-faithful host programs, mask morphology) wrap
    their bodies in this — every trace then produces identical f32 programs,
    so their aval-keyed jit caches cannot be poisoned by a scoped caller.
    """
    with precision_scope(None), storage_scope(None):
        yield


_UNSET = object()


def einsum_store(
    spec: str, M: jnp.ndarray, x: jnp.ndarray, out_f32: bool = False, store=_UNSET
):
    """``jnp.einsum(spec, M, x)`` honoring the storage scope.

    Outside a scope: the framework's f32 contract (``_prec()`` precision).
    Inside: bf16 x bf16 -> f32-accumulate form, output narrowed back to
    the storage dtype unless ``out_f32`` marks a segment boundary.

    ``store``: explicit storage dtype (or None), for code traced inside a
    JITTED shared function — the scope global is trace-time state, so a
    jitted function must take it as a STATIC argument (part of its cache
    key) and thread it down; otherwise two callers with identical avals but
    different scopes would collide in the trace cache. Non-jitted helpers
    traced directly under distinct outer programs may use the default
    (read the scope at trace time).
    """
    d = _store_dtype() if store is _UNSET else store
    if d is None:
        return jnp.einsum(spec, M, x, precision=_prec())
    if jax.default_backend() == "cpu":
        # XLA:CPU's DotThunk cannot execute bf16 x bf16 -> f32 on some hosts.
        # Products of two bf16 values are exact in f32, so contracting the
        # NARROWED operands in f32 is the same computation up to accumulation
        # order; only the CPU test/fallback path takes this branch.
        y = jnp.einsum(
            spec,
            M.astype(d).astype(jnp.float32),
            x.astype(d).astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        y = jnp.einsum(spec, M.astype(d), x.astype(d), preferred_element_type=jnp.float32)
    return y if out_f32 else y.astype(d)


def toeplitz_blur_matrix(sigma: jnp.ndarray, size: int, half_len: int) -> jnp.ndarray:
    """(size, size) 'same'-conv Gaussian operator for a traced sigma.

    Row i holds the truncated normalized kernel centered at i; zero padding at
    the borders falls out of the band structure. ``sigma == 0`` yields the
    identity.
    """
    t = jnp.arange(-half_len, half_len + 1, dtype=jnp.float32)
    sl = jnp.ceil(3.0 * sigma)
    safe = jnp.where(sigma > 0, sigma, 1.0)
    g = jnp.exp(-((t / safe) ** 2) / 2.0)
    g = jnp.where(jnp.abs(t) <= sl, g, 0.0)
    g = g / jnp.sum(g)
    kernel = jnp.where(sigma > 0, g, (t == 0).astype(jnp.float32))

    rows = lax.broadcasted_iota(jnp.int32, (size, size), 0)
    cols = lax.broadcasted_iota(jnp.int32, (size, size), 1)
    idx = cols - rows + half_len
    valid = (idx >= 0) & (idx <= 2 * half_len)
    return jnp.where(valid, jnp.take(kernel, jnp.clip(idx, 0, 2 * half_len)), 0.0)


def interp_matrix(
    coords: jnp.ndarray,
    in_size: int,
    in_valid: jnp.ndarray | int | None = None,
    out_valid: jnp.ndarray | int | None = None,
    oob_zero: bool = False,
) -> jnp.ndarray:
    """(out, in_size) linear-interpolation operator at traced ``coords``.

    Args:
        coords: (out,) sample positions along the axis.
        in_size: static input buffer length.
        in_valid: traced logical input extent (<= in_size); clamping uses it.
        out_valid: traced logical output extent; rows beyond it are zeroed.
        oob_zero: reference linear-mode OOB semantics — rows whose coordinate
            is not strictly inside ``(0, valid-1]`` are zeroed (default value
            0) instead of clamped.
    """
    out = coords.shape[0]
    valid_in = in_size if in_valid is None else in_valid
    ok = (coords > 0) & (coords <= valid_in - 1)
    c = jnp.clip(coords, 0, valid_in - 1)
    f = jnp.clip(jnp.floor(c), 0, valid_in - 2)
    w = (c - f).astype(jnp.float32)
    fi = f.astype(jnp.int32)

    cols = lax.broadcasted_iota(jnp.int32, (out, in_size), 1)
    W = (
        (cols == fi[:, None]).astype(jnp.float32) * (1.0 - w)[:, None]
        + (cols == fi[:, None] + 1).astype(jnp.float32) * w[:, None]
    )
    if oob_zero:
        W = W * ok[:, None]
    if out_valid is not None:
        rows = lax.broadcasted_iota(jnp.int32, (out, 1), 0)
        W = W * (rows < out_valid)
    return W


def apply_axis_matrix(
    vol: jnp.ndarray, M: jnp.ndarray, axis: int, out_f32: bool = False, store=_UNSET
) -> jnp.ndarray:
    """Contract ``vol``'s ``axis`` with operator ``M`` (out, in) as a matmul.

    Honors :func:`storage_scope` (bf16 intermediates on the stream path);
    ``out_f32`` marks a segment boundary whose consumer needs f32. See
    :func:`einsum_store` for the ``store`` threading rule.
    """
    return einsum_store(
        {0: "oi,ijk->ojk", 1: "oi,jik->jok", 2: "oi,jki->jko"}[axis],
        M,
        vol,
        out_f32=out_f32,
        store=store,
    )


def apply_separable(vol: jnp.ndarray, Ms: tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """Apply one operator per axis (order 0, 1, 2)."""
    for axis, M in enumerate(Ms):
        vol = apply_axis_matrix(vol, M, axis)
    return vol


def gaussian_blur_mm(vol: jnp.ndarray, stds: jnp.ndarray, half_len: int) -> jnp.ndarray:
    """Separable Gaussian blur via three matmuls (== ``gaussian_blur_3d``)."""
    Ms = tuple(toeplitz_blur_matrix(stds[a], vol.shape[a], half_len) for a in range(3))
    return apply_separable(vol, Ms)


def zoom_mm(
    vol: jnp.ndarray,
    out_shape: tuple[int, int, int],
    factor: jnp.ndarray,
    in_shape: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """``myzoom_torch``-style zoom via matmuls (== ``ops.interp.zoom``)."""
    Ms = []
    for axis in range(3):
        delta = (1.0 - factor[axis]) / (2.0 * factor[axis])
        i = jnp.arange(out_shape[axis], dtype=jnp.float32)
        coords = delta + i / factor[axis]
        Ms.append(
            interp_matrix(
                coords,
                vol.shape[axis],
                in_valid=None if in_shape is None else in_shape[axis],
            )
        )
    return apply_separable(vol, tuple(Ms))
