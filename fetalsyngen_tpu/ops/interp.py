"""Fixed-shape 3D interpolation primitives (JAX/XLA).

These replace the reference's voxel kernels in ``fetalsyngen/utils/generation.py``:

- ``trilinear_interp`` / ``nearest_interp`` == ``fast_3D_interp_torch``
  (``generation.py:204-288``) — the hot trilinear gather over a 256^3 grid.
- ``zoom`` == ``myzoom_torch`` (``generation.py:310-397``), whose Python
  per-index loops are replaced by three vectorized separable 1-D interpolations.

Design notes:
- All shapes are static; coordinates/indices may be traced values, so the same
  compiled program serves every random deformation.
- The trilinear gather fetches all 8 corners with a single ``lax.gather`` of
  2x2x2 slices (one descriptor, contiguous innermost pairs) rather than 8
  scalar gathers. Edge handling folds the reference's corner clamping into the
  floor index: ``f = clip(floor(x), 0, D-2)``, ``w = x - f`` reproduces
  ``c = min(f+1, D-1)`` exactly for coordinates inside ``[0, D-1]``.
- Out-of-bounds semantics replicate the reference: in linear mode a voxel is
  "ok" iff ``x > 0 and x <= D-1`` (strictly greater than zero — a reference
  quirk, ``generation.py:228-235``); others get ``default_value``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _corner_indices(coord: jnp.ndarray, size: int | jnp.ndarray):
    """Floor index (clamped to size-2) and fractional weight for linear interp."""
    f = jnp.clip(jnp.floor(coord), 0, size - 2)
    w = coord - f
    return f.astype(jnp.int32), w


def gather_trilinear(vol: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray):
    """Trilinear sample of ``vol`` (D,H,W) at float coords (any shape).

    Coordinates are assumed within [0, dim-1] (callers clamp); returns values
    with the same shape as ``x``.
    """
    D, H, W = vol.shape
    shape = x.shape
    xf, wx = _corner_indices(x.reshape(-1), D)
    yf, wy = _corner_indices(y.reshape(-1), H)
    zf, wz = _corner_indices(z.reshape(-1), W)

    # Eight flat row-major gathers keep every intermediate at (N,) and let
    # XLA fuse the corner FMA tree.
    flat = vol.reshape(-1)
    base = (xf * H + yf) * W + zf

    def g(off):
        return jnp.take(flat, base + off, mode="clip")

    c000, c001 = g(0), g(1)
    c010, c011 = g(W), g(W + 1)
    c100, c101 = g(H * W), g(H * W + 1)
    c110, c111 = g(H * W + W), g(H * W + W + 1)

    c00 = c000 * (1.0 - wz) + c001 * wz
    c01 = c010 * (1.0 - wz) + c011 * wz
    c10 = c100 * (1.0 - wz) + c101 * wz
    c11 = c110 * (1.0 - wz) + c111 * wz
    c0 = c00 * (1.0 - wy) + c01 * wy
    c1 = c10 * (1.0 - wy) + c11 * wy
    out = c0 * (1.0 - wx) + c1 * wx
    return out.reshape(shape)


def trilinear_interp(
    vol: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    z: jnp.ndarray,
    default_value: float | jnp.ndarray = 0.0,
) -> jnp.ndarray:
    """``fast_3D_interp_torch(..., mode="linear")`` equivalent.

    Reference: ``fetalsyngen/utils/generation.py:227-288``.
    """
    D, H, W = vol.shape
    ok = (x > 0) & (y > 0) & (z > 0) & (x <= D - 1) & (y <= H - 1) & (z <= W - 1)
    vals = gather_trilinear(vol, jnp.clip(x, 0, D - 1), jnp.clip(y, 0, H - 1), jnp.clip(z, 0, W - 1))
    return jnp.where(ok, vals, default_value).astype(vol.dtype)


def nearest_interp(vol: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """``fast_3D_interp_torch(..., mode="nearest")`` equivalent.

    Rounds coordinates, clamps to the volume bounds, and gathers.
    Reference: ``fetalsyngen/utils/generation.py:211-225``.
    """
    D, H, W = vol.shape
    xi = jnp.clip(jnp.round(x), 0, D - 1).astype(jnp.int32)
    yi = jnp.clip(jnp.round(y), 0, H - 1).astype(jnp.int32)
    zi = jnp.clip(jnp.round(z), 0, W - 1).astype(jnp.int32)
    flat_idx = (xi * H + yi) * W + zi
    return jnp.take(vol.reshape(-1), flat_idx.reshape(-1)).reshape(x.shape)


def interp_axis_linear(
    x: jnp.ndarray,
    coords: jnp.ndarray,
    axis: int,
    in_size: jnp.ndarray | int | None = None,
) -> jnp.ndarray:
    """Linear interpolation along one axis at (traced) float ``coords``.

    ``in_size`` optionally restricts the valid extent of the input axis (used
    when a logically smaller volume lives in the corner of a fixed-shape
    buffer). Coordinates are clamped to ``[0, in_size-1]`` with edge
    duplication, matching ``myzoom_torch``'s clamping
    (``generation.py:340-363``).
    """
    size = x.shape[axis] if in_size is None else in_size
    coords = jnp.clip(coords, 0, size - 1)
    f = jnp.clip(jnp.floor(coords), 0, size - 2).astype(jnp.int32)
    w = (coords - f).astype(x.dtype)
    lo = jnp.take(x, f, axis=axis, mode="clip")
    hi = jnp.take(x, f + 1, axis=axis, mode="clip")
    bshape = [1] * x.ndim
    bshape[axis] = -1
    w = w.reshape(bshape)
    return lo * (1.0 - w) + hi * w


def zoom_coords(out_size: int, factor: jnp.ndarray):
    """Sample coordinates for ``myzoom_torch``-style zoom along one axis.

    ``v[i] = delta + i / factor`` with ``delta = (1 - factor) / (2 factor)``
    (``generation.py:315-338``). ``out_size`` is static; ``factor`` may be traced.
    """
    delta = (1.0 - factor) / (2.0 * factor)
    i = jnp.arange(out_size, dtype=jnp.float32)
    return delta + i / factor


@partial(jax.jit, static_argnames=("out_shape",))
def zoom(
    x: jnp.ndarray,
    out_shape: tuple[int, int, int],
    factor: jnp.ndarray | None = None,
    in_shape: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Separable trilinear zoom of the leading 3 axes to ``out_shape``.

    Equivalent to ``myzoom_torch(X, factor)`` (``generation.py:310-397``) with
    ``out_shape = round(X.shape * factor)``, but the three Python loops become
    three vectorized axis interpolations (channels broadcast along trailing
    axes).

    Args:
        x: (D, H, W) or (D, H, W, C) input.
        out_shape: static output spatial shape.
        factor: per-axis zoom factor; defaults to ``out_shape / x.shape[:3]``.
            May be a traced array (e.g. when the logical input occupies a
            dynamic corner of the fixed buffer).
        in_shape: optional traced logical input extent (<= x.shape[:3]).
    """
    if factor is None:
        factor = jnp.array([out_shape[d] / x.shape[d] for d in range(3)], dtype=jnp.float32)
    factor = jnp.asarray(factor, dtype=jnp.float32)
    for axis in range(3):
        coords = zoom_coords(out_shape[axis], factor[axis])
        size = None if in_shape is None else in_shape[axis]
        x = interp_axis_linear(x, coords, axis=axis, in_size=size)
    return x
