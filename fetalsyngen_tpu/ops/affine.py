"""Affine matrix construction and coordinate grids.

Replaces ``make_affine_matrix`` (reference:
``fetalsyngen/utils/generation.py:39-71``) with a traced-jnp version so the
matrix can be built inside a jitted pipeline from sampled parameters, and
provides centered meshgrids matching ``SpatialDeformation._prepare_grid``
(``fetalsyngen/generator/deformation/affine_nonrigid.py:64-84``).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _mm(a, b):
    """Full f32 matmul — at default precision a GPU may run it in TF32
    (10-bit mantissa), which loses ~3 decimal digits on the composed affine
    chain."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def make_affine_matrix(rot: jnp.ndarray, sh: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Build the 3x3 affine ``diag(s) @ SHx @ SHy @ SHz @ Rx @ Ry @ Rz``.

    Identical composition order to the reference (``generation.py:39-71``):
    shears use the same index layout (``SHx`` uses ``sh[1], sh[2]`` etc.) and
    scaling multiplies rows.

    Args:
        rot: (3,) rotations in radians.
        sh: (3,) shear coefficients.
        s: (3,) scale factors.
    """
    rot = jnp.asarray(rot, dtype=jnp.float32)
    sh = jnp.asarray(sh, dtype=jnp.float32)
    s = jnp.asarray(s, dtype=jnp.float32)
    cx, sx = jnp.cos(rot[0]), jnp.sin(rot[0])
    cy, sy = jnp.cos(rot[1]), jnp.sin(rot[1])
    cz, sz = jnp.cos(rot[2]), jnp.sin(rot[2])
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)

    Rx = jnp.array([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = jnp.array([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = jnp.array([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])

    SHx = jnp.array([[one, zero, zero], [sh[1], one, zero], [sh[2], zero, one]])
    SHy = jnp.array([[one, sh[0], zero], [zero, one, zero], [zero, sh[2], one]])
    SHz = jnp.array([[one, zero, sh[0]], [zero, one, sh[1]], [zero, zero, one]])

    A = _mm(_mm(_mm(_mm(_mm(SHx, SHy), SHz), Rx), Ry), Rz)
    return A * s[:, None]


def centered_grid(shape: tuple[int, int, int]):
    """Centered (ij-indexed) coordinate grids.

    Returns ``xc, yc, zc`` where ``xc[i,j,k] = i - (D-1)/2`` etc., matching
    ``_prepare_grid`` (``affine_nonrigid.py:64-84``). Built from broadcast
    iotas so XLA materializes no host-side meshgrid.
    """
    D, H, W = shape
    c = jnp.array([(D - 1) / 2.0, (H - 1) / 2.0, (W - 1) / 2.0], dtype=jnp.float32)
    xc = jnp.arange(D, dtype=jnp.float32)[:, None, None] - c[0]
    yc = jnp.arange(H, dtype=jnp.float32)[None, :, None] - c[1]
    zc = jnp.arange(W, dtype=jnp.float32)[None, None, :] - c[2]
    return xc, yc, zc
