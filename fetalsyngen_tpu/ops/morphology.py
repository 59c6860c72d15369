"""Binary morphology on voxel grids (separable box sums as matmuls).

Reference parity with ``fetalsyngen/generator/artifacts/utils.py:163-210``:
``apply_kernel`` (cube box-sum conv), ``erode``, ``dilate`` — all cube
structuring elements, which factor into three 1-D box convolutions applied as
banded matmuls. ``ball_dilate`` covers ``BlurCortex``/``SimulatedBoundaries``'s
``skimage.ball`` halo (``artifacts.py:484-499``): a spherical structuring
element realized as a thresholded Euclidean-ball test via separable squared
offsets (exact sphere, no 31^3 conv).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .linops import apply_separable

_PREC = lax.Precision.HIGHEST


def _box_matrix(size: int, k: int) -> jnp.ndarray:
    """(size, size) 'same' box-sum operator of width k (zero padding)."""
    rows = lax.broadcasted_iota(jnp.int32, (size, size), 0)
    cols = lax.broadcasted_iota(jnp.int32, (size, size), 1)
    return (jnp.abs(cols - rows) <= (k // 2)).astype(jnp.float32)


@partial(jax.jit, static_argnames=("kernel_size",))
def box_sum(vol: jnp.ndarray, kernel_size: int = 3) -> jnp.ndarray:
    """== ``apply_kernel`` (``utils.py:163-171``): cube box-sum convolution.

    Pinned to f32/HIGHEST regardless of the caller's production scopes:
    this jit is shared by the replay-faithful host path and the scoped
    stream with identical avals, so its trace must be scope-independent
    (see ``linops.f32_scope``). Counts are small integers — the cost of
    the pin is negligible next to the contract risk.
    """
    from .linops import f32_scope

    with f32_scope():
        vol = vol.astype(jnp.float32)
        Ms = tuple(_box_matrix(vol.shape[a], kernel_size) for a in range(3))
        return apply_separable(vol, Ms)


@partial(jax.jit, static_argnames=("kernel_size",))
def erode(mask: jnp.ndarray, kernel_size: int = 3) -> jnp.ndarray:
    """== ``erode`` (``utils.py:174-191``): cube erosion via box-sum == k^3."""
    s = box_sum(mask.astype(jnp.float32), kernel_size)
    return (jnp.round(s).astype(jnp.int32) == kernel_size**3).astype(jnp.int32)


@partial(jax.jit, static_argnames=("kernel_size",))
def dilate(mask: jnp.ndarray, kernel_size: int = 3) -> jnp.ndarray:
    """== ``dilate`` (``utils.py:194-210``): cube dilation via box-sum > 0."""
    s = box_sum(mask.astype(jnp.float32), kernel_size)
    return (s > 0.5).astype(jnp.int32)


@partial(jax.jit, static_argnames=("radius",))
def ball_dilate(mask: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Dilation with an exact Euclidean ball (== conv with ``skimage.ball``
    then ``> 0``, reference ``build_halo``, ``artifacts.py:484-499``).

    Separable trick: dilation by a ball of radius r == thresholding the
    squared distance transform restricted to r, computed as three 1-D
    min-plus passes with parabolic increments over a (2r+1) window.
    """
    big = jnp.float32(1e9)
    # squared distance to the nearest foreground voxel, axis by axis
    # (min-plus "conv" with d^2 along each axis is exact for squared EDT)
    d2 = jnp.where(mask > 0, 0.0, big)
    for axis in range(3):
        idx = lax.broadcasted_iota(jnp.int32, d2.shape, axis)
        acc = d2
        for off in range(-radius, radius + 1):
            if off == 0:
                continue
            shifted = jnp.roll(d2, off, axis=axis)
            ok = (idx - off >= 0) & (idx - off < d2.shape[axis])
            acc = jnp.minimum(acc, jnp.where(ok, shifted + float(off * off), big))
        d2 = acc
    return (d2 <= radius * radius + 1e-3).astype(jnp.int32)
