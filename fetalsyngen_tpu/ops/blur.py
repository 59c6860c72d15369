"""Separable Gaussian blur with fixed-shape (mask-truncated) kernels.

Replaces ``make_gaussian_kernel`` / ``gaussian_blur_3d``
(reference: ``fetalsyngen/utils/generation.py:74-110``).

The reference builds a kernel of dynamic length ``2*ceil(3*sigma)+1`` per call;
under jit a dynamic kernel length would force recompilation, so we evaluate a
fixed maximum-length kernel and zero taps beyond ``ceil(3*sigma)``. Because the
reference's taps are exactly ``exp(-(t/sigma)^2/2)`` at integer offsets ``t``
normalized over the truncated support, masking + renormalizing over the fixed
window is bit-for-bit the same math. ``sigma == 0`` degenerates to identity
(the reference skips the conv in that case).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def gaussian_kernel_fixed(sigma: jnp.ndarray, half_len: int) -> jnp.ndarray:
    """Truncated, normalized Gaussian taps over a static window.

    Args:
        sigma: traced scalar std (>= 0).
        half_len: static window half-length; must satisfy
            ``half_len >= ceil(3 * sigma_max)``.

    Returns:
        (2*half_len+1,) kernel. Matches ``make_gaussian_kernel``
        (``generation.py:74-81``) zero-padded to the fixed window; identity
        (one-hot center) when ``sigma == 0``.
    """
    t = jnp.arange(-half_len, half_len + 1, dtype=jnp.float32)
    sl = jnp.ceil(3.0 * sigma)
    safe_sigma = jnp.where(sigma > 0, sigma, 1.0)
    g = jnp.exp(-((t / safe_sigma) ** 2) / 2.0)
    g = jnp.where(jnp.abs(t) <= sl, g, 0.0)
    g = g / jnp.sum(g)
    identity = (t == 0).astype(jnp.float32)
    return jnp.where(sigma > 0, g, identity)


def _conv_axis(vol: jnp.ndarray, kernel: jnp.ndarray, axis: int) -> jnp.ndarray:
    """1-D 'same' convolution of a (D,H,W) volume along ``axis``."""
    half = (kernel.shape[0] - 1) // 2
    kshape = [1, 1, 1, 1, 1]
    kshape[2 + axis] = kernel.shape[0]
    k = kernel.reshape(kshape)
    padding = [(0, 0)] * 3
    padding[axis] = (half, half)
    out = lax.conv_general_dilated(
        vol[None, None],
        k,
        window_strides=(1, 1, 1),
        padding=padding,
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


@partial(jax.jit, static_argnames=("half_len",))
def gaussian_blur_3d(vol: jnp.ndarray, stds: jnp.ndarray, half_len: int) -> jnp.ndarray:
    """Separable 3D Gaussian blur with per-axis (traced) stds.

    Equivalent to ``gaussian_blur_3d`` (``generation.py:84-110``): three
    sequential 1-D convolutions with zero padding; an axis with ``std == 0``
    is a no-op (identity kernel).

    Args:
        vol: (D, H, W) volume.
        stds: (3,) per-axis standard deviations (traced OK).
        half_len: static kernel half-length >= ceil(3 * max possible std).
    """
    stds = jnp.asarray(stds, dtype=jnp.float32)
    for axis in range(3):
        k = gaussian_kernel_fixed(stds[axis], half_len)
        vol = _conv_axis(vol, k, axis)
    return vol


def blur_half_len(max_sigma: float) -> int:
    """Static kernel half-length covering ``ceil(3 * max_sigma)``."""
    import math

    return int(math.ceil(3.0 * max_sigma))
