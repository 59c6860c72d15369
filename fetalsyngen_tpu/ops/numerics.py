"""Exactly-rounded scalar numerics for f32-only device programs.

The reference computes its integer grid sizes with float64 host math, e.g.
``new_size = (shape * input_res / spacing).astype(int)``
(``fetalsyngen/generator/augmentation/synthseg.py:84``). Under jit we only
have f32, and f32 division can round *across* an integer boundary: with
``spacing = 1.1f`` the true quotient ``22 / 1.1f = 19.99999957`` lies within
half an ulp of ``20.0``, so ``jnp.float32(22) / jnp.float32(1.1)`` is exactly
``20.0`` and truncates to 20 — while the f64 law yields 19. That is a
one-voxel grid-size deviation (and a replay mismatch against
reference-produced genparams) whenever a draw lands near a boundary.

:func:`floor_div_exact` computes ``floor(a / b)`` for positive f32 inputs
with the correct-rounding guarantee of the f64 law on the same inputs, using
only f32 ops: take the f32 quotient as a candidate and correct it by an
EXACT comparison of ``n * b`` against ``a`` via a Dekker two-product
(split ``b`` into 12-bit halves; both partial products are exact for
``n < 2^12``) and a Sterbenz-exact subtraction.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 (Dekker split point; Python float, exact in f32)


def _nb_le_a(n: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact predicate ``n * b <= a`` for f32 ``a, b > 0`` and integer-valued
    f32 ``n`` with ``0 <= n < 2^12`` and ``n * b`` within a factor of 2 of
    ``a`` (guaranteed by the caller's candidate construction).

    ``b = b_hi + b_lo`` with 12-bit halves makes ``n * b_hi`` and ``n * b_lo``
    exact f32 products; ``n * b_hi - a`` is exact by Sterbenz's lemma, and the
    final add cannot flip the sign of the exact sum.
    """
    c = _SPLIT * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    s = n * b_hi - a
    return s + n * b_lo <= 0.0


def floor_div_exact(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``floor(a / b)`` for positive f32 scalars/arrays, correctly rounded.

    Matches ``np.float64(a) / np.float64(b)`` truncation for all positive
    f32 ``a, b`` with quotient < 2^12 (grid sizes here are <= ~1536).
    Returns int32.
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    q0 = jnp.floor(a / b)
    # the f32 quotient is within 1 of the true floor; test upward then downward
    q = jnp.where(_nb_le_a(q0 + 1.0, a, b), q0 + 1.0, q0)
    q = jnp.where(_nb_le_a(q, a, b), q, q - 1.0)
    return q.astype(jnp.int32)
