"""Vector-math samplers for small non-uniform draws inside traced programs.

``jax.random.gamma`` / ``poisson`` / ``beta`` lower to rejection loops
(``lax.while_loop``): serial loops inside the batch program even for a few
hundred scalars. The artifact engines draw
only a handful of such scalars per sample (reference
``fetalsyngen/generator/augmentation/artifacts.py:104,110,499-585`` uses host
NumPy), so the stream path uses closed-form equivalents instead:

- integer-shape gamma: Gamma(k, 1) == -log(prod of k uniforms) (exact law);
- Poisson: inverse-CDF against an in-program cumulative table (exact within
  fp; the table is O(kmax) scalars);
- integer beta: Beta(a, b) == G_a / (G_a + G_b) from integer gammas (exact).

These sample the same DISTRIBUTIONS as the jax.random primitives via a
different stream — fine for the stream path, which is documented as not
bit-replaying the host path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gamma_int(key: jax.Array, k: int, shape: tuple = ()) -> jnp.ndarray:
    """Gamma(k, 1) for INTEGER k as a sum of exponentials (no rejection).

    Drawn as ``k`` separate same-shape uniforms rather than one draw with a
    trailing length-``k`` dim, keeping every draw 1-D/2-D.
    """
    acc = None
    for j in range(int(k)):
        u = jax.random.uniform(jax.random.fold_in(key, j), tuple(shape), minval=1e-12)
        acc = -jnp.log(u) if acc is None else acc - jnp.log(u)
    return acc


def gamma_fast(key: jax.Array, a, shape: tuple = ()) -> jnp.ndarray:
    """Gamma(a, 1): exact product form when ``a`` is a static integer,
    ``jax.random.gamma`` otherwise."""
    if isinstance(a, (int, float)) and float(a).is_integer() and 1 <= a <= 32:
        return gamma_int(key, int(a), shape)
    return jax.random.gamma(key, a, shape)


def poisson_icdf(key: jax.Array, lam, shape: tuple = (), kmax: int = 256) -> jnp.ndarray:
    """Poisson(lam) via inverse transform on an O(kmax) cumulative table.

    Exact within fp as long as P(K > kmax) is negligible (kmax >= lam +
    10*sqrt(lam) gives < 1e-12 truncation).
    """
    k = jnp.arange(kmax + 1, dtype=jnp.float32)
    lam = jnp.asarray(lam, jnp.float32)
    logpmf = k * jnp.log(jnp.maximum(lam, 1e-12)) - lam - jax.lax.lgamma(k + 1.0)
    cdf = jnp.cumsum(jnp.exp(logpmf))
    u = jax.random.uniform(key, shape)
    return jnp.sum(u[..., None] > cdf, axis=-1).astype(jnp.int32)


def beta_int(key: jax.Array, a: int, b: int, shape: tuple = ()) -> jnp.ndarray:
    """Beta(a, b) for INTEGER a, b from two integer gammas (exact law)."""
    k1, k2 = jax.random.split(key)
    g1 = gamma_int(k1, a, shape)
    g2 = gamma_int(k2, b, shape)
    return g1 / (g1 + g2)
