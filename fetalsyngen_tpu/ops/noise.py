"""Structured noise fields: Perlin/fractal noise and mixture-of-Gaussian maps.

Reference parity with ``fetalsyngen/generator/artifacts/utils.py``:
- ``perlin_noise_3d`` / ``fractal_noise_3d`` == ``generate_perlin_noise_3d`` /
  ``generate_fractal_noise_3d`` (``utils.py:224-388``), re-designed gather-free:
  lattice gradients are *repeated* into cell-constant volumes (cells are large,
  32^3+), so the corner dot-products are pure elementwise math — no gathers.
  Note: the reference reseeds NumPy with time.time() here (``utils.py:365-367``),
  destroying reproducibility; we thread an explicit PRNG key instead.
- ``mog_3d`` == ``mog_3d_tensor`` (``utils.py:125-160``) with centers given in
  (i, j, k) grid order matching the volume axes. (The reference pairs the
  first center coordinate with the last grid axis — a transposition we do not
  replicate.)
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=64)
def _perlin_axis_mats(s: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis fade-interpolation operators for the separable Perlin form.

    The classic 8-corner trilinear fade blend factorizes per gradient
    component: with per-axis corner weights ``w0 = 1-fade(d)``, ``w1 =
    fade(d)`` and offsets ``(d-a)``, the x-gradient term is

        sum_{a,b,c} [w_a(d0)*(d0-a)] * w_b(d1) * w_c(d2) * gx[(i0+a)%r, ...]

    i.e. a rank-1 chain of three (s, r) matrices applied to the (r, r, r)
    lattice — small matmuls instead of materializing 8 corners x 3
    gradient volumes. ``A`` carries the plain fade weights, ``Ad`` the
    fade-weighted displacement ``w_a(d)*(d-a)``. The ``% r`` wrap reproduces
    the reference's tileable ``gradients[-1] = gradients[0]`` identification.
    """
    c = s // r
    i = np.arange(s)
    i0 = i // c
    d = (i % c) / c
    t = d * d * d * (d * (d * 6 - 15) + 10)
    A = np.zeros((s, r), np.float32)
    Ad = np.zeros((s, r), np.float32)
    np.add.at(A, (i, i0), 1 - t)
    np.add.at(A, (i, (i0 + 1) % r), t)
    np.add.at(Ad, (i, i0), (1 - t) * d)
    np.add.at(Ad, (i, (i0 + 1) % r), t * (d - 1))
    return A, Ad


def perlin_noise_3d(key: jax.Array, shape: tuple[int, int, int], res: tuple[int, int, int]):
    """Tileable 3D Perlin noise (reference ``utils.py:224-327`` semantics).

    ``shape`` must be divisible by ``res``. Evaluated in the separable
    matmul form (see :func:`_perlin_axis_mats`): three small per-axis
    operators upsample each gradient-component lattice, so the whole field
    costs ~4 full-volume writes instead of the naive 8-corner blend's ~30.

    The matmul precision scope is read HERE (caller trace time) and threaded
    into the jitted impl as a static arg — a module-level jit must key its
    trace cache on the scope (see ``linops.einsum_store``).
    """
    from .linops import _prec

    return _perlin_noise_3d_impl(key, shape, res, prec=_prec())


@partial(jax.jit, static_argnames=("shape", "res", "prec"))
def _perlin_noise_3d_impl(
    key: jax.Array, shape: tuple[int, int, int], res: tuple[int, int, int], prec=None
):
    k1, k2 = jax.random.split(key)
    theta = 2 * jnp.pi * jax.random.uniform(k1, (res[0], res[1], res[2]))
    phi = 2 * jnp.pi * jax.random.uniform(k2, (res[0], res[1], res[2]))
    gx = jnp.sin(phi) * jnp.cos(theta)
    gy = jnp.sin(phi) * jnp.sin(theta)
    gz = jnp.cos(phi)

    mats = [_perlin_axis_mats(shape[d], res[d]) for d in range(3)]

    def up(g, M0, M1, M2):
        t = jnp.einsum("Ia,abc->Ibc", jnp.asarray(M0), g, precision=prec)
        t = jnp.einsum("Jb,Ibc->IJc", jnp.asarray(M1), t, precision=prec)
        return jnp.einsum("Kc,IJc->IJK", jnp.asarray(M2), t, precision=prec)

    (A0, A0d), (A1, A1d), (A2, A2d) = mats
    return (
        up(gx, A0d, A1, A2) + up(gy, A0, A1d, A2) + up(gz, A0, A1, A2d)
    )


def fractal_noise_3d(
    key: jax.Array,
    shape: tuple[int, int, int],
    res: tuple[int, int, int],
    octaves=1,
    persistence: float = 0.5,
    lacunarity: int = 2,
    increase: float = 0.0,
    max_octaves: int = 4,
):
    """Multi-octave Perlin, normalized to [0, 1] (``utils.py:330-388``).

    ``octaves`` may be TRACED (the randomized draws change per sample) — the
    loop runs ``max_octaves`` (static) times with amplitudes masked, so one
    compiled program serves every octave count instead of recompiling per
    draw. Precision scope threading: see :func:`perlin_noise_3d`.
    """
    from .linops import _prec

    return _fractal_noise_3d_impl(
        key, shape, res, octaves, persistence=persistence, lacunarity=lacunarity,
        increase=increase, max_octaves=max_octaves, prec=_prec(),
    )


@partial(
    jax.jit,
    static_argnames=("shape", "res", "lacunarity", "max_octaves", "prec"),
)
def _fractal_noise_3d_impl(
    key: jax.Array,
    shape: tuple[int, int, int],
    res: tuple[int, int, int],
    octaves=1,
    persistence: float = 0.5,
    lacunarity: int = 2,
    increase: float = 0.0,
    max_octaves: int = 4,
    prec=None,
):
    noise = jnp.zeros(shape, jnp.float32)
    frequency = 1
    amplitude = 1.0
    for o in range(max_octaves):
        if any(s % (frequency * r) or frequency * r > s for s, r in zip(shape, res)):
            break  # lattice no longer divides the grid — octave unreachable
        gate = (o < jnp.asarray(octaves)).astype(jnp.float32)
        noise += gate * amplitude * _perlin_noise_3d_impl(
            jax.random.fold_in(key, o),
            shape,
            tuple(frequency * r for r in res),
            prec=prec,
        )
        frequency *= lacunarity
        amplitude *= persistence
    noise = (noise + increase - noise.min()) / (noise.max() - noise.min())
    return jnp.clip(noise, 0.0, 1.0)


def mog_3d(
    shape: tuple[int, int, int],
    centers: jnp.ndarray,
    sigmas: jnp.ndarray,
    valid: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Sum of Gaussians, clipped to [0, 1] (``utils.py:125-160``).

    Args:
        shape: volume shape.
        centers: (N, 3) float centers in (i, j, k) grid coordinates.
        sigmas: (N, 3) per-axis sigmas (broadcastable).
        valid: optional (N,) mask (fixed-shape padding support).
    """
    centers = jnp.asarray(centers, jnp.float32)
    sigmas = jnp.broadcast_to(jnp.asarray(sigmas, jnp.float32), centers.shape)
    if valid is None:
        valid = jnp.ones(centers.shape[0], bool)

    # An axis-aligned Gaussian factorizes per axis, so the mixture is a rank-N
    # tensor contraction: exp evaluations drop from N*D*H*W (a scan of full
    # volumes — ~3.3e9 exps for 200 centers at 256^3) to N*(D+H+W), and the
    # accumulation is a matmul.
    def axis_factor(axis):
        g = jnp.arange(shape[axis], dtype=jnp.float32)[None, :]
        return jnp.exp(-0.5 * ((g - centers[:, axis : axis + 1]) / sigmas[:, axis : axis + 1]) ** 2)

    from .linops import _prec

    fx = axis_factor(0) * valid[:, None]  # (N, D)
    fy = axis_factor(1)  # (N, H)
    fz = axis_factor(2)  # (N, W)
    t = fx[:, :, None] * fy[:, None, :]  # (N, D, H)
    acc = jnp.einsum("ndh,nw->dhw", t, fz, precision=_prec())
    return jnp.clip(acc, 0.0, 1.0)
