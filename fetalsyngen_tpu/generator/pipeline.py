"""The fixed-shape, jit-once, vmap-able synthesis pipeline.

This is the jit-once re-design of ``FetalSynthGen.generate/augment``
(reference ``fetalsyngen/generator/model.py:94-229``): the entire
seed -> GMM intensities -> flip/affine/nonlinear warp -> gamma -> bias field ->
anisotropic resample -> noise -> resize-back chain compiles to ONE XLA program
over a static ``(D, H, W)`` grid.

Dynamic behavior in the reference becomes fixed-shape here:

- probability gates (``np.random.rand() < prob``) -> sampled booleans +
  ``jnp.where`` selects (all branches compute; under ``vmap`` every batch
  element takes its own gate values with no divergence);
- the dynamically-sized low-res nonlinear/bias fields -> static max-size
  buffers whose logical extent is a traced ``size`` (interpolation clamps to
  it, so unused tail values are never read);
- the dynamically-sized resample grid -> the full-resolution buffer with a
  traced logical corner extent ``new_size`` + validity masks.

Randomness: one ``jax.random`` key per sample; scalar parameters come from
:func:`sample_params` (replayable via genparams overrides), voxel fields from
``field_key`` folds of the same key, so (key, genparams) -> volume is exactly
reproducible.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.affine import centered_grid, make_affine_matrix
from ..ops.interp import nearest_interp, trilinear_interp, zoom_coords
from ..ops.linops import (
    apply_separable,
    gaussian_blur_mm,
    interp_matrix,
    zoom_mm,
)
from ..ops.warp import (
    warp_affine_field_pair,
    warp_affine_field_separable,
    warp_affine_separable,
    warp_displacement_separable,
)
from .config import GeneratorCfg
from .params import GenParams, field_key, sample_params


# ---------------------------------------------------------------------------
# Stage 1: GMM intensity sampling (reference rand_gmm.py:101-154)
# ---------------------------------------------------------------------------

def intensity_stage(key: jax.Array, seeds: jnp.ndarray, p: GenParams) -> jnp.ndarray:
    """``intensity = mus[seeds] + sigmas[seeds] * N(0,1)``, clamped at 0.

    Stray labels outside the table clamp to its ends (``mode="clip"``).
    """
    noise = jax.random.normal(field_key(key, "field_intensity"), seeds.shape, jnp.float32)
    flat = seeds.reshape(-1).astype(jnp.int32)
    mu = jnp.take(p.mus, flat, mode="clip").reshape(seeds.shape)
    sigma = jnp.take(p.sigmas, flat, mode="clip").reshape(seeds.shape)
    return jnp.maximum(mu + sigma * noise, 0.0)


# ---------------------------------------------------------------------------
# Stage 2: spatial deformation (reference affine_nonrigid.py:86-366)
# ---------------------------------------------------------------------------

def deformation_coords(key: jax.Array, p: GenParams, cfg: GeneratorCfg):
    """Build the warp coordinate grids ``xx2, yy2, zz2``.

    Mirrors ``generate_deformation`` + ``deform_image``
    (``affine_nonrigid.py:195-366``): centered grid, optional low-res
    Gaussian displacement field upsampled to full res, affine, clamp, and the
    reference's margin shift by ``floor(min(coord))``.
    """
    shape = cfg.shape
    dcfg = cfg.deform
    xc, yc, zc = centered_grid(shape)

    if dcfg.nonlinear_transform:
        Fx, Fy, Fz = _nonlin_field(key, p, cfg)
        xx1 = xc + Fx
        yy1 = yc + Fy
        zz1 = zc + Fz
    else:
        xx1 = xc + jnp.zeros(shape, jnp.float32)
        yy1 = yc + jnp.zeros(shape, jnp.float32)
        zz1 = zc + jnp.zeros(shape, jnp.float32)

    A = make_affine_matrix(p.rotations, p.shears, p.scalings)
    # random_shift (affine_nonrigid.py:271-284): with shp == cfg.shape the
    # max shift is 0, so c2 is the exact center.
    c2 = (jnp.asarray(shape, jnp.float32) - 1.0) / 2.0

    xx2 = A[0, 0] * xx1 + A[0, 1] * yy1 + A[0, 2] * zz1 + c2[0]
    yy2 = A[1, 0] * xx1 + A[1, 1] * yy1 + A[1, 2] * zz1 + c2[1]
    zz2 = A[2, 0] * xx1 + A[2, 1] * yy1 + A[2, 2] * zz1 + c2[2]
    xx2 = jnp.clip(xx2, 0, shape[0] - 1)
    yy2 = jnp.clip(yy2, 0, shape[1] - 1)
    zz2 = jnp.clip(zz2, 0, shape[2] - 1)

    if dcfg.margin_shift:
        # affine_nonrigid.py:350-358 — shift coords by the floor of their min.
        xx2 = xx2 - jnp.floor(jnp.min(xx2))
        yy2 = yy2 - jnp.floor(jnp.min(yy2))
        zz2 = zz2 - jnp.floor(jnp.min(zz2))
    return xx2, yy2, zz2


def _flip0(vol: jnp.ndarray, flip: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(flip, vol[::-1], vol)


def _nonlin_field(key: jax.Array, p: GenParams, cfg: GeneratorCfg):
    """Upsample the low-res displacement field to (3, D, H, W).

    The field is POSITION data: under the bf16 production scopes a
    quantized field would jitter every warp coordinate (~0.2% of seg labels
    flip at deformation-cell boundaries). Positions stay f32 — the scopes
    are suspended for the 3 upsample chains (trivial traffic next to the
    image passes), keeping the seg chain voxel-exact vs the f32 contract.
    """
    from ..ops.linops import precision_scope, storage_scope

    shape = cfg.shape
    smax = cfg.deform.small_field_max()
    f_small = p.nonlin_std * jax.random.normal(
        field_key(key, "field_nonlin"), (3, *smax), jnp.float32
    )
    factor = jnp.asarray(shape, jnp.float32) / p.size_F_small.astype(jnp.float32)
    with precision_scope(None), storage_scope(None):
        return tuple(
            zoom_mm(f_small[c], shape, factor, in_shape=p.size_F_small)
            for c in range(3)
        )


def _deform_pair_small_fields(key, p, cfg, A, c1, c2, vol_lin, vol_near):
    """Pair warp with all field mixing done on the SMALL displacement field.

    The full-res fields the warp and mask consume are LINEAR in the small
    field (upsample = per-axis matmuls), so every combination is formed at
    small-field size first:

    - L-mixed warp displacements (``warp_affine_field_pair_pre``), upsampled
      straight into each pass's layout (permute the small field, zoom with
      permuted factors) — no full-res combos, no displacement transposes;
    - A-mixed coordinate deviations ``H = A F`` for the composite OOB mask
      and margin shift (``deform_image``'s clamp + ``floor(min(coord))``
      semantics, ``affine_nonrigid.py:327-366``).

    Positions stay f32 (scopes suspended), like :func:`_nonlin_field`.
    """
    from ..ops.linops import precision_scope, storage_scope
    from ..ops.warp import FIELD_LIM, ul_decompose, warp_affine_field_pair_pre

    shape = cfg.shape
    smax = cfg.deform.small_field_max()
    f_small = p.nonlin_std * jax.random.normal(
        field_key(key, "field_nonlin"), (3, *smax), jnp.float32
    )
    U, L = ul_decompose(A)
    lim = FIELD_LIM
    gx_s = f_small[0]
    gy_s = L[1, 0] * f_small[0] + f_small[1]
    gz_s = L[2, 0] * f_small[0] + L[2, 1] * f_small[1] + f_small[2]
    h_s = jnp.einsum("ij,jabc->iabc", A, f_small, precision=jax.lax.Precision.HIGHEST)
    factor = jnp.asarray(shape, jnp.float32) / p.size_F_small.astype(jnp.float32)

    def zoomP(small, perm):
        out_shape = tuple(shape[q] for q in perm)
        fac = jnp.stack([factor[q] for q in perm])
        in_shape = jnp.stack([p.size_F_small[q] for q in perm])
        return zoom_mm(jnp.transpose(small, perm), out_shape, fac, in_shape=in_shape)

    with precision_scope(None), storage_scope(None):
        gyT = jnp.clip(zoomP(gy_s, (0, 2, 1)), -lim, lim)
        gz = jnp.clip(zoomP(gz_s, (0, 1, 2)), -lim, lim)
        gxT = jnp.clip(zoomP(gx_s, (1, 2, 0)), -lim, lim)
        Hx = zoomP(h_s[0], (0, 1, 2))
        Hy = zoomP(h_s[1], (0, 1, 2))
        Hz = zoomP(h_s[2], (0, 1, 2))

    xc, yc, zc = centered_grid(shape)
    Xr = A[0, 0] * xc + A[0, 1] * yc + A[0, 2] * zc + c2[0] + Hx
    Yr = A[1, 0] * xc + A[1, 1] * yc + A[1, 2] * zc + c2[1] + Hy
    Zr = A[2, 0] * xc + A[2, 1] * yc + A[2, 2] * zc + c2[2] + Hz
    Xc = jnp.clip(Xr, 0, shape[0] - 1)
    Yc = jnp.clip(Yr, 0, shape[1] - 1)
    Zc = jnp.clip(Zr, 0, shape[2] - 1)

    if cfg.deform.margin_shift:
        shift = jnp.stack(
            [jnp.floor(jnp.min(Xc)), jnp.floor(jnp.min(Yc)), jnp.floor(jnp.min(Zc))]
        )
    else:
        shift = jnp.zeros(3, jnp.float32)

    ok = (
        (Xc - shift[0] > 0)
        & (Yc - shift[1] > 0)
        & (Zc - shift[2] > 0)
        & (Xc - shift[0] <= shape[0] - 1)
        & (Yc - shift[1] <= shape[1] - 1)
        & (Zc - shift[2] <= shape[2] - 1)
    )

    t = c2 - jnp.matmul(A, c1, precision=jax.lax.Precision.HIGHEST) - shift
    a, b = warp_affine_field_pair_pre(vol_lin, vol_near, A, t, gyT, gz, gxT)
    return [jnp.where(ok, a, 0.0)], [b.astype(vol_near.dtype)]


def _deform_separable(
    key: jax.Array,
    p: GenParams,
    cfg: GeneratorCfg,
    volumes_linear: list[jnp.ndarray],
    volumes_nearest: list[jnp.ndarray],
):
    """Separable warp: affine triangular passes + small-displacement passes.

    Samples ``V[A (o - c1 + F(o)) + c2 - shift]`` like the reference
    (``deform_image``, ``affine_nonrigid.py:327-366``), with the composite OOB
    mask and margin shift computed closed-form.

    Hot path (the image+segmentation pair): the L-mixed displacement combos
    and the mask's A-mixed coordinate deviations are formed on the SMALL
    field and upsampled directly into each consumer's layout — upsampling is
    linear, so this matches the combine-at-full-res order to f32 association
    while skipping the full-res combo pass, two full-volume displacement
    transposes, and the three raw-field buffers entirely.
    """
    shape = cfg.shape
    dcfg = cfg.deform
    c1 = (jnp.asarray(shape, jnp.float32) - 1.0) / 2.0
    c2 = c1  # random_shift degenerates to the center for shp == size
    A = make_affine_matrix(p.rotations, p.shears, p.scalings)

    if dcfg.nonlinear_transform and len(volumes_linear) == 1 and len(volumes_nearest) == 1:
        return _deform_pair_small_fields(
            key, p, cfg, A, c1, c2, volumes_linear[0], volumes_nearest[0]
        )

    if dcfg.nonlinear_transform:
        Fx, Fy, Fz = _nonlin_field(key, p, cfg)
    else:
        Fx = Fy = Fz = jnp.zeros(shape, jnp.float32)

    # composite raw coordinates (elementwise, no gathers)
    xc, yc, zc = centered_grid(shape)
    gx = xc + Fx
    gy = yc + Fy
    gz = zc + Fz
    Xr = A[0, 0] * gx + A[0, 1] * gy + A[0, 2] * gz + c2[0]
    Yr = A[1, 0] * gx + A[1, 1] * gy + A[1, 2] * gz + c2[1]
    Zr = A[2, 0] * gx + A[2, 1] * gy + A[2, 2] * gz + c2[2]
    Xc = jnp.clip(Xr, 0, shape[0] - 1)
    Yc = jnp.clip(Yr, 0, shape[1] - 1)
    Zc = jnp.clip(Zr, 0, shape[2] - 1)

    if dcfg.margin_shift:
        shift = jnp.stack(
            [jnp.floor(jnp.min(Xc)), jnp.floor(jnp.min(Yc)), jnp.floor(jnp.min(Zc))]
        )
    else:
        shift = jnp.zeros(3, jnp.float32)

    ok = (
        (Xc - shift[0] > 0)
        & (Yc - shift[1] > 0)
        & (Zc - shift[2] > 0)
        & (Xc - shift[0] <= shape[0] - 1)
        & (Yc - shift[1] <= shape[1] - 1)
        & (Zc - shift[2] <= shape[2] - 1)
    )

    t = c2 - jnp.matmul(A, c1, precision=jax.lax.Precision.HIGHEST) - shift

    def run(vol, nearest):
        if dcfg.nonlinear_transform:
            return warp_affine_field_separable(vol, A, t, Fx, Fy, Fz, nearest=nearest)
        return warp_affine_separable(vol, A, t, nearest=nearest)

    # Fast path: the image + segmentation pair shares each pass's sample
    # positions. Extra linear volumes (load_image) take the single-volume
    # path.
    if dcfg.nonlinear_transform and len(volumes_nearest) == 1:
        a, b = warp_affine_field_pair(volumes_linear[0], volumes_nearest[0], A, t, Fx, Fy, Fz)
        lin = [jnp.where(ok, a, 0.0)] + [
            jnp.where(ok, run(v, False), 0.0) for v in volumes_linear[1:]
        ]
        near = [b.astype(volumes_nearest[0].dtype)]
        return lin, near

    lin = [jnp.where(ok, run(v, False), 0.0) for v in volumes_linear]
    near = [run(v.astype(jnp.float32), True).astype(v.dtype) for v in volumes_nearest]
    return lin, near


def deform_stage(
    key: jax.Array,
    p: GenParams,
    cfg: GeneratorCfg,
    output: jnp.ndarray,
    segmentation: jnp.ndarray,
    image: jnp.ndarray | None,
):
    """Flip + warp of output/image (linear), segmentation (nearest).

    Gate semantics match ``generate_deformation_and_flip``
    (``affine_nonrigid.py:122-162``): when the gate is off there is no flip
    and no warp. ``cfg.deform.warp_impl`` selects the exact trilinear gather
    or the separable axis-pass warp.
    """
    apply = p.deform_apply
    flip = jnp.logical_and(p.flip, apply)

    out_f = _flip0(output, flip)
    seg_f = _flip0(segmentation, flip)
    img_f = _flip0(image, flip) if image is not None else None

    if cfg.deform.warp_impl == "exact":
        xx2, yy2, zz2 = deformation_coords(key, p, cfg)
        out_w = trilinear_interp(out_f, xx2, yy2, zz2)
        seg_w = nearest_interp(seg_f, xx2, yy2, zz2)
        img_w = trilinear_interp(img_f, xx2, yy2, zz2) if image is not None else None
    else:
        lins = [out_f] + ([img_f] if image is not None else [])
        lin, near = _deform_separable(key, p, cfg, lins, [seg_f])
        out_w = lin[0]
        img_w = lin[1] if image is not None else None
        seg_w = near[0]

    output = jnp.where(apply, out_w, output)
    segmentation = jnp.where(apply, seg_w, segmentation)
    if image is not None:
        image = jnp.where(apply, img_w, image)
    return output, segmentation, image


# ---------------------------------------------------------------------------
# Stage 3: gamma (synthseg.py:250-275)
# ---------------------------------------------------------------------------

def gamma_stage(output: jnp.ndarray, p: GenParams) -> jnp.ndarray:
    transformed = 300.0 * jnp.power(jnp.maximum(output, 0.0) / 300.0, p.gamma)
    return jnp.where(p.gamma_apply, transformed, output)


# ---------------------------------------------------------------------------
# Stage 4: bias field (synthseg.py:144-188)
# ---------------------------------------------------------------------------

def bias_stage(key: jax.Array, output: jnp.ndarray, p: GenParams, cfg: GeneratorCfg) -> jnp.ndarray:
    shape = cfg.shape
    bmax = cfg.bias_field.small_field_max(shape)
    small = p.bf_std * jax.random.normal(field_key(key, "field_bias"), bmax, jnp.float32)
    factor = jnp.asarray(shape, jnp.float32) / p.bf_size.astype(jnp.float32)
    bf = jnp.exp(zoom_mm(small, shape, factor, in_shape=p.bf_size))
    return jnp.where(p.bf_apply, output * bf, output)


# ---------------------------------------------------------------------------
# Stage 5+6+7: resample -> noise -> resize back
# (synthseg.py:50-114, 206-235; orchestration model.py:193-207)
# ---------------------------------------------------------------------------

def resample_noise_stage(
    key: jax.Array, output: jnp.ndarray, p: GenParams, cfg: GeneratorCfg
) -> jnp.ndarray:
    shape = cfg.shape
    in_res = jnp.asarray(cfg.resolution, jnp.float32)
    apply = p.resample_apply

    # --- blur (synthseg.py:78-81): std law, zeroed where spacing <= in_res
    stds = p.blur_mult * jnp.log(5.0) / jnp.pi * p.spacing / in_res
    stds = jnp.where((p.spacing > in_res) & apply, stds, 0.0)
    half_len = cfg.resample.blur_half_len(cfg.resolution)
    blurred = gaussian_blur_mm(output, stds, half_len)

    # --- downsample to the logical corner [0:new_size] (synthseg.py:84-104).
    # The reference interpolates a product meshgrid with the full trilinear
    # kernel; on a product grid that factorizes into three 1-D operators,
    # each a matmul with the linear-mode OOB semantics folded into
    # zeroed rows.
    # downsample grid size: sampled/overridden in params (exact f64-law
    # truncation, see sample_params); identity when the gate is off
    new_size = jnp.where(apply, p.new_size, jnp.asarray(shape, jnp.int32))
    factors = new_size.astype(jnp.float32) / jnp.asarray(shape, jnp.float32)

    down_Ms = tuple(
        interp_matrix(
            zoom_coords(shape[axis], factors[axis]),
            shape[axis],
            out_valid=new_size[axis],
            oob_zero=True,
        )
        for axis in range(3)
    )
    ds = apply_separable(blurred, down_Ms)
    ds = jnp.where(apply, ds, blurred)

    # --- noise at the (logical) low resolution (synthseg.py:218-233)
    corner = (
        (jax.lax.broadcasted_iota(jnp.int32, shape, 0) < new_size[0])
        & (jax.lax.broadcasted_iota(jnp.int32, shape, 1) < new_size[1])
        & (jax.lax.broadcasted_iota(jnp.int32, shape, 2) < new_size[2])
    )
    noise = jax.random.normal(field_key(key, "field_noise"), shape, jnp.float32)
    noisy = jnp.maximum(ds + p.noise_std * noise * corner, 0.0)
    noisy = jnp.where(p.noise_apply, noisy, ds)

    # --- resize back (synthseg.py:109-114): zoom 1/factors then /max
    up_Ms = tuple(
        interp_matrix(
            zoom_coords(
                shape[axis],
                jnp.asarray(shape[axis], jnp.float32) / new_size[axis].astype(jnp.float32),
            ),
            shape[axis],
            in_valid=new_size[axis],
        )
        for axis in range(3)
    )
    up = apply_separable(noisy, up_Ms)
    peak = jnp.max(up)
    up = up / jnp.where(peak > 0, peak, 1.0)
    return jnp.where(apply, up, noisy)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

# Stage sets for the reference's split public API (model.py:94-159 generate =
# intensity + deform; model.py:161-229 augment = gamma..resize-back).
STAGES_ALL = ("intensity", "deform", "augment")
STAGES_GENERATE = ("intensity", "deform")
STAGES_AUGMENT = ("augment",)


def _synth_core(
    key: jax.Array,
    seeds: jnp.ndarray,
    segmentation: jnp.ndarray,
    image: jnp.ndarray,
    override_values: tuple,
    cfg: GeneratorCfg,
    override_names: tuple,
    with_image: bool,
    use_seeds: bool = True,
    stages: tuple = STAGES_ALL,
):
    """Jitted synth core (wrapper). Reads the matmul precision / storage
    scopes at caller trace time and threads them into the impl as STATIC
    args — a module-level jit must key its trace cache on the scopes, or a
    scoped caller (the bf16 stream/bench production mode) and an unscoped
    one (the replay-faithful f32 host path) with identical avals would
    collide (see ``linops.einsum_store``)."""
    from ..ops import linops as _lo

    return _synth_core_impl(
        key, seeds, segmentation, image, override_values, cfg, override_names,
        with_image, use_seeds=use_seeds, stages=stages,
        prec=_lo._PREC_OVERRIDE, store=_lo._store_dtype(),
    )


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "override_names", "with_image", "use_seeds", "stages", "prec",
        "store",
    ),
)
def _synth_core_impl(
    key: jax.Array,
    seeds: jnp.ndarray,
    segmentation: jnp.ndarray,
    image: jnp.ndarray,
    override_values: tuple,
    cfg: GeneratorCfg,
    override_names: tuple,
    with_image: bool,
    use_seeds: bool = True,
    stages: tuple = STAGES_ALL,
    prec=None,
    store=None,
):
    import contextlib

    from ..ops.linops import precision_scope, storage_scope

    # re-establish the scopes from the STATIC key so the body's helpers see
    # them regardless of the global state at this trace
    with (
        precision_scope(prec) if prec is not None else contextlib.nullcontext()
    ), (storage_scope(store) if store is not None else contextlib.nullcontext()):
        return _synth_core_body(
            key, seeds, segmentation, image, override_values, cfg,
            override_names, with_image, use_seeds, stages,
        )


def _synth_core_body(
    key, seeds, segmentation, image, override_values, cfg, override_names,
    with_image, use_seeds, stages,
):
    overrides = dict(zip(override_names, override_values))
    p = sample_params(key, cfg, overrides)

    if use_seeds and "intensity" in stages:
        output = intensity_stage(key, seeds, p)
    else:
        # image-as-intensity prior (reference model.py:131-139; ``seeds``
        # already holds the rescaled image), or augment-only entry.
        output = seeds

    img = image if with_image else None
    if "deform" in stages:
        output, segmentation, img = deform_stage(key, p, cfg, output, segmentation, img)

    if "augment" in stages:
        output = gamma_stage(output, p)
        output = bias_stage(key, output, p, cfg)
        output = resample_noise_stage(key, output, p, cfg)
    return output, segmentation, img, p


def synth_sample(
    key: jax.Array,
    seeds: jnp.ndarray,
    segmentation: jnp.ndarray,
    image: jnp.ndarray | None = None,
    cfg: GeneratorCfg = GeneratorCfg(),
    overrides: dict | None = None,
    intensity_prior: jnp.ndarray | None = None,
    stages: tuple = STAGES_ALL,
):
    """Generate one synthetic (image, segmentation) pair.

    Args:
        key: per-sample PRNG key.
        seeds: (D, H, W) int seed-label volume (already summed across
            meta-labels, values grouped 1-19 CSF / 20-29 GM / 30-39 WM /
            40-49 extra-cerebral like the reference), or None when
            ``intensity_prior`` is given.
        segmentation: (D, H, W) int label volume.
        image: optional (D, H, W) f32 volume, co-deformed when given.
        cfg: static generator config.
        overrides: flat genparams overrides (see ``params.overrides_from_genparams``).
        intensity_prior: optional (D, H, W) f32 [0,255] volume used instead of
            GMM sampling (reference's image-as-intensity mode).

    Returns:
        (output, segmentation, image_or_None, GenParams).
    """
    from .params import resolve_new_size_override

    # host-precision new_size from a concrete spacing (must happen OUTSIDE
    # jit — inside, sample_params only sees the f32 tracer)
    ov = dict(sorted(resolve_new_size_override(overrides or {}, cfg).items()))
    names = tuple(ov.keys())
    values = tuple(jnp.asarray(v) for v in ov.values())
    with_image = image is not None
    img = image if with_image else jnp.zeros((), jnp.float32)
    use_seeds = intensity_prior is None
    base = seeds if use_seeds else jnp.asarray(intensity_prior, jnp.float32)
    out, seg, img, p = _synth_core(
        key, base, segmentation, img, values, cfg, names, with_image, use_seeds, stages
    )
    return out, seg, (img if with_image else None), p


def synth_batch(
    keys: jax.Array,
    seeds: jnp.ndarray,
    segmentations: jnp.ndarray,
    cfg: GeneratorCfg = GeneratorCfg(),
):
    """vmapped batch generation: (B,) keys + (B, D, H, W) volumes."""
    fn = jax.vmap(
        lambda k, sd, sg: _synth_core(
            k, sd, sg, jnp.zeros((), jnp.float32), (), cfg, (), False
        )[:2]
    )
    return fn(keys, seeds, segmentations)
