"""The plain-JAX 3D UNet consumer model (``train/unet.py``)."""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from fetalsyngen_tpu.train.unet import UNet3D, conv3d


def test_unet_output_shape_and_dtype():
    model = UNet3D(channels=(4, 8, 16), n_classes=3)
    x = jnp.ones((2, 16, 16, 16, 1), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)
    out = model.apply(params, x)
    assert out.shape == (2, 16, 16, 16, 3) and out.dtype == jnp.float32
    assert bool(jnp.isfinite(out).all())


def test_unet_gradient_is_finite():
    model = UNet3D(channels=(4, 8), n_classes=3)
    x = jax.random.uniform(jax.random.PRNGKey(1), (1, 8, 8, 8, 1))
    labels = jax.random.randint(jax.random.PRNGKey(2), (1, 8, 8, 8), 0, 3)
    params = model.init(jax.random.PRNGKey(0), x)

    def loss(p):
        logits = model.apply(p, x)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(labels, 3), -1))

    grads = jax.grad(loss)(params)
    leaves = jax.tree.leaves(grads)
    assert all(g.dtype == jnp.float32 for g in leaves)
    assert all(bool(jnp.isfinite(g).all()) for g in leaves)
    assert any(float(jnp.abs(g).max()) > 0 for g in leaves)


def test_bf16_conv_accumulates_in_f32():
    """bf16 operands, f32 result: equal to an exact f32 convolution of the
    bf16-rounded operands, not to a bf16-rounded result."""
    kx, kw = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.normal(kx, (1, 8, 8, 8, 16))
    w = jax.random.normal(kw, (3, 3, 3, 16, 8))
    got = conv3d(x, w)
    assert got.dtype == jnp.float32
    xb = x.astype(jnp.bfloat16).astype(jnp.float32)
    wb = w.astype(jnp.bfloat16).astype(jnp.float32)
    ref = lax.conv_general_dilated(
        xb, wb, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-4)
    rounded = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    assert np.abs(np.asarray(got) - rounded).max() > 1e-3  # not a bf16 result
