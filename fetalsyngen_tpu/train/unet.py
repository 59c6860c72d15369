"""3D segmentation UNet in plain JAX — the downstream consumer model.

The reference ships no model (SURVEY §0: "no training loop, no model"); its
datasets feed an external trainer. To prove the end-to-end contract
(BASELINE config #5: "batched generation ... feeding a segmentation train
loop"), this module provides a compact 3D UNet whose convolutions take
bfloat16 operands and accumulate in float32.

Parameters are a nested dict; :meth:`UNet3D.init` builds it and
:meth:`UNet3D.apply` runs the network, so a trainer needs nothing beyond
JAX and optax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

_DN = ("NDHWC", "DHWIO", "NDHWC")


def _precision(dtype):
    # an f32 convolution at default precision may run in TF32 on a GPU;
    # bf16 operands are exact in either mode
    return lax.Precision.HIGHEST if jnp.dtype(dtype) == jnp.float32 else None


def _f32_result(op):
    """Differentiable ``op(x, w, preferred_element_type)`` that returns f32
    from low-precision operands. The backward pass runs ``op`` on the
    cotangent cast to the operand dtype, so every gradient convolution also
    takes low-precision operands."""

    @jax.custom_vjp
    def f(x, w):
        return op(x, w, jnp.float32)

    def fwd(x, w):
        return op(x, w, jnp.float32), (x, w)

    def bwd(res, g):
        x, w = res
        _, vjp = jax.vjp(lambda a, b: op(a, b, None), x, w)
        return vjp(g.astype(x.dtype))

    f.defvjp(fwd, bwd)
    return f


_conv = _f32_result(
    lambda x, w, out: lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=_DN,
        precision=_precision(x.dtype), preferred_element_type=out,
    )
)
_conv_t = _f32_result(
    lambda x, w, out: lax.conv_transpose(
        x, w, (2, 2, 2), "VALID", dimension_numbers=_DN,
        precision=_precision(x.dtype), preferred_element_type=out,
    )
)


def conv3d(x, w, dtype=jnp.bfloat16):
    """SAME-padded stride-1 3D convolution, ``dtype`` operands, f32 result."""
    return _conv(x.astype(dtype), w.astype(dtype))


def conv_transpose3d_x2(x, w, dtype=jnp.bfloat16):
    """Stride-2, kernel-2 transposed 3D convolution (doubles D, H, W)."""
    return _conv_t(x.astype(dtype), w.astype(dtype))


def group_norm(x, scale, bias, groups, eps=1e-6):
    """Group normalisation over (D, H, W, C/groups), statistics in f32."""
    B, D, H, W, C = x.shape
    xg = x.astype(jnp.float32).reshape(B, D, H, W, groups, C // groups)
    mean = xg.mean(axis=(1, 2, 3, 5), keepdims=True)
    var = jnp.square(xg - mean).mean(axis=(1, 2, 3, 5), keepdims=True)
    xg = (xg - mean) * lax.rsqrt(var + eps)
    return xg.reshape(B, D, H, W, C) * scale + bias


def max_pool_x2(x):
    return lax.reduce_window(
        x, -jnp.inf, lax.max, (1, 2, 2, 2, 1), (1, 2, 2, 2, 1), "VALID"
    )


@dataclasses.dataclass(frozen=True)
class UNet3D:
    """Encoder-decoder with skip connections over (B, D, H, W, C) volumes."""

    channels: Sequence[int] = (16, 32, 64)
    n_classes: int = 8
    dtype: jnp.dtype = jnp.bfloat16

    def init(self, key, x) -> dict:
        """Random parameters for inputs shaped like ``x`` (B, D, H, W, C_in)."""
        keys = iter(jax.random.split(key, 64))
        lecun = jax.nn.initializers.lecun_normal()

        def conv(k, cin, cout):
            return {"w": lecun(next(keys), (k, k, k, cin, cout), jnp.float32),
                    "b": jnp.zeros((cout,), jnp.float32)}

        def block(cin, cout):
            return [
                {"conv": conv(3, c, cout),
                 "norm": {"scale": jnp.ones((cout,), jnp.float32),
                          "bias": jnp.zeros((cout,), jnp.float32)}}
                for c in (cin, cout)
            ]

        chs = tuple(self.channels)
        cin = x.shape[-1]
        params: dict = {"down": [], "up": []}
        for ch in chs[:-1]:
            params["down"].append(block(cin, ch))
            cin = ch
        params["bottom"] = block(cin, chs[-1])
        cin = chs[-1]
        for ch in reversed(chs[:-1]):
            params["up"].append({"tconv": conv(2, cin, ch), "block": block(2 * ch, ch)})
            cin = ch
        params["head"] = conv(1, cin, self.n_classes)
        return params

    def _block(self, p, x):
        for layer in p:
            x = conv3d(x, layer["conv"]["w"], self.dtype) + layer["conv"]["b"]
            c = x.shape[-1]
            x = group_norm(x, layer["norm"]["scale"], layer["norm"]["bias"], min(8, c))
            x = jax.nn.silu(x).astype(self.dtype)
        return x

    def apply(self, params: dict, x) -> jnp.ndarray:
        """f32 logits (B, D, H, W, n_classes)."""
        x = x.astype(self.dtype)
        skips = []
        for p in params["down"]:
            x = self._block(p, x)
            skips.append(x)
            x = max_pool_x2(x)
        x = self._block(params["bottom"], x)
        for p, skip in zip(params["up"], reversed(skips)):
            x = conv_transpose3d_x2(x, p["tconv"]["w"], self.dtype) + p["tconv"]["b"]
            x = jnp.concatenate([x.astype(self.dtype), skip], axis=-1)
            x = self._block(p["block"], x)
        head = params["head"]
        return conv3d(x, head["w"], jnp.float32) + head["b"]
