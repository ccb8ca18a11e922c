"""XYB <-> linear sRGB color transform (device path, jnp).

The opsin absorbance model of JPEG XL: linear RGB -> LMS-ish mixing ->
cube root + bias -> (X, Y, B-ish) opponent space.  Inverse uses the
serialized (or default) OpsinInverseMatrix
(headers.DEFAULT_INV_OPSIN; see ImageMetadata default_m).

This is trivial matrix work (3x3 matmuls over pixels) fused by XLA with the
surrounding elementwise ops — the analogue of what the reference does
inside libjxl_cms (SURVEY.md §2.5).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..bitstream.headers import (
    DEFAULT_INV_OPSIN, DEFAULT_OPSIN_BIAS)

# Forward opsin absorbance matrix (inverse of DEFAULT_INV_OPSIN)
OPSIN_ABSORBANCE = np.linalg.inv(
    np.array(DEFAULT_INV_OPSIN, np.float64).reshape(3, 3)).astype(np.float32)
OPSIN_BIAS = np.float32(-DEFAULT_OPSIN_BIAS[0])  # 0.003793...
CBRT_BIAS = np.cbrt(OPSIN_BIAS)


def linear_rgb_to_xyb(rgb: jnp.ndarray) -> jnp.ndarray:
    """(3, H, W) linear sRGB -> (3, H, W) XYB."""
    mix = jnp.einsum("ij,jhw->ihw", jnp.asarray(OPSIN_ABSORBANCE), rgb,
                     preferred_element_type=jnp.float32,
                     precision="highest")
    mix = jnp.maximum(mix + OPSIN_BIAS, 1e-12)
    gamma = jnp.cbrt(mix) - CBRT_BIAS
    l, m, s = gamma[0], gamma[1], gamma[2]
    x = (l - m) * 0.5
    y = (l + m) * 0.5
    b = s
    return jnp.stack([x, y, b])


def xyb_to_linear_rgb(xyb: jnp.ndarray,
                      inv_matrix=None,
                      opsin_bias=None) -> jnp.ndarray:
    """(3, H, W) XYB -> (3, H, W) linear sRGB."""
    if inv_matrix is None:
        inv_matrix = DEFAULT_INV_OPSIN
    if opsin_bias is None:
        opsin_bias = DEFAULT_OPSIN_BIAS
    x, y, b = xyb[0], xyb[1], xyb[2]
    l = x + y
    m = y - x
    s = b
    gamma = jnp.stack([l, m, s]) + CBRT_BIAS
    mixed = gamma * gamma * gamma - OPSIN_BIAS
    inv = jnp.asarray(np.array(inv_matrix, np.float32).reshape(3, 3))
    return jnp.einsum("ij,jhw->ihw", inv, mixed,
                      preferred_element_type=jnp.float32,
                     precision="highest")
