"""Multi-size DCT/IDCT as batched matmuls (SURVEY.md §7.4).

All transforms are expressed as batched matmuls with orthonormal DCT-II
basis matrices, which XLA hands to the matrix units: a block batch of
shape (N, K, K) costs two (N*K, K)x(K, K) GEMMs.  This replaces
libjxl's SIMD IDCT (inside the prebuilt libjxl.so the reference wraps,
SURVEY.md §2.5) with a matmul formulation for the device.

JPEG XL uses orthonormal DCT-II with the AC scaling convention of the
spec; for the 8x8 path the forward/inverse pair here is self-inverse
(orthonormal), which is what the codestream coefficients assume after
dequantization.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: M @ x performs the forward DCT."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float32)


def dct2d(blocks: jnp.ndarray) -> jnp.ndarray:
    """Forward 2D DCT over the last two dims: (..., H, W) -> (..., H, W)."""
    h, w = blocks.shape[-2], blocks.shape[-1]
    mh = jnp.asarray(dct_matrix(h))
    mw = jnp.asarray(dct_matrix(w))
    t = jnp.einsum("ij,...jk->...ik", mh, blocks,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("...ik,lk->...il", t, mw,
                      preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def idct2d(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Inverse 2D DCT over the last two dims (transpose of dct2d)."""
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    mh = jnp.asarray(dct_matrix(h))
    mw = jnp.asarray(dct_matrix(w))
    t = jnp.einsum("ji,...jk->...ik", mh, coeffs,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("...ik,kl->...il", t, mw,
                      preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def blockify(img: jnp.ndarray, bs: int = 8) -> jnp.ndarray:
    """(C, H, W) -> (C, H//bs, W//bs, bs, bs)."""
    c, h, w = img.shape
    return img.reshape(c, h // bs, bs, w // bs, bs).transpose(0, 1, 3, 2, 4)


def unblockify(blocks: jnp.ndarray) -> jnp.ndarray:
    """(C, nY, nX, bs, bs) -> (C, nY*bs, nX*bs)."""
    c, ny, nx, bs, _ = blocks.shape
    return blocks.transpose(0, 1, 3, 2, 4).reshape(c, ny * bs, nx * bs)
