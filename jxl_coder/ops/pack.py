"""Pixel-format packing (jnp) — the imagebit kernel equivalents
(SURVEY.md §2.4): RGBA8888, RGBA_F16, RGB565, RGBA1010102 with the
PreferredColorConfig dispatch of ReformatBitmap.cpp:46-263."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


@jax.jit
def to_rgba8888(rgba_f: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) float [0,1] -> uint8 RGBA."""
    return jnp.clip(jnp.round(rgba_f * 255.0), 0, 255).astype(jnp.uint8)


@jax.jit
def to_rgba_f16(rgba_f: jnp.ndarray) -> jnp.ndarray:
    return rgba_f.astype(jnp.float16)


@jax.jit
def to_rgb565(rgb_f: jnp.ndarray) -> jnp.ndarray:
    """(..., >=3) float -> uint16 RGB565 little-endian packed."""
    r = jnp.clip(jnp.round(rgb_f[..., 0] * 31.0), 0, 31).astype(jnp.uint32)
    g = jnp.clip(jnp.round(rgb_f[..., 1] * 63.0), 0, 63).astype(jnp.uint32)
    b = jnp.clip(jnp.round(rgb_f[..., 2] * 31.0), 0, 31).astype(jnp.uint32)
    return ((r << 11) | (g << 5) | b).astype(jnp.uint16)


@jax.jit
def from_rgb565(packed: jnp.ndarray) -> jnp.ndarray:
    v = packed.astype(jnp.uint32)
    r = ((v >> 11) & 31).astype(jnp.float32) / 31.0
    g = ((v >> 5) & 63).astype(jnp.float32) / 63.0
    b = (v & 31).astype(jnp.float32) / 31.0
    return jnp.stack([r, g, b], axis=-1)


@jax.jit
def to_rgba1010102(rgba_f: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) float -> uint32 RGBA1010102 (R low bits, A top 2)."""
    r = jnp.clip(jnp.round(rgba_f[..., 0] * 1023.0), 0, 1023)
    g = jnp.clip(jnp.round(rgba_f[..., 1] * 1023.0), 0, 1023)
    b = jnp.clip(jnp.round(rgba_f[..., 2] * 1023.0), 0, 1023)
    a = jnp.clip(jnp.round(rgba_f[..., 3] * 3.0), 0, 3)
    return (r.astype(jnp.uint32) | (g.astype(jnp.uint32) << 10)
            | (b.astype(jnp.uint32) << 20) | (a.astype(jnp.uint32) << 30))


@jax.jit
def from_rgba1010102(packed: jnp.ndarray) -> jnp.ndarray:
    v = packed.astype(jnp.uint32)
    r = (v & 1023).astype(jnp.float32) / 1023.0
    g = ((v >> 10) & 1023).astype(jnp.float32) / 1023.0
    b = ((v >> 20) & 1023).astype(jnp.float32) / 1023.0
    a = ((v >> 30) & 3).astype(jnp.float32) / 3.0
    return jnp.stack([r, g, b, a], axis=-1)


def reformat(rgba_f: np.ndarray, config: int, bits_per_sample: int = 8):
    """PreferredColorConfig dispatch (ReformatBitmap.cpp:52-63):
    DEFAULT picks F16 for >8-bit content, else 8888."""
    from ..api import PreferredColorConfig as C
    x = jnp.asarray(rgba_f)
    if config == C.DEFAULT:
        config = C.RGBA_F16 if bits_per_sample > 8 else C.RGBA_8888
    if config == C.RGBA_8888:
        return np.asarray(to_rgba8888(x))
    if config == C.RGBA_F16:
        return np.asarray(to_rgba_f16(x))
    if config == C.RGB_565:
        return np.asarray(to_rgb565(x))
    if config == C.RGBA_1010102:
        return np.asarray(to_rgba1010102(x))
    if config == C.HARDWARE:  # no AHardwareBuffer off Android: 8888
        return np.asarray(to_rgba8888(x))
    raise ValueError(f"unknown color config {config}")
