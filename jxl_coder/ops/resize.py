"""High-quality separable resampling as two dense matmuls.

Device-side replacement for the weaver Rust crate the reference uses
(/root/reference/weaver/src/scale.rs:294-361): the 10 filter kernels of
weaver's ScalingFunction (scaling_function.rs:37-48, mirrored by
JxlResizeFilter.kt) with FIT/FILL/RESIZE semantics incl. center-crop
(scale.rs:202-234) and premultiply-aware alpha handling.

Design: separable resampling is expressed as two dense matmuls
out = Wy @ img @ Wx^T with precomputed (out_size, in_size) weight
matrices — matrix-unit work, no gathers.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import backend


# ---- kernel functions (support radius, weight fn) ------------------------

def _box(x):
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


def _triangle(x):
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


def _cubic_bc(x, b, c):
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
          + (6 - 2 * b)) / 6.0
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
          + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
    return np.where(x < 1.0, p1, np.where(x < 2.0, p2, 0.0))


def _sinc(x):
    return np.sinc(x)


def _lanczos(x, a=3.0):
    ax = np.abs(x)
    return np.where(ax < a, _sinc(x) * _sinc(x / a), 0.0)


def _hermite(x):
    x = np.abs(x)
    return np.where(x < 1.0, (2 * x - 3) * x * x + 1, 0.0)


def _hann(x, a=3.0):
    ax = np.abs(x)
    return np.where(ax < a, _sinc(x) * (0.5 + 0.5 * np.cos(np.pi * x / a)),
                    0.0)


# name -> (radius, fn); ids match api.ResizeFilter / JxlResizeFilter.kt
KERNELS = {
    1: (1.0, _triangle),                                    # BILINEAR
    2: (0.5, _box),                                         # NEAREST
    3: (2.0, lambda x: _cubic_bc(x, 1 / 3, 1 / 3)),         # CUBIC
    4: (2.0, lambda x: _cubic_bc(x, 1 / 3, 1 / 3)),         # MITCHELL
    5: (3.0, _lanczos),                                     # LANCZOS
    6: (2.0, lambda x: _cubic_bc(x, 0.0, 0.5)),             # CATMULL_ROM
    7: (1.0, _hermite),                                     # HERMITE
    8: (2.0, lambda x: _cubic_bc(x, 1.0, 0.0)),             # BSPLINE
    9: (3.0, _hann),                                        # HANN
    10: (2.0, lambda x: _cubic_bc(x, 0.0, 0.75)),           # BICUBIC
}


@functools.lru_cache(maxsize=128)
def resample_matrix(in_size: int, out_size: int,
                    filter_id: int) -> np.ndarray:
    """(out_size, in_size) row-normalized resampling weights."""
    radius, fn = KERNELS[filter_id]
    scale = in_size / out_size
    support = radius * max(1.0, scale)
    w = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        center = (o + 0.5) * scale - 0.5
        lo = int(math.floor(center - support))
        hi = int(math.ceil(center + support)) + 1
        idx = np.arange(lo, hi)
        x = (idx - center) / max(1.0, scale)
        vals = fn(x)
        idx_c = np.clip(idx, 0, in_size - 1)
        for i, v in zip(idx_c, vals):
            w[o, i] += v
        s = w[o].sum()
        if s != 0:
            w[o] /= s
        else:
            w[o, np.clip(int(round(center)), 0, in_size - 1)] = 1.0
    return w


@functools.partial(jax.jit, static_argnames=("out_h", "out_w", "filter_id"))
def resize_plane_stack(img: jnp.ndarray, out_h: int, out_w: int,
                       filter_id: int = 4) -> jnp.ndarray:
    """(C, H, W) float -> (C, out_h, out_w): two matmuls."""
    c, h, w = img.shape
    wy = jnp.asarray(resample_matrix(h, out_h, filter_id))
    wx = jnp.asarray(resample_matrix(w, out_w, filter_id))
    t = jnp.einsum("oh,chw->cow", wy, img,
                   preferred_element_type=jnp.float32,
                   precision=backend.PRECISION)
    return jnp.einsum("pw,cow->cop", wx, t,
                      preferred_element_type=jnp.float32,
                      precision=backend.PRECISION)


def _fit_size(w, h, tw, th) -> Tuple[int, int]:
    s = min(tw / w, th / h)
    return max(1, round(w * s)), max(1, round(h * s))


def _fill_size(w, h, tw, th) -> Tuple[int, int]:
    s = max(tw / w, th / h)
    return max(1, round(w * s)), max(1, round(h * s))


def rescale_image(img: np.ndarray, target_w: int, target_h: int,
                  scale_mode: int = 1, filter_id: int = 4,
                  premultiplied: bool = False) -> np.ndarray:
    """(H, W, C) uint8/uint16/float -> resized per ScaleMode semantics.

    scale_mode: 1 FIT (aspect-preserving, result <= target),
    2 FILL (aspect-preserving cover + center-crop to target),
    3 RESIZE (exact target, aspect ignored) — ScaleMode.kt /
    weaver scale.rs:202-234.
    Unassociated alpha is premultiplied for filtering and unassociated
    after, as weaver's premultiply-aware path does.
    """
    h, w, c = img.shape
    dtype = img.dtype
    maxv = {np.dtype(np.uint8): 255.0,
            np.dtype(np.uint16): 65535.0}.get(np.dtype(dtype), 1.0)
    f = np.asarray(img, np.float32) / maxv

    has_alpha = c in (2, 4)
    if has_alpha and not premultiplied:
        alpha = f[..., -1:]
        f = np.concatenate([f[..., :-1] * alpha, alpha], axis=-1)

    if scale_mode == 1:      # FIT
        ow, oh = _fit_size(w, h, target_w, target_h)
        crop = None
    elif scale_mode == 2:    # FILL
        ow, oh = _fill_size(w, h, target_w, target_h)
        crop = (target_w, target_h)
    else:                    # RESIZE
        ow, oh = target_w, target_h
        crop = None

    planes = jnp.asarray(f.transpose(2, 0, 1))
    out = np.asarray(resize_plane_stack(planes, oh, ow, filter_id))
    out = out.transpose(1, 2, 0)

    if crop is not None:
        cw, ch = crop
        x0 = max(0, (ow - cw) // 2)
        y0 = max(0, (oh - ch) // 2)
        out = out[y0:y0 + ch, x0:x0 + cw]

    if has_alpha and not premultiplied:
        alpha = np.clip(out[..., -1:], 1e-6, 1.0)
        out = np.concatenate([out[..., :-1] / alpha, out[..., -1:]],
                             axis=-1)

    out = np.clip(out, 0.0, 1.0)
    if maxv != 1.0:
        return np.round(out * maxv).astype(dtype)
    return out.astype(dtype)
