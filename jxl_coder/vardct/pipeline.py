"""Device-side VarDCT reconstruction pipeline (jnp / XLA, jit-compiled).

The round-1 device pipeline replacing libjxl's threaded SIMD decode loop
(SURVEY.md §3.1 hot loop): dequant -> chroma-from-luma -> IDCT (batched
matmuls) -> Gaborish (3x3 depthwise conv) -> EPF (edge-preserving
stencil) -> XYB->linear RGB -> transfer function.  Everything is
static-shape and fusion-friendly; group/frame sharding wraps this with
shard_map (parallel/groups.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .dct import idct2d, dct2d, blockify, unblockify
from .quant import default_dequant_matrix, LF_STEPS
from .xyb import xyb_to_linear_rgb, linear_rgb_to_xyb
from ..ops.color import linear_to_srgb, srgb_to_linear

GABORISH_W1 = 0.115169525
GABORISH_W2 = 0.061248592


def gaborish_kernel() -> np.ndarray:
    k = np.array([[GABORISH_W2, GABORISH_W1, GABORISH_W2],
                  [GABORISH_W1, 1.0, GABORISH_W1],
                  [GABORISH_W2, GABORISH_W1, GABORISH_W2]], np.float32)
    return k / k.sum()


def apply_gaborish(img: jnp.ndarray) -> jnp.ndarray:
    """(3, H, W) depthwise 3x3 smoothing with edge-replicate padding."""
    k = jnp.asarray(gaborish_kernel())
    pad = jnp.pad(img, ((0, 0), (1, 1), (1, 1)), mode="edge")
    out = jnp.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + k[dy, dx] * pad[:, dy:dy + img.shape[1],
                                        dx:dx + img.shape[2]]
    return out


# EPF channel scales (X, Y, B) — relative SAD weights per channel.
EPF_CHANNEL_SCALE = np.array([40.0, 5.0, 3.5], np.float32)
_EPF_TAPS_CROSS = ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1))


def apply_epf(img: jnp.ndarray, inv_sigma: jnp.ndarray,
              iters: int = 1) -> jnp.ndarray:
    """Edge-preserving filter.

    img: (3, H, W) XYB.  inv_sigma: (H, W) per-pixel inverse sigma
    (broadcast from the per-block quant field).  Plus-shaped 5-tap
    filter; weight = max(0, 1 - sad * inv_sigma) with 3-channel SAD.
    """
    for _ in range(max(0, iters)):
        pad = jnp.pad(img, ((0, 0), (1, 1), (1, 1)), mode="edge")
        h, w = img.shape[1], img.shape[2]
        num = jnp.zeros_like(img)
        den = jnp.zeros((h, w), img.dtype)
        scale = jnp.asarray(EPF_CHANNEL_SCALE)[:, None, None]
        for (dy, dx) in _EPF_TAPS_CROSS:
            shifted = pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            sad = jnp.sum(jnp.abs(shifted - img) * scale, axis=0)
            wgt = jnp.maximum(0.0, 1.0 - sad * inv_sigma)
            wgt = jnp.where((dy == 0) & (dx == 0), 1.0, wgt)
            num = num + shifted * wgt[None]
            den = den + wgt
        img = num / den[None]
    return img


def expand_cfl(cfl_x: jnp.ndarray, cfl_b: jnp.ndarray, ny: int, nx: int):
    """Per-64x64-tile factors -> per-block (nY, nX) float factors."""
    tile_y = (jnp.arange(ny) // 8)
    tile_x = (jnp.arange(nx) // 8)
    fx = cfl_x[tile_y[:, None], tile_x[None, :]].astype(jnp.float32) / 64.0
    fb = cfl_b[tile_y[:, None], tile_x[None, :]].astype(jnp.float32) / 64.0
    return fx, fb


def dequant_idct(ac_coeffs: jnp.ndarray, dc: jnp.ndarray, qf: jnp.ndarray,
                 fx: jnp.ndarray, fb: jnp.ndarray,
                 distance: jnp.ndarray) -> jnp.ndarray:
    """Per-block device decode: dequant + CfL + DC merge + IDCT.

    ac_coeffs: (3, nY, nX, 8, 8) int32; dc: (3, nY, nX) int32;
    qf/fx/fb: (nY, nX).  Returns (3, nY*8, nX*8) XYB.  Pure per-block —
    safe to shard over block rows with no halo.
    """
    dm = jnp.asarray(default_dequant_matrix(8))  # (3,8,8)
    steps = dm[:, None, None, :, :] * distance * (8.0 / qf[None, :, :,
                                                           None, None])
    coeffs = ac_coeffs.astype(jnp.float32) * steps

    # chroma-from-luma as a dense broadcast (no scatters: fast compile +
    # full fusion)
    cfl = jnp.stack([fx, jnp.zeros_like(fx), fb])       # (3, nY, nX)
    coeffs = coeffs + cfl[:, :, :, None, None] * coeffs[1][None]

    lf_steps = jnp.asarray(LF_STEPS) * distance
    dc_vals = dc.astype(jnp.float32) * lf_steps[:, None, None]
    dc_vals = dc_vals + cfl * dc_vals[1][None]
    dc_mask = jnp.zeros((8, 8), jnp.float32).at[0, 0].set(1.0)
    coeffs = (coeffs * (1.0 - dc_mask)
              + (dc_vals * 8.0)[:, :, :, None, None] * dc_mask)

    pixels = idct2d(coeffs)              # (3, nY, nX, 8, 8)
    return unblockify(pixels)            # (3, H, W)


def inv_sigma_map(qf: jnp.ndarray, distance: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel EPF inverse sigma from the block quant field."""
    inv_sigma = (qf.astype(jnp.float32) / (distance * 4.0))
    return jnp.repeat(jnp.repeat(inv_sigma, 8, axis=0), 8, axis=1)


def filter_halo(epf_iters: int, gab: bool) -> int:
    """Vertical halo rows the filter chain consumes."""
    return (1 if gab else 0) + max(0, epf_iters)


def apply_filters(img: jnp.ndarray, inv_sigma_px: jnp.ndarray,
                  epf_iters: int, gab: bool) -> jnp.ndarray:
    """Canonical filter chain on a row-padded slab.

    The input must already be padded vertically by filter_halo() rows
    (edge-replicated at the true image borders, real neighbor rows at
    shard boundaries); the same amount is cropped from the output.  Both
    the single-device and the shard_map paths share this construction so
    their outputs match exactly.
    """
    halo = filter_halo(epf_iters, gab)
    if halo == 0:
        return img
    if gab:
        img = apply_gaborish(img)
    if epf_iters > 0:
        img = apply_epf(img, inv_sigma_px, iters=epf_iters)
    return img[:, halo:-halo, :]


def pad_rows(arr: jnp.ndarray, halo: int) -> jnp.ndarray:
    """Edge-replicate `halo` rows on top/bottom (axis -2)."""
    if halo == 0:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[-2] = (halo, halo)
    return jnp.pad(arr, pad, mode="edge")


@functools.partial(jax.jit, static_argnames=("epf_iters", "gab"))
def reconstruct_xyb(ac_coeffs: jnp.ndarray, dc: jnp.ndarray,
                    qf: jnp.ndarray, cfl_x: jnp.ndarray,
                    cfl_b: jnp.ndarray, distance: jnp.ndarray,
                    epf_iters: int = 1, gab: bool = True) -> jnp.ndarray:
    """Single-device decode for an 8x8-blocked frame: dequant + CfL + DC
    merge + IDCT + Gaborish + EPF.  See dequant_idct for shapes."""
    c, ny, nx, _, _ = ac_coeffs.shape
    fx, fb = expand_cfl(cfl_x, cfl_b, ny, nx)
    img = dequant_idct(ac_coeffs, dc, qf, fx, fb, distance)
    halo = filter_halo(epf_iters, gab)
    img = pad_rows(img, halo)
    inv_sigma = pad_rows(inv_sigma_map(qf, distance), halo)
    return apply_filters(img, inv_sigma, epf_iters, gab)


@jax.jit
def xyb_to_srgb8(xyb: jnp.ndarray) -> jnp.ndarray:
    rgb = xyb_to_linear_rgb(xyb)
    srgb = linear_to_srgb(jnp.clip(rgb, 0.0, 1.0))
    return jnp.clip(jnp.round(srgb * 255.0), 0, 255).astype(jnp.uint8)


@jax.jit
def xyb_to_u16(xyb: jnp.ndarray) -> jnp.ndarray:
    rgb = xyb_to_linear_rgb(xyb)
    srgb = linear_to_srgb(jnp.clip(rgb, 0.0, 1.0))
    return jnp.clip(jnp.round(srgb * 65535.0), 0, 65535).astype(jnp.uint16)


# --------------------------------------------------------------------------
# Encoder-side device path

@jax.jit
def forward_xyb(srgb8: jnp.ndarray) -> jnp.ndarray:
    """(3, H, W) uint8 sRGB -> XYB."""
    rgb = srgb_to_linear(srgb8.astype(jnp.float32) / 255.0)
    return linear_rgb_to_xyb(rgb)


@jax.jit
def quantize_coeffs(xyb: jnp.ndarray, qf: jnp.ndarray,
                    distance: jnp.ndarray):
    """XYB image -> (quantized AC (3,nY,nX,8,8) int32, DC (3,nY,nX) int32,
    cfl factors fixed to (0, 64-ish? -> 0/64 here)).

    The Y->B default correlation of 1.0 is handled by subtracting Y from
    B before the DCT (base_correlation_b), mirroring the decode-side CfL
    add.
    """
    c, h, w = xyb.shape
    # B carries Y: store residual
    xyb = xyb.at[2].add(-xyb[1])
    blocks = blockify(xyb, 8)           # (3, nY, nX, 8, 8)
    coeffs = dct2d(blocks)
    ny, nx = coeffs.shape[1], coeffs.shape[2]
    dm = jnp.asarray(default_dequant_matrix(8))
    steps = dm[:, None, None, :, :] * distance * (8.0 / qf[None, :, :,
                                                           None, None])
    q = jnp.round(coeffs / steps).astype(jnp.int32)
    # DC: mean = coef[0,0] / 8
    lf_steps = jnp.asarray(LF_STEPS) * distance
    dc = jnp.round((coeffs[:, :, :, 0, 0] / 8.0)
                   / lf_steps[:, None, None]).astype(jnp.int32)
    q = q.at[:, :, :, 0, 0].set(0)
    return q, dc


@functools.partial(jax.jit, static_argnames=("epf_iters", "gab"))
def reconstruct_srgb8(ac_coeffs: jnp.ndarray, dc: jnp.ndarray,
                      qf: jnp.ndarray, cfl_x: jnp.ndarray,
                      cfl_b: jnp.ndarray, distance: jnp.ndarray,
                      epf_iters: int = 1, gab: bool = True) -> jnp.ndarray:
    """Full decode to (3, H, W) uint8 sRGB."""
    c, ny, nx, _, _ = ac_coeffs.shape
    fx, fb = expand_cfl(cfl_x, cfl_b, ny, nx)
    img = dequant_idct(ac_coeffs, dc, qf, fx, fb, distance)
    halo = filter_halo(epf_iters, gab)
    img = pad_rows(img, halo)
    inv_sigma = pad_rows(inv_sigma_map(qf, distance), halo)
    xyb = apply_filters(img, inv_sigma, epf_iters, gab)
    return xyb_to_srgb8(xyb)
