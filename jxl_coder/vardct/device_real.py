"""Device (JAX/XLA) reconstruction for real-format VarDCT frames.

Host side parses entropy streams into dense arrays; everything after
that — dequant, CfL, IDCT (batched matmuls), adaptive DC
smoothing, gaborish, EPF passes 0-2, XYB->sRGB8/16 (including the
bit-exact FastLinearToSRGB exponent trick) — runs on device in one
jitted program.  This module is the DCT8-only fast path; device_full.py
extends it to every transform family.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import backend
from .dec_real import (DC_SMOOTH_W1, DC_SMOOTH_W2, KINV_SIGMA,
                       EPF_CHANNEL_SCALE, EPF_SIGMA_PER, EPF1_INV_SCALE,
                       _OPSIN_INV, _BIAS, _CBRT_BIAS,
                       _POW25TO18, _POW17TO10)


@functools.lru_cache(maxsize=None)
def _idct8_basis_np():
    A = np.zeros((8, 8), np.float32)
    for k in range(8):
        for x in range(8):
            a = 1.0 if k == 0 else np.sqrt(2.0)
            A[k, x] = a * np.cos(np.pi * (2 * x + 1) * k / 16)
    return A


def _idct8_basis():
    # constant folded by XLA; never cache the jnp array (a first call under
    # a shard_map/jit trace would leak a tracer into later traces)
    return jnp.asarray(_idct8_basis_np())


def dc_smoothing_device(dc, steps):
    """dc: (3, ys, xs) float32; steps: (3,) float32."""
    w1, w2 = DC_SMOOTH_W1, DC_SMOOTH_W2
    w0 = 1.0 - 4.0 * (w1 + w2)
    p = jnp.pad(dc, ((0, 0), (1, 1), (1, 1)), mode="edge")
    sm = (w0 * dc
          + w1 * (p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
                  + p[:, 1:-1, :-2] + p[:, 1:-1, 2:])
          + w2 * (p[:, :-2, :-2] + p[:, :-2, 2:]
                  + p[:, 2:, :-2] + p[:, 2:, 2:]))
    gap = jnp.max(jnp.abs(sm - dc) / steps[:, None, None], axis=0)
    gap = jnp.maximum(0.5, gap)
    mix = jnp.clip(3.0 - 4.0 * gap, 0.0, 1.0)
    out = dc + (sm - dc) * mix[None]
    # image borders untouched
    ys, xs = dc.shape[1], dc.shape[2]
    ymask = (jnp.arange(ys) % (ys - 1) == 0)[None, :, None]
    xmask = (jnp.arange(xs) % (xs - 1) == 0)[None, None, :]
    keep = ymask | xmask
    return jnp.where(keep, dc, out)


def gaborish_device(plane, w1, w2):
    norm = 1.0 + 4.0 * (w1 + w2)
    p = jnp.pad(plane, 1, mode="symmetric")
    out = (p[1:-1, 1:-1]
           + w1 * (p[:-2, 1:-1] + p[2:, 1:-1]
                   + p[1:-1, :-2] + p[1:-1, 2:])
           + w2 * (p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]))
    return out / norm


EPF_OFFS_PLUS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
EPF_OFFS_DIAMOND12 = ((0, 1), (0, -1), (1, 0), (-1, 0),
                      (1, 1), (1, -1), (-1, 1), (-1, -1),
                      (0, 2), (0, -2), (2, 0), (-2, 0))


def epf_device(X, Y, B, sigma_map, offs=EPF_OFFS_PLUS4,
               slope_scale=1.0, patch=True):
    """Generic EPF pass: `offs` neighbours, patch (5-tap) or pointwise
    SAD, weight slope EPF1_INV_SCALE * slope_scale.  Mirrors
    dec_real.apply_epf0/1/2."""
    from .dec_real import EPF_SIGMA_GATE
    H, W = Y.shape
    planes = (X, Y, B)
    R = max(abs(o[0]) for o in offs) + (1 if patch else 0)
    # libjxl Mirror() convention: -1 -> 0, -2 -> 1 ("symmetric")
    pad = [jnp.pad(p, R, mode="symmetric") for p in planes]
    taps = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)) if patch \
        else ((0, 0),)
    active = sigma_map >= EPF_SIGMA_GATE
    inv = jnp.where(active,
                    KINV_SIGMA * EPF1_INV_SCALE * slope_scale
                    / jnp.maximum(sigma_map, 1e-9), 0.0)
    inv_px = jnp.repeat(jnp.repeat(inv, 8, 0), 8, 1)[:H, :W]
    act_px = jnp.repeat(jnp.repeat(active, 8, 0), 8, 1)[:H, :W]
    bx = jnp.arange(W) % 8
    by = jnp.arange(H) % 8
    border = (((by == 0) | (by == 7))[:, None]
              | ((bx == 0) | (bx == 7))[None, :])
    inv_px = jnp.where(border, inv_px * (2.0 / 3.0), inv_px)
    sel = act_px
    wsum = jnp.ones((H, W), jnp.float32)
    acc = [p for p in planes]
    for (dy, dx) in offs:
        sad = jnp.zeros((H, W), jnp.float32)
        for c in range(3):
            pc = pad[c]
            if patch:
                for (ty, tx) in taps:
                    a = jax.lax.dynamic_slice(pc, (R + ty, R + tx), (H, W))
                    b = jax.lax.dynamic_slice(
                        pc, (R + dy + ty, R + dx + tx), (H, W))
                    sad = sad + EPF_CHANNEL_SCALE[c] * jnp.abs(a - b)
            else:
                a = planes[c]
                b = jax.lax.dynamic_slice(pc, (R + dy, R + dx), (H, W))
                sad = sad + EPF_CHANNEL_SCALE[c] * jnp.abs(a - b)
        w = jnp.maximum(0.0, 1.0 + sad * inv_px)
        wsum = wsum + w
        acc = [acc[c] + w * jax.lax.dynamic_slice(
            pad[c], (R + dy, R + dx), (H, W)) for c in range(3)]
    out = [jnp.where(sel, acc[c] / wsum, planes[c]) for c in range(3)]
    return out[0], out[1], out[2]


def epf1_device(X, Y, B, sigma_map):
    return epf_device(X, Y, B, sigma_map)


_P25 = jnp.asarray(np.asarray(_POW25TO18, np.uint32))
_P17 = jnp.asarray(np.asarray(_POW17TO10, np.uint32))


def fast_linear_to_srgb_device(v):
    v = v.astype(jnp.float32)
    vb = jax.lax.bitcast_convert_type(v, jnp.uint32)
    v025 = jax.lax.bitcast_convert_type(
        (vb | np.uint32(0x3e800000)) & np.uint32(0x3effffff), jnp.float32)
    d1 = v025 * np.float32(0.059914046) + np.float32(-0.108894556)
    d2 = d1 * v025 + np.float32(0.107963754)
    pw = d2 * v025 + np.float32(0.018092343)
    exp = ((vb >> np.uint32(23)) - np.uint32(118)) & np.uint32(0xf)
    mul = jax.lax.bitcast_convert_type(
        (_P25[exp] << np.uint32(18)) | (_P17[exp] << np.uint32(10))
        | np.uint32(0x40000000), jnp.float32)
    return jnp.where(v < np.float32(0.0031308),
                     v * np.float32(12.92),
                     pw * mul + np.float32(-0.055))


_OPSIN_INV32 = jnp.asarray(_OPSIN_INV.astype(np.float32))


def xyb_to_srgb8_device(X, Y, B):
    cb = np.float32(_CBRT_BIAS)
    bias = np.float32(_BIAS)
    g_r = Y + X + cb
    g_g = Y - X + cb
    g_b = B + cb
    ml = g_r * g_r * g_r - bias
    mm = g_g * g_g * g_g - bias
    ms = g_b * g_b * g_b - bias
    # 3x3 opsin inverse unrolled to elementwise ops: XLA fuses them
    # with the cube and the transfer curve, where a 3-wide matmul would
    # not fuse
    M = np.asarray(_OPSIN_INV32)
    lin = jnp.stack([np.float32(M[c, 0]) * ml + np.float32(M[c, 1]) * mm
                     + np.float32(M[c, 2]) * ms for c in range(3)],
                    axis=-1)
    srgb = fast_linear_to_srgb_device(lin)
    return jnp.clip(jnp.floor(srgb * 255.0 + 0.5), 0, 255).astype(
        jnp.uint8)


def dc_xyb_planes(dc, dc_steps):
    """Raw int DC (3, ys, xs) channel order (y, x, b) -> XYB DC planes."""
    dcY = dc[0].astype(jnp.float32) * dc_steps[1]
    dcX = dc[1].astype(jnp.float32) * dc_steps[0] + 0.0 * dcY
    dcB = dc[2].astype(jnp.float32) * dc_steps[2] + 1.0 * dcY
    return jnp.stack([dcX, dcY, dcB])


def synth_from_dcp(coeffs, dcp, qf, xf, bf, table, igs, qm_x, qm_b):
    """Dequant + CfL + IDCT given already-smoothed XYB DC planes.

    HBM-lean formulation: the DC coefficient never enters the matmul
    (basis row 0 is constant 1, so DC contributes a per-block constant
    added in pixel space, fused into the transpose's output); the
    dequant/CfL elementwise chains fuse into the einsum operand reads
    instead of materializing three full-size deq arrays.
    """
    _, ys, xs, _ = coeffs.shape
    inv_qac = (igs / qf.astype(jnp.float32))[None, :, :, None]
    qm = jnp.asarray([qm_x, 1.0, qm_b], jnp.float32)[:, None, None, None]
    # zero the DC position via the table so no .at[].set pass is needed
    # (table may arrive as numpy or as a traced jnp array)
    tab0 = jnp.asarray(table).at[:, 0].set(0.0)
    deq = coeffs * tab0[:, None, None, :] * inv_qac * qm
    deqY = deq[1]
    deqX = deq[0] + xf[:, :, None] * deqY
    deqB = deq[2] + bf[:, :, None] * deqY
    A = _idct8_basis()

    def synth(dq, dcplane):
        km = dq.reshape(ys, xs, 8, 8)
        pix = jnp.einsum("yxkl,km,ln->yxmn", km, A, A,
                         precision=backend.PRECISION)
        pix = pix + dcplane[:, :, None, None]
        return jnp.transpose(pix, (0, 2, 1, 3)).reshape(ys * 8, xs * 8)

    return synth(deqX, dcp[0]), synth(deqY, dcp[1]), synth(deqB, dcp[2])


def synth_dct8_planes(coeffs, dc, qf, xf, bf, table,
                      igs, quant_dc, dcq, qm_x, qm_b, skip_dc_smooth):
    """Dequant + CfL + IDCT only -> (X, Y, B) planes (no filters)."""
    dc_steps = jnp.asarray([dcq[0] * igs / quant_dc,
                            dcq[1] * igs / quant_dc,
                            dcq[2] * igs / quant_dc], jnp.float32)
    dcp = dc_xyb_planes(dc, dc_steps)
    if not skip_dc_smooth:
        dcp = dc_smoothing_device(dcp, dc_steps)
    return synth_from_dcp(coeffs, dcp, qf, xf, bf, table, igs, qm_x, qm_b)


def apply_filters_device(Xp, Yp, Bp, qf, sharp, igs, gab, epf_iters):
    """epf_iters: 0-3 (bool True means 1, matching the old signature)."""
    epf_iters = int(epf_iters)
    if gab:
        w1, w2 = np.float32(0.115169525), np.float32(0.061248592)
        Xp = gaborish_device(Xp, w1, w2)
        Yp = gaborish_device(Yp, w1, w2)
        Bp = gaborish_device(Bp, w1, w2)
    if epf_iters >= 1:
        sigma = (EPF_SIGMA_PER * sharp.astype(jnp.float32)
                 * igs / jnp.maximum(qf.astype(jnp.float32), 1.0))
        if epf_iters >= 3:
            Xp, Yp, Bp = epf_device(Xp, Yp, Bp, sigma,
                                    offs=EPF_OFFS_DIAMOND12,
                                    slope_scale=0.9)
        Xp, Yp, Bp = epf1_device(Xp, Yp, Bp, sigma)
        if epf_iters >= 2:
            from .device_full import _epf2_device
            Xp, Yp, Bp = _epf2_device(Xp, Yp, Bp, sigma, 6.5)
    return Xp, Yp, Bp


def reconstruct_dct8_frame(coeffs, dc, qf, sharp, xf, bf, table,
                           igs, quant_dc, dcq, qm_x, qm_b,
                           gab, epf_iters, skip_dc_smooth):
    """All-DCT8 frame reconstruction on device.

    coeffs: (3, ys, xs, 64) float32 scan->basis ALREADY applied
    (basis-indexed); dc: (3, ys, xs) int32 (y, x, b channel order);
    qf/sharp: (ys, xs); xf/bf: per-block cfl factor maps (ys, xs);
    epf_iters: 0-3 (bool True means 1).
    """
    epf_iters = int(epf_iters)
    Xp, Yp, Bp = synth_dct8_planes(coeffs, dc, qf, xf, bf, table, igs,
                                   quant_dc, dcq, qm_x, qm_b,
                                   skip_dc_smooth)
    Xp, Yp, Bp = apply_filters_device(Xp, Yp, Bp, qf, sharp, igs, gab,
                                      epf_iters)
    return xyb_to_srgb8_device(Xp, Yp, Bp)
