"""Color management ops (jnp, device-side).

Re-expresses the reference's first-party pixel pipeline as JAX ops
(SURVEY.md §2.4): the 11 transfer functions of colorspaces/Trc.h:31-57,
primaries/gamut matrices of ColorSpaceProfile.h:28-145, the BT.2408
PQ-domain tone mapper of Rec2408ToneMapper.cpp:32-99, and luma
coefficients of ITUR.h:39-67.  All elementwise work fuses under jit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import backend


# --------------------------------------------------------------------------
# Transfer functions (linear <-> encoded), vectorized.

def srgb_to_linear(v):
    return jnp.where(v <= 0.04045, v / 12.92,
                     ((v + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(v):
    v = jnp.maximum(v, 0.0)
    return jnp.where(v <= 0.0031308, v * 12.92,
                     1.055 * v ** (1 / 2.4) - 0.055)


def bt709_to_linear(v):
    return jnp.where(v < 0.081, v / 4.5,
                     ((v + 0.099) / 1.099) ** (1 / 0.45))


def linear_to_bt709(v):
    v = jnp.maximum(v, 0.0)
    return jnp.where(v < 0.018, v * 4.5,
                     1.099 * v ** 0.45 - 0.099)


def gamma_to_linear(v, gamma: float):
    return jnp.maximum(v, 0.0) ** gamma


def linear_to_gamma(v, gamma: float):
    return jnp.maximum(v, 0.0) ** (1.0 / gamma)


# PQ (SMPTE ST 2084); normalized so 1.0 = 10000 nits.
_PQ_M1 = 2610.0 / 16384
_PQ_M2 = 2523.0 / 4096 * 128
_PQ_C1 = 3424.0 / 4096
_PQ_C2 = 2413.0 / 4096 * 32
_PQ_C3 = 2392.0 / 4096 * 32


def pq_to_linear(v):
    """Encoded PQ -> linear (1.0 == 10000 nits)."""
    v = jnp.maximum(v, 0.0)
    p = v ** (1.0 / _PQ_M2)
    num = jnp.maximum(p - _PQ_C1, 0.0)
    den = _PQ_C2 - _PQ_C3 * p
    return (num / den) ** (1.0 / _PQ_M1)


def linear_to_pq(v):
    v = jnp.maximum(v, 0.0)
    p = v ** _PQ_M1
    return ((_PQ_C1 + _PQ_C2 * p) / (1.0 + _PQ_C3 * p)) ** _PQ_M2


# HLG (ARIB STD-B67)
_HLG_A = 0.17883277
_HLG_B = 1 - 4 * _HLG_A
_HLG_C = 0.5 - _HLG_A * np.log(4 * _HLG_A)


def hlg_to_linear(v):
    v = jnp.maximum(v, 0.0)
    return jnp.where(v <= 0.5, v * v / 3.0,
                     (jnp.exp((v - _HLG_C) / _HLG_A) + _HLG_B) / 12.0)


def linear_to_hlg(v):
    v = jnp.maximum(v, 0.0)
    return jnp.where(v <= 1.0 / 12, jnp.sqrt(3.0 * v),
                     _HLG_A * jnp.log(jnp.maximum(12.0 * v - _HLG_B, 1e-12))
                     + _HLG_C)


def dci_to_linear(v):
    return gamma_to_linear(v, 2.6)


def linear_to_dci(v):
    return linear_to_gamma(v, 2.6)


def smpte240_to_linear(v):
    return jnp.where(v < 0.0913, v / 4.0,
                     ((v + 0.1115) / 1.1115) ** (1 / 0.45))


def linear_to_smpte240(v):
    return jnp.where(v < 0.0228, 4.0 * v, 1.1115 * v ** 0.45 - 0.1115)


def log100_to_linear(v):
    return jnp.where(v <= 0.0, 0.01, 10.0 ** (2.0 * (v - 1.0)))


def linear_to_log100(v):
    return jnp.where(v < 0.01, 0.0,
                     1.0 + jnp.log10(jnp.maximum(v, 1e-10)) / 2.0)


def log100sqrt10_to_linear(v):
    return jnp.where(v <= 0.0, np.sqrt(10.0) / 1000,
                     10.0 ** (2.5 * (v - 1.0)))


def linear_to_log100sqrt10(v):
    return jnp.where(v < np.sqrt(10.0) / 1000, 0.0,
                     1.0 + jnp.log10(jnp.maximum(v, 1e-10)) / 2.5)


def bt1361_to_linear(v):
    return jnp.where(
        v < -0.25, -(((-4.0 * v + 0.099) / 1.099) ** (1 / 0.45)) / 4.0,
        jnp.where(v < 0.081, v / 4.5,
                  ((v + 0.099) / 1.099) ** (1 / 0.45)))


def linear_to_bt1361(v):
    return jnp.where(
        v < -0.0045, -(1.099 * (-4 * v) ** 0.45 - 0.099) / 4,
        jnp.where(v < 0.018, 4.5 * v, 1.099 * v ** 0.45 - 0.099))


def smpte428_to_linear(v):
    return jnp.maximum(v, 0.0) ** 2.6 * (52.37 / 48.0)


def linear_to_smpte428(v):
    return (jnp.maximum(v, 0.0) * 48.0 / 52.37) ** (1 / 2.6)


# TransferFunction enum values (Trc.h:31-57 names; wire values are
# headers.TransferFunction)
TRC_TO_LINEAR = {
    1: bt709_to_linear,       # BT709
    8: lambda v: v,           # Linear
    13: srgb_to_linear,       # SRGB
    16: pq_to_linear,         # PQ
    17: dci_to_linear,        # DCI
    18: hlg_to_linear,        # HLG
}
LINEAR_TO_TRC = {
    1: linear_to_bt709,
    8: lambda v: v,
    13: linear_to_srgb,
    16: linear_to_pq,
    17: linear_to_dci,
    18: linear_to_hlg,
}


# --------------------------------------------------------------------------
# Primaries / gamut matrices (ColorSpaceProfile.h:28-145 equivalents)

ILLUMINANT_D65 = (0.3127, 0.3290)
ILLUMINANT_DCI = (0.314, 0.351)
ILLUMINANT_E = (1 / 3, 1 / 3)

PRIMARIES = {
    "srgb": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060)),
    "display_p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
    "dci_p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)),
    "bt601_525": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070)),
    "bt601_625": ((0.640, 0.330), (0.290, 0.600), (0.150, 0.060)),
    "adobe_rgb": ((0.640, 0.330), (0.210, 0.710), (0.150, 0.060)),
    "bt470m": ((0.670, 0.330), (0.210, 0.710), (0.140, 0.080)),
}


def _xy_to_xyz(x, y):
    return np.array([x / y, 1.0, (1 - x - y) / y])


def gamut_rgb_to_xyz(primaries, white) -> np.ndarray:
    """3x3 RGB->XYZ from xy primaries + white point
    (GamutRgbToXYZ, ColorSpaceProfile.h)."""
    m = np.stack([_xy_to_xyz(*p) for p in primaries], axis=1)
    w = _xy_to_xyz(*white)
    s = np.linalg.solve(m, w)
    return (m * s).astype(np.float64)


def gamut_xyz_to_rgb(primaries, white) -> np.ndarray:
    return np.linalg.inv(gamut_rgb_to_xyz(primaries, white))


def conversion_matrix(src: str, dst: str,
                      white=ILLUMINANT_D65) -> np.ndarray:
    """3x3 src-RGB -> dst-RGB (no adaptation when whites equal)."""
    a = gamut_rgb_to_xyz(PRIMARIES[src], white)
    b = gamut_xyz_to_rgb(PRIMARIES[dst], white)
    return (b @ a).astype(np.float32)


def apply_matrix(m, rgb: jnp.ndarray) -> jnp.ndarray:
    """(3,3) x (3, H, W)."""
    return jnp.einsum("ij,jhw->ihw", jnp.asarray(m, jnp.float32), rgb,
                      preferred_element_type=jnp.float32,
                      precision=backend.PRECISION)


def luma_coeffs(primaries, white=ILLUMINANT_D65) -> np.ndarray:
    """Y row of RGB->XYZ: luma weights (colorPrimariesComputeYCoeffs,
    ITUR.h:39-67)."""
    return gamut_rgb_to_xyz(primaries, white)[1].astype(np.float32)


# Wire-value maps (bitstream/headers.py Primaries / WhitePoint enums)
WIRE_PRIMARIES = {1: "srgb", 9: "bt2020", 11: "display_p3"}
WIRE_WHITE = {1: ILLUMINANT_D65, 10: ILLUMINANT_E, 11: ILLUMINANT_DCI}


def primaries_xy(ce):
    """xy primaries of a ColourEncoding (CUSTOM uses the signalled xys)."""
    if ce.primaries == 2 and ce.red is not None:  # CUSTOM
        return (ce.red.as_float(), ce.green.as_float(),
                ce.blue.as_float())
    return PRIMARIES[WIRE_PRIMARIES.get(ce.primaries, "srgb")]


def white_xy(ce):
    if ce.white_point == 2 and ce.white is not None:  # CUSTOM
        return ce.white.as_float()
    return WIRE_WHITE.get(ce.white_point, ILLUMINANT_D65)


def encoding_trc_to_linear(v, trc, intensity_target: float):
    """Stream-encoded -> linear, extended-SDR convention (1.0 = SDR
    white).  PQ scales absolute nits so SDR white (203 nits) is 1.0, as
    the reference's avifToLinearPQ (Trc.cpp:197-208); HLG uses the
    inverse OETF with peak == intensity_target."""
    if trc == 16:   # PQ
        return pq_to_linear(v) * (10000.0 / 203.0)
    if trc == 18:   # HLG
        return hlg_to_linear(v) * (intensity_target / 203.0)
    fn = TRC_TO_LINEAR.get(trc, srgb_to_linear)
    return fn(v)


# --------------------------------------------------------------------------
# BT.2408/2390-style tone mapping (Rec2408ToneMapper.cpp:32-99)

def rec2408_tone_map(rgb_linear: jnp.ndarray,
                     content_brightness: float,
                     display_brightness: float = 250.0,
                     white_point: float = 203.0,
                     primaries="bt2020") -> jnp.ndarray:
    """PQ-domain knee tone mapping of linear RGB (1.0 == white_point nits
    content scale), via luminance scaling with BT.2020 luma weights."""
    lw = jnp.asarray(luma_coeffs(PRIMARIES[primaries]))
    lum = jnp.einsum("c,chw->hw", lw, rgb_linear,
                     precision=backend.PRECISION)
    # to PQ domain (abs nits / 10000)
    nits = jnp.maximum(lum, 1e-9) * (content_brightness / 10000.0)
    pq = linear_to_pq(nits)
    src_max = linear_to_pq(jnp.asarray(content_brightness / 10000.0))
    dst_max = linear_to_pq(jnp.asarray(display_brightness / 10000.0))
    # BT.2390 EETF knee: normalize, soft-clip top
    e1 = pq / src_max
    ks = 1.5 * dst_max / src_max - 0.5
    t = jnp.clip((e1 - ks) / (1 - ks), 0.0, 1.0)
    p = ((2 * t ** 3 - 3 * t ** 2 + 1) * ks
         + (t ** 3 - 2 * t ** 2 + t) * (1 - ks)
         + (-2 * t ** 3 + 3 * t ** 2) * (dst_max / src_max))
    e2 = jnp.where(e1 < ks, e1, p)
    mapped_nits = pq_to_linear(e2 * src_max) * 10000.0
    scale = mapped_nits / (jnp.maximum(lum, 1e-9) * content_brightness)
    return rgb_linear * scale[None] * (content_brightness
                                       / display_brightness)


def transfer_tone_rec2408(rgb_linear: jnp.ndarray,
                          content_brightness: float,
                          display_brightness: float = 250.0,
                          white_point: float = 203.0,
                          luma=None) -> jnp.ndarray:
    """Fast BT.2408 rational luminance scale — the reference's
    Rec2408ToneMapper (Rec2408ToneMapper.h ctor weights +
    transferTone, Rec2408ToneMapper.cpp:81-99).

    rgb_linear: (..., 3) extended-SDR linear (1.0 == `white_point` nits).
    """
    if luma is None:
        luma = np.array([0.2627, 0.6780, 0.0593], np.float32)
    ld = content_brightness / white_point
    weight_a = (display_brightness / white_point) / (ld * ld)
    weight_b = 1.0 / (display_brightness / white_point)
    light = jnp.einsum("...c,c->...", rgb_linear,
                       jnp.asarray(luma, jnp.float32),
                       precision=backend.PRECISION)
    scale = jnp.where(light == 0.0, 1.0,
                      (1.0 + weight_a * light) / (1.0 + weight_b * light))
    return jnp.minimum(rgb_linear * scale[..., None], 1.0)


def hdr_to_sdr(pixels: np.ndarray, ce, intensity_target: float):
    """HDR/wide-gamut decoded buffer -> SDR sRGB (Rec.709 primaries),
    the reference's post-decode fallback pipeline
    (JniDecoding.cpp:138-228 + applyColorMatrix,
    colorspaces/ColorMatrix.cpp:35-118): linearize with the stream TRC,
    BT.2408 tone map for PQ/HLG, 3x3 gamut matrix from the stream
    primaries to Rec.709, re-encode with sRGB.

    pixels: uint8/uint16 (H, W, C>=3) in the stream's colour encoding;
    alpha (channel 3+) passes through untouched.  Returns same dtype.
    """
    arr = np.asarray(pixels)
    maxv = 255.0 if arr.dtype == np.uint8 else 65535.0
    f = jnp.asarray(arr[..., :3], jnp.float32) / maxv
    trc = ce.transfer_function if not ce.have_gamma else None
    if ce.have_gamma:
        lin = gamma_to_linear(f, 1.0 / (ce.gamma / 1e7))
    else:
        lin = encoding_trc_to_linear(f, trc, intensity_target)
    if trc in (16, 18):  # PQ / HLG: tone map (JniDecoding.cpp:140-156)
        prim = primaries_xy(ce)
        wp = white_xy(ce)
        lin = transfer_tone_rec2408(
            lin, intensity_target,
            luma=gamut_rgb_to_xyz(prim, wp)[1].astype(np.float32))
    src = gamut_rgb_to_xyz(primaries_xy(ce), white_xy(ce))
    dst = gamut_xyz_to_rgb(PRIMARIES["srgb"], ILLUMINANT_D65)
    m = (dst @ src).astype(np.float32)
    lin = jnp.einsum("...c,dc->...d", lin, jnp.asarray(m),
                     precision=backend.PRECISION)
    out = np.asarray(jnp.clip(jnp.round(
        linear_to_srgb(jnp.clip(lin, 0.0, 1.0)) * maxv), 0, maxv))
    res = arr.copy()
    res[..., :3] = out.astype(arr.dtype)
    return res


def is_hdr_encoding(ce) -> bool:
    """True when the signalled colour encoding needs the SDR fallback
    for 8-bit outputs (PQ/HLG transfer or wide-gamut primaries)."""
    if ce is None or ce.want_icc:
        return False
    return (ce.transfer_function in (16, 18)
            or ce.primaries not in (1,))
