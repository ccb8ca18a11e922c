"""HDR colour-encoding decode parity + the HDR->SDR fallback pipeline.

The reference tone-maps PQ/HLG/wide-gamut streams to SDR Rec.709 when
the output target can't represent HDR (JniDecoding.cpp:138-228 +
colorspaces/ColorMatrix.cpp + Rec2408ToneMapper.cpp); the decoder
itself must emit the stream's signalled colour encoding the way libjxl
does (interop/JxlDecoding.cpp:115-144).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "research"))

try:
    import refjxl  # noqa: E402
    HAVE_LIBJXL = True
except Exception:
    HAVE_LIBJXL = False

from jxl_coder import api  # noqa: E402
from jxl_coder.ops import color as C  # noqa: E402


def _hdr_img(h=64, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.clip(yy * 4, 0, 255), np.clip(xx * 4, 0, 255),
                     np.full_like(yy, 100)], -1).astype(np.uint8)


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl missing")
@pytest.mark.parametrize("trc,prim,it", [
    (16, 1, 1000.0),   # PQ, sRGB primaries
    (16, 9, 4000.0),   # PQ, BT.2100
    (18, 1, 1000.0),   # HLG, sRGB primaries
    (18, 9, 1000.0),   # HLG, BT.2100
    (13, 9, 255.0),    # sRGB TRC, wide gamut only
    (1, 1, 255.0),     # BT.709 TRC
])
def test_decode_parity_hdr_encodings(trc, prim, it):
    """Our decode of PQ/HLG/wide-gamut XYB streams matches libjxl's
    output in the signalled encoding.  PQ near black is steep enough
    that float noise moves isolated codes by tens, so the bound is on
    the mean and the 99.9th percentile, not the max."""
    img = _hdr_img()
    ce = refjxl.make_color_encoding(transfer_function=trc, primaries=prim)
    data = refjxl.encode_ex(img, distance=1.0, color_encoding=ce,
                            intensity_target=it)
    ref, _ = refjxl.decode(data)
    out, info = api.decode(data)
    assert out.shape == ref.shape
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.mean() < 0.5, f"mean {d.mean()}"
    assert np.quantile(d, 0.995) <= 2.0, f"p995 {np.quantile(d, 0.995)}"
    if trc != 16:  # non-PQ encodings are tight everywhere
        assert d.max() <= 2, f"max {d.max()}"


def test_transfer_tone_rec2408_formula():
    """The fast tone mapper matches the reference's rational formula
    (Rec2408ToneMapper.h ctor + transferTone loop) computed directly."""
    rng = np.random.default_rng(3)
    rgb = rng.random((17, 13, 3)).astype(np.float32) * 5.0
    content, display, white = 1000.0, 250.0, 203.0
    got = np.asarray(C.transfer_tone_rec2408(rgb, content, display, white))
    ld = content / white
    wa = (display / white) / (ld * ld)
    wb = 1.0 / (display / white)
    luma = np.array([0.2627, 0.6780, 0.0593], np.float32)
    light = (rgb * luma).sum(-1)
    scale = np.where(light == 0, 1.0, (1 + wa * light) / (1 + wb * light))
    want = np.minimum(rgb * scale[..., None], 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl missing")
def test_decode_sampled_sdr_fallback():
    """decode_sampled applies the HDR->SDR pipeline for 8-bit targets
    and leaves F16 targets in the stream encoding."""
    img = _hdr_img()
    ce = refjxl.make_color_encoding(transfer_function=16, primaries=9)
    data = refjxl.encode_ex(img, distance=1.0, color_encoding=ce,
                            intensity_target=1000.0)
    raw, info = api.decode(data)
    sdr, _ = api.decode_sampled(
        data, 64, 64,
        preferred_color_config=api.PreferredColorConfig.RGBA_8888)
    # expected: exactly the hdr_to_sdr post-op on the raw decode
    hdr_ce = api.parse_header(data).metadata.colour_encoding
    want = C.hdr_to_sdr(raw, hdr_ce, info.intensity_target)
    assert np.array_equal(sdr[..., :3], want[..., :3])
    assert sdr.dtype == np.uint8
    # F16 target: HDR kept (stream-encoded values, no tone mapping)
    f16, _ = api.decode_sampled(
        data, 64, 64,
        preferred_color_config=api.PreferredColorConfig.RGBA_F16)
    assert f16.dtype == np.float16
    want_f16 = (raw.astype(np.float32) / 255.0)
    np.testing.assert_allclose(np.asarray(f16[..., :3], np.float32),
                               want_f16, atol=1e-3)


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl missing")
def test_sdr_stream_not_tone_mapped():
    """Plain sRGB streams must pass through decode_sampled unchanged."""
    img = _hdr_img()
    data = refjxl.encode_ex(img, distance=1.0)
    raw, _ = api.decode(data)
    out, _ = api.decode_sampled(
        data, 64, 64,
        preferred_color_config=api.PreferredColorConfig.RGBA_8888)
    assert np.array_equal(out[..., :3], raw)
