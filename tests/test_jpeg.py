"""JPEG <-> JXL transcoding tests (BASELINE config[4] shape: lossless
round-trip)."""

import io
import os
import sys

import numpy as np
import pytest

from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "research"))
try:
    import refjxl
    HAVE_LIBJXL = True
except Exception:
    HAVE_LIBJXL = False

from jxl_coder import api
from jxl_coder.jpeg.parser import parse_jpeg, JpegError
from jxl_coder.jpeg.writer import write_jpeg
from jxl_coder.jpeg import transcode as TC


def _jpeg(img_arr, quality=85, subsampling=0, **kw):
    buf = io.BytesIO()
    Image.fromarray(img_arr).save(buf, format="JPEG", quality=quality,
                                  subsampling=subsampling, **kw)
    return buf.getvalue()


def _img(h=90, w=120, seed=4, noise=0.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([120 + 60 * np.sin(yy / 11), 100 + 50 * np.cos(xx / 7),
                     80 + 40 * np.sin((xx + yy) / 13)], -1)
    if noise:
        base = base + rng.normal(0, noise, base.shape)
    return np.clip(base, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality,subsampling", [
    (85, 0), (70, 2), (90, 1), (40, 2), (98, 0)])
def test_parse_write_byte_exact(quality, subsampling):
    jpeg = _jpeg(_img(noise=8), quality, subsampling)
    assert write_jpeg(parse_jpeg(jpeg)) == jpeg


def test_parse_write_grayscale():
    arr = _img()[:, :, 0]
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="JPEG", quality=75)
    jpeg = buf.getvalue()
    assert write_jpeg(parse_jpeg(jpeg)) == jpeg


def test_parse_write_odd_dims():
    jpeg = _jpeg(_img(41, 53), 80, 2)
    assert write_jpeg(parse_jpeg(jpeg)) == jpeg


@pytest.mark.parametrize("subsampling", [0, 2])
def test_progressive_parse_write_byte_exact(subsampling):
    """SOF2 multi-scan files (DC/AC first + refinement scans, EOB
    runs, correction bits) re-serialize byte-exactly."""
    from jxl_coder.jpeg.writer import write_jpeg
    buf = io.BytesIO()
    Image.fromarray(_img(noise=8)).save(
        buf, format="JPEG", quality=75, progressive=True,
        subsampling=subsampling)
    data = buf.getvalue()
    j = parse_jpeg(data)
    assert j.progressive and len(j.scans) > 2
    assert write_jpeg(j) == data


def test_progressive_construct_reconstruct_byte_exact():
    buf = io.BytesIO()
    Image.fromarray(_img(noise=6)).save(buf, format="JPEG", quality=80,
                                        progressive=True)
    jpeg = buf.getvalue()
    jxl = api.construct(jpeg)
    assert api.is_jxl(jxl)
    assert api.reconstruct_jpeg(jxl) == jpeg


def test_progressive_grayscale_roundtrip():
    from jxl_coder.jpeg.writer import write_jpeg
    buf = io.BytesIO()
    Image.fromarray(_img()[:, :, 0]).save(
        buf, format="JPEG", quality=70, progressive=True)
    data = buf.getvalue()
    j = parse_jpeg(data)
    assert write_jpeg(j) == data


@pytest.mark.parametrize("quality,subsampling", [(85, 0), (70, 2)])
def test_construct_reconstruct_byte_exact(quality, subsampling):
    jpeg = _jpeg(_img(noise=6), quality, subsampling)
    jxl = api.construct(jpeg)
    assert api.is_jxl(jxl)
    assert api.reconstruct_jpeg(jxl) == jpeg


def test_construct_compresses():
    jpeg = _jpeg(_img(240, 320, noise=6), 85, 0)
    jxl = api.construct(jpeg)
    assert len(jxl) < len(jpeg), (len(jxl), len(jpeg))


def test_decode_constructed_matches_pil():
    jpeg = _jpeg(_img(), 90, 0)
    jxl = api.construct(jpeg)
    pix, info = api.decode(jxl)
    ref = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    assert pix.shape == ref.shape
    # 4:4:4: only IDCT rounding differences
    assert np.abs(pix.astype(int) - ref.astype(int)).max() <= 2
    assert info.uses_original_profile


def test_reconstruct_rejects_plain_jxl():
    data = api.encode(np.zeros((8, 8, 3), np.uint8), lossless=True)
    with pytest.raises(api.InvalidJXLError):
        api.reconstruct_jpeg(data)


# ---- standard wire format (jbrd + VarDCT frame), round 2 ----------------

from jxl_coder.jpeg import wire as W  # noqa: E402
from jxl_coder.jpeg import jbrd as JB  # noqa: E402


@pytest.mark.parametrize("quality,gray", [(85, False), (40, False),
                                          (95, False), (70, True)])
def test_wire_construct_reconstruct_roundtrip(quality, gray):
    img = _img(noise=10)
    if gray:
        img = img[:, :, 0]
    jpeg = _jpeg(img, quality)
    jxl = W.construct(jpeg)
    # standard container: signature + jbrd + jxlc boxes
    from jxl_coder.bitstream import container as C
    cont = C.extract_codestream(jxl)
    assert cont.jpeg_reconstruction_data is not None
    assert cont.codestream[:2] == b"\xff\x0a"
    assert W.reconstruct(jxl) == jpeg


def test_wire_restart_markers_roundtrip():
    jpeg = _jpeg(_img(64, 64, noise=6), 60, restart_marker_blocks=2)
    assert W.reconstruct(W.construct(jpeg)) == jpeg


def test_wire_api_decode_pixels():
    jpeg = _jpeg(_img(noise=4), 85)
    jxl = api.construct(jpeg)
    px, info = api.decode(jxl)
    pil = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    assert px.shape == pil.shape
    # IDCT implementation differences only (exact coefficients)
    assert np.abs(px.astype(int) - pil.astype(int)).max() <= 16


def test_jbrd_bundle_roundtrip():
    jpeg = _jpeg(_img(noise=8), 75, comment=b"bundle-test")
    j = parse_jpeg(jpeg)
    d = JB.jbrd_from_jpeg(j)
    d2 = JB.parse_jbrd(JB.write_jbrd(d))
    assert d2.marker_order == d.marker_order
    assert d2.app_data == d.app_data
    assert d2.com_data == d.com_data
    assert [(h.is_ac, h.id, h.counts, h.values) for h in d2.huffman] \
        == [(h.is_ac, h.id, h.counts, h.values) for h in d.huffman]
    assert d2.quant_idx == d.quant_idx


@pytest.mark.parametrize("subsampling", [1, 2])
def test_wire_subsampled_roundtrip(subsampling):
    jpeg = _jpeg(_img(noise=5), 80, subsampling=subsampling)
    jxl = api.construct(jpeg)
    from jxl_coder.bitstream import container as C
    assert C.extract_codestream(jxl).jpeg_reconstruction_data is not None
    assert api.reconstruct_jpeg(jxl) == jpeg
    px, info = api.decode(jxl)
    pil = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    assert px.shape == pil.shape
    assert np.abs(px.astype(int) - pil.astype(int)).max() <= 24


def test_wire_subsampled_odd_size():
    jpeg = _jpeg(_img(h=43, w=51, noise=7), 70, subsampling=2)
    assert api.reconstruct_jpeg(api.construct(jpeg)) == jpeg


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl missing")
@pytest.mark.parametrize("subsampling", [0, 2])
def test_libjxl_progressive_reconstructs_byte_exact(subsampling):
    """libjxl-constructed PROGRESSIVE files reconstruct byte-exactly
    through our decoder (scan grammar + trailing-region skip pinned in
    round 3; our canonical libjpeg re-encode reproduces the original
    entropy bytes including refinement ZRLs and EOB runs)."""
    buf = io.BytesIO()
    Image.fromarray(_img(noise=8)).save(
        buf, format="JPEG", quality=78, progressive=True,
        subsampling=subsampling)
    jpeg = buf.getvalue()
    ljx = refjxl.jpeg_construct(jpeg)
    assert api.reconstruct_jpeg(ljx) == jpeg


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl missing")
def test_libjxl_reconstructs_our_progressive_construct():
    """The full interop matrix: libjxl byte-exactly reconstructs OUR
    progressive construct output (the trailing-section grammar —
    pooled per-scan reset/EZR counts, no extensions field — pinned in
    round 3)."""
    buf = io.BytesIO()
    Image.fromarray(_img(noise=8)).save(
        buf, format="JPEG", quality=78, progressive=True)
    jpeg = buf.getvalue()
    jx = api.construct(jpeg)
    assert refjxl.jpeg_reconstruct(jx) == jpeg


def _fuzz_jpeg(progressive=False, quality=80, subsampling=2, gray=False,
               qtables=None, restart_blocks=0, optimize=False):
    import io
    from PIL import Image
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:80, 0:96]
    base = np.clip(np.stack(
        [128 + 90 * np.sin(yy / 9) + rng.normal(0, 10, yy.shape),
         120 + 70 * np.cos(xx / 7),
         110 + 50 * np.sin((xx + yy) / 11)], -1), 0, 255).astype(np.uint8)
    img = Image.fromarray(base[:, :, 0] if gray else base)
    buf = io.BytesIO()
    kw = dict(quality=quality)
    if progressive:
        kw["progressive"] = True
    if not gray:
        kw["subsampling"] = subsampling
    if qtables is not None:
        kw["qtables"] = qtables
        kw.pop("quality", None)
    if restart_blocks:
        kw["restart_marker_blocks"] = restart_blocks
    if optimize:
        kw["optimize"] = True
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


_Q16 = [[min(3000, 16 + i * j * 7) for i in range(8)] for j in range(8)]
_Q16F = [v for row in _Q16 for v in row]

_FUZZ_MATRIX = [
    ("prog-420", dict(progressive=True, quality=75, subsampling=2)),
    ("prog-422", dict(progressive=True, quality=75, subsampling=1)),
    ("prog-444", dict(progressive=True, quality=90, subsampling=0)),
    ("prog-gray", dict(progressive=True, quality=80, gray=True)),
    ("base-restart", dict(quality=80, restart_blocks=4)),
    ("base-q16", dict(quality=75, qtables=[_Q16F, _Q16F])),
    ("prog-q16", dict(progressive=True, qtables=[_Q16F, _Q16F])),
    ("base-optimized", dict(quality=85, optimize=True)),
    ("prog-lowq", dict(progressive=True, quality=20, subsampling=2)),
]


@pytest.mark.parametrize("label,kw", _FUZZ_MATRIX)
def test_jbrd_fuzz_matrix_own(label, kw):
    """Exotic progressive/subsampled/16-bit-quant/restart JPEGs must
    construct->reconstruct byte-exactly through our own pipeline
    (VERDICT r3 item 7: pin the jbrd grammar adversarially)."""
    from jxl_coder import api
    j = _fuzz_jpeg(**kw)
    b = api.construct(j)
    assert api.reconstruct_jpeg(b) == j


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl unavailable")
@pytest.mark.parametrize("label,kw", _FUZZ_MATRIX)
def test_jbrd_fuzz_matrix_interop(label, kw):
    """Same matrix cross-coded with libjxl: their construct -> our
    reconstruct and our construct -> their reconstruct, both
    byte-exact."""
    import refjxl
    from jxl_coder import api
    j = _fuzz_jpeg(**kw)
    ours_from_theirs = api.reconstruct_jpeg(refjxl.jpeg_construct(j))
    assert ours_from_theirs == j
    theirs_from_ours = refjxl.jpeg_reconstruct(api.construct(j))
    assert theirs_from_ours == j


def test_jbrd_multi_dri_rejected():
    """Files redefining DRI mid-stream are unrepresentable in jbrd;
    the reference rejects them (enc_jpeg_data_reader.cc "Duplicate DRI
    marker") and so must we — with a clean error, not a bad stream."""
    import io
    from PIL import Image
    from jxl_coder import api
    from jxl_coder.jpeg.parser import JpegError
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (80, 96, 3)).astype(np.uint8)
    buf = io.BytesIO()
    try:
        Image.fromarray(base).save(buf, "JPEG", progressive=True,
                                   quality=80, restart_marker_rows=2)
    except Exception:
        pytest.skip("Pillow lacks restart_marker_rows")
    j = buf.getvalue()
    if j.count(b"\xff\xdd") <= 1:
        pytest.skip("encoder emitted a single DRI")
    with pytest.raises((JpegError, api.InvalidJXLError)):
        api.construct(j)
    # the pure JPEG parse/serialize path must still be byte-exact
    from jxl_coder.jpeg.parser import parse_jpeg
    from jxl_coder.jpeg import writer as W
    assert W.write_jpeg_multiscan(parse_jpeg(j)) == j
