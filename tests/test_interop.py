"""Wire-format interoperability with the system libjxl (when present).

These tests are the living proof of format compatibility: our encoder's
output must decode exactly in libjxl, and libjxl's output must decode
exactly (lossless) or near-exactly (lossy, filters pending) here.
"""
import ctypes.util
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

pytestmark = pytest.mark.skipif(not HAVE_LIBJXL,
                                reason="system libjxl not available")

from jxl_coder import api  # noqa: E402


def _img(seed=7, h=40, w=56):
    rng = np.random.default_rng(seed)
    base = (np.sin(np.arange(h)[:, None] / 5) * 90
            + np.cos(np.arange(w)[None, :] / 9) * 60 + 128)
    img = (base + rng.normal(0, 12, (h, w))).clip(0, 255)
    return img.astype(np.uint8)[..., None].repeat(3, -1)


def test_lossless_ours_to_libjxl():
    img = _img()
    data = api.encode(img, lossless=True)
    out, _ = refjxl.decode(data)
    assert np.array_equal(out, img)


@pytest.mark.parametrize("effort", [1, 3, 7])
def test_lossless_libjxl_to_ours(effort):
    img = _img(seed=effort)
    data = refjxl.encode(img, lossless=True, effort=effort)
    out, _ = api.decode(data)
    assert np.array_equal(out, img)


def test_lossy_ours_to_libjxl():
    img = _img(seed=3, h=64, w=64)
    data = api.encode(img, lossless=False, quality=90)
    out, _ = refjxl.decode(data)
    d = np.abs(out.astype(int) - img.astype(int))
    assert d.mean() < 4.0


def test_lossy_roundtrip_matches_libjxl_decode():
    img = _img(seed=4, h=64, w=64)
    data = api.encode(img, lossless=False, quality=90)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours.astype(int) - theirs.astype(int))
    assert d.max() <= 3 and (d > 1).mean() < 0.05


def test_lossy_libjxl_to_ours_e3():
    img = _img(seed=5, h=64, w=64)
    data = refjxl.encode(img, lossless=False, effort=3, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours.astype(int) - theirs.astype(int))
    assert d.mean() < 1.0  # EPF/DC-smoothing still pending


# ---------------------------------------------------------------------------
# Lossy extra channels (squeezed, quantized via MA-tree multipliers) and
# animated composition.  These pin the DefaultSqueezeParameters
# vertical-first rule (h >= w) and the unpadded EC frame size.

def _rgba(seed, size):
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = rng.integers(0, 255, (size, size, 3))
    img[..., 3] = 255
    img[size // 4:3 * size // 4, size // 4:3 * size // 4, 3] = 128
    return img


@pytest.mark.parametrize("size", [64, 77, 300])
def test_lossy_alpha_bit_exact(size):
    """Alpha of lossy VarDCT streams decodes bit-exactly vs libjxl
    (square images exercise the V-first default squeeze; 77/300
    exercise the unpadded EC size)."""
    img = _rgba(3, size)
    data = refjxl.encode(img, lossless=False, effort=3, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    assert ours.shape == theirs.shape
    assert np.array_equal(ours[..., 3], theirs[..., 3])


def _decode_all_frames_libjxl(data):
    import ctypes
    from refjxl import (_lib, JxlBasicInfo, JxlPixelFormat, byref,
                        c_size_t, c_uint8, JXL_DEC_BASIC_INFO,
                        JXL_DEC_FULL_IMAGE, JXL_TYPE_UINT8,
                        JXL_NATIVE_ENDIAN)
    dec = _lib.JxlDecoderCreate(None)
    frames = []
    try:
        assert _lib.JxlDecoderSubscribeEvents(
            dec, JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE) == 0
        buf = ctypes.create_string_buffer(data, len(data))
        assert _lib.JxlDecoderSetInput(dec, buf, len(data)) == 0
        info = JxlBasicInfo()
        pixels = None
        fmt = None
        while True:
            st = _lib.JxlDecoderProcessInput(dec)
            if st == JXL_DEC_BASIC_INFO:
                assert _lib.JxlDecoderGetBasicInfo(dec, byref(info)) == 0
            elif st == 5:
                nch = 3 + (1 if info.alpha_bits else 0)
                fmt = JxlPixelFormat(nch, JXL_TYPE_UINT8,
                                     JXL_NATIVE_ENDIAN, 0)
                size = c_size_t()
                _lib.JxlDecoderImageOutBufferSize(dec, byref(fmt),
                                                  byref(size))
                pixels = (c_uint8 * size.value)()
                _lib.JxlDecoderSetImageOutBuffer(dec, byref(fmt), pixels,
                                                 size.value)
            elif st == JXL_DEC_FULL_IMAGE:
                frames.append(np.ctypeslib.as_array(pixels).reshape(
                    info.ysize, info.xsize, fmt.num_channels).copy())
            elif st == 0:
                break
            else:
                raise RuntimeError(f"decoder status {st}")
        return frames
    finally:
        _lib.JxlDecoderDestroy(dec)


def test_animated_lossy_frames_match_libjxl():
    base = (np.fromfunction(
        lambda y, x, c: 100 + 80 * np.sin(x / 11 + c)
        + 60 * np.cos(y / 13), (96, 96, 3))).clip(0, 255).astype(np.uint8)
    frames_in = [base, np.roll(base, 7, axis=1), np.roll(base, 14, axis=0)]
    data = refjxl.encode_animation(frames_in, lossless=False, effort=3,
                                   distance=1.0)
    refs = _decode_all_frames_libjxl(data)
    ours, durs, _ = api.decode_frames(data)
    assert len(ours) == len(refs) == 3
    for o, r in zip(ours, refs):
        assert o.shape == r.shape
        d = np.abs(o[..., :3].astype(int) - r[..., :3].astype(int))
        assert d.max() <= 4, d.max()


def test_animated_corpus_composition():
    """animated_jxl.jxl: 48 cropped/blended frames compose to libjxl's
    coalesced output (alpha bit-exact; colour within the EPF-stage-2/3
    residual)."""
    path = "/root/reference/app/src/main/assets/animated_jxl.jxl"
    if not os.path.exists(path):
        pytest.skip("corpus not available")
    data = open(path, "rb").read()
    refs = _decode_all_frames_libjxl(data)
    ours, durs, _ = api.decode_frames(data)
    assert len(ours) == len(refs) == 48
    for i in (0, 1, 17, 47):
        d = np.abs(ours[i].astype(int) - refs[i].astype(int))
        assert d[..., 3].max() == 0          # alpha bit-exact
        assert d.mean() < 0.05 and d.max() <= 12


# ---------------------------------------------------------------------------
# Lossy modular (XYB) mode and frame upsampling (RESAMPLING streams).

def _set_option_encode(img, opts, **kw):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "research"))
    from encopts import encode_opts
    return encode_opts(img, opts, **kw)


def _smooth(size):
    return (np.fromfunction(
        lambda y, x, c: 100 + 80 * np.sin(x / 17 + c)
        + 60 * np.cos(y / 23), (size, size, 3))).clip(0, 255).astype(np.uint8)


def test_lossy_modular_xyb():
    """cjxl -m with a distance: quantized squeezed XYB channels
    ((Y, X, B-Y) * dc_quant), non-in-place chroma squeeze."""
    img = _smooth(128)
    data = _set_option_encode(img, {11: 1}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 1


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resampling_lossless(factor):
    img = _smooth(40 * factor)
    data = _set_option_encode(img, {2: factor}, lossless=True)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    assert ours.shape == theirs.shape
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 1, d.max()


def test_resampling_lossy_vardct():
    img = _smooth(96)
    data = _set_option_encode(img, {2: 2}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    assert ours.shape == theirs.shape
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 4, d.max()


def test_progressive_dc():
    """PROGRESSIVE_DC=1: a modular-coded LF frame carries the 8x-down
    DC image; the VarDCT frame references it via kUseDcFrame."""
    img = _smooth(128)
    data = _set_option_encode(img, {19: 1}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 3, d.max()
    assert d.mean() < 0.2


def test_noise_synthesis():
    """kNoise streams: Xorshift128Plus planes, subtract-box convolution,
    intensity-lut strength — matches libjxl within the decoder's float
    floor."""
    rng = np.random.default_rng(4)
    img = (np.full((128, 128, 3), 128.0)
           + rng.normal(0, 6, (128, 128, 3))).clip(0, 255).astype(np.uint8)
    data = _set_option_encode(img, {6: 1}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 3, d.max()


def test_photon_noise_multigroup():
    y, x = np.mgrid[0:200, 0:300]
    img = np.repeat(((y + x) // 3).clip(0, 255).astype(np.uint8)[:, :, None],
                    3, 2)
    data = _set_option_encode(img, {5: 1600.0}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 2, d.max()


# ---------------------------------------------------------------------------
# ICC profile streams (want_icc): the JXL ICC codec + lcms apply.

def _encode_icc_stream(img, icc):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "research"))
    from encopts import encode_icc, decode_icc
    data = encode_icc(img, icc)
    return data, decode_icc(data)


def _srgb_icc():
    import io
    from PIL import ImageCms
    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def test_icc_codec_byte_exact():
    """Our ICC codec (entropy layer + unpredict commands) reproduces the
    profile libjxl reports, byte for byte."""
    from jxl_coder.bitstream.container import extract_codestream
    from jxl_coder.bitstream.reader import BitReader
    from jxl_coder.bitstream.headers import read_image_header
    img = np.full((16, 16, 3), 100, np.uint8)
    icc = _srgb_icc()
    data, true = _encode_icc_stream(img, icc)
    cs = extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    assert hdr.metadata.icc_profile == true == icc


def test_want_icc_decode():
    """want_icc lossless streams decode; an sRGB embedded profile is an
    identity transform."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    data, _ = _encode_icc_stream(img, _srgb_icc())
    out, info = api.decode(data)
    assert np.array_equal(out, img)


def test_patches_decode():
    """Text-like content at high effort: a kReferenceOnly patch-source
    frame + kPatches dictionary in the main frame."""
    rng = np.random.default_rng(3)
    img = np.full((256, 256, 3), 245, np.uint8)
    glyph = np.array([[0, 1, 1, 1, 0], [1, 0, 0, 0, 1], [1, 1, 1, 1, 1],
                      [1, 0, 0, 0, 1], [1, 0, 0, 0, 1], [1, 0, 0, 0, 1],
                      [0, 0, 0, 0, 0]], bool)
    for _ in range(120):
        y, x = rng.integers(0, 248), rng.integers(0, 250)
        img[y:y + 7, x:x + 5][glyph] = 20
    data = _set_option_encode(img, {8: 1}, lossless=False, distance=1.0,
                              effort=8)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 4, d.max()


def test_progressive_dc_level2_custom_quant():
    """Two-level LF frame chains carry custom (distance-band DCT mode)
    dequant matrices; smooth content decodes to libjxl parity."""
    img = np.repeat(np.linspace(40, 200, 520)[None, :, None], 300,
                    0).astype(np.uint8).repeat(3, 2).reshape(300, 520, 3)
    data = _set_option_encode(img, {19: 2}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 2, d.max()


def test_progressive_ac_two_pass():
    """Multi-pass AC: coefficients split across passes with per-pass
    shifts recombine exactly (our writer's streams decode identically
    to the single-pass equivalent in BOTH decoders)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "research"))
    import importlib
    import passes_probe, vardct_write
    importlib.reload(passes_probe)
    r = np.random.default_rng(3)
    dc = r.integers(-40, 40, (3, 8, 8))
    varblocks = []
    for by in range(8):
        for bx in range(8):
            chans = {}
            for c in range(3):
                v = np.zeros(64, np.int64)
                nz = r.integers(0, 10)
                pos = r.choice(np.arange(1, 64), nz, replace=False)
                v[pos] = r.integers(-15, 16, nz)
                chans[c] = v
            varblocks.append((bx, by, 0, chans, 16))
    data2 = passes_probe.craft_two_pass(dc, varblocks, shift=1)
    data1 = vardct_write.craft_blocks(dc, varblocks, gs=65536, qdc=16,
                                      W=64, H=64)
    theirs2, _ = refjxl.decode(data2)
    theirs1, _ = refjxl.decode(data1)
    assert np.array_equal(theirs2, theirs1)
    ours2, _ = api.decode(data2)
    ours1, _ = api.decode(data1)
    assert np.array_equal(ours2, ours1)
    d = np.abs(ours2[..., :3].astype(int) - theirs2[..., :3].astype(int))
    assert d.max() <= 1


def test_splines_decode():
    """Crafted spline streams (kSplines flag): our renderer matches
    libjxl's within the float-pipeline tolerance on uint8 output."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "research"))
    import vardct_write
    from jxl_coder.vardct.splines import Splines, QuantizedSpline

    def flat(splines=None, W=64, H=64):
        ys_b, xs_b = H // 8, W // 8
        dc = np.zeros((3, ys_b, xs_b), np.int64)
        dc[0] = 80  # mid-gray base so negative spline lobes stay in range
        vbs = [(bx, by, 0,
                {c: np.zeros(64, np.int64) for c in range(3)}, 16)
               for by in range(ys_b) for bx in range(xs_b)]
        return vardct_write.craft_blocks(dc, vbs, W=W, H=H,
                                         splines=splines)

    cd1 = np.zeros((3, 32), np.int64)
    cd1[1, 0] = 12
    cd1[1, 2] = 5
    cd1[0, 0] = 30
    sd1 = np.zeros(32, np.int64)
    sd1[0] = 8
    s1 = QuantizedSpline(
        points=np.array([[8.0, 10.0], [30.0, 44.0], [52.0, 18.0]]),
        color_dct=cd1, sigma_dct=sd1)
    cd2 = np.zeros((3, 32), np.int64)
    cd2[1, 0] = -8
    cd2[2, 1] = 6
    sd2 = np.zeros(32, np.int64)
    sd2[0] = 5
    sd2[1] = 2
    s2 = QuantizedSpline(
        points=np.array([[50.0, 50.0], [14.0, 54.0]]),
        color_dct=cd2, sigma_dct=sd2)
    spl = Splines(quantization_adjustment=2, splines=[s1, s2])
    data = flat(spl)
    theirs, _ = refjxl.decode(data)
    ours, _ = api.decode(data)
    d = np.abs(ours[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 4 and d.mean() < 0.05, (d.max(), d.mean())
    # splines actually drew something
    base, _ = refjxl.decode(flat())
    assert np.abs(theirs.astype(int) - base.astype(int)).max() > 30


@pytest.mark.parametrize("sid", [19, 20, 21, 22, 23, 24, 25, 26])
def test_large_transform_strategies(sid):
    """DCT64X32 .. DCT256X256 crafted streams decode within float-1 of
    libjxl (ref: the strategy zoo of jxl/decode.h streams; tables from
    research/strategy_calib.py)."""
    import vardct_write
    from jxl_coder.vardct.strategies import STRATEGIES
    s = STRATEGIES[sid]
    bw, bh = s.width, s.height
    W = max(bw, 256); H = max(bh, 256)
    W -= W % bw; H -= H % bh
    rng = np.random.default_rng(sid)
    dc = rng.integers(-4, 5, (3, H // 8, W // 8)).astype(np.int64)
    n = bw * bh
    vbs = []
    for by in range(0, H // 8, s.cy):
        for bx in range(0, W // 8, s.cx):
            vals = {}
            for c in range(3):
                v = np.zeros(n, np.int64)
                idx = rng.choice(n - 1, 30, replace=False) + 1
                v[idx] = rng.integers(-6, 7, 30)
                vals[c] = v
            vbs.append((bx, by, sid, vals, 20))
    data = vardct_write.craft_blocks(dc, vbs, W=W, H=H)
    ref = refjxl.decode(data)[0][..., :3]
    ours, _ = api.decode(data)
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("dist", [1.0, 2.0, 4.0, 8.0])
def test_decode_parity_all_distances(dist):
    """libjxl e7 streams decode to within +-2 of libjxl's own output at
    every distance tier (quant bias + EPF passes 0-2 + DC smoothing all
    exact; see dec_real.apply_epf0/1/2, synthesis.adjust_quant_bias)."""
    img = _img(seed=9, h=128, w=128)
    data = refjxl.encode(img, lossless=False, effort=7, distance=dist)
    theirs, _ = refjxl.decode(data)
    ours, _ = api.decode(data)
    d = np.abs(ours.astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 4 and d.mean() < 0.05, (d.max(), d.mean())


@pytest.mark.skipif(not HAVE_LIBJXL, reason="libjxl not available")
def test_fuzz_interop_nonaligned_sizes():
    """Randomized encode/decode interop across non-block-aligned sizes,
    channel counts, bit depths, efforts and decoding speeds (regression
    for the double-mirrored filter borders at padded edges)."""
    rng = np.random.default_rng(42)
    for _ in range(12):
        h = int(rng.integers(8, 150))
        w = int(rng.integers(8, 150))
        nch = int(rng.choice([1, 3, 4]))
        bits = int(rng.choice([8, 8, 16]))
        dt = np.uint8 if bits == 8 else np.uint16
        img = rng.integers(0, 1 << bits, (h, w, nch)).astype(dt)
        if rng.random() < 0.5:
            d = api.encode(img, lossless=True,
                           effort=int(rng.integers(1, 9)))
            r, _ = api.decode(d)
            assert np.array_equal(r.reshape(img.shape), img)
            if bits == 8:
                t, _ = refjxl.decode(d)
                tt = t[..., :nch] if t.ndim == 3 else t
                assert np.array_equal(tt.reshape(img.shape), img)
        elif nch == 3 and bits == 8:
            d = api.encode(img, lossless=False,
                           quality=int(rng.integers(20, 100)),
                           effort=int(rng.integers(1, 9)),
                           decoding_speed=int(rng.integers(0, 5)))
            r, _ = api.decode(d)
            t, _ = refjxl.decode(d)
            dd = np.abs(r.astype(int) - t[..., :3].astype(int))
            assert dd.max() <= 4, dd.max()


@pytest.mark.skipif(not HAVE_LIBJXL, reason="libjxl not available")
def test_animated_lossy_encode_libjxl_decodes():
    """Our animated lossy streams are real wire format: libjxl's
    one-shot decoder (which surfaces the LAST frame) matches our
    last-frame decode within 1 code."""
    from jxl_coder.animation import AnimatedEncoder, AnimatedImage
    yy, xx = np.mgrid[0:48, 0:64]
    base = np.clip(np.stack([120 + 100 * np.sin(xx / 9),
                             128 + 60 * np.cos(yy / 7),
                             100 + 80 * np.sin((xx + yy) / 11)], -1),
                   0, 255).astype(np.uint8)
    enc = AnimatedEncoder(64, 48, lossless=False, quality=85)
    for i in range(4):
        enc.add_frame(np.clip(base.astype(int) + i * 12, 0,
                              255).astype(np.uint8), 40)
    data = enc.encode()
    img = AnimatedImage(data)
    assert img.frames_count == 4
    last = img.get_frame(3)
    theirs, _ = refjxl.decode(data)
    d = np.abs(last[..., :3].astype(int) - theirs[..., :3].astype(int))
    assert d.max() <= 1, d.max()


# ---- standard-wire JPEG recompression interop (round 2) -----------------

def _jpeg_bytes(img_arr, quality=80, subsampling=0, **kw):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img_arr).save(buf, format="JPEG", quality=quality,
                                  subsampling=subsampling, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [50, 85, 95])
def test_libjxl_reconstructs_our_construct(quality):
    """libjxl must byte-exactly reconstruct the original JPEG from OUR
    standard-wire construct() output (JxlConstruction.hpp semantics)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (56, 72, 3)).astype(np.uint8)
    jpeg = _jpeg_bytes(img, quality)
    jxl = api.construct(jpeg)
    assert refjxl.jpeg_reconstruct(jxl) == jpeg


def test_libjxl_decodes_our_construct_pixels():
    import io
    from PIL import Image
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    jpeg = _jpeg_bytes(img, 85)
    px, _ = refjxl.decode(api.construct(jpeg))
    pil = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    assert np.abs(px[:, :, :3].astype(int) - pil.astype(int)).max() <= 24


@pytest.mark.parametrize("quality,gray", [(50, False), (80, False),
                                          (75, True)])
def test_we_reconstruct_libjxl_construct(quality, gray):
    """Byte-exact reconstruction of libjxl-constructed files, including
    the integer chroma-from-luma undo (JxlReconstruction.hpp)."""
    rng = np.random.default_rng(5)
    shape = (56, 72) if gray else (56, 72, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    jpeg = _jpeg_bytes(img, quality)
    assert api.reconstruct_jpeg(refjxl.jpeg_construct(jpeg)) == jpeg


@pytest.mark.parametrize("subsampling", [1, 2])
def test_libjxl_roundtrips_our_subsampled_construct(subsampling):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (56, 72, 3)).astype(np.uint8)
    jpeg = _jpeg_bytes(img, 75, subsampling=subsampling)
    jxl = api.construct(jpeg)
    assert refjxl.jpeg_reconstruct(jxl) == jpeg


def test_we_reconstruct_libjxl_420_construct():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (112, 96, 3)).astype(np.uint8)
    jpeg = _jpeg_bytes(img, 65, subsampling=2)
    assert api.reconstruct_jpeg(refjxl.jpeg_construct(jpeg)) == jpeg


# ---- lossy encoder completeness: alpha, 16-bit, colour tagging ----------

def test_lossy_rgba_alpha_survives_libjxl():
    """VarDCT frame + lossless ALPHA extra channel: libjxl must decode
    4 channels with bit-exact alpha (interop/JxlEncoding.cpp:112-123)."""
    yy, xx = np.mgrid[0:80, 0:96]
    img = np.stack([(yy * 2) % 256, (xx * 2) % 256, (xx + yy) % 256,
                    np.clip(xx * 3, 0, 255)], -1).astype(np.uint8)
    data = api.encode(img, lossless=False, quality=90)
    out, info = refjxl.decode(data)
    assert out.shape[2] == 4
    assert np.array_equal(out[:, :, 3], img[:, :, 3])
    ours, oinfo = api.decode(data)
    assert oinfo.alpha
    assert np.array_equal(ours[:, :, 3], img[:, :, 3])


def test_lossy_rgba_alpha_multigroup():
    yy, xx = np.mgrid[0:500, 0:600]
    img = np.stack([yy % 256, xx % 256, ((xx + yy) // 2) % 256,
                    np.clip(xx // 3, 0, 255)], -1).astype(np.uint8)
    data = api.encode(img, lossless=False, quality=88)
    out, _ = refjxl.decode(data)
    assert np.array_equal(out[:, :, 3], img[:, :, 3])


def test_lossy_16bit_keeps_precision():
    """uint16 lossy input must NOT be quantized to 8 bits
    (JxlEncoder.cpp:92-152 accepts 16-bit input)."""
    g = (np.mgrid[0:120, 0:160][1] * 300 + 70).astype(np.uint16)
    img16 = np.stack([g, g, g], -1)
    data = api.encode(img16, lossless=False, quality=98)
    out, info = refjxl.decode(data, as_float=True)
    assert info.bits_per_sample == 16
    err = np.abs(out[:, :, :3].astype(np.float64)
                 - img16.astype(np.float64) / 65535.0)
    assert err.max() < 1.0 / 255.0     # beyond-8-bit fidelity
    ours, oinfo = api.decode(data)
    assert ours.dtype == np.uint16 and oinfo.bits_per_sample == 16


def test_lossy_pq_rgba16_roundtrip():
    """RGBA16 PQ image through our encoder -> libjxl decoder keeps the
    HDR encoding and the alpha channel (VERDICT item 4 criterion)."""
    from jxl_coder.bitstream.headers import ColourEncoding
    base = np.clip(np.mgrid[0:96, 0:112][0] * 500 + 2000, 0,
                   60000).astype(np.uint16)
    alpha = np.clip(np.mgrid[0:96, 0:112][1] * 600, 0,
                    65535).astype(np.uint16)
    pq = np.stack([base, base // 2, base // 3, alpha], -1)
    ce = ColourEncoding()
    ce.transfer_function = 16          # PQ
    data = api.encode(pq, lossless=False, quality=92, colour=ce,
                      intensity_target=10000)
    out, info = refjxl.decode(data, as_float=True)
    assert out.shape[2] == 4
    assert np.abs(out[:, :, 3] - alpha / 65535.0).max() < 1e-4
    err = np.abs(out[:, :, :3] - pq[:, :, :3] / 65535.0)
    # parity with libjxl's own lossy PQ encode at this distance
    enc = refjxl.make_color_encoding(transfer_function=16)
    ref = refjxl.encode_ex(pq[:, :, :3], lossless=False, effort=5,
                           distance=0.9, color_encoding=enc,
                           intensity_target=10000)
    rerr = np.abs(refjxl.decode(ref, as_float=True)[0][:, :, :3]
                  - pq[:, :, :3] / 65535.0)
    assert err.mean() <= rerr.mean() * 1.5


def test_ec_resampling_stream():
    """EXTRA_CHANNEL_RESAMPLING streams: the alpha EC is coded at 1/2
    resolution and upsampled on decode; parity with libjxl."""
    img = np.zeros((96, 96, 4), np.uint8)
    img[..., :3] = (np.mgrid[0:96, 0:96][0] * 2).astype(
        np.uint8)[..., None]
    img[..., 3] = 255
    img[20:60, 30:70, 3] = 128
    data = _set_option_encode(img, {3: 2}, lossless=False, distance=1.0)
    ours, _ = api.decode(data)
    theirs, _ = refjxl.decode(data)
    d = np.abs(ours.astype(int) - np.asarray(theirs).astype(int))
    assert d[..., :3].max() <= 2
    assert d[..., 3].max() <= 1
