"""Bitstream front-end tests: bit reader, container, headers, TOC.

Conformance strategy (SURVEY.md §4): no reference decoder exists in this
image, so structural conformance is checked against the 13 real-world .jxl
corpus files shipped with the reference app, with the byte-exact invariant
that TOC section sizes sum to the codestream length.
"""

import pytest

from conftest import asset, all_assets

from jxl_coder.bitstream.reader import BitReader, unpack_signed, pack_signed
from jxl_coder.bitstream.container import extract_codestream, is_jxl
from jxl_coder.bitstream.headers import read_image_header
from jxl_coder.bitstream.frame_header import read_frame_header, read_toc
from jxl_coder import api


# ---- primitives ----------------------------------------------------------

def test_bitreader_lsb_first():
    br = BitReader(bytes([0b10110010, 0xFF]))
    assert br.u(1) == 0
    assert br.u(2) == 0b01
    assert br.u(5) == 0b10110
    assert br.u(4) == 0xF


def test_u64_selectors():
    # selector 0 -> 0
    br = BitReader(bytes([0b00]))
    assert br.u64() == 0
    # selector 1 -> u(4)+1 ; bits: sel=01 then 4 bits value 5 -> 6
    br = BitReader(bytes([0b0101_01, 0]))
    assert br.u64() == 6


def test_unpack_signed_roundtrip():
    for v in range(-300, 300):
        assert unpack_signed(pack_signed(v)) == v
    assert unpack_signed(0) == 0
    assert unpack_signed(1) == -1
    assert unpack_signed(2) == 1
    assert unpack_signed(3) == -2


def test_f16():
    br = BitReader(bytes([0x00, 0x3C]))  # 0x3C00 = 1.0
    assert br.f16() == 1.0
    br = BitReader(bytes([0x00, 0xC0]))  # 0xC000 = -2.0
    assert br.f16() == -2.0


# ---- container -----------------------------------------------------------

def test_is_jxl_magics():
    assert is_jxl(b"\xff\x0a" + b"\x00" * 10)
    assert is_jxl(b"\x00\x00\x00\x0cJXL \r\n\x87\n" + b"rest")
    assert not is_jxl(b"\x89PNG\r\n\x1a\n")
    assert not is_jxl(b"")


@pytest.mark.parametrize("name", all_assets())
def test_corpus_is_jxl(name):
    assert api.is_jxl(asset(name))


# ---- headers against the real corpus -------------------------------------

EXPECTED_SIZES = {
    "alpha_jxl.jxl": (1000, 1000),
    # art.jxl is orientation 7 (anti-transpose): oriented size swaps
    "art.jxl": (1024, 1024),
    "alpha_png_freepik.jxl": (1920, 1080),
    "animated_jxl.jxl": (128, 128),
    "dark_street.jxl": (2205, 3920),
    "first_jxl.jxl": (768, 768),
    "hdr_cosmos.jxl": (2048, 858),
    "jxl_icc_12.bit.jxl": (2048, 858),
    "large_jxl.jxl": (3910, 5865),
    "pexels-thibaut-tattevin-18273081.jxl": (2832, 4240),
    "second_jxl.jxl": (768, 992),
    "summer_nature.jxl": (3840, 2160),
    "wide_gamut.jxl": (2048, 858),
}


@pytest.mark.parametrize("name", sorted(EXPECTED_SIZES))
def test_get_size_corpus(name):
    assert api.get_size(asset(name)) == EXPECTED_SIZES[name]


def test_basic_info_flags():
    info = api.basic_info(asset("animated_jxl.jxl"))
    assert info.have_animation
    info = api.basic_info(asset("alpha_jxl.jxl"))
    assert info.alpha
    info = api.basic_info(asset("dark_street.jxl"))
    assert info.bits_per_sample == 16 and not info.alpha


def frame_walk(data):
    """Walk all frames; return (#frames, end_offset, codestream_len)."""
    c = extract_codestream(data)
    cs = c.codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    nframes = 0
    while True:
        fh = read_frame_header(br, hdr)
        ng, ndc = fh.counts(hdr)
        n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
            2 + ndc + ng * fh.passes.num_passes)
        toc = read_toc(br, n)
        nframes += 1
        br = BitReader(cs, start_bit=toc.end_offset * 8)
        if fh.is_last or nframes > 1000:
            break
    return nframes, toc.end_offset, len(cs)


TOC_EXACT = [n for n in sorted(EXPECTED_SIZES)]


@pytest.mark.parametrize("name", TOC_EXACT)
def test_toc_sections_cover_codestream(name):
    """Byte-exact invariant: all TOC section sizes sum to codestream end."""
    nframes, end, total = frame_walk(asset(name))
    assert end == total


def test_animated_frame_count():
    nframes, _, _ = frame_walk(asset("animated_jxl.jxl"))
    assert nframes == 48


def test_bad_data_raises():
    with pytest.raises(api.InvalidJXLError):
        api.get_size(b"\x89PNG\r\n\x1a\nnotjxl")


def test_total_size_ceiling():
    """A forged header claiming a huge image must raise
    InvalidImageSizeError BEFORE any allocation — the reference's
    w*h*4*bpp < 2^31 guard (interop/JxlDecoding.cpp:103-109)."""
    import numpy as np
    from jxl_coder.bitstream.writer import BitWriter
    from jxl_coder.bitstream.headers import (ImageHeader,
                                                 ImageMetadata, SizeHeader)
    from jxl_coder.codec import write_image_header
    from jxl_coder import api
    import pytest
    hdr = ImageHeader(size=SizeHeader(xsize=10 ** 6, ysize=10 ** 6),
                      metadata=ImageMetadata())
    bw = BitWriter()
    write_image_header(bw, hdr)
    data = bw.to_bytes() + b"\x00" * 64
    for fn in (api.decode, api.decode_frames, api.decode_thumbnail):
        with pytest.raises(api.InvalidImageSizeError):
            fn(data)
    from jxl_coder.animation import AnimatedImage
    with pytest.raises(api.InvalidImageSizeError):
        AnimatedImage(data)
    # the boundary itself: just-under passes the size check (then fails
    # later on the truncated stream, which must NOT be a size error)
    hdr2 = ImageHeader(size=SizeHeader(xsize=16384, ysize=16384),
                       metadata=ImageMetadata())
    bw2 = BitWriter()
    write_image_header(bw2, hdr2)
    with pytest.raises(api.InvalidJXLError):
        api.decode(bw2.to_bytes() + b"\x00" * 64)


def test_animated_get_frame_thread_safety():
    """Concurrent get_frame from two threads must not corrupt the
    compose cursor (the reference mutexes its animated decoder,
    interop/JxlAnimatedDecoder.hpp:235)."""
    import threading
    import numpy as np
    from jxl_coder import api
    from jxl_coder.animation import AnimatedImage, AnimatedEncoder
    rng = np.random.default_rng(5)
    enc = AnimatedEncoder(width=40, height=32, num_loops=0)
    frames = [rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
              for _ in range(6)]
    for f in frames:
        enc.add_frame(f, duration_ms=40)
    data = enc.encode()
    img = AnimatedImage(data)
    expect = [img.get_frame(i) for i in range(6)]
    img2 = AnimatedImage(data)
    errs = []

    def worker(order):
        try:
            for i in order:
                got = img2.get_frame(i)
                if not np.array_equal(got, expect[i]):
                    errs.append(i)
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    ts = [threading.Thread(target=worker, args=([0, 3, 1, 5, 2, 4] * 3,)),
          threading.Thread(target=worker, args=([5, 0, 4, 1, 3, 2] * 3,))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs


def test_bitflip_fuzz_typed_errors():
    """Bit-flipped corpus headers must raise TYPED errors, never leak
    IndexError/KeyError or crash (VERDICT r3 hardening criterion).
    The three named reproducers leaked IndexError before round 4; the
    sweep covers the smallest corpus file's whole header."""
    import os
    import numpy as np
    from jxl_coder import api
    assets = "/root/reference/app/src/main/assets"
    if not os.path.isdir(assets):
        import pytest
        pytest.skip("reference corpus unavailable")
    allowed = (api.InvalidJXLError, api.InvalidImageSizeError)

    def check(blob):
        for fn in (api.get_size, api.basic_info):
            try:
                fn(blob)
            except allowed:
                pass
        try:
            api.decode(blob)
        except allowed:
            pass

    for fname, pos, bit in (("alpha_jxl.jxl", 78, 0),
                            ("alpha_png_freepik.jxl", 50, 3),
                            ("art.jxl", 71, 6)):
        path = os.path.join(assets, fname)
        if not os.path.exists(path):
            continue
        data = bytearray(open(path, "rb").read())
        data[pos] ^= 1 << bit
        check(bytes(data))

    small = min((os.path.join(assets, f) for f in os.listdir(assets)
                 if f.endswith(".jxl")), key=os.path.getsize)
    data = bytearray(open(small, "rb").read())
    rng = np.random.default_rng(1)
    for _ in range(40):
        pos = int(rng.integers(0, min(len(data), 128)))
        bit = int(rng.integers(0, 8))
        mut = bytearray(data)
        mut[pos] ^= 1 << bit
        check(bytes(mut))
