"""Public API facade, mirroring the reference `JxlCoder` object surface.

Reference: /root/reference/jxlcoder/src/main/java/com/awxkee/jxlcoder/
JxlCoder.kt:39-267 (decode/decodeSampled/encode/getSize/isJXL and the
Convenience transcoders).  Enums mirror the 9 Kotlin option enums
(SURVEY.md §2.1).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from .bitstream.reader import BitReader, BitstreamError
from .bitstream import container as _container
from .bitstream.headers import read_image_header, ImageHeader
from .bitstream.frame_header import (read_frame_header, read_toc,
                                     Encoding)


# ---- Option enums (values mirror JxlDefinitions.h:32-58) -----------------

class CompressionOption(enum.IntEnum):
    """JxlCompressionOption.kt:30-32"""
    LOSSLESS = 1
    LOSSY = 2


class Effort(enum.IntEnum):
    """JxlEffort.kt — 1 (fastest) .. 10 (slowest)."""
    LIGHTNING = 1
    THUNDER = 2
    FALCON = 3
    CHEETAH = 4
    HARE = 5
    WOMBAT = 6
    SQUIRREL = 7
    KITTEN = 8
    TORTOISE = 9
    GLACIER = 10


class DecodingSpeed(enum.IntEnum):
    """JxlDecodingSpeed.kt — 0 (slowest decode) .. 4 (fastest decode)."""
    SLOWEST = 0
    SLOW = 1
    MEDIUM = 2
    FAST = 3
    FASTEST = 4


class ChannelsConfiguration(enum.IntEnum):
    """JxlChannelsConfiguration.kt"""
    RGB = 1
    RGBA = 2
    MONOCHROME = 3


class EncodingPixelFormat(enum.IntEnum):
    """JxlEncodingDataPixelFormat.kt"""
    UNSIGNED_8 = 1
    BINARY_16 = 2


class PreferredColorConfig(enum.IntEnum):
    """PreferredColorConfig.kt"""
    DEFAULT = 1
    RGBA_8888 = 2
    RGBA_F16 = 3
    RGB_565 = 4
    RGBA_1010102 = 5
    HARDWARE = 6


class ScaleMode(enum.IntEnum):
    """ScaleMode.kt"""
    FIT = 1
    FILL = 2
    RESIZE = 3


class ResizeFilter(enum.IntEnum):
    """JxlResizeFilter.kt — 10 resampling kernels."""
    BILINEAR = 1
    NEAREST = 2
    CUBIC = 3
    MITCHELL = 4
    LANCZOS = 5
    CATMULL_ROM = 6
    HERMITE = 7
    BSPLINE = 8
    HANN = 9
    BICUBIC = 10


# ---- Exceptions (mirror the 6 Kotlin exception types) --------------------

class InvalidJXLError(ValueError):
    """InvalidJXLException.kt — not a JXL stream / corrupt stream."""


class CompressionError(RuntimeError):
    """JXLCoderCompressionException.kt"""


class InvalidColorSpaceError(ValueError):
    """InvalidColorSpaceException.kt"""


class InvalidCompressionOptionError(ValueError):
    """InvalidCompressionOptionException.kt"""


class InvalidImageSizeError(ValueError):
    """InvalidImageSizeException.kt — also enforces the reference's
    pixels*bytes < 2^31 ceiling (interop/JxlDecoding.cpp:103-109)."""


def _check_decode_size(hdr) -> None:
    """Total image-size ceiling, checked BEFORE any allocation: a
    forged header claiming e.g. 10^6 x 10^6 px must raise, not attempt
    the buffers.  Mirrors interop/JxlDecoding.cpp:103-109
    (w * h * 4 channels * bytes-per-sample < INT32_MAX)."""
    m = hdr.metadata
    w, h = hdr.size.xsize, hdr.size.ysize
    bps = 2 if (m.bit_depth.bits_per_sample > 8
                or m.bit_depth.float_sample) else 1
    if w * h * 4 * bps >= (1 << 31):
        raise InvalidImageSizeError(
            f"image too large to decode: {w}x{h} at {bps * 8}-bit "
            f"exceeds the 2^31-byte buffer ceiling")


# ---- Probe functions -----------------------------------------------------

def is_jxl(data: bytes) -> bool:
    """Magic sniff, both bare codestream and container
    (JxlCoder.kt:244-267)."""
    return _container.is_jxl(data)


def parse_header(data: bytes) -> ImageHeader:
    """Parse container + image header, raising InvalidJXLError on garbage."""
    try:
        c = _container.extract_codestream(data)
        br = BitReader(c.codestream)
        return read_image_header(br)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e


def get_size(data: bytes) -> Tuple[int, int]:
    """(width, height) after orientation, as the reference's getSize
    (JniDecoding.cpp:394-414) reports post-orientation dimensions."""
    hdr = parse_header(data)
    return hdr.oriented_xsize, hdr.oriented_ysize


@dataclasses.dataclass
class BasicInfo:
    """Mirror of JxlBasicInfo surface used by the reference
    (interop/JxlDecoding.cpp:85-111)."""
    xsize: int
    ysize: int
    bits_per_sample: int
    float_samples: bool
    alpha: bool
    alpha_premultiplied: bool
    orientation: int
    have_animation: bool
    intensity_target: float
    uses_original_profile: bool


def basic_info(data: bytes) -> BasicInfo:
    hdr = parse_header(data)
    m = hdr.metadata
    alpha_idx = m.alpha_index
    return BasicInfo(
        xsize=hdr.oriented_xsize,
        ysize=hdr.oriented_ysize,
        bits_per_sample=m.bit_depth.bits_per_sample,
        float_samples=m.bit_depth.float_sample,
        alpha=alpha_idx is not None,
        alpha_premultiplied=(alpha_idx is not None
                             and m.extra_channels[alpha_idx].alpha_associated),
        orientation=m.orientation,
        have_animation=m.animation is not None,
        intensity_target=m.tone_mapping.intensity_target,
        uses_original_profile=not m.xyb_encoded,
    )


# ---- Encode / decode (lossless Modular path) -----------------------------

def encode(pixels, lossless: bool = True, bits_per_sample: int = None,
           effort: int = 7, quality: int = None,
           decoding_speed: int = 0, colour=None,
           intensity_target: float = None,
           icc: bytes = None, progressive: bool = False,
           photon_noise_iso: float = 0.0, noise=None) -> bytes:
    """Encode an image array to a bare JXL codestream.

    pixels: uint8/uint16/float array (H, W), (H, W, 1), (H, W, 3) or
    (H, W, 4).  Mirrors JxlCoder.encode (JxlCoder.kt:107-138): RGBA
    input splits into color + alpha extra channel (lossy alpha is
    carried as a lossless modular extra channel,
    interop/JxlEncoding.cpp:112-123).  colour: optional ColourEncoding
    tag (PQ/HLG/wide gamut, JxlEncoder.cpp:228-371 analogue) —
    CUSTOM primaries/white point are supported; 16-bit and float
    inputs keep full precision on the lossy path too.
    icc: optional raw ICC profile bytes describing `pixels`
    (JxlEncoderSetICCProfile analogue, interop/JxlEncoding.cpp:125-137).
    Lossless embeds it in the codestream (want_icc, byte-exact on
    decode); lossy converts the pixels to sRGB through the profile
    first (libjxl's effective XYB-path semantics: the stored image is
    sRGB-referred).
    """
    import numpy as np
    from .bitstream.writer import BitWriter
    from .bitstream.headers import (
        ImageHeader, ImageMetadata, SizeHeader, BitDepth, ColourEncoding,
        ExtraChannelInfo, ExtraChannelType, ColourSpace)
    from .bitstream.frame_header import FrameHeader, Encoding
    from . import codec

    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    if icc is not None and not lossless:
        from .ops.icc_apply import icc_to_srgb
        if pixels.dtype.kind == "f":
            pix8 = np.clip(np.rint(pixels * 65535.0), 0,
                           65535).astype(np.uint16)
            pixels = icc_to_srgb(pix8, icc).astype(np.float64) / 65535.0
        else:
            pixels = icc_to_srgb(pixels, icc)
        icc = None
    h, w, nch = pixels.shape
    if bits_per_sample is None:
        bits_per_sample = 16 if pixels.dtype == np.uint16 else 8
    if not lossless:
        if nch == 1:
            pixels = np.repeat(pixels, 3, axis=2)
            nch = 3
        alpha_plane = None
        if nch == 4:
            if pixels.dtype.kind == "f":
                # rescale the [0,1] float plane BEFORE integer cast
                # (casting first would truncate 0.5 -> 0, destroying
                # partial transparency)
                alpha_plane = np.clip(
                    np.rint(pixels[:, :, 3].astype(np.float64)
                            * ((1 << bits_per_sample) - 1)), 0,
                    (1 << bits_per_sample) - 1).astype(np.int64)
            else:
                alpha_plane = pixels[:, :, 3].astype(np.int64)
            pixels = pixels[:, :, :3]
            nch = 3
        from .vardct.quant import quality_to_distance
        q = quality if quality is not None else 90
        distance = quality_to_distance(int(q))
        noise_lut = noise
        if noise_lut is None and photon_noise_iso > 0:
            # approximate photon-noise grain curve: strength grows
            # with ISO and falls with intensity (shot noise is
            # relatively strongest in the shadows).  The exact lut is
            # an encoder-side choice — the DECODER's synthesis is
            # pinned bit-exact vs libjxl (vardct/noise.py); `noise=`
            # takes a raw 8-knot lut for full control.
            import math
            a = 0.12 * math.sqrt(photon_noise_iso / 3200.0)
            noise_lut = [min(1.0, a * (1.0 - 0.8 * (k / 7.0)))
                         for k in range(8)]
        from .vardct.enc_real import encode_vardct_real
        blob = encode_vardct_real(pixels, distance=distance,
                                  decoding_speed=decoding_speed,
                                  effort=effort, alpha=alpha_plane,
                                  colour=colour,
                                  bit_depth=bits_per_sample,
                                  intensity_target=intensity_target,
                                  progressive=progressive,
                                  noise_lut=noise_lut)
        # screen-content mode decision (libjxl behaviour: cjxl encodes
        # few-colour images losslessly in modular mode even at lossy
        # settings, often an order of magnitude smaller than VarDCT):
        # when a sample shows few distinct colours, also run the
        # lossless encoder and keep the smaller stream.
        if (effort >= 3 and alpha_plane is None and colour is None
                and noise_lut is None and pixels.dtype == np.uint8):
            samp = pixels[::max(1, pixels.shape[0] // 64),
                          ::max(1, pixels.shape[1] // 64)]
            flat = samp.reshape(-1, samp.shape[2])
            packed = (flat[:, 0].astype(np.uint32) << 16) \
                | (flat[:, 1].astype(np.uint32) << 8) | flat[:, 2]
            if len(np.unique(packed)) <= 64:
                try:
                    ll = encode(pixels, lossless=True, effort=effort)
                    if len(ll) < len(blob):
                        return ll
                except Exception:
                    pass
        return blob

    m = ImageMetadata()
    m.xyb_encoded = False
    m.bit_depth = BitDepth(False, bits_per_sample, 0)
    ce = colour if colour is not None else ColourEncoding()
    if nch == 1:
        ce.colour_space = ColourSpace.GREY
    if icc is not None:
        ce.want_icc = True
        m.icc_profile = icc
    m.colour_encoding = ce
    planes = [pixels[:, :, i].astype(np.int32) for i in range(nch)]
    if nch == 4:
        ec = ExtraChannelInfo(type=ExtraChannelType.ALPHA)
        ec.bit_depth = BitDepth(False, bits_per_sample, 0)
        m.extra_channels = [ec]
    elif nch not in (1, 3):
        raise InvalidImageSizeError(f"unsupported channel count {nch}")
    hdr = ImageHeader(size=SizeHeader(xsize=w, ysize=h), metadata=m)

    fh = FrameHeader()
    fh.encoding = Encoding.MODULAR
    fh.group_size_shift = 3  # 1024 group dim
    fh.x_qm_scale = 2
    fh.ec_upsampling = [1] * len(m.extra_channels)
    fh.ec_blending_info = [
        __import__("jxl_coder.bitstream.frame_header",
                   fromlist=["BlendingInfo"]).BlendingInfo()
        for _ in m.extra_channels]
    fh.restoration_filter.epf_iters = 0
    fh.restoration_filter.gab = False

    # effort semantics (JxlEffort.kt 1-10 -> JXL_ENC_FRAME_SETTING_
    # EFFORT, jxl/encode.h:132-138): every step buys real search depth —
    #   1           no colour decorrelation, fixed gradient predictor
    #   2           + RCT (YCoCg), kept only when it wins
    #   3..6        + learned MA tree, leaf budget 6/10/16/24
    #   7           + RCT on/off search (pick the smaller stream)
    #   8           + alternative RCT subtypes {6, 0}
    #   9           + full RCT subtype sweep {0..6}
    #   10          + leaf budget 32
    from .bitstream.writer import BitWriter as _BW
    eff = max(1, min(10, int(effort)))
    leaves = {3: 6, 4: 10, 5: 16, 6: 24, 7: 24, 8: 24, 9: 24, 10: 32}
    can_rct = nch >= 3

    def enc(ycocg, tree, rct_type=6):
        cand = _BW()
        codec.encode_modular_frame(cand, hdr, fh, planes,
                                   use_ycocg=ycocg, tree=tree,
                                   rct_type=rct_type)
        return cand.to_bytes()

    def learn(ycocg, rct_type=6):
        return codec.learned_modular_tree(
            hdr, fh, planes, use_ycocg=ycocg, rct_type=rct_type,
            max_leaves=leaves[eff])

    bw = BitWriter()
    codec.write_image_header(bw, hdr)
    if not can_rct:
        body = enc(False, learn(False) if eff >= 3 else None)
    elif eff == 1:
        body = enc(False, None)
    elif eff == 2:
        # RCT is not a free win (modulo/gradient synthetics compress
        # better untouched): keep the better of RCT/no-RCT so the
        # ladder never loses to effort 1
        body = min(enc(True, None), enc(False, None), key=len)
    elif eff <= 6:
        body = min(enc(True, learn(True)), enc(False, None), key=len)
    else:
        rct_types = {7: [6], 8: [6, 0],
                     9: [6, 0, 1, 2, 3, 4, 5],
                     10: [6, 0, 1, 2, 3, 4, 5]}[eff]
        body = None
        for rt in rct_types:
            b = enc(True, learn(True, rt), rt)
            if body is None or len(b) < len(body):
                body = b
        b = enc(False, learn(False))
        if len(b) < len(body):
            body = b

    # palette transform (Transform id 1): few-colour images collapse to
    # one index channel + the palette meta-channel — the decisive mode
    # for screen content (cjxl's palette path).  Tried from effort 2;
    # kept only when it wins.
    if (eff >= 2 and nch == 3 and not m.extra_channels
            and pixels.dtype in (np.uint8, np.uint16)):
        pb = _try_palette_body(hdr, fh, planes, eff)
        if pb is not None and len(pb) < len(body):
            body = pb
    for byte in body:
        bw.u(byte, 8)
    bw.zero_pad_to_byte()
    return bw.to_bytes()


def _try_palette_body(hdr, fh, planes, eff: int):
    """Candidate modular body using the palette transform, or None when
    the image has more than 256 distinct colours."""
    import numpy as np
    from . import codec
    from .bitstream.writer import BitWriter
    r, g, b3 = (p.astype(np.uint64) for p in planes[:3])
    packed = (r << 32) | (g << 16) | b3
    # cheap bail-out: a sparse sample with >256 colours decides early
    samp = packed[::max(1, packed.shape[0] // 64),
                  ::max(1, packed.shape[1] // 64)]
    if len(np.unique(samp)) > 256:
        return None
    uniq, inv = np.unique(packed, return_inverse=True)
    K = len(uniq)
    if K > 256:
        return None
    pal = np.stack([(uniq >> 32) & 0xFFFF, (uniq >> 16) & 0xFFFF,
                    uniq & 0xFFFF]).astype(np.int32)
    idx = inv.reshape(packed.shape).astype(np.int32)
    tree = None
    if eff >= 3:
        from .modular.learn import learn_tree
        from .modular.image import Channel
        pal_ch = Channel(K, 3, hshift=-1, vshift=-1)
        pal_ch.data = pal
        idx_ch = Channel(idx.shape[1], idx.shape[0])
        idx_ch.data = idx
        leaves = {3: 6, 4: 10, 5: 16, 6: 24}.get(min(eff, 6), 24)
        tree = learn_tree([pal_ch, idx_ch], max_leaves=leaves,
                          props_allowed=[0] + list(range(2, 15)))
    cand = BitWriter()
    codec.encode_modular_frame(cand, hdr, fh, planes, tree=tree,
                               palette=(pal, idx))
    return cand.to_bytes()


def _subsampled_jpeg_probe(data: bytes):
    """If `data` is a recompressed-JPEG JXL whose frame uses chroma
    subsampling, render it via jpeg.wire and return the pixels; else
    None."""
    try:
        from .bitstream import container as _c
        from .bitstream.reader import BitReader
        from .bitstream.headers import read_image_header
        from .bitstream.frame_header import read_frame_header
        from .vardct.dec_real import jpeg_shifts
        cont = _c.extract_codestream(data)
        if cont.jpeg_reconstruction_data is None:
            return None
        br = BitReader(cont.codestream)
        hdr = read_image_header(br)
        fh = read_frame_header(br, hdr)
        if jpeg_shifts(fh) is None:
            return None
    except BitstreamError:
        return None
    from .jpeg import wire as _wire
    return _wire.decode_subsampled_to_pixels(data)


def decode(data: bytes):
    """Decode a JXL file to (pixels, BasicInfo).

    pixels: uint8/uint16 (H, W, C) with C in 1/3/4.  Both coding paths
    are supported: Modular (bit-exact lossless) and full VarDCT
    (multi-size DCT, CfL, gaborish/EPF, patches, splines, noise,
    progressive DC/AC, upsampling, ICC); the post-entropy VarDCT
    reconstruction runs on the device automatically when an accelerator
    is attached (JXL_DEVICE=0/1 force-overrides).
    """
    import numpy as np
    from .bitstream.reader import BitReader
    from .bitstream.headers import read_image_header, ColourSpace
    from .bitstream.frame_header import (
        read_frame_header, read_toc, Encoding)
    from . import codec

    from .jpeg import transcode as _jpeg_tc
    if _jpeg_tc.is_constructed(data):
        pixels = _jpeg_tc.decode_to_pixels(data)
        h, w, _ = pixels.shape
        info = BasicInfo(xsize=w, ysize=h, bits_per_sample=8,
                         float_samples=False, alpha=False,
                         alpha_premultiplied=False, orientation=1,
                         have_animation=False, intensity_target=255.0,
                         uses_original_profile=True)
        return pixels, info
    # chroma-subsampled recompressed JPEGs need per-channel block
    # grids: rendered by the jpeg.wire path (full-resolution jpeg
    # frames go through the normal VarDCT decoder below)
    _sub = _subsampled_jpeg_probe(data)
    if _sub is not None:
        pixels = _sub
        h, w, _ = pixels.shape
        info = BasicInfo(xsize=w, ysize=h, bits_per_sample=8,
                         float_samples=False, alpha=False,
                         alpha_premultiplied=False, orientation=1,
                         have_animation=False, intensity_target=255.0,
                         uses_original_profile=True)
        return pixels, info
    try:
        c = _container.extract_codestream(data)
        cs = c.codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        m = hdr.metadata
        if m.animation is not None:
            # reference parity: libjxl's one-shot decode rewrites its
            # output buffer at every FULL_IMAGE event, so decoding an
            # animated stream yields the LAST composed frame
            # (interop/JxlDecoding.cpp:74-175 event loop)
            from .animation import AnimatedImage
            img = AnimatedImage(data)
            last = img.get_frame(img.frames_count - 1)
            return apply_orientation(last, m.orientation), \
                basic_info(data)
        # skip LF (progressive-DC) and reference-only frames, stashing
        # their XYB output for the frame that references them
        dc_frames = {}
        ref_frames = {}
        while True:
            fh = read_frame_header(br, hdr)
            ng, ndc = fh.counts(hdr)
            n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
                2 + ndc + ng * fh.passes.num_passes)
            toc = read_toc(br, n)
            if fh.frame_type == 1:
                dc_frames[fh.lf_level] = _decode_lf_frame(
                    cs, hdr, fh, toc, dc_frames)
                br.pos = toc.end_offset * 8
                continue
            if fh.frame_type == 2:  # REFERENCE_ONLY (e.g. patch source)
                ref_frames[fh.save_as_reference] = _decode_reference_frame(
                    cs, hdr, fh, toc, dc_frames)
                br.pos = toc.end_offset * 8
                continue
            break
        if fh.encoding != Encoding.MODULAR:
            from .vardct.dec_real import decode_vardct_frame
            out = decode_vardct_frame(
                cs, hdr, fh, toc,
                dc_frame=dc_frames.get(fh.lf_level + 1),
                ref_frames=ref_frames if ref_frames else None)
            out = apply_orientation(out, m.orientation)
            return out, basic_info(data)
        planes = codec.decode_modular_frame(cs, hdr, fh, toc)
    except BitstreamError as e:
        part = _decode_partial(data)
        if part is not None:
            return part
        raise InvalidJXLError(str(e)) from e

    bits = m.bit_depth.bits_per_sample
    maxval = (1 << bits) - 1
    arrs = [np.clip(p, 0, maxval) for p in planes]
    dtype = np.uint8 if bits <= 8 else np.uint16
    out = np.stack(arrs, axis=-1).astype(dtype)
    if m.icc_profile is not None:
        # reference behaviour: lcms transform to sRGB on decode
        # (convertUseDefinedColorSpace, colorspaces/colorspace.cpp:38-86)
        from .ops.icc_apply import icc_to_srgb
        out = icc_to_srgb(out, m.icc_profile)
    out = apply_orientation(out, m.orientation)
    info = basic_info(data)
    return out, info


def _decode_partial(data: bytes):
    """Best-effort render of a BYTE-TRUNCATED stream: decode the
    complete received AC passes, or the DC image upsampled to full
    resolution when no AC pass arrived whole.  The reference's event
    loop yields at JXL_DEC_NEED_MORE_INPUT and renders what it has
    (jxl/decode.h:377-462 re-entry contract); this is the one-shot
    equivalent.  Returns (pixels, BasicInfo) or None when the input is
    not a clean prefix truncation (corrupt data keeps raising typed
    errors)."""
    import numpy as np
    from .bitstream.reader import BitReader
    from .bitstream.headers import read_image_header
    from .bitstream.frame_header import (read_frame_header, read_toc,
                                         Encoding)
    from .vardct.dec_real import decode_vardct_frame
    try:
        c = _container.extract_codestream(data)
        cs = c.codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        m = hdr.metadata
        if m.animation is not None:
            return None
        fh = read_frame_header(br, hdr)
        ng, ndc = fh.counts(hdr)
        npasses = fh.passes.num_passes
        n = 1 if (ng == 1 and npasses == 1) else (
            2 + ndc + ng * npasses)
        toc = read_toc(br, n)
        if (fh.encoding != Encoding.VARDCT or fh.frame_type != 0
                or len(toc.entries) == 1):
            return None
        if toc.end_offset <= len(cs):
            return None          # not a truncation: full bytes present

        def ok(idx):
            s = toc.section(idx)
            return s.offset + s.size <= len(cs)

        if not all(ok(i) for i in range(2 + ndc)):
            # LfGlobal / LF groups / HfGlobal incomplete: nothing
            # renderable arrived
            return None
        complete = 0
        for p in range(npasses):
            if all(ok(2 + ndc + p * ng + gi) for gi in range(ng)):
                complete = p + 1
            else:
                break
        if complete >= 1:
            out = decode_vardct_frame(cs, hdr, fh, toc,
                                      max_passes=complete)
        else:
            # DC arrived but no whole AC pass: render the 1/8 DC image
            # and upsample to full resolution (libjxl's progressive-DC
            # preview semantics)
            dc = decode_vardct_frame(cs, hdr, fh, toc, dc_only=True)
            from .ops.resize import rescale_image
            w = fh.frame_width or hdr.xsize
            h = fh.frame_height or hdr.ysize
            out = rescale_image(dc, w, h, scale_mode=3,
                                filter_id=int(ResizeFilter.CATMULL_ROM))
        out = apply_orientation(out, m.orientation)
        return out, basic_info(data)
    except (BitstreamError, LookupError, ValueError, ArithmeticError):
        # corrupt rather than truncated input; a device failure
        # (RuntimeError) propagates
        return None


def decode_preview(data: bytes, passes: int = 1):
    """Progressive preview: decode only the first `passes` AC passes of
    a multi-pass VarDCT still (api.encode(progressive=True) emits 2 —
    pass 0 carries the coarse coefficients).  Streams without extra
    passes — or with animation / reference frames — decode fully.

    Returns (pixels, BasicInfo) at full resolution."""
    import numpy as np
    from .vardct.dec_real import decode_vardct_frame
    try:
        c = _container.extract_codestream(data)
        cs = c.codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        m = hdr.metadata
        if m.animation is not None:
            return decode(data)
        fh = read_frame_header(br, hdr)
        ng, ndc = fh.counts(hdr)
        n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
            2 + ndc + ng * fh.passes.num_passes)
        toc = read_toc(br, n)
        if (fh.encoding != Encoding.VARDCT or fh.frame_type != 0
                or fh.passes.num_passes <= passes
                or len(toc.entries) == 1):
            return decode(data)
        out = decode_vardct_frame(cs, hdr, fh, toc, max_passes=passes)
        out = apply_orientation(out, m.orientation)
        return out, basic_info(data)
    except BitstreamError as e:
        part = _decode_partial(data)
        if part is not None:
            return part
        raise InvalidJXLError(str(e)) from e


def decode_batch(datas):
    """Decode several still JXL files, pipelining host entropy decode
    (thread pool) with device reconstruction dispatch and the d2h fetch
    of earlier frames — the steady-state batched path (the reference's
    analogue is one JxlDecoder per image on a thread pool;
    interop/JxlDecoding.cpp:36).  Files the device path cannot take
    (animation, modular, extra channels, ICC, recompressed JPEG) fall
    back to decode() per file.  Returns a list of pixel arrays.
    """
    import numpy as np
    from .vardct import device_full as TF
    from .vardct.dec_real import decode_vardct_frame

    results = [None] * len(datas)
    if not TF.device_enabled() or len(datas) <= 1:
        return [decode(d)[0] for d in datas]

    def parse(i):
        data = datas[i]
        try:
            from .jpeg import transcode as _jpeg_tc
            if _jpeg_tc.is_constructed(data) \
                    or _subsampled_jpeg_probe(data) is not None:
                return i, None
            c = _container.extract_codestream(data)
            cs = c.codestream
            br = BitReader(cs)
            hdr = read_image_header(br)
            _check_decode_size(hdr)
            m = hdr.metadata
            if (m.icc_profile is not None or m.extra_channels
                    or m.animation is not None):
                return i, None
            fh = read_frame_header(br, hdr)
            if fh.frame_type != 0 or fh.encoding == Encoding.MODULAR \
                    or not fh.is_last:
                return i, None
            ng, ndc = fh.counts(hdr)
            n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
                2 + ndc + ng * fh.passes.num_passes)
            toc = read_toc(br, n)
            st = decode_vardct_frame(cs, hdr, fh, toc, parse_only=True)
        except BitstreamError:
            return i, None
        if not isinstance(st, dict):
            # ineligible for the device path: the host already
            # produced the pixels during the parse
            return i, ("pixels", st, m.orientation)
        # all host marshalling happens here on the worker thread; the
        # main thread only dispatches the (cached-compiled) device fn
        static, args, _ = TF.prepare_exec(st)
        return i, ("state", (st, (static, args)), m.orientation)

    from concurrent.futures import ThreadPoolExecutor

    def fetch(entry):
        j, dev, stt, orx = entry
        arr = np.asarray(dev)[:stt["h"], :stt["w"]]
        results[j] = apply_orientation(arr, orx)

    pend = []
    fallback = []
    # two parse workers: not re-measured on this device yet (ROADMAP A2)
    with ThreadPoolExecutor(max_workers=2) as ex:
        for i, r in ex.map(parse, range(len(datas))):
            if r is None:
                fallback.append(i)
                continue
            kind, payload, orient = r
            if kind == "pixels":
                results[i] = apply_orientation(payload, orient)
                continue
            st, prepared = payload
            # drain the previous frame before enqueueing this frame's
            # uploads, so h2d and d2h never interleave; parse of later
            # frames still overlaps in the worker threads (rule not
            # measured on PCIe yet, ROADMAP A2)
            while pend:
                fetch(pend.pop(0))
            dev = TF.reconstruct_state_device(st, as_device=True,
                                              prepared=prepared)
            pend.append((i, dev, st, orient))
    for entry in pend:
        fetch(entry)
    for i in fallback:
        results[i] = decode(datas[i])[0]
    return results


def _decode_reference_frame(cs, hdr, fh, toc, dc_frames):
    """Decode a kReferenceOnly frame to per-channel float planes in the
    saved (pre-color-transform, i.e. XYB) space for patches."""
    from . import codec
    if fh.encoding == Encoding.MODULAR:
        xyb = codec.decode_modular_frame(cs, hdr, fh, toc, as_xyb_dc=True)
        return [xyb[0], xyb[1], xyb[2]]
    from .vardct.dec_real import decode_vardct_frame
    xyb = decode_vardct_frame(cs, hdr, fh, toc,
                              dc_frame=dc_frames.get(fh.lf_level + 1),
                              return_xyb=True)
    return [xyb[0], xyb[1], xyb[2]]


def _decode_lf_frame(cs, hdr, fh, toc, dc_frames):
    """Decode an LF (progressive-DC) frame to {0: X, 1: Y, 2: B} planes.

    LF frames are ordinary frames of the 8^lf_level-downsampled image;
    modular-coded ones carry quantized (Y, X, B-Y) channels, VarDCT
    ones reconstruct in XYB directly."""
    from . import codec
    if fh.encoding == Encoding.MODULAR:
        return codec.decode_modular_frame(cs, hdr, fh, toc,
                                          as_xyb_dc=True)
    from .vardct.dec_real import decode_vardct_frame
    return decode_vardct_frame(cs, hdr, fh, toc,
                               dc_frame=dc_frames.get(fh.lf_level + 1),
                               return_xyb=True)


def _decode_one_frame(cs, hdr, fh, toc, dc_frame=None, ref_frames=None):
    """Decode one frame's pixels (no orientation)."""
    from . import codec
    import numpy as np
    m = hdr.metadata
    if fh.encoding != Encoding.MODULAR:
        from .vardct.dec_real import decode_vardct_frame
        return decode_vardct_frame(cs, hdr, fh, toc, dc_frame=dc_frame,
                                   ref_frames=ref_frames)
    planes = codec.decode_modular_frame(cs, hdr, fh, toc)
    bits = m.bit_depth.bits_per_sample
    maxval = (1 << bits) - 1
    arrs = [np.clip(p, 0, maxval) for p in planes]
    dtype = np.uint8 if bits <= 8 else np.uint16
    return np.stack(arrs, axis=-1).astype(dtype)


def _compose_frame(canvas, pix, fh, m):
    """Blend the decoded frame rect onto the full-size canvas in place.

    Implements the FrameHeader blending semantics used by animations
    (dec_frame blending; reference coordinator composes per-frame the
    same way through libjxl): crop offsets clip against the canvas,
    REPLACE/ADD/BLEND/ALPHA_WEIGHTED_ADD/MUL per colour channel, extra
    channels follow ec_blending_info."""
    import numpy as np
    x0, y0 = fh.x0, fh.y0
    h, w = pix.shape[:2]
    sx, sy = max(0, -x0), max(0, -y0)
    dx, dy = max(0, x0), max(0, y0)
    cw = min(w - sx, canvas.shape[1] - dx)
    ch = min(h - sy, canvas.shape[0] - dy)
    if cw <= 0 or ch <= 0:
        return
    src = pix[sy:sy + ch, sx:sx + cw]
    dst = canvas[dy:dy + ch, dx:dx + cw]
    nch = pix.shape[2]
    ncolor = 1 if nch - len(m.extra_channels) == 1 else 3
    maxv = float(np.iinfo(canvas.dtype).max)

    # snapshot the pre-blend canvas alpha planes: every channel's blend
    # must see the ORIGINAL background alpha, not one updated earlier
    # in this frame's pass
    _ba0 = dst[..., ncolor:].astype(np.float64) / maxv \
        if nch > ncolor else None

    def _alpha_planes(bi):
        ai = ncolor + bi.alpha_channel
        fa = src[..., ai].astype(np.float64) / maxv
        ba = _ba0[..., bi.alpha_channel]
        premult = (bi.alpha_channel < len(m.extra_channels)
                   and m.extra_channels[bi.alpha_channel].alpha_associated)
        return fa, ba, premult

    def _blend_channels(chans, bi):
        mode = fh.blending_info.mode if bi is fh.blending_info else bi.mode
        if mode == 0:           # REPLACE
            dst[..., chans] = src[..., chans]
            return
        s = src[..., chans].astype(np.float64)
        d = dst[..., chans].astype(np.float64)
        if mode == 1:           # ADD
            out = s + d
        elif mode == 2:         # BLEND (source-over)
            fa, ba, premult = _alpha_planes(bi)
            if bi.clamp:
                fa = np.clip(fa, 0.0, 1.0)
            if premult:
                out = s + d * (1.0 - fa)[..., None]
                na = fa + ba * (1.0 - fa)
            else:
                na = fa + ba * (1.0 - fa)
                with np.errstate(divide="ignore", invalid="ignore"):
                    out = np.where(
                        na[..., None] > 0,
                        (s * fa[..., None]
                         + d * (ba * (1.0 - fa))[..., None])
                        / np.where(na[..., None] > 0, na[..., None], 1.0),
                        0.0)
            ai = ncolor + bi.alpha_channel
            dst[..., ai] = np.clip(np.rint(na * maxv), 0,
                                   maxv).astype(canvas.dtype)
        elif mode == 3:         # ALPHA_WEIGHTED_ADD
            fa, _, _ = _alpha_planes(bi)
            if bi.clamp:
                fa = np.clip(fa, 0.0, 1.0)
            out = d + s * fa[..., None]
        elif mode == 4:         # MUL
            if bi.clamp:
                s = np.clip(s, 0.0, maxv)
            out = s * d / maxv
        else:
            raise InvalidJXLError(f"unknown blend mode {mode}")
        dst[..., chans] = np.clip(np.rint(out), 0, maxv).astype(canvas.dtype)

    _blend_channels(list(range(ncolor)), fh.blending_info)
    for i, bi in enumerate(fh.ec_blending_info):
        ei = ncolor + i
        if (fh.blending_info.mode == 2
                and fh.blending_info.alpha_channel == i
                and bi.mode == 2):
            continue  # already written by the colour blend above
        if bi.mode == 0:
            dst[..., ei] = src[..., ei]
        elif bi.mode == 1:
            out = (src[..., ei].astype(np.float64)
                   + dst[..., ei].astype(np.float64))
            dst[..., ei] = np.clip(np.rint(out), 0,
                                   maxv).astype(canvas.dtype)
        elif bi.mode == 2:
            if bi.alpha_channel == i:
                # the alpha channel itself: source-over coverage
                fa, ba, _ = _alpha_planes(bi)
                if bi.clamp:
                    fa = np.clip(fa, 0.0, 1.0)
                na = fa + ba * (1.0 - fa)
                dst[..., ei] = np.clip(np.rint(na * maxv), 0,
                                       maxv).astype(canvas.dtype)
            else:
                # non-alpha EC (depth, spot colour, thermal ...)
                # blended through another channel's alpha: same
                # source-over math as the colour channels, without
                # re-writing the alpha plane
                fa, ba, premult = _alpha_planes(bi)
                if bi.clamp:
                    fa = np.clip(fa, 0.0, 1.0)
                s_ = src[..., ei].astype(np.float64)
                d_ = dst[..., ei].astype(np.float64)
                if premult:
                    out = s_ + d_ * (1.0 - fa)
                else:
                    na = fa + ba * (1.0 - fa)
                    with np.errstate(divide="ignore",
                                     invalid="ignore"):
                        out = np.where(
                            na > 0,
                            (s_ * fa + d_ * ba * (1.0 - fa))
                            / np.where(na > 0, na, 1.0), 0.0)
                dst[..., ei] = np.clip(np.rint(out), 0,
                                      maxv).astype(canvas.dtype)
        elif bi.mode == 3:      # ALPHA_WEIGHTED_ADD
            fa, _, _ = _alpha_planes(bi)
            if bi.clamp:
                fa = np.clip(fa, 0.0, 1.0)
            out = (dst[..., ei].astype(np.float64)
                   + src[..., ei].astype(np.float64) * fa)
            dst[..., ei] = np.clip(np.rint(out), 0,
                                   maxv).astype(canvas.dtype)
        elif bi.mode == 4:      # MUL
            s_ = src[..., ei].astype(np.float64)
            if bi.clamp:
                s_ = np.clip(s_, 0.0, maxv)
            out = s_ * dst[..., ei].astype(np.float64) / maxv
            dst[..., ei] = np.clip(np.rint(out), 0,
                                   maxv).astype(canvas.dtype)
        else:
            raise InvalidJXLError(
                f"extra-channel blend mode {bi.mode} not supported")


def decode_frames(data: bytes):
    """Decode ALL frames of a (possibly animated) codestream.

    Returns (frames, durations, info): frames are (H, W, C) arrays in
    display order (cropped frames composed over the blending source's
    reference canvas, saved back per save_as_reference), durations in
    animation ticks (empty header -> [0]).
    """
    import numpy as np
    try:
        c = _container.extract_codestream(data)
        cs = c.codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        m = hdr.metadata
        frames = []
        durations = []
        ref_slots = {}
        dc_frames = {}
        ref_frames_xyb = {}
        while True:
            fh = read_frame_header(br, hdr)
            ng, ndc = fh.counts(hdr)
            n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
                2 + ndc + ng * fh.passes.num_passes)
            toc = read_toc(br, n)
            if fh.frame_type == 1:  # LF frame: XYB for the next frame's DC
                dc_frames[fh.lf_level] = _decode_lf_frame(
                    cs, hdr, fh, toc, dc_frames)
                br.pos = toc.end_offset * 8
                continue
            if fh.frame_type == 2 and fh.save_before_color_transform:
                # patch source: stored pre-color-transform (XYB)
                ref_frames_xyb[fh.save_as_reference] =                     _decode_reference_frame(cs, hdr, fh, toc, dc_frames)
                if fh.is_last:
                    break
                br.pos = toc.end_offset * 8
                continue
            pix = _decode_one_frame(
                cs, hdr, fh, toc,
                dc_frame=dc_frames.get(fh.lf_level + 1),
                ref_frames=ref_frames_xyb if ref_frames_xyb else None)
            if fh.frame_type == 2:  # REFERENCE_ONLY: stored raw, not shown
                ref_slots[fh.save_as_reference] = pix
                if fh.is_last:
                    break
                br.pos = toc.end_offset * 8
                continue
            full = (not fh.have_crop
                    and pix.shape[0] >= hdr.ysize
                    and pix.shape[1] >= hdr.xsize
                    and fh.blending_info.mode == 0)
            if full:
                canvas = pix[:hdr.ysize, :hdr.xsize]
            else:
                base = ref_slots.get(fh.blending_info.source)
                if base is None:
                    canvas = np.zeros((hdr.ysize, hdr.xsize, pix.shape[2]),
                                      pix.dtype)
                else:
                    canvas = base.copy()
                _compose_frame(canvas, pix, fh, m)
            if not fh.is_last:
                ref_slots[fh.save_as_reference] = canvas
            if fh.frame_type in (0, 3) and (fh.duration > 0
                                            or m.animation is None
                                            or fh.is_last):
                frames.append(apply_orientation(canvas.copy(),
                                                m.orientation))
                durations.append(fh.duration)
            if fh.is_last:
                break
            br.pos = toc.end_offset * 8
        return frames, durations, basic_info(data)
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e


def decode_thumbnail(data: bytes):
    """Fast 1/8-scale preview: VarDCT frames decode only their DC image
    (no AC entropy decode, no filters).  Returns (pixels, BasicInfo)
    with pixels at ceil(size/8).  Modular frames fall back to a full
    decode + 8x box downsample."""
    import numpy as np
    from .bitstream.reader import BitReader
    from .bitstream.headers import read_image_header
    from .bitstream.frame_header import read_frame_header, read_toc, \
        Encoding
    info = basic_info(data)
    if info.have_animation:
        # animated: match the one-shot decode semantics (LAST composed
        # frame) instead of previewing only the first frame's DC
        full, info = decode(data)
        h, w = full.shape[:2]
        th, tw = -(-h // 8), -(-w // 8)
        ph, pw = th * 8, tw * 8
        import numpy as np
        pad = np.pad(full, ((0, ph - h), (0, pw - w)) + ((0, 0),) *
                     (full.ndim - 2), mode="edge")
        small = pad.reshape(th, 8, tw, 8, -1).mean(axis=(1, 3))
        return np.rint(small).astype(full.dtype).reshape(
            th, tw, *full.shape[2:]), info
    try:
        c = _container.extract_codestream(data)
        cs = c.codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        dc_frames = {}
        while True:
            fh = read_frame_header(br, hdr)
            ng, ndc = fh.counts(hdr)
            n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
                2 + ndc + ng * fh.passes.num_passes)
            toc = read_toc(br, n)
            if fh.frame_type == 1:
                dc_frames[fh.lf_level] = _decode_lf_frame(
                    cs, hdr, fh, toc, dc_frames)
                br.pos = toc.end_offset * 8
                continue
            if fh.frame_type == 2:
                br.pos = toc.end_offset * 8
                continue
            break
        if fh.encoding != Encoding.MODULAR and fh.upsampling == 1:
            from .vardct.dec_real import decode_vardct_frame
            out = decode_vardct_frame(
                cs, hdr, fh, toc,
                dc_frame=dc_frames.get(fh.lf_level + 1), dc_only=True)
            out = apply_orientation(out, hdr.metadata.orientation)
            return out, info
    except BitstreamError as e:
        raise InvalidJXLError(str(e)) from e
    # Modular (or upsampled) path: full decode + box downsample
    full, info = decode(data)
    h, w = full.shape[:2]
    th, tw = -(-h // 8), -(-w // 8)
    ph, pw = th * 8, tw * 8
    pad = np.pad(full, ((0, ph - h), (0, pw - w)) + ((0, 0),) *
                 (full.ndim - 2), mode="edge")
    small = pad.reshape(th, 8, tw, 8, -1).mean(axis=(1, 3))
    return np.rint(small).astype(full.dtype).reshape(
        th, tw, *full.shape[2:]), info


def _decode_downsampled(data: bytes, factor: int):
    """1/factor-resolution decode of an eligible VarDCT still through
    the device downsample post stage; returns (pixels, BasicInfo) or
    None when ineligible (animation, modular, extra channels, ICC, no
    device) — callers fall back to the full decode."""
    import numpy as np
    from .bitstream.reader import BitReader
    from .bitstream.headers import read_image_header
    from .bitstream.frame_header import (read_frame_header, read_toc,
                                         Encoding)
    from .vardct import device_full as TF
    from .vardct.dec_real import decode_vardct_frame
    if not TF.device_enabled():
        return None
    try:
        c = _container.extract_codestream(data)
        cs = c.codestream
        br = BitReader(cs)
        hdr = read_image_header(br)
        _check_decode_size(hdr)
        m = hdr.metadata
        if (m.animation is not None or m.extra_channels
                or m.icc_profile is not None
                or m.orientation != 1):
            return None
        fh = read_frame_header(br, hdr)
        if fh.frame_type != 0 or fh.encoding == Encoding.MODULAR \
                or not fh.is_last:
            return None
        ng, ndc = fh.counts(hdr)
        n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
            2 + ndc + ng * fh.passes.num_passes)
        toc = read_toc(br, n)
        out = decode_vardct_frame(cs, hdr, fh, toc, downsample=factor)
        return out, basic_info(data)
    except BitstreamError:
        return None


def decode_sampled(data: bytes, width: int, height: int,
                   preferred_color_config: int = PreferredColorConfig.DEFAULT,
                   scale_mode: int = ScaleMode.FIT,
                   resize_filter: int = ResizeFilter.MITCHELL):
    """Decode with target-size rescale + format reformat — the reference's
    decodeSampled pipeline (JniDecoding.cpp:45-331: decode -> rescale ->
    reformat).

    Returns (array, BasicInfo).  Array layout depends on the color
    config: RGBA8888 uint8 (H,W,4), RGBA_F16 float16 (H,W,4),
    RGB_565 uint16 (H,W), RGBA_1010102 uint32 (H,W).
    """
    import numpy as np
    from .ops.resize import rescale_image
    from .ops import pack as _pack

    info0 = basic_info(data)
    if (0 < width <= -(-info0.xsize // 8)
            and 0 < height <= -(-info0.ysize // 8)):
        # target fits in the 1/8 DC image: decode only the DC
        # (no AC entropy decode) and rescale from there
        pixels, info = decode_thumbnail(data)
    else:
        pixels = None
        if (0 < width <= -(-info0.xsize // 4)
                and 0 < height <= -(-info0.ysize // 4)):
            # target fits in 1/4: synthesize on device and box-average
            # there BEFORE the pixel download (16x fewer d2h bytes;
            # the reference full-decodes then rescales,
            # JniDecoding.cpp:124-136)
            pixels_info = _decode_downsampled(data, 4)
            if pixels_info is not None:
                pixels, info = pixels_info
        if pixels is None:
            pixels, info = decode(data)
    maxv = 255.0 if pixels.dtype == np.uint8 else 65535.0
    if width > 0 and height > 0 and \
            (width, height) != (pixels.shape[1], pixels.shape[0]):
        pixels = rescale_image(pixels, width, height,
                               scale_mode=scale_mode,
                               filter_id=resize_filter,
                               premultiplied=info.alpha_premultiplied)
    # HDR -> SDR fallback (JniDecoding.cpp:138-228): when the stream is
    # PQ/HLG/wide-gamut and the requested output format cannot represent
    # HDR (8-bit configs), tone map + gamut-convert to SDR sRGB.
    from .ops import color as _color
    ce = parse_header(data).metadata.colour_encoding
    sdr_target = preferred_color_config in (
        PreferredColorConfig.RGBA_8888, PreferredColorConfig.RGB_565,
        PreferredColorConfig.HARDWARE) or (
        preferred_color_config == PreferredColorConfig.DEFAULT
        and info.bits_per_sample <= 8)
    if sdr_target and pixels.shape[-1] >= 3 and \
            _color.is_hdr_encoding(ce):
        pixels = _color.hdr_to_sdr(pixels, ce, info.intensity_target)
    f = pixels.astype(np.float32) / maxv
    if f.shape[-1] == 1:
        f = np.repeat(f, 3, axis=-1)
    if f.shape[-1] == 3:
        f = np.concatenate([f, np.ones_like(f[..., :1])], axis=-1)
    out = _pack.reformat(f, preferred_color_config, info.bits_per_sample)
    return out, info


# ---- Convenience transcoders (JxlCoder.Convenience, JxlCoder.kt:141-185) -

def construct(jpeg_data: bytes) -> bytes:
    """Lossless JPEG -> JXL (Convenience.construct, JxlCoder.kt:173-175).

    Emits the STANDARD wire format (jbrd box + do_ycbcr VarDCT frame)
    that libjxl decodes and reconstructs byte-exactly, including
    4:2:0/4:2:2 chroma subsampling; the round-1 private container only
    remains as a fallback for inputs the wire path rejects."""
    from .jpeg import wire as _wire
    from .jpeg import transcode as _tc
    from .jpeg.parser import JpegError
    try:
        try:
            return _wire.construct(jpeg_data)
        except JpegError:
            return _tc.construct(jpeg_data)
    except JpegError as e:
        raise InvalidJXLError(str(e)) from e


def reconstruct_jpeg(data: bytes) -> bytes:
    """JXL -> byte-identical original JPEG (Convenience.reconstructJPEG,
    JxlCoder.kt:182-184).  Accepts standard recompressed files (ours or
    libjxl/cjxl's) and the round-1 private container."""
    from .jpeg import wire as _wire
    from .jpeg import transcode as _tc
    from .jpeg.parser import JpegError
    try:
        if _tc.is_constructed(data):
            return _tc.reconstruct(data)
        return _wire.reconstruct(data)
    except (JpegError, BitstreamError) as e:
        raise InvalidJXLError(str(e)) from e


def gif_to_jxl(gif_data: bytes, lossless: bool = True,
               quality: int = 90) -> bytes:
    """GIF -> animated JXL (Convenience.gif2JXL, JxlCoder.kt:146-153)."""
    from . import animation as _anim
    return _anim.gif_to_jxl(gif_data, lossless, quality)


def apng_to_jxl(png_data: bytes, lossless: bool = True,
                quality: int = 90) -> bytes:
    """APNG -> animated JXL (Convenience.apng2JXL, JxlCoder.kt:159-166)."""
    from . import animation as _anim
    return _anim.apng_to_jxl(png_data, lossless, quality)


def apply_orientation(pixels, orientation: int):
    """EXIF-style orientation 1..8 -> upright pixels (the reference
    resolves orientation before returning bitmaps,
    JniDecoding.cpp:95-100)."""
    import numpy as np
    if orientation == 1:
        return pixels
    if orientation == 2:
        return pixels[:, ::-1]
    if orientation == 3:
        return pixels[::-1, ::-1]
    if orientation == 4:
        return pixels[::-1]
    if orientation == 5:  # transpose
        return np.swapaxes(pixels, 0, 1)
    if orientation == 6:  # rotate 90 CW
        return np.swapaxes(pixels, 0, 1)[:, ::-1]
    if orientation == 7:  # anti-transpose
        return np.swapaxes(pixels, 0, 1)[::-1, ::-1]
    if orientation == 8:  # rotate 90 CCW
        return np.swapaxes(pixels, 0, 1)[::-1]
    raise InvalidJXLError(f"bad orientation {orientation}")
