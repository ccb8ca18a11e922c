"""Frame header + TOC parsing (ISO/IEC 18181-1 frame layer).

Covers the frame-level feature surface the reference exercises through
libjxl: multi-frame animation with blending/duration
(/root/reference/jxlcoder/src/main/cpp/interop/JxlAnimatedDecoder.hpp:99-184),
VarDCT and Modular encodings, crops, reference frames, restoration filters.

Sections are byte-aligned, independently decodable byte ranges — this is the
property the device build exploits for group-grid sharding (SURVEY.md §2.6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .reader import BitReader, BitstreamError, unpack_signed
from .headers import ImageHeader


class FrameType:
    REGULAR = 0
    LF_FRAME = 1
    REFERENCE_ONLY = 2
    SKIP_PROGRESSIVE = 3


class Encoding:
    VARDCT = 0
    MODULAR = 1


class BlendMode:
    REPLACE = 0
    ADD = 1
    BLEND = 2
    ALPHA_WEIGHTED_ADD = 3
    MUL = 4


class FrameFlags:
    NOISE = 1
    PATCHES = 2
    SPLINES = 16
    USE_DC_FRAME = 32
    SKIP_ADAPTIVE_DC_SMOOTHING = 128


@dataclasses.dataclass
class BlendingInfo:
    mode: int = BlendMode.REPLACE
    alpha_channel: int = 0
    clamp: bool = False
    source: int = 0

    @staticmethod
    def read(br: BitReader, num_extra: int, full_frame: bool) -> "BlendingInfo":
        b = BlendingInfo()
        b.mode = br.u32(0, 1, 2, (2, 3))
        if num_extra > 0 and b.mode in (BlendMode.BLEND,
                                        BlendMode.ALPHA_WEIGHTED_ADD):
            b.alpha_channel = br.u32(0, 1, 2, (3, 3))
        if b.mode in (BlendMode.BLEND, BlendMode.ALPHA_WEIGHTED_ADD,
                      BlendMode.MUL):
            b.clamp = br.bool()
        if b.mode != BlendMode.REPLACE or not full_frame:
            b.source = br.u(2)
        return b


@dataclasses.dataclass
class Passes:
    num_passes: int = 1
    num_downsample: int = 0
    shift: List[int] = dataclasses.field(default_factory=list)
    downsample: List[int] = dataclasses.field(default_factory=list)
    last_pass: List[int] = dataclasses.field(default_factory=list)

    @staticmethod
    def read(br: BitReader) -> "Passes":
        p = Passes()
        p.num_passes = br.u32(1, 2, 3, (3, 4))
        if p.num_passes != 1:
            p.num_downsample = br.u32(0, 1, 2, (1, 3))
            p.shift = [br.u(2) for _ in range(p.num_passes - 1)]
            p.downsample = [br.u32(1, 2, 4, 8)
                            for _ in range(p.num_downsample)]
            p.last_pass = [br.u32(0, 1, 2, (3, 0))
                           for _ in range(p.num_downsample)]
        return p


@dataclasses.dataclass
class RestorationFilter:
    gab: bool = True
    gab_custom: bool = False
    gab_weights: Optional[tuple] = None  # (x1,x2,y1,y2,b1,b2)
    epf_iters: int = 2
    epf_sharp_custom: bool = False
    epf_sharp_lut: Optional[tuple] = None
    epf_weight_custom: bool = False
    epf_channel_scale: Optional[tuple] = None
    epf_quant_mul: float = 0.46
    epf_pass0_sigma_scale: float = 0.9
    epf_pass2_sigma_scale: float = 6.5
    epf_border_sad_mul: float = 2. / 3.
    epf_sigma_for_modular: float = 1.0

    @staticmethod
    def read(br: BitReader, encoding: int) -> "RestorationFilter":
        rf = RestorationFilter()
        if br.bool():  # all_default
            return rf
        rf.gab = br.bool()
        if rf.gab:
            rf.gab_custom = br.bool()
            if rf.gab_custom:
                rf.gab_weights = tuple(br.f16() for _ in range(6))
        rf.epf_iters = br.u(2)
        if rf.epf_iters > 0:
            if encoding == Encoding.VARDCT:
                rf.epf_sharp_custom = br.bool()
                if rf.epf_sharp_custom:
                    rf.epf_sharp_lut = tuple(br.f16() for _ in range(8))
            rf.epf_weight_custom = br.bool()
            if rf.epf_weight_custom:
                rf.epf_channel_scale = tuple(br.f16() for _ in range(3))
                rf.epf_border_sad_mul = br.f16()
            if br.bool():  # epf_sigma_custom
                if encoding == Encoding.VARDCT:
                    rf.epf_quant_mul = br.f16()
                rf.epf_pass0_sigma_scale = br.f16()
                rf.epf_pass2_sigma_scale = br.f16()
                rf.epf_border_sad_mul = br.f16()
            if encoding == Encoding.MODULAR:
                rf.epf_sigma_for_modular = br.f16()
        from .headers import read_extensions
        read_extensions(br)
        return rf


@dataclasses.dataclass
class FrameHeader:
    frame_type: int = FrameType.REGULAR
    encoding: int = Encoding.VARDCT
    flags: int = 0
    do_ycbcr: bool = False
    jpeg_upsampling: tuple = (0, 0, 0)
    upsampling: int = 1
    ec_upsampling: List[int] = dataclasses.field(default_factory=list)
    group_size_shift: int = 1
    x_qm_scale: int = 3
    b_qm_scale: int = 2
    passes: Passes = dataclasses.field(default_factory=Passes)
    lf_level: int = 0
    have_crop: bool = False
    x0: int = 0
    y0: int = 0
    frame_width: int = 0   # 0 => full image
    frame_height: int = 0
    blending_info: BlendingInfo = dataclasses.field(
        default_factory=BlendingInfo)
    ec_blending_info: List[BlendingInfo] = dataclasses.field(
        default_factory=list)
    duration: int = 0
    timecode: int = 0
    is_last: bool = True
    save_as_reference: int = 0
    save_before_color_transform: bool = False
    name: str = ""
    restoration_filter: RestorationFilter = dataclasses.field(
        default_factory=RestorationFilter)

    # ---- derived geometry -------------------------------------------------

    def coded_size(self, hdr: ImageHeader):
        """(width, height) of the coded frame data (after crop/upsampling)."""
        w = self.frame_width or hdr.xsize
        h = self.frame_height or hdr.ysize
        w = -(-w // self.upsampling)
        h = -(-h // self.upsampling)
        w = -(-w // (1 << (3 * self.lf_level)))
        h = -(-h // (1 << (3 * self.lf_level)))
        return w, h

    def group_dim(self) -> int:
        if self.encoding == Encoding.MODULAR:
            return 128 << self.group_size_shift
        return 256

    def counts(self, hdr: ImageHeader):
        """(num_groups, num_dc_groups) for TOC layout."""
        w, h = self.coded_size(hdr)
        gd = self.group_dim()
        ng = (-(-w // gd)) * (-(-h // gd))
        ndc = (-(-w // (gd * 8))) * (-(-h // (gd * 8)))
        return ng, ndc

    @property
    def is_full_frame(self) -> bool:
        return not self.have_crop or (
            self.x0 == 0 and self.y0 == 0 and self.frame_width == 0
            and self.frame_height == 0)


def read_frame_header(br: BitReader, hdr: ImageHeader) -> FrameHeader:
    m = hdr.metadata
    f = FrameHeader()
    f.ec_upsampling = [1] * m.num_extra_channels
    f.ec_blending_info = [BlendingInfo() for _ in range(m.num_extra_channels)]
    # Frame headers always begin at a byte boundary (headers and TOC
    # sections are byte-padded), then open with an all_default bit.
    # Verified bit-level against the reference corpus.
    br.zero_pad_to_byte()
    if br.bool():  # all_default
        return f
    f.frame_type = br.u(2)
    f.encoding = br.u(1)
    f.flags = br.u64()
    if not m.xyb_encoded:
        f.do_ycbcr = br.bool()
    if f.do_ycbcr and not (f.flags & FrameFlags.USE_DC_FRAME):
        f.jpeg_upsampling = (br.u(2), br.u(2), br.u(2))
    if not (f.flags & FrameFlags.USE_DC_FRAME):
        f.upsampling = br.u32(1, 2, 4, 8)
        f.ec_upsampling = [br.u32(1, 2, 4, 8)
                           for _ in range(m.num_extra_channels)]
    if f.encoding == Encoding.MODULAR:
        f.group_size_shift = br.u(2)
    if f.encoding == Encoding.VARDCT and m.xyb_encoded:
        f.x_qm_scale = br.u(3)
        f.b_qm_scale = br.u(3)
    if f.frame_type != FrameType.REFERENCE_ONLY:
        f.passes = Passes.read(br)
    if f.frame_type == FrameType.LF_FRAME:
        f.lf_level = br.u(2) + 1
    else:
        f.have_crop = br.bool()
        if f.have_crop:
            crop_enc = ((8, 0), (11, 256), (14, 2304), (30, 18688))
            if f.frame_type != FrameType.REFERENCE_ONLY:
                f.x0 = unpack_signed(br.u32(*crop_enc))
                f.y0 = unpack_signed(br.u32(*crop_enc))
            f.frame_width = br.u32(*crop_enc)
            f.frame_height = br.u32(*crop_enc)
    normal = f.frame_type in (FrameType.REGULAR, FrameType.SKIP_PROGRESSIVE)
    if normal:
        full = (not f.have_crop or (
            f.x0 <= 0 and f.y0 <= 0
            and f.frame_width + f.x0 >= hdr.xsize
            and f.frame_height + f.y0 >= hdr.ysize))
        f.blending_info = BlendingInfo.read(br, m.num_extra_channels, full)
        f.ec_blending_info = [
            BlendingInfo.read(br, m.num_extra_channels, full)
            for _ in range(m.num_extra_channels)]
        if m.animation is not None:
            f.duration = br.u32(0, 1, (8, 0), (32, 0))
            if m.animation.have_timecodes:
                f.timecode = br.u(32)
        f.is_last = br.bool()
    else:
        f.is_last = False
    if f.frame_type != FrameType.LF_FRAME and not f.is_last:
        f.save_as_reference = br.u(2)
    # save_before_color_transform is present for reference-only frames and
    # for saveable full regular frames (libjxl frame_header.cc condition).
    full = f.is_full_frame
    if (f.frame_type == FrameType.REFERENCE_ONLY or
            (full and f.frame_type == FrameType.REGULAR
             and f.blending_info.mode == BlendMode.REPLACE
             and f.duration == 0 and (f.save_as_reference != 0 or not f.is_last))):
        f.save_before_color_transform = br.bool()
    if f.frame_type == FrameType.REFERENCE_ONLY:
        f.save_before_color_transform = True if f.save_before_color_transform else f.save_before_color_transform
    name_len = br.u32(0, (4, 0), (5, 16), (10, 48))
    f.name = bytes(br.u(8) for _ in range(name_len)).decode("utf-8", "replace")
    f.restoration_filter = RestorationFilter.read(br, f.encoding)
    from .headers import read_extensions
    read_extensions(br)
    return f


@dataclasses.dataclass
class TocEntry:
    offset: int  # byte offset in codestream
    size: int


@dataclasses.dataclass
class Toc:
    entries: List[TocEntry]
    permutation: Optional[List[int]] = None
    end_offset: int = 0  # first byte after all sections

    def section(self, idx: int) -> TocEntry:
        """Entry for section idx in *logical* order (LfGlobal first)."""
        if self.permutation is not None:
            idx = self.permutation[idx]
        return self.entries[idx]


def read_toc(br: BitReader, num_entries: int,
             permutation_decoder=None) -> Toc:
    """Read the table of contents; br must be positioned right after the
    frame header."""
    permutation = None
    if br.bool():  # permuted
        if permutation_decoder is None:
            raise BitstreamError("permuted TOC requires entropy decoder")
        permutation = permutation_decoder(br, num_entries)
    br.zero_pad_to_byte()
    sizes = [br.u32((10, 0), (14, 1024), (22, 17408), (30, 4211712))
             for _ in range(num_entries)]
    br.zero_pad_to_byte()
    offset = br.pos // 8
    entries = []
    for s in sizes:
        entries.append(TocEntry(offset=offset, size=s))
        offset += s
    return Toc(entries=entries, permutation=permutation, end_offset=offset)


# --------------------------------------------------------------------------
# Writing (encoder side)

def write_frame_header(bw, f: FrameHeader, hdr: ImageHeader) -> None:
    """Mirror of read_frame_header."""
    m = hdr.metadata
    bw.zero_pad_to_byte()
    bw.bool(False)  # not all_default
    bw.u(f.frame_type, 2)
    bw.u(f.encoding, 1)
    bw.u64(f.flags)
    if not m.xyb_encoded:
        bw.bool(f.do_ycbcr)
    if f.do_ycbcr and not (f.flags & FrameFlags.USE_DC_FRAME):
        for v in f.jpeg_upsampling:
            bw.u(v, 2)
    if not (f.flags & FrameFlags.USE_DC_FRAME):
        bw.u32(f.upsampling, 1, 2, 4, 8)
        for v in f.ec_upsampling:
            bw.u32(v, 1, 2, 4, 8)
    if f.encoding == Encoding.MODULAR:
        bw.u(f.group_size_shift, 2)
    if f.encoding == Encoding.VARDCT and m.xyb_encoded:
        bw.u(f.x_qm_scale, 3)
        bw.u(f.b_qm_scale, 3)
    if f.frame_type != FrameType.REFERENCE_ONLY:
        p = f.passes
        bw.u32(p.num_passes, 1, 2, 3, (3, 4))
        if p.num_passes != 1:
            bw.u32(p.num_downsample, 0, 1, 2, (1, 3))
            for s in p.shift:
                bw.u(s, 2)
            for d in p.downsample:
                bw.u32(d, 1, 2, 4, 8)
            for lp in p.last_pass:
                bw.u32(lp, 0, 1, 2, (3, 0))
    if f.frame_type == FrameType.LF_FRAME:
        bw.u(f.lf_level - 1, 2)
    else:
        bw.bool(f.have_crop)
        if f.have_crop:
            crop_enc = ((8, 0), (11, 256), (14, 2304), (30, 18688))
            from .reader import pack_signed
            if f.frame_type != FrameType.REFERENCE_ONLY:
                bw.u32(pack_signed(f.x0), *crop_enc)
                bw.u32(pack_signed(f.y0), *crop_enc)
            bw.u32(f.frame_width, *crop_enc)
            bw.u32(f.frame_height, *crop_enc)
    normal = f.frame_type in (FrameType.REGULAR, FrameType.SKIP_PROGRESSIVE)
    if normal:
        full = (not f.have_crop or (
            f.x0 <= 0 and f.y0 <= 0
            and f.frame_width + f.x0 >= hdr.xsize
            and f.frame_height + f.y0 >= hdr.ysize))
        _write_blending(bw, f.blending_info, hdr.metadata.num_extra_channels,
                        full)
        for bi in f.ec_blending_info:
            _write_blending(bw, bi, hdr.metadata.num_extra_channels, full)
        if m.animation is not None:
            bw.u32(f.duration, 0, 1, (8, 0), (32, 0))
            if m.animation.have_timecodes:
                bw.u(f.timecode, 32)
        bw.bool(f.is_last)
    if f.frame_type != FrameType.LF_FRAME and not f.is_last:
        bw.u(f.save_as_reference, 2)
    full = f.is_full_frame
    if (f.frame_type == FrameType.REFERENCE_ONLY or
            (full and f.frame_type == FrameType.REGULAR
             and f.blending_info.mode == BlendMode.REPLACE
             and f.duration == 0
             and (f.save_as_reference != 0 or not f.is_last))):
        bw.bool(f.save_before_color_transform)
    name_bytes = f.name.encode("utf-8")
    bw.u32(len(name_bytes), 0, (4, 0), (5, 16), (10, 48))
    for b in name_bytes:
        bw.u(b, 8)
    _write_restoration_filter(bw, f.restoration_filter, f.encoding)
    bw.u64(0)  # extensions


def _write_blending(bw, b: BlendingInfo, num_extra: int, full: bool) -> None:
    bw.u32(b.mode, 0, 1, 2, (2, 3))
    if num_extra > 0 and b.mode in (BlendMode.BLEND,
                                    BlendMode.ALPHA_WEIGHTED_ADD):
        bw.u32(b.alpha_channel, 0, 1, 2, (3, 3))
    if b.mode in (BlendMode.BLEND, BlendMode.ALPHA_WEIGHTED_ADD,
                  BlendMode.MUL):
        bw.bool(b.clamp)
    if b.mode != BlendMode.REPLACE or not full:
        bw.u(b.source, 2)


def _write_restoration_filter(bw, rf: RestorationFilter, encoding: int) -> None:
    default = (rf.gab and not rf.gab_custom and rf.epf_iters == 2
               and not rf.epf_sharp_custom and not rf.epf_weight_custom
               and rf.epf_quant_mul == 0.46
               and rf.epf_sigma_for_modular == 1.0)
    if default:
        bw.bool(True)
        return
    bw.bool(False)
    bw.bool(rf.gab)
    if rf.gab:
        bw.bool(rf.gab_custom)
        if rf.gab_custom:
            for wv in rf.gab_weights:
                bw.f16(wv)
    bw.u(rf.epf_iters, 2)
    if rf.epf_iters > 0:
        if encoding == Encoding.VARDCT:
            bw.bool(False)  # sharp custom
        bw.bool(False)  # weight custom
        bw.bool(False)  # sigma custom
        if encoding == Encoding.MODULAR:
            bw.f16(rf.epf_sigma_for_modular)
    bw.u64(0)  # rf extensions


def write_toc(bw, sizes) -> None:
    bw.bool(False)  # not permuted
    bw.zero_pad_to_byte()
    for s in sizes:
        bw.u32(s, (10, 0), (14, 1024), (22, 17408), (30, 4211712))
    bw.zero_pad_to_byte()
