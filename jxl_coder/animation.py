"""Animated JXL: streaming encoder + random-access decoder.

Mirrors the reference's JxlAnimatedEncoder (addFrame/encode,
JxlAnimatedEncoder.kt:38-118 over interop/JxlAnimatedEncoder.hpp:54-198:
tps 1000/1 so durations are milliseconds) and JxlAnimatedImage
(frame count/durations/loop count + getFrame,
JxlAnimatedImage.kt:43-193).

Architectural improvement over the reference: the reference's indexing
pass must run the full decoder with coalescing off
(interop/JxlAnimatedDecoder.hpp:99-184) and getFrame(i) rewinds +
re-decodes O(i) frames (interop/JxlAnimatedDecoder.cpp:40-57).  Here the
TOC gives byte-exact section spans, so indexing walks headers only and
getFrame(i) decodes exactly one frame's sections — O(1) random access
for REPLACE-blended streams.  Frames are the GOP-sharding axis across
chips (SURVEY.md §2.6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .bitstream.reader import BitReader, BitstreamError
from .bitstream.writer import BitWriter
from .bitstream.headers import (
    ImageHeader, ImageMetadata, SizeHeader, BitDepth, ColourEncoding,
    ExtraChannelInfo, ExtraChannelType, AnimationHeader, ColourSpace,
    read_image_header)
from .bitstream.frame_header import (
    FrameHeader, Encoding, BlendMode, read_frame_header, read_toc)
from . import codec
from .bitstream import container as container_mod


@dataclasses.dataclass
class FrameIndexEntry:
    header: FrameHeader
    toc: object
    header_bit_start: int


class AnimatedImage:
    """Random-access animated decoder handle."""

    def __init__(self, data: bytes):
        import threading
        self._mutex = threading.Lock()
        try:
            c = container_mod.extract_codestream(data)
            self.codestream = c.codestream
            br = BitReader(self.codestream)
            self.image_header = read_image_header(br)
            from .api import _check_decode_size
            _check_decode_size(self.image_header)
            m = self.image_header.metadata
            if m.animation is None:
                # single still treated as 1-frame animation (the reference
                # constructor accepts stills too)
                self.animation = AnimationHeader()
            else:
                self.animation = m.animation
            self.frames: List[FrameIndexEntry] = []
            pos = br.pos
            while True:
                fbr = BitReader(self.codestream, start_bit=pos)
                fh = read_frame_header(fbr, self.image_header)
                ng, ndc = fh.counts(self.image_header)
                n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
                    2 + ndc + ng * fh.passes.num_passes)
                toc = read_toc(fbr, n)
                self.frames.append(FrameIndexEntry(fh, toc, pos))
                pos = toc.end_offset * 8
                if fh.is_last or len(self.frames) > 1 << 16:
                    break
        except BitstreamError as e:
            from .api import InvalidJXLError
            raise InvalidJXLError(str(e)) from e

    @property
    def width(self) -> int:
        return self.image_header.oriented_xsize

    @property
    def height(self) -> int:
        return self.image_header.oriented_ysize

    @property
    def frames_count(self) -> int:
        return len(self.frames)

    @property
    def loops_count(self) -> int:
        return self.animation.num_loops

    def frame_duration_ms(self, i: int) -> int:
        """Duration in ms (the reference's 1000*d*den/num formula,
        interop/JxlAnimatedDecoder.hpp:150-154)."""
        a = self.animation
        d = self.frames[i].header.duration
        return int(1000 * d * a.tps_denominator / a.tps_numerator)

    def total_duration_ms(self) -> int:
        return sum(self.frame_duration_ms(i)
                   for i in range(self.frames_count))

    def get_frame(self, i: int, scale_width: int = 0,
                  scale_height: int = 0) -> np.ndarray:
        """Decode frame i.  O(1) when frame i is a full-canvas REPLACE
        frame (only its sections are touched); cropped or blended frames
        fall back to sequential composition from the nearest cached
        state — the analogue of the reference's Rewind + SkipFrames
        re-decode (interop/JxlAnimatedDecoder.cpp:40-57), but resumable:
        monotone playback stays O(1) per frame."""
        entry = self.frames[i]
        fh = entry.header
        hdr = self.image_header
        full = (fh.blending_info.mode == BlendMode.REPLACE
                and not fh.have_crop and fh.frame_type in (0, 3))
        # the compose cursor (_seq) is shared mutable state: a player
        # thread and a caller thread may race here, so frame access is
        # mutex-guarded exactly like the reference decoder
        # (interop/JxlAnimatedDecoder.hpp:235)
        with self._mutex:
            if full:
                out = self._decode_entry(entry)[:hdr.ysize, :hdr.xsize]
            else:
                out = self._compose_to(i)
        if scale_width > 0 and scale_height > 0:
            from .ops.resize import rescale_image
            out = rescale_image(out, scale_width, scale_height)
        return out

    def _compose_to(self, target: int) -> np.ndarray:
        """Sequentially compose frames up to `target`, returning its
        full-canvas pixels.  Keeps a resumable cursor (ref slots, LF
        frames, last canvas) so successive calls with increasing indices
        re-decode nothing."""
        from . import api as _api
        hdr = self.image_header
        m = hdr.metadata
        st = getattr(self, "_seq", None)
        if st is not None and st["last_idx"] == target:
            return st["last"].copy()
        if st is None or st["next"] > target:
            st = {"next": 0, "ref_slots": {}, "dc": {}, "ref_xyb": {},
                  "last": None, "last_idx": -1}
            self._seq = st
        cs = self.codestream
        canvas = st["last"]
        for idx in range(st["next"], target + 1):
            fh = self.frames[idx].header
            toc = self.frames[idx].toc
            if fh.frame_type == 1:  # LF frame
                st["dc"][fh.lf_level] = _api._decode_lf_frame(
                    cs, hdr, fh, toc, st["dc"])
                continue
            if fh.frame_type == 2 and fh.save_before_color_transform:
                st["ref_xyb"][fh.save_as_reference] = \
                    _api._decode_reference_frame(cs, hdr, fh, toc,
                                                 st["dc"])
                continue
            pix = _api._decode_one_frame(
                cs, hdr, fh, toc, dc_frame=st["dc"].get(fh.lf_level + 1),
                ref_frames=st["ref_xyb"] if st["ref_xyb"] else None)
            if fh.frame_type == 2:  # REFERENCE_ONLY, stored raw
                st["ref_slots"][fh.save_as_reference] = pix
                canvas = pix
                continue
            if (not fh.have_crop and pix.shape[0] >= hdr.ysize
                    and pix.shape[1] >= hdr.xsize
                    and fh.blending_info.mode == BlendMode.REPLACE):
                canvas = pix[:hdr.ysize, :hdr.xsize]
            else:
                base = st["ref_slots"].get(fh.blending_info.source)
                if base is None:
                    canvas = np.zeros(
                        (hdr.ysize, hdr.xsize, pix.shape[2]), pix.dtype)
                else:
                    canvas = base.copy()
                _api._compose_frame(canvas, pix, fh, m)
            if not fh.is_last:
                st["ref_slots"][fh.save_as_reference] = canvas
        st["next"] = target + 1
        st["last"] = canvas
        st["last_idx"] = target
        return canvas.copy()

    def _decode_entry(self, entry: FrameIndexEntry) -> np.ndarray:
        hdr = self.image_header
        fh = entry.header
        if fh.encoding == Encoding.MODULAR:
            planes = codec.decode_modular_frame(self.codestream, hdr, fh,
                                                entry.toc)
            bits = hdr.metadata.bit_depth.bits_per_sample
            maxval = (1 << bits) - 1
            dtype = np.uint8 if bits <= 8 else np.uint16
            return np.stack([np.clip(p, 0, maxval) for p in planes],
                            axis=-1).astype(dtype)
        from .vardct.dec_real import decode_vardct_frame
        return decode_vardct_frame(self.codestream, hdr, fh, entry.toc)


class AnimatedEncoder:
    """Streaming animated encoder: add_frame(pixels, ms) then encode()."""

    def __init__(self, width: int, height: int, num_loops: int = 0,
                 lossless: bool = True, quality: int = 90,
                 effort: int = 7, ec_distance: float = 0.0):
        """ec_distance: extra-channel (alpha) distance for lossy
        animations — 0 keeps alpha lossless; > 0 pre-quantizes the
        alpha plane (step ~ 2*distance at 8 bits) before its lossless
        modular coding, trading alpha fidelity for rate (the
        reference's per-extra-channel distance knob,
        interop/JxlAnimatedEncoder.hpp:164-196)."""
        self.width = width
        self.height = height
        self.num_loops = num_loops
        self.lossless = lossless
        self.quality = quality
        self.effort = effort
        self.ec_distance = float(ec_distance)
        self._frames: List[Tuple[np.ndarray, int]] = []
        self._closed = False

    def add_frame(self, pixels: np.ndarray, duration_ms: int) -> None:
        if self._closed:
            raise RuntimeError("encoder already closed")
        pixels = np.asarray(pixels)
        if pixels.ndim == 2:
            pixels = pixels[:, :, None]
        if pixels.shape[:2] != (self.height, self.width):
            from .api import InvalidImageSizeError
            raise InvalidImageSizeError(
                f"frame size {pixels.shape[:2]} != "
                f"({self.height}, {self.width})")
        self._frames.append((pixels, int(duration_ms)))

    def encode(self) -> bytes:
        if not self._frames:
            raise RuntimeError("no frames added")
        self._closed = True
        nch = self._frames[0][0].shape[2]
        bits = 16 if self._frames[0][0].dtype == np.uint16 else 8

        m = ImageMetadata()
        m.bit_depth = BitDepth(False, bits, 0)
        # tps 1000/1: durations are milliseconds
        # (interop/JxlAnimatedEncoder.hpp:114-118)
        m.animation = AnimationHeader(tps_numerator=1000,
                                     tps_denominator=1,
                                     num_loops=self.num_loops)
        if self.lossless:
            m.xyb_encoded = False
            ce = ColourEncoding()
            if nch == 1:
                ce.colour_space = ColourSpace.GREY
            m.colour_encoding = ce
        if nch == 4:
            # alpha rides as an extra channel on the lossy path too
            # (interop/JxlAnimatedEncoder.hpp:135-144)
            ec = ExtraChannelInfo(type=ExtraChannelType.ALPHA)
            ec.bit_depth = BitDepth(False, bits, 0)
            m.extra_channels = [ec]
        hdr = ImageHeader(size=SizeHeader(xsize=self.width,
                                          ysize=self.height), metadata=m)
        bw = BitWriter()
        codec.write_image_header(bw, hdr)
        from .bitstream.frame_header import BlendingInfo
        for idx, (pixels, dur) in enumerate(self._frames):
            fh = FrameHeader()
            fh.duration = dur
            fh.is_last = idx == len(self._frames) - 1
            fh.ec_upsampling = [1] * len(m.extra_channels)
            fh.ec_blending_info = [BlendingInfo()
                                   for _ in m.extra_channels]
            if self.lossless:
                fh.encoding = Encoding.MODULAR
                fh.group_size_shift = 3
                fh.restoration_filter.epf_iters = 0
                fh.restoration_filter.gab = False
                planes = [pixels[:, :, i].astype(np.int32)
                          for i in range(nch)]
                codec.encode_modular_frame(bw, hdr, fh, planes,
                                           use_ycocg=(nch >= 3))
            else:
                fh.encoding = Encoding.VARDCT
                fh.restoration_filter.epf_iters = 1
                from .vardct.quant import quality_to_distance
                alpha = None
                if nch == 4:
                    alpha = pixels[:, :, 3].astype(np.int64)
                    if self.ec_distance > 0:
                        # per-extra-channel distance: uniform alpha
                        # pre-quantization before the lossless modular
                        # coding (step ~ 2*distance at 8 bits)
                        step = max(1, int(round(
                            self.ec_distance * 2.0
                            * ((1 << bits) - 1) / 255.0)))
                        alpha = np.clip(
                            (alpha + step // 2) // step * step,
                            0, (1 << bits) - 1)
                codec.encode_vardct_frame_into(
                    bw, hdr, fh, pixels[:, :, :3],
                    quality_to_distance(self.quality), alpha=alpha)
        bw.zero_pad_to_byte()
        return bw.to_bytes()


# ---- Convenience transcoders (JxlCoder.Convenience surface) --------------

def gif_to_jxl(gif_data: bytes, lossless: bool = True,
               quality: int = 90) -> bytes:
    """GIF -> animated JXL (gif2JXL, JXLConventions.cpp:99-171).

    GIF demux on host via Pillow (replaces the vendored giflib +
    EasyGifReader; SURVEY.md §2.5), frames composited to RGBA.
    """
    return _pil_animation_to_jxl(gif_data, lossless, quality)


def apng_to_jxl(png_data: bytes, lossless: bool = True,
                quality: int = 90) -> bytes:
    """APNG -> animated JXL (apng2JXL, JXLConventions.cpp:200-388).

    Pillow handles acTL/fcTL chunks and dispose/blend compositing
    (replaces the vendored apng-patched libpng)."""
    return _pil_animation_to_jxl(png_data, lossless, quality)


def _pil_animation_to_jxl(data: bytes, lossless: bool,
                          quality: int) -> bytes:
    import io
    from PIL import Image, ImageSequence

    im = Image.open(io.BytesIO(data))
    frames = []
    durations = []
    for frame in ImageSequence.Iterator(im):
        frames.append(np.asarray(frame.convert("RGBA")))
        durations.append(int(frame.info.get("duration", 100)))
    if not frames:
        raise ValueError("no frames in animation")
    loops = im.info.get("loop", 0)
    h, w = frames[0].shape[:2]
    enc = AnimatedEncoder(w, h, num_loops=loops, lossless=lossless,
                          quality=quality)
    for f, d in zip(frames, durations):
        enc.add_frame(f, d)
    return enc.encode()


def decode_frames_batch(img: "AnimatedImage", indices=None,
                        mesh=None) -> np.ndarray:
    """Decode several VarDCT frames as one device batch, optionally
    sharded over a mesh frame axis (GOP sharding).  Host entropy decode
    per frame feeds a single batched device reconstruction.

    Returns (N, H, W, 3) uint8.
    """
    import jax
    import jax.numpy as jnp
    from .vardct import frame as VF
    from .vardct import pipeline as P
    from .parallel import groups as G

    if indices is None:
        indices = list(range(img.frames_count))
    hdr = img.image_header
    for i in indices:
        if img.frames[i].header.encoding != Encoding.VARDCT:
            raise NotImplementedError("batch decode is for VarDCT frames")
    # explicit format routing (no exception-driven fallback): the batch
    # path below understands only the round-1 private payload; real-
    # format frames (the current encoder output) reconstruct per frame
    # — host entropy stages in a thread pool (GIL-released native
    # loops), device reconstruction when an accelerator is attached
    legacy = all(
        VF.is_legacy_vardct_payload(hdr, img.frames[i].header,
                                    img.frames[i].toc)
        for i in indices)
    if not legacy:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, len(indices))) as ex:
            outs = list(ex.map(img.get_frame, indices))
        return np.stack(outs)
    datas = []
    for i in indices:
        e = img.frames[i]
        datas.append(VF.decode_vardct_frame(img.codestream, hdr,
                                            e.header, e.toc))
    d0 = datas[0]
    ny, nx = d0.qf.shape
    ac = np.stack([d.ac for d in datas])
    dc = np.stack([d.dc for d in datas])
    qf = np.stack([d.qf for d in datas])
    fxs, fbs = [], []
    for d in datas:
        fx, fb = P.expand_cfl(jnp.asarray(d.cfl_x), jnp.asarray(d.cfl_b),
                              ny, nx)
        fxs.append(np.asarray(fx))
        fbs.append(np.asarray(fb))
    fx = np.stack(fxs)
    fb = np.stack(fbs)
    fh = img.frames[indices[0]].header
    epf = fh.restoration_filter.epf_iters or 0
    gab = fh.restoration_filter.gab
    dist = jnp.float32(d0.distance)
    if mesh is not None:
        fn = G.sharded_frame_reconstruct(mesh, epf_iters=epf, gab=gab)
        xyb = fn(jnp.asarray(ac), jnp.asarray(dc), jnp.asarray(qf),
                 jnp.asarray(fx), jnp.asarray(fb), dist)
    else:
        def one(a, d_, q, x_, b_):
            im = P.dequant_idct(a, d_, q, x_, b_, dist)
            halo = P.filter_halo(epf, gab)
            im = P.pad_rows(im, halo)
            inv = P.pad_rows(P.inv_sigma_map(q, dist), halo)
            return P.apply_filters(im, inv, epf, gab)
        xyb = jax.vmap(one)(jnp.asarray(ac), jnp.asarray(dc),
                            jnp.asarray(qf), jnp.asarray(fx),
                            jnp.asarray(fb))
    out = jax.vmap(P.xyb_to_srgb8)(xyb)
    out = np.asarray(out).transpose(0, 2, 3, 1)
    return out[:, :hdr.ysize, :hdr.xsize]


def iter_frames(img: "AnimatedImage"):
    """Playback iterator: yields (pixels, duration_ms) — the analogue of
    the reference's AnimatedDrawable frame loop
    (animation/AnimatedDrawable.kt:128-167)."""
    for i in range(img.frames_count):
        yield img.get_frame(i), img.frame_duration_ms(i)


# ---- Playback (AnimatedDrawable / FrameSequenceDrawable parity) ----------

class FrameStore:
    """Abstract frame source for playback (the reference's
    AnimatedFrameStore, animation/AnimatedFrameStore.kt): width/height,
    frames count, per-frame pixels + duration."""

    @property
    def width(self) -> int:
        raise NotImplementedError

    @property
    def height(self) -> int:
        raise NotImplementedError

    @property
    def frames_count(self) -> int:
        raise NotImplementedError

    def get_frame(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def frame_duration_ms(self, i: int) -> int:
        raise NotImplementedError


class AnimatedStore(FrameStore):
    """Adapts AnimatedImage to a target display size with FIT/FILL
    factor math (the reference's JxlAnimatedStore,
    animation/JxlAnimatedStore.kt:48-60)."""

    def __init__(self, image: AnimatedImage, target_width: int = 0,
                 target_height: int = 0, fill: bool = False):
        self._image = image
        w, h = image.width, image.height
        if target_width > 0 and target_height > 0:
            sx = target_width / w
            sy = target_height / h
            f = max(sx, sy) if fill else min(sx, sy)
            self._w = max(1, int(round(w * f)))
            self._h = max(1, int(round(h * f)))
        else:
            self._w, self._h = w, h

    @property
    def width(self) -> int:
        return self._w

    @property
    def height(self) -> int:
        return self._h

    @property
    def frames_count(self) -> int:
        return self._image.frames_count

    def get_frame(self, i: int) -> np.ndarray:
        return self._image.get_frame(i, self._w if self._w
                                     != self._image.width else 0,
                                     self._h if self._h
                                     != self._image.height else 0)

    def frame_duration_ms(self, i: int) -> int:
        return self._image.frame_duration_ms(i)


class AnimationPlayer:
    """Decode-ahead playback driver mirroring the reference's
    AnimatedDrawable (animation/AnimatedDrawable.kt:64-167): a worker
    thread prefetches `preheat` frames ahead of the consumer while
    `current()`/`advance()` serve decoded frames from the cache.

    The reference decodes on a HandlerThread and keeps a synced frame
    list; here a daemon thread fills an LRU dict guarded by a lock."""

    def __init__(self, store: FrameStore, preheat: int = 6):
        import threading
        self._store = store
        self._preheat = max(1, preheat)
        self._cache = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pos = 0
        self._want = 0
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._request(0)

    def _worker(self):
        while True:
            with self._cv:
                while not self._stop:
                    n = self._store.frames_count
                    missing = [k % n for k in range(self._want,
                                                    self._want
                                                    + self._preheat)
                               if (k % n) not in self._cache]
                    if missing:
                        target = missing[0]
                        break
                    self._cv.wait()
                if self._stop:
                    return
            frame = self._store.get_frame(target)
            with self._cv:
                self._cache[target] = frame
                # evict frames far behind the playhead
                n = self._store.frames_count
                keep = {k % n for k in range(self._pos - 1,
                                             self._pos + self._preheat + 1)}
                for k in list(self._cache):
                    if k not in keep:
                        del self._cache[k]
                self._cv.notify_all()

    def _request(self, pos: int):
        with self._cv:
            self._pos = pos
            self._want = pos
            self._cv.notify_all()

    def current(self, timeout: float = 30.0):
        """Pixels of the frame at the playhead (blocking until decoded)."""
        import time as _t
        deadline = _t.monotonic() + timeout
        i = self._pos % self._store.frames_count
        with self._cv:
            while i not in self._cache:
                remaining = deadline - _t.monotonic()
                if remaining <= 0:
                    raise TimeoutError("frame decode timed out")
                self._cv.wait(remaining)
            return self._cache[i]

    def current_duration_ms(self) -> int:
        return self._store.frame_duration_ms(
            self._pos % self._store.frames_count)

    def advance(self):
        self._request(self._pos + 1)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
