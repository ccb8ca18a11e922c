"""Pillow image plugin for JXL files decoded by jxl_coder.

The image-loader integration layer — analogue of the reference's Glide
plugin (app/src/main/java/com/awxkee/jxlcoder/glide/
JxlCoderByteBufferDecoder.kt:19-74, registered by JxlGlideModule.kt):
after register(), `PIL.Image.open("x.jxl")` works everywhere Pillow is
used, with the same magic-sniff gate the Glide decoder uses.

Animated streams support the standard Pillow sequence protocol
(`n_frames`, `is_animated`, `seek`/`tell`, per-frame
`info["duration"]`), and `save(..., save_all=True)` writes a real
animated JXL through AnimatedEncoder — the analogue of reaching
JxlAnimatedEncoder.kt:38-118 from the integration layer.
"""

from __future__ import annotations

import io

import numpy as np

from PIL import Image, ImageFile

from .. import api


def _accept(prefix: bytes) -> bool:
    return api.is_jxl(prefix)


def _to_uint8(pixels: np.ndarray, mode: str) -> np.ndarray:
    if pixels.dtype == np.uint16:
        pixels = (pixels >> 8).astype(np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    if pixels.shape[-1] == 1:
        pixels = np.repeat(pixels, 3, axis=-1)
    want = 4 if mode == "RGBA" else 3
    if pixels.shape[-1] != want:
        if want == 4:
            pixels = np.concatenate(
                [pixels, np.full_like(pixels[..., :1], 255)], -1)
        else:
            pixels = pixels[..., :3]
    return pixels


class JxlImageFile(ImageFile.ImageFile):
    format = "JXL"
    format_description = "JPEG XL (jxl_coder)"

    def _open(self):
        self.fp.seek(0)
        data = self.fp.read()
        self._jxl_data = data
        info = api.basic_info(data)
        self._size = (info.xsize, info.ysize)
        if info.alpha:
            self._mode = "RGBA"
        else:
            self._mode = "RGB"
        self.info["bits_per_sample"] = info.bits_per_sample
        self.info["animation"] = info.have_animation
        self.tile = []
        self._decoded = None
        self._anim = None
        self._frame = 0
        self.n_frames = 1
        if info.have_animation:
            from ..animation import AnimatedImage
            self._anim = AnimatedImage(data)
            self.n_frames = self._anim.frames_count
            self.info["loop"] = self._anim.loops_count
            if self.n_frames:
                self.info["duration"] = self._anim.frame_duration_ms(0)

    @property
    def is_animated(self) -> bool:
        return self.n_frames > 1

    def seek(self, frame: int) -> None:
        if frame == self._frame:
            return
        if frame < 0 or frame >= self.n_frames:
            raise EOFError(f"no frame {frame}")
        self._frame = frame
        self._decoded = None
        if self._anim is not None:
            self.info["duration"] = self._anim.frame_duration_ms(frame)

    def tell(self) -> int:
        return self._frame

    def load(self):
        if self._decoded is None:
            if self._anim is not None:
                pixels = self._anim.get_frame(self._frame)
            else:
                pixels, _ = api.decode(self._jxl_data)
            pixels = _to_uint8(pixels, self.mode)
            self._decoded = Image.fromarray(pixels, self.mode)
            self.im = self._decoded.im
        return self._decoded.load()


def _frame_arrays(im, append_images):
    """Every frame of im (+ append_images) as uint8 arrays with the
    Pillow per-frame duration convention (encoderinfo 'duration' as a
    scalar or list overrides frame info)."""
    seqs = [im] + list(append_images or [])
    enc = getattr(im, "encoderinfo", {}) or {}
    dur = enc.get("duration")
    frames = []
    for seq in seqs:
        n = getattr(seq, "n_frames", 1)
        for i in range(n):
            if n > 1:
                seq.seek(i)
            mode = "RGBA" if "A" in seq.mode else "RGB"
            arr = np.asarray(seq.convert(mode))
            d = seq.info.get("duration", 100)
            frames.append((arr, int(d) if d else 100))
    if dur is not None:
        if isinstance(dur, (list, tuple)):
            frames = [(a, int(dur[i % len(dur)]))
                      for i, (a, _) in enumerate(frames)]
        else:
            frames = [(a, int(dur)) for a, _ in frames]
    return frames


def _save(im, fp, filename, save_all=False):
    enc = getattr(im, "encoderinfo", {}) or {}
    lossless = enc.get("lossless", True)
    quality = enc.get("quality", 90)
    if save_all:
        frames = _frame_arrays(im, enc.get("append_images"))
        if len(frames) > 1:
            from ..animation import AnimatedEncoder
            h, w = frames[0][0].shape[:2]
            ae = AnimatedEncoder(w, h, num_loops=int(enc.get("loop", 0)),
                                 lossless=lossless, quality=quality)
            for arr, dur in frames:
                ae.add_frame(arr, dur)
            fp.write(ae.encode())
            return
    arr = np.asarray(im.convert("RGBA" if "A" in im.mode else "RGB"))
    fp.write(api.encode(arr, lossless=lossless, quality=quality))


def _save_all(im, fp, filename):
    _save(im, fp, filename, save_all=True)


_registered = False


def register() -> None:
    """Register the JXL codec with Pillow (idempotent)."""
    global _registered
    if _registered:
        return
    Image.register_open(JxlImageFile.format, JxlImageFile, _accept)
    Image.register_save(JxlImageFile.format, _save)
    Image.register_save_all(JxlImageFile.format, _save_all)
    Image.register_extension(JxlImageFile.format, ".jxl")
    Image.register_mime(JxlImageFile.format, "image/jxl")
    _registered = True
