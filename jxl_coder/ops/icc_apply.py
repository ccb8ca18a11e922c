"""Apply an ICC profile to decoded pixels — the reference's
`convertUseDefinedColorSpace` (colorspaces/colorspace.cpp:38-86):
lcms2 transform source-ICC -> sRGB with perceptual intent, black-point
compensation and alpha copy-through.

We use Pillow's bundled littlecms (ImageCms) as the host-side CMS —
the same engine the reference vendors (cpp/icc/ lcms2).  Failures
degrade gracefully (return input unchanged), matching the reference's
log-and-continue behaviour (colorspace.cpp:46-50).
"""

from __future__ import annotations

import io
import logging

import numpy as np

_log = logging.getLogger("jxl_coder.icc")


def icc_to_srgb(pixels: np.ndarray, icc: bytes) -> np.ndarray:
    """uint8/uint16 (H, W, C) in the ICC space -> same shape in sRGB."""
    try:
        from PIL import Image, ImageCms
    except Exception as e:
        _log.warning("ICC transform unavailable (no littlecms): %s — "
                     "returning pixels unconverted", e)
        return pixels
    try:
        src = ImageCms.ImageCmsProfile(io.BytesIO(icc))
        dst = ImageCms.createProfile("sRGB")
        nch = pixels.shape[2] if pixels.ndim == 3 else 1
        alpha = None
        rgb = pixels
        if nch == 4:
            alpha = pixels[..., 3]
            rgb = pixels[..., :3]
        elif nch == 1:
            rgb = np.repeat(pixels, 3, axis=2)
        was16 = rgb.dtype == np.uint16
        if was16:
            rgb8 = (rgb >> 8).astype(np.uint8)
        else:
            rgb8 = rgb.astype(np.uint8)
        im = Image.fromarray(rgb8, "RGB")
        out = ImageCms.profileToProfile(
            im, src, dst, renderingIntent=ImageCms.Intent.PERCEPTUAL,
            flags=(ImageCms.Flags.BLACKPOINTCOMPENSATION))
        arr = np.asarray(out)
        if was16:
            arr = (arr.astype(np.uint16) << 8) | arr
        if alpha is not None:
            arr = np.concatenate([arr, alpha[..., None]], axis=2)
        return arr
    except Exception as e:
        # log-and-continue, as the reference does on lcms failure
        # (colorspaces/colorspace.cpp:46-50)
        _log.warning("ICC -> sRGB transform failed: %s — returning "
                     "pixels unconverted", e)
        return pixels
