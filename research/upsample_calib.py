"""Recover the default up4/up8 upsampling kernels from libjxl output.

The decoder needs the default CustomTransformData up4_weight /
up8_weight kernels.  Rather than transcribing constants, we recover
the (n, n, 5, 5) phase kernels numerically: encode lossless frames
with RESAMPLING=n, decode the low-res planes with our own modular
decoder, decode the full-size float output with libjxl, and solve the
per-phase linear system.  The min/max window clamp makes some rows
nonlinear; those are rejected iteratively (they show up as outliers).

Writes jxl_coder/ops/upsample_calib.npz with up4/up8 kernels.
Verification: tests/test_ops_animation.py round-trips RESAMPLING
streams bit-exactly through the public API.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import refjxl  # noqa: E402
from encopts import encode_opts  # noqa: E402  (ctypes SetOption helper)
from jxl_coder.bitstream.container import extract_codestream  # noqa
from jxl_coder.bitstream.reader import BitReader  # noqa: E402
from jxl_coder.bitstream.headers import read_image_header  # noqa
from jxl_coder.bitstream.frame_header import (  # noqa: E402
    read_frame_header, read_toc)
from jxl_coder import codec  # noqa: E402

# the decoder now upsamples internally; calibration needs the raw
# coded-resolution planes
codec._finalize_modular_planes = lambda planes, hdr, fh, dcq: planes


def get_pair(img, n):
    data = encode_opts(img, {2: n}, lossless=True)
    reff, _ = refjxl.decode(data, as_float=True)
    out = reff * 255.0
    cs = extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    nsec = 1 if (ng == 1 and fh.passes.num_passes == 1) else 2 + ndc + ng
    toc = read_toc(br, nsec)
    planes = codec.decode_modular_frame(cs, hdr, fh, toc)
    lo = np.stack(planes[:3], -1).astype(np.float64)
    return lo, out


def make_images(n):
    # band-limited noise: good conditioning for the 25-tap system while
    # keeping the min/max clamp mostly inactive
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(23)
    imgs = []
    for k in range(3):
        size = 320
        sm = gaussian_filter(rng.normal(0, 1, (size, size, 3)),
                             (2 + k, 2 + k, 0))
        sm = (sm - sm.min()) / (np.ptp(sm) + 1e-9)
        imgs.append((20 + sm * 215).astype(np.uint8))
    return imgs


def fit_kernels(n):
    half = n // 2
    pairs = [get_pair(img, n) for img in make_images(n)]
    K = np.zeros((n, n, 5, 5))
    for dy in range(half):
        for dx in range(half):
            rows, tgts = [], []
            for lo, out in pairs:
                H, W = lo.shape[:2]
                for c in range(3):
                    win = np.lib.stride_tricks.sliding_window_view(
                        lo[..., c], (5, 5))
                    rows.append(win.reshape(-1, 25))
                    tgts.append(out[n * 2 + dy:n * (H - 2) + dy:n,
                                    n * 2 + dx:n * (W - 2) + dx:n,
                                    c].ravel())
            A = np.concatenate(rows)
            b = np.concatenate(tgts)
            keep = np.ones(len(b), bool)
            k = None
            # tightening schedule: rows bound by the min/max clamp fall
            # out as outliers; survivors converge to float32 noise
            for thr in (2.0, 0.5, 0.2, 0.1, 0.05, 0.03, 0.02):
                k, *_ = np.linalg.lstsq(A[keep], b[keep], rcond=None)
                keep = np.abs(A @ k - b) < thr
            kept = int(keep.sum())
            resk = np.abs(A[keep] @ k - b[keep]).max()
            print(f"n={n} phase ({dy},{dx}): kept {kept}/{len(b)} "
                  f"max resid {resk:.5f}")
            K[dy, dx] = k.reshape(5, 5)
    # mirrors + per-phase normalization
    for py in range(n):
        for px in range(n):
            k = K[py if py < half else n - 1 - py,
                  px if px < half else n - 1 - px]
            if py >= half:
                k = k[::-1, :]
            if px >= half:
                k = k[:, ::-1]
            K[py, px] = k / k.sum()
    return K


def main():
    out = {}
    for n in (4, 8):
        out[f"up{n}"] = fit_kernels(n)
    path = os.path.join(os.path.dirname(__file__), "..",
                        "jxl_coder", "ops", "upsample_calib.npz")
    np.savez(path, **out)
    print("wrote", os.path.abspath(path))


if __name__ == "__main__":
    main()
