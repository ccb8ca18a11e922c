"""Measure the EPF passes' asymptotic (sigma >> sad) kernels exactly.

Custom flat DCT8 dequant tables decouple the AC step from sigma: with
weight w the AC step is igs/(qf*64*w), while sigma stays
0.0592*sharp*igs/qf — so tiny-amplitude noise survives quantization at
huge sigma, where every EPF weight saturates and the filter becomes a
fixed linear kernel we can regress per offset class.
"""
import os
import sys

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ["JXL_NO_NATIVE"] = "1"

import numpy as np
import refjxl
import vardct_write
from jxl_coder.vardct.dec_real import ZIGZAG8
from epf_fit import ANA
from epf2_weights import srgb_to_xyb


def make_stream(Yp, qf, sharpness, epf_iters, weight=4096.0,
                gs=8192, qdc=4000):
    H, W = Yp.shape
    ys_b, xs_b = H // 8, W // 8
    igs = 65536.0 / gs
    step = igs / (qf * 64.0 * weight)
    dstepY = 0.001953125 * igs / qdc
    dc = np.zeros((3, ys_b, xs_b), np.int64)
    vbs = []
    for by in range(ys_b):
        for bx in range(xs_b):
            co = ANA @ Yp[by*8:(by+1)*8, bx*8:(bx+1)*8] @ ANA.T
            dc[0, by, bx] = round(co[0, 0] / dstepY)
            v = np.zeros(64, np.int64)
            flat = co.flatten()
            for p in range(1, 64):
                s_ = ZIGZAG8[p]
                basis = (s_ % 8) * 8 + s_ // 8
                v[p] = round(flat[basis] / step)
            vbs.append((bx, by, 0,
                        {0: np.zeros(64, np.int64), 1: v,
                         2: np.zeros(64, np.int64)}, qf))
    return vardct_write.craft_blocks(
        dc, vbs, gs=gs, qdc=qdc, W=W, H=H, epf_iters=epf_iters,
        sharpness=sharpness, dct8_flat_weight=weight)


def kernel(epf_iters, qf=1, sharpness=7, seed=0, amp=0.001):
    """Regress the linear kernel (per |dy|,|dx| class, radius 3)."""
    r = np.random.default_rng(seed)
    H = W = 64
    Yp = 0.35 + r.normal(0, amp, (H, W))
    data = make_stream(Yp, qf, sharpness, epf_iters)
    tgt = refjxl.decode(data, as_float=True)[0][..., :3]
    base = make_stream(Yp, qf, sharpness, 0)
    t0 = refjxl.decode(base, as_float=True)[0][..., :3]
    _, Yin, _ = srgb_to_xyb(t0)     # exact pre-filter image
    _, Yo, _ = srgb_to_xyb(tgt)
    classes = {}
    R = 3
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            classes.setdefault(tuple(sorted((abs(dy), abs(dx)))),
                               []).append((dy, dx))
    keys = sorted(classes)
    rows, ys = [], []
    for y in range(16, 48):
        if y % 8 in (0, 1, 2, 5, 6, 7):
            continue
        for x in range(16, 48):
            if x % 8 in (0, 1, 2, 5, 6, 7):
                continue
            rows.append([sum(Yin[y+dy, x+dx] for dy, dx in classes[k])
                         for k in keys])
            ys.append(Yo[y, x])
    A = np.array(rows)
    b = np.array(ys)
    coef, *_ = np.linalg.lstsq(A, b, rcond=None)
    rms = float(np.sqrt(np.mean((A @ coef - b) ** 2)))
    return keys, coef, rms, float(np.std(Yin - 0.35))


def main():
    for it in (0, 1, 2, 3):
        keys, coef, rms, sd = kernel(it)
        print(f"iters={it} (content sd {sd:.5f}, fit rms {rms:.2e}):")
        for k, c in zip(keys, coef):
            if abs(c) > 5e-5:
                print(f"   {k}: {c:.5f}")


if __name__ == "__main__":
    main()
