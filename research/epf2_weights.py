"""Recover EPF pass-2's weight function pointwise.

Vertical stripes: horizontal neighbours differ by a known delta,
vertical neighbours equal the centre (weight = 1 at sad 0).  For an
interior pixel:  out = (3 v + 2 w a) / (3 + 2 w)  =>
w = 3 (out - v) / (2 (a - out)).

We feed epf_iters=2 streams, capture OUR pass-2 input (exact through
pass 1), take libjxl's float output, invert it to XYB, and solve for w
per pixel.  Plot w against the model sad to identify slope/shape.
"""
import os
import sys

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ["JXL_NO_NATIVE"] = "1"

import numpy as np
import refjxl
from epf_fit import planes_to_stream
from jxl_coder.vardct import dec_real
import epf2_fit

_BIAS = 0.0037930732552754493
_CBRT = np.cbrt(_BIAS)
from jxl_coder.bitstream.headers import DEFAULT_INV_OPSIN
_INV = np.array(DEFAULT_INV_OPSIN, np.float64).reshape(3, 3)
_FWD = np.linalg.inv(_INV)


def srgb_to_xyb(srgb):
    s = srgb.astype(np.float64)
    lin = np.where(s <= 0.0404482362771082, s / 12.92,
                   ((s + 0.055) / 1.055) ** 2.4)
    lin = np.where(s < 0, s / 12.92, lin)  # sign-preserving tail
    mixed = lin @ _FWD.T
    gamma = np.cbrt(mixed + _BIAS)
    X = (gamma[..., 0] - gamma[..., 1]) * 0.5
    Y = (gamma[..., 0] + gamma[..., 1]) * 0.5 - _CBRT
    B = gamma[..., 2] - _CBRT
    return X, Y, B


def probe(amp, qf, sharpness=7, gs=8192, base=0.35, H=64, W=64):
    stripe = np.where((np.arange(W) % 2) == 0, 1.0, -1.0)[None, :]
    Yp = base + amp * stripe * np.ones((H, 1))
    Xp = np.zeros((H, W))
    Bp = np.full((H, W), base)
    data = planes_to_stream(Yp, Xp, Bp, qf=qf, gs=gs,
                            epf_iters=2, sharpness=sharpness)
    tgt = refjxl.decode(data, as_float=True)[0][..., :3]
    (X1, Y1, B1, sig, _), _ = epf2_fit.capture_pass2_input(data)
    Xo, Yo, Bo = srgb_to_xyb(tgt)
    # interior pixels only (3..4 within each 8-block, rows away from
    # block borders), stripes exact after pass1 so v/a per column parity
    ws = []
    sads = []
    for y in range(16, 48):
        if y % 8 in (0, 7):
            continue
        for x in range(16, 48):
            if x % 8 in (0, 7):
                continue
            v = Y1[y, x]
            a = Y1[y, x - 1]
            out = Yo[y, x]
            den = 2.0 * (a - out)
            if abs(den) < 1e-9 or abs(a - v) < 1e-9:
                continue
            w = 3.0 * (out - v) / den
            # model sad: pointwise |v-a| * yscale
            sads.append(abs(v - a))
            ws.append(w)
    return float(sig.max()), np.array(sads), np.array(ws)


def main():
    print("sigma      |dY|        w_measured (median)   n")
    for qf in (4, 8, 12):
        for amp in (0.002, 0.004, 0.008, 0.015, 0.03, 0.06):
            sig, sads, ws = probe(amp, qf)
            if len(ws) == 0:
                print(f"{sig:.3f}  amp={amp:.3f}  (no samples)")
                continue
            print(f"{sig:.3f}  dY={np.median(sads):.5f}  "
                  f"w={np.median(ws):+.4f}  spread "
                  f"{np.percentile(ws, 10):+.3f}..{np.percentile(ws, 90):+.3f}"
                  f"  n={len(ws)}")


if __name__ == "__main__":
    main()
