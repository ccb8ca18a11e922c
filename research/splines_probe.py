"""Pin the spline wire syntax + rendering constants against libjxl 0.7.

Method: craft real-format VarDCT streams that decode to a flat base
image, attach a spline via the kSplines frame flag, float-decode with
libjxl, invert sRGB->XYB, and compare the residual blob against our
renderer (jxl_coder/vardct/splines.py).
"""
import sys, os
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ.setdefault("JXL_NO_NATIVE", "1")

import numpy as np
import refjxl
from vardct_write import craft_blocks
from epf_extract import srgb_to_xyb
from jxl_coder.vardct.splines import Splines, QuantizedSpline


def flat_stream(splines=None, W=64, H=64):
    ys_b, xs_b = H // 8, W // 8
    dc = np.zeros((3, ys_b, xs_b), np.int64)
    vbs = []
    for by in range(ys_b):
        for bx in range(xs_b):
            vbs.append((bx, by, 0,
                        {c: np.zeros(64, np.int64) for c in range(3)}, 16))
    return craft_blocks(dc, vbs, W=W, H=H, splines=splines)


def decode_xyb(data):
    out, _ = refjxl.decode(data, as_float=True)
    X, Y, B = srgb_to_xyb(out[..., :3].astype(np.float64))
    return np.stack([X, Y, B])


def mk_spline(points, color_dct, sigma_dct, qa=0):
    qs = QuantizedSpline(points=np.asarray(points, np.float64),
                         color_dct=np.asarray(color_dct, np.int64),
                         sigma_dct=np.asarray(sigma_dct, np.int64))
    return Splines(quantization_adjustment=qa, splines=[qs])


def ours_render(spl, W=64, H=64):
    planes = [np.zeros((H, W)) for _ in range(3)]
    spl.render(planes, base_cx=0.0, base_cb=1.0)
    return np.stack(planes)


def main():
    base = decode_xyb(flat_stream())
    print("base XYB means:", base.reshape(3, -1).mean(1))

    # --- smoke: single blob, Y-only constant color, constant sigma
    cd = np.zeros((3, 32), np.int64)
    cd[1, 0] = 20
    sd = np.zeros(32, np.int64)
    sd[0] = 10
    spl = mk_spline([[32.0, 32.0]], cd, sd)
    data = flat_stream(spl)
    try:
        got = decode_xyb(data) - base
    except RuntimeError as e:
        print("DECODE FAILED:", e)
        return
    ours = ours_render(spl)
    print("blob: ref absmax", np.abs(got[1]).max(),
          "sum", got[1].sum())
    print("      ours absmax", np.abs(ours[1]).max(),
          "sum", ours[1].sum())
    yy, xx = np.unravel_index(np.abs(got[1]).argmax(), got[1].shape)
    print("ref peak at", (yy, xx), "val", got[1][yy, xx])
    print("ref row through peak:",
          np.array2string(got[1][yy, 24:41], precision=4))
    print("our row through peak:",
          np.array2string(ours[1][yy, 24:41], precision=4))


if __name__ == "__main__":
    main()
