"""Fit the EPF (pass 1) against libjxl step-edge probes.

Model under test (spec structure):
  sigma(block) = SIG_SCALE * sharp_lut[s] * quant_step(qf)
  for each pixel, neighbours {W,E,N,S}:
    sad_n = sum_c cscale_c * sum_{d in cross} |I_c(p+d) - I_c(n+d)|
    w_n = relu(1 + sad_n * kInvSigmaNum / sigma)
  out = (v_p + sum w_n v_n) / (1 + sum w_n), border pixels use
  sad * border_mul.
"""
import sys, os
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ.setdefault("JXL_NO_NATIVE", "1")

import numpy as np
import refjxl
from vardct_write import craft_blocks
from jxl_coder.vardct.dec_real import ZIGZAG8
from jxl_coder.vardct.synthesis import ana_basis, dequant_table
from strategy_calib import decode_xyb

ANA = ana_basis(8)
KINV = -1.1715728752538099024


def planes_to_stream(Yp, Xp, Bp, qf, gs, epf_iters, sharpness, qdc=16):
    H, W = Yp.shape
    ys_b, xs_b = H // 8, W // 8
    igs = 65536.0 / gs
    dc = np.zeros((3, ys_b, xs_b), np.int64)
    vbs = []
    tabs = [dequant_table('DCT8', c).astype(np.float64) for c in range(3)]
    dsteps = [s_ * igs / qdc for s_ in
              (0.000244140625, 0.001953125, 0.00390625)]
    for by in range(ys_b):
        for bx in range(xs_b):
            chans = {}
            coY = ANA @ Yp[by*8:(by+1)*8, bx*8:(bx+1)*8] @ ANA.T
            dcY_int = round(coY[0, 0] / dsteps[1])
            dcY = dcY_int * dsteps[1]
            coX = ANA @ Xp[by*8:(by+1)*8, bx*8:(bx+1)*8] @ ANA.T
            coB = ANA @ Bp[by*8:(by+1)*8, bx*8:(bx+1)*8] @ ANA.T
            dc[0, by, bx] = dcY_int
            dc[1, by, bx] = round(coX[0, 0] / dsteps[0])
            dc[2, by, bx] = round((coB[0, 0] - dcY) / dsteps[2])
            for c, co in ((0, coX), (1, coY), (2, coB)):
                if c == 2:
                    co = co - coY  # cfl base 1.0 on AC too
                vals = np.zeros(64, np.int64)
                flat = co.flatten()
                for p in range(1, 64):
                    s_ = ZIGZAG8[p]
                    basis = (s_ % 8) * 8 + s_ // 8
                    vals[p] = round(flat[basis] / (tabs[c][basis] * igs / qf))
                chans[c] = vals
            vbs.append((bx, by, 0, chans, qf))
    return craft_blocks(dc, vbs, gs=gs, qdc=qdc, W=W, H=H,
                        epf_iters=epf_iters, sharpness=sharpness)


def epf_pass1(X, Y, B, sigma_map, cscale, border_mul, zeroflush=0.0):
    """sigma_map: per-pixel sigma; returns filtered planes."""
    planes = [X, Y, B]
    H, W = Y.shape
    pad = [np.pad(p, 2, mode="edge") for p in planes]
    # cross sads per neighbor direction
    offs = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    taps = [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)]
    sads = []
    for (dy, dx) in offs:
        sad = np.zeros((H, W))
        for c in range(3):
            pc = pad[c]
            acc = np.zeros((H, W))
            for (ty, tx) in taps:
                a = pc[2+ty:2+ty+H, 2+tx:2+tx+W]
                b = pc[2+dy+ty:2+dy+ty+H, 2+dx+tx:2+dx+tx+W]
                acc += np.abs(a - b)
            sad += cscale[c] * acc
        sads.append(sad)
    # border pixels: x%8 in {0,7} or y%8 in {0,7}
    bx = np.arange(W) % 8
    by = np.arange(H) % 8
    border = ((by == 0) | (by == 7))[:, None] | ((bx == 0) | (bx == 7))[None, :]
    mul = np.where(border, border_mul, 1.0)
    inv = KINV / sigma_map
    outs = []
    wsum = np.ones((H, W))
    wacc = [p.copy() for p in planes]
    for (dy, dx), sad in zip(offs, sads):
        w = np.maximum(zeroflush, 1.0 + sad * mul * inv)
        wsum += w
        for c in range(3):
            pc = pad[c]
            wacc[c] += w * pc[2+dy:2+dy+H, 2+dx:2+dx+W]
    return [wacc[c] / wsum for c in range(3)]


def make_probe(h=0.06, axis='Y', qf=7, gs=7340):
    H = W = 64
    Y = np.full((H, W), 0.5)
    X = np.zeros((H, W))
    B = np.full((H, W), 0.5)
    step = np.zeros((H, W))
    step[:, 28:] = h
    if axis == 'Y':
        Y = Y + step
    elif axis == 'B':
        B = B + step
    else:
        X = X + step
    return (X, Y, B)


if __name__ == "__main__":
    qf, gs = 7, 7340
    X, Y, B = make_probe(h=0.06, qf=qf, gs=gs)
    d0 = planes_to_stream(Y, X, B, qf, gs, 0, 4)
    d1 = planes_to_stream(Y, X, B, qf, gs, 1, 4)
    X0, Y0, B0 = decode_xyb(d0)
    X1, Y1, B1 = decode_xyb(d1)
    D = Y1 - Y0
    print("EPF effect |D|max:", np.abs(D).max())
    print("column profile at row 33 (cols 24..33):")
    print("  in :", np.round(Y0[33, 24:34], 4))
    print("  out:", np.round(Y1[33, 24:34], 4))
    print("  d  :", np.round(D[33, 24:34], 5))
    print("row profile col 29 (rows 22..26):", np.round(D[22:27, 29], 5))
