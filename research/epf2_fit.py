"""Fit EPF pass 2 (and the sigma gate) against libjxl float decodes.

Method: craft uniform-qf noise streams with epf_iters=2.  Our decoder
is exact through pass 1, so capture the planes entering pass 2 by
monkeypatching apply_epf2, apply candidate pass-2 models, convert with
our float XYB->sRGB (bit-exact vs libjxl float32), and score MSE
against refjxl.decode(as_float=True).
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
from jxl_coder import api

KINV = dec_real.KINV_SIGMA
CSCALE = dec_real.EPF_CHANNEL_SCALE


def capture_pass2_input(data):
    """Decode `data`, returning (X, Y, B, sigma_map) as given to
    apply_epf2, plus the final uint8 for sanity."""
    captured = {}
    orig = dec_real.apply_epf2

    def hook(X, Y, B, sigma_map, sigma_scale=6.5):
        captured["in"] = (X.copy(), Y.copy(), B.copy(), sigma_map.copy(),
                          sigma_scale)
        return orig(X, Y, B, sigma_map, sigma_scale)

    dec_real.apply_epf2 = hook
    try:
        out, _ = api.decode(data)
    finally:
        dec_real.apply_epf2 = orig
    return captured["in"], out


def pass2_model(X, Y, B, sigma_map, *, slope, gate, border_mul,
                border_on_sad=True):
    """Candidate pass-2: 4-neighbour cross, pointwise SAD.
    inv = KINV * slope / sigma; active when sigma >= gate."""
    H, W = Y.shape
    planes = [X, Y, B]
    pad = [np.pad(p, 1, mode="edge") for p in planes]
    active = sigma_map >= gate
    with np.errstate(divide="ignore"):
        inv = np.where(active, KINV * slope / sigma_map, 0.0)
    inv_px = np.repeat(np.repeat(inv, 8, 0), 8, 1)[:H, :W]
    act_px = np.repeat(np.repeat(active, 8, 0), 8, 1)[:H, :W]
    bx = np.arange(W) % 8
    by = np.arange(H) % 8
    border = (((by == 0) | (by == 7))[:, None]
              | ((bx == 0) | (bx == 7))[None, :])
    mul = np.where(border, border_mul, 1.0) if border_on_sad else 1.0
    wsum = np.ones((H, W))
    acc = [p.copy() for p in planes]
    for (dy, dx) in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        sad = np.zeros((H, W))
        for c in range(3):
            pc = pad[c]
            sad += CSCALE[c] * np.abs(
                pc[1:1 + H, 1:1 + W]
                - pc[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
        w = np.maximum(0.0, 1.0 + sad * mul * inv_px)
        wsum += w
        for c in range(3):
            acc[c] += w * pad[c][1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    out = []
    for c in range(3):
        f = acc[c] / wsum
        out.append(np.where(act_px, f, planes[c]))
    return out


def main():
    rng = np.random.default_rng(0)
    H = W = 64
    cases = []
    for seed in (0, 1):
        r = np.random.default_rng(seed)
        Yp = r.normal(0.3, 0.05, (H, W))
        Xp = r.normal(0.0, 0.004, (H, W))
        Bp = Yp * 0.8 + r.normal(0, 0.02, (H, W))
        for qf in (3, 4, 6, 8, 10, 12, 14):
            data = planes_to_stream(Yp, Xp, Bp, qf=qf, gs=8192,
                                    epf_iters=2, sharpness=7)
            tgt = refjxl.decode(data, as_float=True)[0][..., :3]
            (X, Y, B, sig, _), _ = capture_pass2_input(data)
            cases.append((qf, X, Y, B, sig, tgt))

    from jxl_coder.vardct.dec_real import xyb_planes_to_srgb

    def score(slope, gate, border_mul, border_on_sad=True):
        tot = 0.0
        per = []
        for qf, X, Y, B, sig, tgt in cases:
            Xo, Yo, Bo = pass2_model(X, Y, B, sig, slope=slope,
                                     gate=gate, border_mul=border_mul,
                                     border_on_sad=border_on_sad)
            got = xyb_planes_to_srgb(Xo, Yo, Bo)
            mse = float(np.mean((got - tgt) ** 2))
            per.append((qf, mse))
            tot += mse
        return tot, per

    print("current model (slope=6.5 inv, gate .3):",
          score(6.5, 0.3, 2.0 / 3.0)[0])
    # hypothesis: slope = 1/6.5 (sigma multiplied by pass2 scale)
    best = (np.inf, None)
    for slope in (1 / 6.5, 1 / 6.5 * 1.1, 1 / 6.5 / 1.1, 0.1, 0.2, 0.3,
                  0.5, 1.0, 2.53 / 6.5, 6.5):
        for gate in (0.21, 0.25, 0.28, 0.3):
            for bm in (2.0 / 3.0, 1.0):
                t, _ = score(slope, gate, bm)
                if t < best[0]:
                    best = (t, (slope, gate, bm))
    print("grid best:", best)
    s, g, bm = best[1]
    for mul in np.linspace(0.6, 1.6, 21):
        t, _ = score(s * mul, g, bm)
        print(f"  slope {s * mul:.4f}: {t:.3e}")


if __name__ == "__main__":
    main()
