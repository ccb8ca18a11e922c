"""Calibrate all AC strategies against libjxl: scan->basis orders,
dequant tables, and response matrices for the non-DCT transforms.
Writes jxl_coder/vardct/calib_real.npz.
"""
import sys, os
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ.setdefault("JXL_NO_NATIVE", "1")

import numpy as np
import refjxl
from vardct_write import craft_blocks
from jxl_coder.vardct.strategies import STRATEGIES
from jxl_coder.vardct.synthesis import (ana_basis, llf_from_dc)

BIAS = 0.0037930732552754493
CBRT_BIAS = np.cbrt(BIAS)
M = np.array([[0.30, 0.622, 0.078],
              [0.23, 0.692, 0.078],
              [0.24342268924547819, 0.20476744424496821, 0.5518098665095536]])

QF = 16
AMP = 16
GS = 65536
DC_STEPS = (0.000244140625, 0.001953125, 0.00390625)  # x, y, b @ qdc=16?


def srgb_to_xyb(f):
    lin = np.where(np.abs(f) <= 0.0404482362771082, f / 12.92,
                   np.sign(f) * ((np.abs(f) + 0.055) / 1.055) ** 2.4)
    mixed = lin @ M.T
    g = np.cbrt(mixed + BIAS) - CBRT_BIAS
    return (g[..., 0] - g[..., 1]) / 2, (g[..., 0] + g[..., 1]) / 2, g[..., 2]


def decode_xyb(data):
    out, _ = refjxl.decode(data, as_float=True)
    return srgb_to_xyb(out.astype(np.float64))


def one_block_stream(sid, chan_vals, dcv=None, qdc=16):
    s = STRATEGIES[sid]
    W, H = s.width, s.height
    xs_b, ys_b = s.cx, s.cy
    dc = np.zeros((3, ys_b, xs_b), np.int64)
    if dcv is not None:
        dc[:] = dcv
    chans = {c: np.zeros(s.num_coeffs, np.int64) for c in range(3)}
    for c, v in chan_vals.items():
        chans[c] = v
    vbs = [(0, 0, sid, chans, QF)]
    return craft_blocks(dc, vbs, gs=GS, qdc=qdc, W=W, H=H)


def calibrate_dct(sid):
    """Separable-DCT strategies: order + per-channel tables."""
    s = STRATEGIES[sid]
    H, W = s.height, s.width
    cov, size = s.covered, s.num_coeffs
    rng = np.random.default_rng(sid)
    signs = rng.integers(0, 2, size).astype(np.int64) * 2 - 1
    AH, AW = ana_basis(H), ana_basis(W)

    def project(plane):
        return AH @ plane @ AW.T

    def probe(c, vals):
        xyb = decode_xyb(one_block_stream(sid, {c: vals}))
        return project(xyb[{0: 0, 1: 1, 2: 2}[c]][:H, :W])

    n_ac = size - cov
    # Y: ones (w/ signs) + digit streams in base 17
    ones = np.zeros(size, np.int64)
    ones[cov:] = AMP * signs[cov:]
    a1 = probe(1, ones)
    BASE = 17
    ndig = 1
    while BASE ** ndig < n_ac:
        ndig += 1
    digit_resps = []
    for d in range(ndig):
        st = np.zeros(size, np.int64)
        for i in range(n_ac):
            st[cov + i] = (((i // (BASE ** d)) % BASE) + 1) * signs[cov + i]
        digit_resps.append(probe(1, st))

    # basis indices excluding the LLF rectangle
    mask = np.ones((H, W), bool)
    mask[:s.cy, :s.cx] = False
    order = np.full(size, -1, np.int64)
    order[:cov] = [ky * W + kx for ky in range(s.cy) for kx in range(s.cx)]
    tabY = np.zeros(size)
    r1 = a1[mask]
    digit_resps = [a[mask] for a in digit_resps]
    basis_idx = np.nonzero(mask.ravel())[0]
    ok = np.abs(r1) > 0
    unit = r1 / AMP
    idxs = np.zeros(mask.sum(), np.int64)
    for d, rd in enumerate(digit_resps):
        dig = np.round(rd / unit).astype(np.int64) - 1
        if dig.min() < 0 or dig.max() >= BASE:
            raise RuntimeError(f"{s.name}: digit {d} out of range "
                               f"[{dig.min()}, {dig.max()}]")
        idxs += dig * (BASE ** d)
    if sorted(idxs) != list(range(n_ac)):
        raise RuntimeError(f"{s.name}: scan extraction failed "
                           f"({len(set(idxs))} unique of {n_ac})")
    for b, i in zip(basis_idx[ok], idxs):
        order[cov + i] = b
    # tables per channel (indexed by basis): |response| * QF/AMP... the
    # calib convention: table = response per unit int at inv_qac=1
    tabs = np.zeros((3, H * W))
    for c in (0, 1, 2):
        if c == 1:
            resp = r1 / (AMP * signs[cov:][idxs.argsort()][...] if False
                         else 1)  # recompute cleanly below
            a = a1
        else:
            a = probe(c, ones)
        flat = a[mask]
        # response of basis b = table[b] * AMP * sign(scan of b) / QF*igs
        scan_of_basis = {b: cov + i for b, i in zip(basis_idx[ok], idxs)}
        for j, b in enumerate(basis_idx):
            p = scan_of_basis.get(b)
            if p is None:
                continue
            tabs[c, b] = flat[j] / (AMP * signs[p]) * QF
    return order, tabs


def validate_llf(sid):
    s = STRATEGIES[sid]
    rng = np.random.default_rng(100 + sid)
    dcv = rng.integers(50, 400, (3, s.cy, s.cx))
    dcv[1] = rng.integers(-30, 30, (s.cy, s.cx))
    dcv[2] = rng.integers(-50, 50, (s.cy, s.cx))
    data = one_block_stream(sid, {}, dcv=dcv, qdc=16)
    X, Y, B = decode_xyb(data)
    H, W = s.height, s.width
    AH, AW = ana_basis(H), ana_basis(W)
    igs = 65536.0 / GS
    steps = [d * igs / 16 for d in DC_STEPS]
    dcY = dcv[0].astype(np.float64) * steps[1]
    meas = (AH @ Y[:H, :W] @ AW.T)[:s.cy, :s.cx]
    pred = llf_from_dc(dcY)
    err = np.abs(meas - pred).max() / (np.abs(pred).max() + 1e-12)
    return err, meas, pred


def calibrate_special(sid):
    """cov==1 non-separable transforms: per-channel response matrices
    (64 scan x 8 x 8), row 0 = response per unit float DC."""
    s = STRATEGIES[sid]
    resp = np.zeros((3, 64, 8, 8))
    for c in (0, 1, 2):
        # 64 blocks in a 64x64 image; block i probes scan i (i>=1)
        vbs = []
        dc = np.zeros((3, 8, 8), np.int64)
        for by in range(8):
            for bx in range(8):
                i = by * 8 + bx
                chans = {ch: np.zeros(64, np.int64) for ch in range(3)}
                if i >= 1:
                    chans[c][i] = AMP
                vbs.append((bx, by, sid, chans, QF))
        data = craft_blocks(dc, vbs, gs=GS, qdc=16, W=64, H=64)
        xyb = decode_xyb(data)
        plane = xyb[c]
        for by in range(8):
            for bx in range(8):
                i = by * 8 + bx
                if i < 1:
                    continue
                blk = plane[by*8:(by+1)*8, bx*8:(bx+1)*8]
                resp[c, i] = blk / AMP * QF
    # DC response (channel-independent basis; measure on Y)
    dc = np.zeros((3, 8, 8), np.int64)
    K = 128
    dc[0, :, :] = K
    vbs = [(bx, by, sid, {ch: np.zeros(64, np.int64) for ch in range(3)},
            QF) for by in range(8) for bx in range(8)]
    data = craft_blocks(dc, vbs, gs=GS, qdc=16, W=64, H=64)
    _, Y, _ = decode_xyb(data)
    igs = 65536.0 / GS
    step = DC_STEPS[1] * igs / 16
    pat = Y[0:8, 0:8] / (K * step)
    for c in range(3):
        resp[c, 0] = pat
    return resp


if __name__ == "__main__":
    out = {}
    import sys as _s
    only = set(int(a) for a in _s.argv[1:]) if len(_s.argv) > 1 else None
    done_kinds = set()
    for sid, s in sorted(STRATEGIES.items()):
        if only and sid not in only:
            continue
        if s.name in ("IDENTITY", "DCT2X2", "DCT4X4", "DCT4X8", "DCT8X4",
                      "AFV0", "AFV1", "AFV2", "AFV3"):
            try:
                resp = calibrate_special(sid)
                out[f"resp_{sid}"] = resp.astype(np.float32)
                print(f"{s.name}: special resp ok "
                      f"(|r|max={np.abs(resp).max():.4f})")
            except Exception as e:
                print(f"{s.name}: SPECIAL FAILED: {e}")
            continue
        try:
            order, tabs = calibrate_dct(sid)
            out[f"order_{sid}"] = order.astype(np.int32)
            out[f"table_{sid}"] = tabs.astype(np.float32)
            err, _, _ = validate_llf(sid) if s.covered > 1 else (0, 0, 0)
            print(f"{s.name}: order+table ok, llf err={err:.2e}")
        except Exception as e:
            print(f"{s.name}: FAILED: {e}")
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "jxl_coder", "vardct", "calib_real.npz")
    if os.path.exists(path):
        old = dict(np.load(path))
        old.update(out)
        out = old
    np.savez(path, **out)
    print("saved", len(out), "entries")
