"""Full-strategy VarDCT frame reconstruction on device (JAX/XLA).

Extends device_real.py (DCT8-only fast path) to the complete transform
zoo: every strategy family present in a frame is reconstructed with
one batched einsum chain into dense 8x8 tile rows, the
frame is assembled with a single gather (tile permutation computed on
host — no device scatters), then the restoration-filter chain
(gaborish + EPF stages 0-2) and the XYB->sRGB transform run on device.
The host keeps only byte-level work: entropy decode into per-block
coefficient arrays and the dense basis-ordered layout.

Mirrors the host reference path (dec_real.reconstruct_group /
_apply_filters_chain / xyb_planes_to_srgb*) in float32; the host path
computes in float64, so device output may differ by 1 ulp of the
output quantizer (<=1 at 8-bit) on rounding-boundary pixels.

Reference semantics: lib/jxl inverse transforms + filters as pinned in
SURVEY.md §7 step 4 (cf. reference interop/JxlDecoding.cpp:36 event
loop, which delegates all of this to libjxl.so on CPU).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

from .. import backend
from .strategies import STRATEGIES
from . import synthesis as S
from .dec_real import (KINV_SIGMA, EPF_CHANNEL_SCALE, EPF_SIGMA_PER,
                       BitstreamError)

_PAD_SENTINEL = 1 << 20


def device_forced() -> bool:
    """True when JXL_DEVICE explicitly forces the device path on;
    auto mode applies a frame-size floor instead (DEVICE_MIN_BLOCKS in
    dec_real)."""
    env = backend.knob("JXL_DEVICE")
    return env is not None and env not in ("", "0")


def device_enabled() -> bool:
    """Device reconstruction runs automatically when an accelerator is
    attached — matching the reference, where the threaded codec path is
    simply *the* decode path (interop/JxlDecoding.cpp:46-60).
    JXL_DEVICE=0/1 force-overrides either way (the host path stays
    the bit-exactness reference)."""
    env = backend.knob("JXL_DEVICE")
    if env is not None and env != "":
        return env != "0"
    return backend.accelerator_present()


def _bucket(n: int) -> int:
    """Pad batch counts to power-of-two buckets to bound the number of
    distinct compiled shapes."""
    return max(8, 1 << (n - 1).bit_length())


def _dq_table(lf, sid, c):
    if getattr(lf, "quant_encodings", None) is not None:
        from . import quant_tables as QTab
        t = QTab.dequant_table_for(lf.quant_encodings, sid, c,
                                   lf.quant_cache)
        if t is not None:
            return t
    return S.dequant_table(sid, c)


def _special_resp(lf, sid, c):
    """Response matrix for cov==1 special transforms, with the
    custom-dequant-table ratio folded in (mirrors
    dec_real.reconstruct_group)."""
    resp = S.response_matrix(sid, c)
    if getattr(lf, "quant_encodings", None) is not None:
        from . import quant_tables as QTab
        try:
            ct = QTab.dequant_table_for(lf.quant_encodings, sid, c,
                                        lf.quant_cache)
            dt = S.dequant_table(sid, c)
            order_ = S.scan_to_basis(sid)
        except (KeyError, BitstreamError):
            ct = None
        if ct is not None:
            ratio = np.ones(len(resp))
            ratio[1:] = (ct[order_[1:]]
                         / np.maximum(dt[order_[1:]], 1e-12))
            resp = resp * ratio[:, None, None]
    return resp


def _pack_family(ba, sel, nc, P, n_pad):
    """Gather one family's coefficients into (n_pad, 3, nc) with the
    permutation P applied (out[j] = in[P[j]]).  Preferred form: int8
    plus a short exception list (flat index, value) applied on device
    with one scatter-add — halves the h2d bytes again vs int16.
    Returns (tensor, fixes-or-None, max|v|); fixes is (idx int32,
    val int32) padded to a power-of-two bucket with harmless
    (0, 0) entries."""
    n = len(sel)
    if not n:
        return np.zeros((n_pad, 3, nc), np.int16), None, 0
    lib = None
    if ba.coeffs.dtype == np.int32:
        from .. import native as native_mod
        lib = native_mod.get_lib()
    if lib is not None:
        import ctypes
        i32p = ctypes.POINTER(ctypes.c_int32)
        co = (ba.coeffs if ba.coeffs.flags.c_contiguous
              else np.ascontiguousarray(ba.coeffs))
        sel32 = np.ascontiguousarray(sel, np.int32)
        offs = np.ascontiguousarray(ba.offs, np.int64)
        P32 = np.ascontiguousarray(P, np.int32)
        # exceptions beyond ~1.5% of the blocks stop paying for the
        # scatter: fall back to int16
        cap = max(32, (n * 3 * nc) // 256)
        out8 = np.zeros((n_pad, 3, nc), np.int8)
        fix_idx = np.zeros(cap, np.int32)
        fix_val = np.zeros(cap, np.int32)
        nexc = lib.pack_family_i8(
            co.ctypes.data_as(i32p),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sel32.ctypes.data_as(i32p), n, int(nc),
            P32.ctypes.data_as(i32p),
            out8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            cap, fix_idx.ctypes.data_as(i32p),
            fix_val.ctypes.data_as(i32p))
        if nexc >= 0:
            if nexc == 0:
                return out8, None, 127
            e_pad = max(8, 1 << (int(nexc) - 1).bit_length())
            if e_pad <= cap:
                return out8, (fix_idx[:e_pad].copy(),
                              fix_val[:e_pad].copy()), 127
        out = np.zeros((n_pad, 3, nc), np.int16)
        mx = lib.pack_family_i16(
            co.ctypes.data_as(i32p),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sel32.ctypes.data_as(i32p), n, int(nc),
            P32.ctypes.data_as(i32p),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out, None, int(mx)
    src = ba.offs[sel][:, None] + np.arange(3 * nc, dtype=np.int64)
    raw = ba.coeffs[src].reshape(n, 3, nc)
    mx = int(np.abs(raw).max(initial=0))
    out = np.zeros((n_pad, 3, nc), np.int16)
    if mx < 32768:
        out[:n] = raw[:, :, P]
    return out, None, mx


def prepare_families(lf, fh, blocks_global, qf_map: np.ndarray,
                     ytox_glob: np.ndarray, ytob_glob: np.ndarray):
    """Group frame-global varblocks by strategy and build the dense
    device inputs.  Returns (descriptor tuple, args tuple, qm,
    perm_inv); descriptor is hashable (part of the compile signature).

    blocks_global: a dec_real.BlockArrays (flat arrays straight from
    the entropy decode — the fast path; everything below is vectorized
    numpy, no per-block Python) or a legacy List[VarBlock].

    perm_inv maps each destination 8x8 tile of the frame to its source
    row in the concatenation of the per-family tile outputs — computed
    on host (block positions are host data after entropy decode), so
    the device assembles the frame with ONE dense gather instead of
    per-family scatters."""
    from .dec_real import BlockArrays
    if not isinstance(blocks_global, BlockArrays):
        blocks_global = BlockArrays.from_varblocks(list(blocks_global))
    ba = blocks_global
    igs = float(lf.inv_global_scale)
    cf = 1.0 / lf.cfl_color_factor
    if getattr(fh, "do_ycbcr", False):
        qm = np.ones(3, np.float32)
    else:
        qm = np.asarray([0.8 ** (fh.x_qm_scale - 2), 1.0,
                         0.8 ** (fh.b_qm_scale - 2)], np.float32)

    ys_b, xs_b = qf_map.shape
    perm_inv = np.zeros(ys_b * xs_b, np.int32)
    fam_offset = 0

    desc = []
    args = []
    for sid in np.unique(ba.ids).tolist():
        sel = np.nonzero(ba.ids == sid)[0]
        strat = STRATEGIES[sid]
        n = len(sel)
        n_pad = _bucket(n)
        bh, bw = strat.height, strat.width
        cov = strat.covered
        special = (cov == 1 and sid != 0)

        bys = np.full(n_pad, _PAD_SENTINEL, np.int32)
        bxs = np.full(n_pad, _PAD_SENTINEL, np.int32)
        bys[:n] = ba.bys[sel]
        bxs[:n] = ba.bxs[sel]
        inv_qac = np.ones(n_pad, np.float32)
        inv_qac[:n] = igs / qf_map[bys[:n], bxs[:n]].astype(np.float64)
        xf = np.zeros(n_pad, np.float32)
        bf = np.zeros(n_pad, np.float32)
        ty, tx = bys[:n] // 8, bxs[:n] // 8
        xf[:n] = lf.cfl_base_x + ytox_glob[ty, tx].astype(np.float64) * cf
        bf[:n] = lf.cfl_base_b + ytob_glob[ty, tx].astype(np.float64) * cf

        nc = strat.num_coeffs
        # quantized coefficients are tiny; int16 halves the h2d upload
        # against int32.  AdjustQuantBias runs on the device; the static scan->basis permutation is
        # applied host-side during the pack (a device-side gather with
        # a K-sized constant index exploded XLA compile time).  The
        # first `cov` scan slots are never-written zeros and land in
        # the [:cy, :cx] corner, which the device LLF einsum
        # overwrites.
        if special:
            P = np.arange(64, dtype=np.int32)
            K = 64
        else:
            K = bh * bw
            B = S.scan_to_basis(sid)
            P = np.empty(K, np.int32)
            P[B] = np.arange(K, dtype=np.int32)
        cmat, fixes, mx = _pack_family(ba, sel, nc, P, n_pad)
        if mx >= 32768:
            # rare (multi-pass shifted coefficients): int32 fallback
            src = (ba.offs[sel][:, None]
                   + np.arange(3 * nc, dtype=np.int64))
            raw = ba.coeffs[src].reshape(n, 3, nc)
            cmat = np.zeros((n_pad, 3, K), np.int32)
            cmat[:n] = raw[:, :, P]
            fixes = None

        if special:
            resp = np.stack([_special_resp(lf, sid, c).astype(np.float32)
                             for c in range(3)])
            resp_y_def = S.response_matrix(sid, 1).astype(np.float32)
            fam = dict(vals=cmat, resp=resp, resp_y_def=resp_y_def,
                       bys=bys, bxs=bxs, inv_qac=inv_qac, xf=xf, bf=bf)
        else:
            tab = np.stack([_dq_table(lf, sid, c)[:K].astype(np.float32)
                            for c in range(3)])
            fam = dict(cmat=cmat, tab=tab, bys=bys, bxs=bxs,
                       inv_qac=inv_qac, xf=xf, bf=bf)
        if fixes is not None:
            fam["fix_idx"], fam["fix_val"] = fixes
        desc.append((sid, n_pad, bh, bw, cov, special))
        args.append(fam)
        # destination tile indices for the one-gather frame assembly
        sh, sw = bh // 8, bw // 8
        byv = bys[:n].astype(np.int64)
        bxv = bxs[:n].astype(np.int64)
        for ty in range(sh):
            for tx in range(sw):
                dest = (byv + ty) * xs_b + (bxv + tx)
                src_t = (fam_offset + np.arange(n, dtype=np.int64)
                         * (sh * sw) + ty * sw + tx)
                perm_inv[dest] = src_t
        fam_offset += n_pad * sh * sw
    return tuple(desc), tuple(args), qm, perm_inv


def _epf2_device(X, Y, B, sigma_map, sigma_scale):
    """EPF second stage on device — mirrors dec_real.apply_epf2."""
    import jax.numpy as jnp
    H, W = Y.shape
    planes = (X, Y, B)
    pad = [jnp.pad(p, 1, mode="edge") for p in planes]
    from .dec_real import EPF_SIGMA_GATE, EPF1_INV_SCALE
    active = sigma_map >= EPF_SIGMA_GATE
    inv = jnp.where(active,
                    KINV_SIGMA * EPF1_INV_SCALE * sigma_scale
                    / jnp.maximum(sigma_map, 1e-9), 0.0)
    inv_px = jnp.repeat(jnp.repeat(inv, 8, 0), 8, 1)[:H, :W]
    act_px = jnp.repeat(jnp.repeat(active, 8, 0), 8, 1)[:H, :W]
    bx = jnp.arange(W) % 8
    by = jnp.arange(H) % 8
    border = (((by == 0) | (by == 7))[:, None]
              | ((bx == 0) | (bx == 7))[None, :])
    mul = jnp.where(border, 2.0 / 3.0, 1.0)
    wsum = jnp.ones((H, W), jnp.float32)
    acc = [p for p in planes]
    for (dy, dx) in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        sad = jnp.zeros((H, W), jnp.float32)
        for c in range(3):
            pc = pad[c]
            sad = sad + EPF_CHANNEL_SCALE[c] * jnp.abs(
                pc[1:1 + H, 1:1 + W]
                - pc[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
        w = jnp.maximum(0.0, 1.0 + sad * mul * inv_px)
        wsum = wsum + w
        acc = [acc[c] + w * pad[c][1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
               for c in range(3)]
    out = [jnp.where(act_px, acc[c] / wsum, planes[c]) for c in range(3)]
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=None)
def _inv_matrix(bh: int, bw: int) -> np.ndarray:
    """(K, K) full 2D inverse transform: kron of the 1D cosine bases,
    built in float64 and cast once.  Row index = basis (k, l); columns
    are permuted to 8x8-TILE order (ty, tx, py, px) so the matmul
    output is already tile rows — no 6D transpose afterwards."""
    Ah = S.cos_basis(bh).astype(np.float64)
    Aw = S.cos_basis(bw).astype(np.float64)
    R = np.kron(Ah, Aw)
    sh, sw = bh // 8, bw // 8
    cols = (np.arange(bh * bw)
            .reshape(sh, 8, sw, 8).transpose(0, 2, 1, 3).ravel())
    return R[:, cols].astype(np.float32)


def _with_fixes(vals_int, fam):
    """Apply the int8 pack's exception list (scatter-ADD of the true
    values at flat indices; pad entries are (0, 0) and harmless)."""
    import jax.numpy as jnp
    if "fix_idx" not in fam:
        return vals_int
    flat = vals_int.reshape(-1).astype(jnp.int32)
    flat = flat.at[fam["fix_idx"]].add(fam["fix_val"])
    return flat.reshape(vals_int.shape)


def _bias_device(vals_int):
    """AdjustQuantBias on device (f32): vals_int (n, 3, K) ints ->
    bias-adjusted float32.  Matches the host float64-LUT path to f32
    rounding (<=1 ulp; the device contract allows <=1 at 8-bit out)."""
    import jax.numpy as jnp
    v = vals_int.astype(jnp.float32)
    qb = np.asarray([1.0 - b for b in S.QUANT_BIAS], np.float32)
    safe = jnp.where(v == 0.0, np.float32(1.0), v)
    return jnp.where(jnp.abs(v) > 1.0,
                     v - np.float32(S.QUANT_BIAS_NUM) / safe,
                     v * qb[None, :, None])


def _synth_family(dc_glob, fam, sid, n_pad, bh, bw, cov,
                  special, qm):
    """Dequant + CfL + inverse transform for one strategy family,
    returning flat 8x8 tile rows (n_pad*sh*sw, 192) [(3, 8, 8) each] —
    assembled into the frame by one gather in _compiled (no scatters).
    dc_glob: (3, ys_b, xs_b)."""
    import jax.numpy as jnp
    hi = backend.PRECISION

    bys, bxs = fam["bys"], fam["bxs"]
    inv_qac, xf, bf = fam["inv_qac"], fam["xf"], fam["bf"]
    gy = jnp.clip(bys, 0, dc_glob.shape[1] - 1)
    gx = jnp.clip(bxs, 0, dc_glob.shape[2] - 1)

    if special:
        vals = _bias_device(_with_fixes(fam["vals"], fam))
        resp = fam["resp"]
        resp_y_def = fam["resp_y_def"]
        acY = jnp.einsum("ns,syx->nyx", vals[:, 1, 1:], resp_y_def[1:],
                         precision=hi) * inv_qac[:, None, None]
        pix = []
        for c in range(3):
            p = jnp.einsum("ns,syx->nyx", vals[:, c, 1:], resp[c, 1:],
                           precision=hi) \
                * (inv_qac * qm[c])[:, None, None]
            p = p + dc_glob[c][gy, gx][:, None, None] * resp[c, 0]
            if c != 1:
                p = p + (xf if c == 0 else bf)[:, None, None] * acY
            pix.append(p)
        # (n, 3, 8, 8) -> (n, 192) flat tile rows (contiguous)
        return jnp.stack(pix, axis=1).reshape(n_pad, 192)
    else:
        cy, cx = STRATEGIES[sid].cy, STRATEGIES[sid].cx
        tab = fam["tab"]
        # cmat arrives basis-ordered int8/int16/int32 (host applied the
        # scan->basis permutation); the int8 exception scatter and the
        # elementwise bias run here
        cmat = _bias_device(_with_fixes(fam["cmat"], fam))
        deq = cmat * (tab[None] * qm[None, :, None]) \
            * inv_qac[:, None, None]
        dY = deq[:, 1]
        dX = deq[:, 0] + xf[:, None] * dY
        dB = deq[:, 2] + bf[:, None] * dY
        cm3 = jnp.stack([dX, dY, dB], axis=1)          # (n, 3, K)
        anY = jnp.asarray(S.ana_basis(cy).astype(np.float32))
        anX = jnp.asarray(S.ana_basis(cx).astype(np.float32))
        rs = jnp.asarray(np.outer(S.resample_vec(cy),
                                  S.resample_vec(cx)).astype(np.float32))
        dyi = jnp.arange(cy)
        dxi = jnp.arange(cx)
        giy = jnp.clip(gy[:, None, None] + dyi[None, :, None],
                       0, dc_glob.shape[1] - 1)
        gix = jnp.clip(gx[:, None, None] + dxi[None, None, :],
                       0, dc_glob.shape[2] - 1)
        dcb = dc_glob.at[:, giy, gix].get(
            mode="promise_in_bounds")                  # (3, n, cy, cx)
        llf = jnp.einsum("ky,cnyx,lx->cnkl", anY, dcb, anX,
                         precision=hi) * rs
        cm3 = cm3.reshape(n_pad, 3, bh, bw).at[:, :, :cy, :cx].set(
            llf.transpose(1, 0, 2, 3))
        return _inverse_tiles(cm3.reshape(n_pad, 3, bh * bw), bh, bw)


def _inverse_tiles(cm3, bh, bw):
    """(n, 3, K) basis-ordered coefficients -> (n*T, 192) flat 8x8 tile
    rows.  One matmul per channel: the full 2D inverse transform is the
    Kronecker product of the two cosine bases, columns already in tile
    order; a transpose then interleaves the channels per tile."""
    import jax.numpy as jnp
    n = cm3.shape[0]
    T = (bh // 8) * (bw // 8)
    Rm = jnp.asarray(_inv_matrix(bh, bw))
    tiles = jnp.einsum("nck,kp->ncp", cm3, Rm, precision=backend.PRECISION)
    tiles = tiles.reshape(n, 3, T, 64).transpose(0, 2, 1, 3)
    return tiles.reshape(n * T, 192)


def _filters_chain_device(X, Y, B, sigma, gab, epf_iters, gabw,
                          pass0_scale, pass2_scale):
    """Gaborish and EPF passes 0-2 on the true-size planes.  Plain jnp
    stencils: XLA fuses their taps into a few loop kernels."""
    from .device_real import gaborish_device, epf1_device
    if gab:
        X = gaborish_device(X, gabw[0], gabw[1])
        Y = gaborish_device(Y, gabw[2], gabw[3])
        B = gaborish_device(B, gabw[4], gabw[5])
    if epf_iters >= 1:
        if epf_iters >= 3:
            from .device_real import epf_device, EPF_OFFS_DIAMOND12
            X, Y, B = epf_device(X, Y, B, sigma,
                                 offs=EPF_OFFS_DIAMOND12,
                                 slope_scale=pass0_scale)
        X, Y, B = epf1_device(X, Y, B, sigma)
        if epf_iters >= 2:
            X, Y, B = _epf2_device(X, Y, B, sigma, pass2_scale)
    return X, Y, B


def _xyb_to_srgb16_device(X, Y, B):
    import jax
    import jax.numpy as jnp
    from .device_real import (fast_linear_to_srgb_device, _OPSIN_INV32)
    from .dec_real import _BIAS, _CBRT_BIAS
    cb = np.float32(_CBRT_BIAS)
    bias = np.float32(_BIAS)
    g_r = Y + X + cb
    g_g = Y - X + cb
    g_b = B + cb
    ml = g_r * g_r * g_r - bias
    mm = g_g * g_g * g_g - bias
    ms = g_b * g_b * g_b - bias
    # 3x3 opsin inverse unrolled to elementwise ops: XLA fuses them
    # with the cube and the transfer curve, where a 3-wide matmul would
    # not fuse
    M = np.asarray(_OPSIN_INV32)
    lin = jnp.stack([np.float32(M[c, 0]) * ml + np.float32(M[c, 1]) * mm
                     + np.float32(M[c, 2]) * ms for c in range(3)],
                    axis=-1)
    srgb = fast_linear_to_srgb_device(lin)
    return jnp.clip(jnp.floor(srgb * 65535.0 + 0.5), 0,
                    65535).astype(jnp.uint16)


def _conv_subbox_device(p):
    """center - 5x5 box sum / 25, mirrored borders (noise.py
    _conv_subbox device mirror)."""
    import jax.numpy as jnp
    pad = jnp.pad(p, 2, mode="symmetric")
    h, w = p.shape
    s = jnp.zeros_like(p)
    for dy in range(5):
        for dx in range(5):
            s = s + pad[dy:dy + h, dx:dx + w]
    return p - s / jnp.float32(25.0)


def _noise_strength_device(lut, v):
    """8-knot piecewise-linear lut (noise.py _strength device mirror)."""
    import jax.numpy as jnp
    sc = jnp.maximum(0.0, v * 6.0)
    idx = jnp.floor(sc).astype(jnp.int32)
    frac = sc - idx.astype(jnp.float32)
    over = sc >= 7.0
    idx = jnp.where(over, 6, jnp.minimum(idx, 6))
    frac = jnp.where(over, jnp.float32(1.0), frac)
    return (lut[idx] * (1.0 - frac)
            + lut[jnp.minimum(idx + 1, 7)] * frac)


def _upsample_plane_device(p, ker):
    """5x5 phase-kernel upsampling with window min/max clamping
    (ops/upsample.upsample_plane device mirror).  ker: (n, n, 5, 5)."""
    import jax.numpy as jnp
    n = ker.shape[0]
    h, w = p.shape
    pad = jnp.pad(p.astype(jnp.float32), 2, mode="symmetric")
    win = jnp.stack([pad[dy:dy + h, dx:dx + w]
                     for dy in range(5) for dx in range(5)])  # (25,H,W)
    kf = jnp.asarray(ker.reshape(n, n, 25), jnp.float32)
    out = jnp.einsum("khw,pqk->hpwq", win, kf,
                     precision=backend.PRECISION)
    lo = win.min(axis=0)
    hi = win.max(axis=0)
    out = jnp.clip(out, lo[:, None, :, None], hi[:, None, :, None])
    return out.reshape(h * n, w * n)


def _xyb_to_linear_device(X, Y, B):
    """XYB planes -> (..., 3) unclamped linear sRGB (elementwise ops —
    see _xyb_to_srgb16_device for why not a matmul)."""
    import jax.numpy as jnp
    from .device_real import _OPSIN_INV32
    from .dec_real import _BIAS, _CBRT_BIAS
    cb = np.float32(_CBRT_BIAS)
    bias = np.float32(_BIAS)
    g_r = Y + X + cb
    g_g = Y - X + cb
    g_b = B + cb
    ml = g_r * g_r * g_r - bias
    mm = g_g * g_g * g_g - bias
    ms = g_b * g_b * g_b - bias
    M = np.asarray(_OPSIN_INV32)
    return jnp.stack([np.float32(M[c, 0]) * ml + np.float32(M[c, 1]) * mm
                      + np.float32(M[c, 2]) * ms for c in range(3)],
                     axis=-1)


def _quantize_device(enc, bits):
    import jax.numpy as jnp
    maxv = (1 << bits) - 1
    out = jnp.clip(jnp.floor(enc * np.float32(maxv) + 0.5), 0, maxv)
    return out.astype(jnp.uint8 if bits <= 8 else jnp.uint16)


def _encode_output_device(X, Y, B, out_spec, bits):
    """Device mirror of the host output-encoding tail
    (dec_real.xyb_planes_to_{gamma,encoding} / ycbcr_planes_to_rgb):
    out_spec is a static tuple — ('srgb',), ('gamma', g),
    ('enc', trc, gamut_matrix_tuple_or_None, intensity_target),
    ('ycbcr',)."""
    import jax.numpy as jnp
    from .device_real import fast_linear_to_srgb_device
    kind = out_spec[0]
    if kind == "ycbcr":
        # dec_real.ycbcr_planes_to_rgb: planes arrive as (Cb, Y, Cr)
        yp = Y + np.float32(128.0 / 255.0)
        r = yp + np.float32(1.402) * B
        g = yp - np.float32(0.344136) * X - np.float32(0.714136) * B
        b = yp + np.float32(1.772) * X
        return _quantize_device(jnp.stack([r, g, b], axis=-1), bits)
    lin = _xyb_to_linear_device(X, Y, B)
    if kind == "srgb":
        srgb = fast_linear_to_srgb_device(lin)
        return _quantize_device(srgb, bits)
    if kind == "gamma":
        enc = jnp.power(jnp.maximum(lin, 0.0), np.float32(out_spec[1]))
        return _quantize_device(enc, bits)
    # generic signalled encoding (dec_real.xyb_planes_to_encoding);
    # out_spec = ('enc', trc, gamut_matrix_or_None, intensity_target,
    # luma_weights) with luma = gamut_rgb_to_xyz(prim, wp)[1]
    from ..ops import color as C
    _, trc, gm, it, luma_w = out_spec
    if gm is not None:
        m = np.asarray(gm, np.float32).reshape(3, 3)
        lin = jnp.matmul(lin, m.T, precision=backend.PRECISION)
    sign = jnp.sign(lin)
    if trc == 16:    # PQ
        enc = sign * C.linear_to_pq(jnp.abs(lin) * (255.0 / 10000.0))
    elif trc == 18:  # HLG with inverse OOTF
        disp = lin * np.float32(255.0 / it)
        gam = 1.2 * 1.111 ** np.log2(it / 1000.0)
        luma = jnp.asarray(np.asarray(luma_w, np.float32))
        yd = jnp.einsum("...c,c->...", disp, luma,
                        precision=backend.PRECISION)
        f = jnp.where(yd > 1e-9,
                      jnp.abs(yd) ** np.float32((1.0 - gam) / gam), 0.0)
        scene = disp * f[..., None]
        enc = jnp.sign(scene) * C.linear_to_hlg(
            jnp.minimum(jnp.abs(scene), 1.0))
    else:
        enc = sign * C.LINEAR_TO_TRC.get(
            trc, C.linear_to_srgb)(jnp.abs(lin))
    return _quantize_device(enc, bits)


def _build_fn(desc, H8, W8, bits, gab, epf_iters, gabw_t, pass0_scale,
              pass2_scale, crop_h=None, crop_w=None, post=()):
    """The (unjitted) whole-frame reconstruction function for one frame
    geometry — jitted by _compiled for the product path, vmapped /
    shard_mapped by the multi-chip GOP paths (parallel/multihost).

    post: static tuple of (key, value) pairs enabling post-filter
    stages on device (the features the reference runs inside libjxl's
    single render pipeline, JxlDecoding.cpp:74-175):
      ("overlay", True)      patches+splines as X*mul+add (extras:
                             mul, add — see patches.patches_to_affine)
      ("noise", True)        noise synthesis (extras: rnd (3,h,w), lut)
      ("ups", n)             2x/4x/8x upsampling (extras: upk kernels)
      ("out", spec)          output encoding; default ('srgb',)
    With post nonempty, the jitted fn takes an extra `extras` dict."""
    import jax
    import jax.numpy as jnp
    from .device_real import xyb_to_srgb8_device
    gabw = np.asarray(gabw_t, np.float32)
    post_d = dict(post)

    def filtered_planes(fams, dc_glob, qf_map, sharp_map, igs, qm,
                        perm_inv):
        fam_tiles = []
        for fam, (sid, n_pad, bh, bw, cov, special) in zip(fams, desc):
            with jax.named_scope(f"synth_{sid}_{bh}x{bw}"):
                fam_tiles.append(_synth_family(dc_glob, fam, sid, n_pad,
                                               bh, bw, cov, special, qm))
        with jax.named_scope("gather_detile"):
            all_tiles = (fam_tiles[0] if len(fam_tiles) == 1
                         else jnp.concatenate(fam_tiles, axis=0))
            ny, nx = H8 // 8, W8 // 8
            # one dense 192-wide gather (hinted: perm_inv is a
            # permutation subset), then detile via 24 strided (c, py)
            # slices + stack + row-permuting transpose
            g = all_tiles.at[perm_inv].get(unique_indices=True,
                                           mode="promise_in_bounds")
            g = g.reshape(ny, nx, 3, 8, 8)
            rows = [g[:, :, c, py, :] for c in range(3)
                    for py in range(8)]
            st = jnp.stack(rows, axis=0).reshape(3, 8, ny, W8)
            frame = st.transpose(0, 2, 1, 3).reshape(3, H8, W8)
        planes = [frame[0], frame[1], frame[2]]
        if (gab or epf_iters >= 1) and (crop_h < H8 or crop_w < W8):
            # filter at the TRUE image size with Mirror() borders (the
            # reference render-pipeline semantics)
            planes = [p[:crop_h, :crop_w] for p in planes]
        X, Y, B = planes
        with jax.named_scope("filters"):
            if epf_iters >= 1:
                sigma = (EPF_SIGMA_PER * sharp_map.astype(jnp.float32)
                         * igs / jnp.maximum(
                             qf_map.astype(jnp.float32), 1.0))
            else:
                sigma = jnp.zeros_like(qf_map, jnp.float32)
            return _filters_chain_device(X, Y, B, sigma, gab, epf_iters,
                                         gabw, pass0_scale, pass2_scale)

    def fn(fams, dc_glob, qf_map, sharp_map, igs, qm, perm_inv):
        X, Y, B = filtered_planes(fams, dc_glob, qf_map, sharp_map, igs,
                                  qm, perm_inv)
        with jax.named_scope("colour"):
            if bits > 8:
                return _xyb_to_srgb16_device(X, Y, B)
            return xyb_to_srgb8_device(X, Y, B)

    if not post_d:
        return fn

    def fn_post(fams, dc_glob, qf_map, sharp_map, igs, qm, perm_inv,
                extras):
        X, Y, B = filtered_planes(fams, dc_glob, qf_map, sharp_map, igs,
                                  qm, perm_inv)
        # post stages run at the TRUE image size, mirroring the host
        # tail (dec_real.decode_vardct_frame: filters -> patches ->
        # splines -> noise -> upsampling -> output encoding)
        X = X[:crop_h, :crop_w]
        Y = Y[:crop_h, :crop_w]
        B = B[:crop_h, :crop_w]
        if post_d.get("overlay"):
            mul = extras["mul"]
            add = extras["add"]
            X = X * mul[0] + add[0]
            Y = Y * mul[1] + add[1]
            B = B * mul[2] + add[2]
        if post_d.get("noise"):
            from .noise import NOISE_K0
            rnd = extras["rnd"]
            lut = extras["lut"]
            conv_r = _conv_subbox_device(rnd[0])
            conv_g = _conv_subbox_device(rnd[1])
            conv_cor = _conv_subbox_device(rnd[2])
            sr = _noise_strength_device(lut, (Y + X) * 0.5)
            sg = _noise_strength_device(lut, (Y - X) * 0.5)
            red = sr * (conv_cor + conv_r / jnp.float32(128.0))
            green = sg * (conv_cor + conv_g / jnp.float32(128.0))
            k0 = jnp.float32(NOISE_K0)
            X = X + k0 * (red - green)
            Y = Y + k0 * (red + green)
            B = B + k0 * (red + green)
        ups = post_d.get("ups", 1)
        if ups > 1:
            ker = extras["upk"]
            X = _upsample_plane_device(X, ker)
            Y = _upsample_plane_device(Y, ker)
            B = _upsample_plane_device(B, ker)
        down = post_d.get("down", 1)
        if down > 1:
            # sampled-decode fast path: box-average on device BEFORE
            # the output encoding, so the d2h transfer shrinks by
            # down^2 (the Glide decodeSampled workload; the reference
            # full-decodes then rescales, JniDecoding.cpp:124-136)
            def _pool(p):
                ph_ = (-p.shape[0]) % down
                pw_ = (-p.shape[1]) % down
                if ph_ or pw_:
                    p = jnp.pad(p, ((0, ph_), (0, pw_)), mode="edge")
                return p.reshape(p.shape[0] // down, down,
                                 p.shape[1] // down, down).mean(
                                     axis=(1, 3))
            X, Y, B = _pool(X), _pool(Y), _pool(B)
        out_spec = post_d.get("out", ("srgb",))
        with jax.named_scope("colour"):
            return _encode_output_device(X, Y, B, out_spec, int(bits))

    return fn_post


@functools.lru_cache(maxsize=32)
def _compiled(desc, H8, W8, bits, gab, epf_iters, gabw_t, pass0_scale,
              pass2_scale, crop_h=None, crop_w=None, post=()):
    import jax
    backend.use_compile_cache()
    return jax.jit(_build_fn(desc, H8, W8, bits, gab, epf_iters, gabw_t,
                             pass0_scale, pass2_scale, crop_h, crop_w,
                             post))


def reconstruct_frame_device(lf, fh, blocks_global, qf_map, sharp_map,
                             ytox_glob, ytob_glob, dc_glob,
                             bits: int, crop_h: int = None,
                             crop_w: int = None,
                             as_device: bool = False,
                             post=(), extras=None) -> np.ndarray:
    """Whole-frame device reconstruction: scan-indexed varblocks (frame
    coords) -> (H8, W8, 3) uint8/uint16 sRGB on the padded block grid.
    dc_glob: dict {0,1,2} of already-smoothed XYB DC planes.
    as_device: return the (asynchronously dispatched) device array
    without blocking on d2h — callers overlap the fetch with the next
    frame's host work (api.decode_batch).
    post/extras: optional post-filter stage config (see _build_fn) —
    patches/splines overlay, noise, upsampling, output encodings."""
    desc, fams, qm, perm_inv = prepare_families(
        lf, fh, blocks_global, qf_map, ytox_glob, ytob_glob)
    ys_b, xs_b = qf_map.shape
    rf = fh.restoration_filter
    if rf.gab and rf.gab_custom and rf.gab_weights is not None:
        gabw = np.asarray(rf.gab_weights, np.float32)
    else:
        gabw = np.asarray([0.115169525, 0.061248592] * 3, np.float32)
    dc = np.stack([dc_glob[c] for c in range(3)]).astype(np.float32)
    H8, W8 = ys_b * 8, xs_b * 8
    fn = _compiled(desc, H8, W8, int(bits), bool(rf.gab),
                   int(rf.epf_iters), tuple(float(g) for g in gabw),
                   float(rf.epf_pass0_sigma_scale),
                   float(rf.epf_pass2_sigma_scale),
                   int(crop_h) if crop_h else H8,
                   int(crop_w) if crop_w else W8,
                   tuple(post))
    args = (fams, dc, qf_map.astype(np.int32),
            sharp_map.astype(np.int32),
            np.float32(lf.inv_global_scale), qm, perm_inv)
    if post:
        out = fn(*args, extras or {})
    else:
        out = fn(*args)
    return out if as_device else np.asarray(out)


def prepare_exec(state: dict):
    """(static kwargs for _build_fn/_compiled, runtime args, batched
    mask) from a decode_vardct_frame(parse_only=True) state.  The mask
    marks which arg leaves carry per-frame data (True) vs replicated
    tables (False) — consumed by the GOP-sharding multihost path.
    All host marshalling (family packing) happens here, so callers can
    run it in worker threads and keep only jit dispatch on the main
    thread (api.decode_batch)."""
    lf, fh = state["lf"], state["fh"]
    qf_map = state["qf_map"]
    desc, fams, qm, perm_inv = prepare_families(
        lf, fh, state["blocks_glob"], qf_map,
        state["ytox_glob"], state["ytob_glob"])
    ys_b, xs_b = qf_map.shape
    rf = fh.restoration_filter
    if rf.gab and rf.gab_custom and rf.gab_weights is not None:
        gabw = tuple(float(g) for g in rf.gab_weights)
    else:
        gabw = (0.115169525, 0.061248592) * 3
    dc = np.stack([state["dc_glob"][c] for c in range(3)]).astype(
        np.float32)
    static = dict(desc=desc, H8=ys_b * 8, W8=xs_b * 8,
                  bits=int(state["bits"]), gab=bool(rf.gab),
                  epf_iters=int(rf.epf_iters), gabw_t=gabw,
                  pass0_scale=float(rf.epf_pass0_sigma_scale),
                  pass2_scale=float(rf.epf_pass2_sigma_scale),
                  crop_h=int(state["h"]), crop_w=int(state["w"]))
    args = (fams, dc, qf_map.astype(np.int32),
            state["sharp_map"].astype(np.int32),
            np.float32(lf.inv_global_scale), qm, perm_inv)
    fams_mask = tuple(
        {k: k not in ("tab", "resp", "resp_y_def") for k in fam}
        for fam in fams)
    mask = (fams_mask, True, True, True, False, False, False)
    return static, args, mask


def reconstruct_state_device(state: dict, as_device: bool = False,
                             prepared=None):
    """Device reconstruction from a decode_vardct_frame(parse_only=True)
    state dict; output is already cropped to the true image size.
    prepared: optional (static, args) from prepare_exec, letting the
    expensive host marshalling run on a worker thread beforehand."""
    static, args = prepared if prepared is not None \
        else prepare_exec(state)[:2]
    fn = _compiled(**static)
    out = fn(*args)
    return out if as_device else np.asarray(out)
