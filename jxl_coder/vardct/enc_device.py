"""Device-side VarDCT encoder front end (JAX/XLA).

Puts the encoder's compute-heavy forward path on the device (SURVEY.md §7
step 6; the reference's analogue is the encode hot loop behind
JxlEncoderAddImageFrame, interop/JxlEncoding.cpp:165-170, which runs
inside libjxl.so on CPU):

  stage 1 (_front):   sRGB -> linear -> XYB, CfL base subtract,
                      gaborish sharpening (Neumann series), the
                      contrast-masking field, per-8x8-block DCT
                      analysis, and the per-64px-tile CfL regression
                      sums — one jit per padded frame size.
  stage 2 (_costs):   bias-aware quantization + rate/distortion cost
                      grids for the DCT8 baseline and every candidate
                      transform shape of the RD search — one jit per
                      (size, candidate-set).

The greedy winner selection, token emission and all bitstream work
stay on the host (enc_real).  Math is float32 (vs the host oracle's
float64): quantization boundary ties may flip, which changes the
emitted stream slightly but never its validity — rate/quality stays
on the same curve (cross-checked by tests/test_vardct.py).

Both stages return host numpy; the planes/coefficients handed from
stage 1 to stage 2 stay on device (no d2h round-trip).
"""

from __future__ import annotations

import functools

import numpy as np

from .. import backend
from . import synthesis as S
from .strategies import STRATEGIES

_D_WEIGHTS = (8.0, 1.0, 0.35)


def enabled() -> bool:
    from .device_full import device_enabled
    return device_enabled() and backend.knob(
        "JXL_ENC_DEVICE", "1") not in ("", "0")


def _adjust_bias_dev(q, c):
    import jax.numpy as jnp
    qb = np.float32(1.0 - S.QUANT_BIAS[c])
    safe = jnp.where(q == 0.0, np.float32(1.0), q)
    return jnp.where(jnp.abs(q) > 1.0,
                     q - np.float32(S.QUANT_BIAS_NUM) / safe, q * qb)


def _quantize_biased_dev(ratio, c, deadzone):
    """Pick the integer whose adjust(q) lands closest to ratio (the
    decoder applies AdjustQuantBias on reconstruction)."""
    import jax.numpy as jnp
    q0 = jnp.round(ratio)
    best_q = q0
    best_e = jnp.abs(_adjust_bias_dev(q0, c) - ratio)
    for dq in (-1.0, 1.0):
        q = q0 + np.float32(dq)
        e = jnp.abs(_adjust_bias_dev(q, c) - ratio)
        take = e < best_e
        best_q = jnp.where(take, q, best_q)
        best_e = jnp.where(take, e, best_e)
    return jnp.where(jnp.abs(ratio) < deadzone, 0.0, best_q)


def _token_cost_dev(vals, cov):
    """Rate proxy (bits) per channel; vals (..., size) float ints."""
    import jax.numpy as jnp
    seg = vals[..., cov:]
    nz = seg != 0
    any_nz = nz.any(-1)
    L = seg.shape[-1]
    last = jnp.where(any_nz,
                     L - jnp.argmax(nz[..., ::-1], axis=-1), 0)
    bits = jnp.where(nz, jnp.log2(1.0 + jnp.abs(seg)), 0.0).sum(-1)
    cnt = nz.sum(-1)
    return jnp.where(any_nz,
                     2.0 + 1.1 * last.astype(jnp.float32) + bits
                     + cnt.astype(jnp.float32), np.float32(2.0))


@functools.lru_cache(maxsize=8)
def _front(ph: int, pw: int, gab_iters: int = 4):
    import jax
    backend.use_compile_cache()
    import jax.numpy as jnp
    from .device_real import gaborish_device
    from .enc_real import (_OPSIN, _BIAS, _CBRT_BIAS, MASK_COEF,
                           MASK_EXP, MASK_COEF2, MASK_EXP2, MASK_MAX)
    ys_b, xs_b = ph // 8, pw // 8
    ty, tx = -(-ys_b // 8), -(-xs_b // 8)
    ANA = jnp.asarray(S.ana_basis(8).astype(np.float32))
    OPS = jnp.asarray(_OPSIN.astype(np.float32))
    w1 = np.float32(0.115169525)
    w2 = np.float32(0.061248592)

    def sharpen(p):
        if gab_iters == 0:
            return p
        out = p
        err = p
        for _ in range(gab_iters):
            err = err - gaborish_device(err, w1, w2)
            out = out + err
        return out

    def fn(pad):                      # (ph, pw, 3) f32 sRGB-encoded
        lin = jnp.where(pad <= 0.04045, pad / 12.92,
                        ((pad + 0.055) / 1.055) ** 2.4)
        mixed = jnp.matmul(lin, OPS.T, precision=backend.PRECISION)
        g = jnp.cbrt(mixed + np.float32(_BIAS)) - np.float32(_CBRT_BIAS)
        X = (g[..., 0] - g[..., 1]) * 0.5
        Y = (g[..., 0] + g[..., 1]) * 0.5
        B = g[..., 2] - Y             # CfL base factor 1.0
        X, Y, B = sharpen(X), sharpen(Y), sharpen(B)
        # contrast-masking field from the sharpened luma
        gy, gx = jnp.gradient(Y)
        act = jnp.sqrt(gy * gy + gx * gx)
        act_b = act.reshape(ys_b, 8, xs_b, 8)
        mean_b = jnp.maximum(act_b.mean(axis=(1, 3)), 0.0)
        # screen-content guard (mirror of enc_real._masking_field):
        # sparse edges on flat blocks keep fine quantization
        med_b = jnp.median(act_b, axis=(1, 3))
        blk = jnp.sqrt(mean_b * jnp.minimum(mean_b, 4.0 * med_b))
        mask = jnp.clip(1.0 + MASK_COEF * blk ** np.float32(MASK_EXP)
                        + MASK_COEF2 * blk ** np.float32(MASK_EXP2),
                        1.0, MASK_MAX)
        planes = jnp.stack([X, Y, B])
        b8 = planes.reshape(3, ys_b, 8, xs_b, 8).transpose(0, 1, 3, 2, 4)
        co = jnp.einsum("ky,cYXyx,lx->cYXkl", ANA, b8, ANA,
                        precision=backend.PRECISION)
        # per-64px-tile CfL regression sums over AC coefficients
        cf = co.reshape(3, ys_b, xs_b, 64)
        pad_y = (-ys_b) % 8
        pad_x = (-xs_b) % 8
        cfp = jnp.pad(cf, ((0, 0), (0, pad_y), (0, pad_x), (0, 0)))
        cft = cfp.reshape(3, ty, 8, tx, 8, 64)
        yac = cft[1, :, :, :, :, 1:]
        y2 = jnp.sum(yac * yac, axis=(1, 3, 4))
        xy = jnp.sum(cft[0, :, :, :, :, 1:] * yac, axis=(1, 3, 4))
        by = jnp.sum(cft[2, :, :, :, :, 1:] * yac, axis=(1, 3, 4))
        # one flat buffer for everything the host needs from stage 1
        # (mask + CfL sums + the DC coefficient slice): a single d2h
        # transfer instead of five
        small = jnp.concatenate([
            mask.ravel(), y2.ravel(), xy.ravel(), by.ravel(),
            co[:, :, :, 0, 0].ravel()])
        return planes, co, small

    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _costs(ys_b: int, xs_b: int, cands: tuple, deadzone: float,
           specials: tuple = ()):
    """jit: quantize + cost for DCT8 and every aligned candidate
    position.  cands: ((sid, cy, cx), ...); specials: cov==1 special
    transform sids evaluated per 8x8 block via their response
    matrices (enc_real._special_quantize_batch's device twin)."""
    import jax
    import jax.numpy as jnp
    backend.use_compile_cache()
    hi = backend.PRECISION

    tabs8 = jnp.asarray(np.stack([
        S.dequant_table(0, c).astype(np.float32) for c in range(3)]))
    order8 = S.scan_to_basis(0)
    idx8 = jnp.asarray(order8[1:].astype(np.int32))
    dz = np.float32(deadzone)

    def quant_cost(flat, qfv, fxv, fbv, tabs, idx, cov, llf_pair):
        """flat (N, 3, size) basis coeffs; returns (vals (N, 3, size-cov)
        scan-tail, dist (N,))."""
        area = np.float32(cov * 64)
        inv_qac = (1.0 / qfv)[:, None]          # x igs by caller
        fY = jnp.take(flat[:, 1], idx, axis=-1)
        stepY = tabs[1][idx][None] * inv_qac
        qy = _quantize_biased_dev(fY / stepY, 1, dz)
        dqY = _adjust_bias_dev(qy, 1) * stepY
        dist = area * np.float32(_D_WEIGHTS[1]) * jnp.sum(
            (dqY - fY) ** 2, axis=-1)
        vals = [None, qy, None]
        for c, f in ((0, fxv), (2, fbv)):
            tgt = jnp.take(flat[:, c], idx, axis=-1)
            sub = tgt - f[:, None] * dqY
            step = tabs[c][idx][None] * inv_qac
            q = _quantize_biased_dev(sub / step, c, dz)
            rec = _adjust_bias_dev(q, c) * step + f[:, None] * dqY
            dist = dist + area * np.float32(_D_WEIGHTS[c]) * jnp.sum(
                (rec - tgt) ** 2, axis=-1)
            vals[c] = q
        if llf_pair is not None:
            llf, tl = llf_pair
            d2 = jnp.sum((llf - tl) ** 2, axis=-1)
            for c in range(3):
                dist = dist + area * np.float32(_D_WEIGHTS[c]) * d2[:, c]
        return jnp.stack(vals, axis=1), dist

    cand_static = []
    for sid, cy, cx in cands:
        nyc, nxc = ys_b // cy, xs_b // cx
        if nyc == 0 or nxc == 0:
            continue
        st = STRATEGIES[sid]
        order = S.scan_to_basis(sid)
        cov = st.covered
        h, w = cy * 8, cx * 8
        pos = np.asarray([(j // cx) * w + (j % cx) for j in range(cov)],
                         np.int32)
        cand_static.append((
            sid, cy, cx, nyc, nxc, cov,
            jnp.asarray(S.ana_basis(h).astype(np.float32)),
            jnp.asarray(S.ana_basis(w).astype(np.float32)),
            jnp.asarray(order[cov:].astype(np.int32)),
            jnp.asarray(np.stack([
                S.dequant_table(sid, c).astype(np.float32)
                for c in range(3)])),
            jnp.asarray(pos),
            jnp.asarray(S.ana_basis(cy).astype(np.float32)),
            jnp.asarray(S.ana_basis(cx).astype(np.float32)),
            jnp.asarray(np.outer(S.resample_vec(cy),
                                 S.resample_vec(cx)).astype(np.float32)),
        ))

    special_static = []
    if specials:
        from .enc_real import _special_mats
        for sid_ in specials:
            r0_, R1_, A_ = _special_mats(sid_)
            special_static.append((
                sid_,
                jnp.asarray(r0_.astype(np.float32)),
                jnp.asarray(R1_.astype(np.float32)),
                jnp.asarray(A_.astype(np.float32))))

    def fn(planes, co, qf_map, fx_blk, fb_blk, dq_dc, igs, lam,
           elig=None):
        qff = qf_map.astype(jnp.float32) / igs     # steps divide by igs
        flat8 = co.reshape(3, ys_b * xs_b, 64).transpose(1, 0, 2)
        dqb8 = dq_dc.transpose(1, 2, 0).reshape(ys_b * xs_b, 3, 1)
        # DCT8 LLF error: llf == dq_dc mean vs true DC coefficient
        tl8 = flat8[:, :, :1]
        vals8, dist8 = quant_cost(
            flat8, qff.ravel(), fx_blk.ravel(), fb_blk.ravel(),
            tabs8, idx8, 1, (dqb8 * np.float32(1.0), tl8))
        rate8 = _token_cost_dev(vals8, 0).sum(-1)
        cost8 = (rate8 + lam * dist8).reshape(ys_b, xs_b)
        outs = [vals8.astype(jnp.int16).reshape(ys_b, xs_b, 3, 63),
                cost8]
        for (sid, cy, cx, nyc, nxc, cov, anaH, anaW, idx, tabs, pos,
             anY, anX, rs) in cand_static:
            h, w = cy * 8, cx * 8
            reg = planes[:, :nyc * h, :nxc * w].reshape(
                3, nyc, h, nxc, w).transpose(1, 3, 0, 2, 4).reshape(
                nyc * nxc, 3, h, w)
            coeff = jnp.einsum("ky,ncyx,lx->nckl", anaH, reg, anaW,
                               precision=hi).reshape(
                nyc * nxc, 3, h * w)
            qfm = (qf_map[:nyc * cy, :nxc * cx].reshape(
                nyc, cy, nxc, cx).min(axis=(1, 3)).ravel()
                .astype(jnp.float32) / igs)
            fxa = fx_blk[:nyc * cy:cy, :nxc * cx:cx].ravel()
            fba = fb_blk[:nyc * cy:cy, :nxc * cx:cx].ravel()
            dqb = dq_dc[:, :nyc * cy, :nxc * cx].reshape(
                3, nyc, cy, nxc, cx).transpose(1, 3, 0, 2, 4).reshape(
                nyc * nxc, 3, cy, cx)
            llf = jnp.einsum("ky,ncyx,lx->nckl", anY, dqb, anX,
                             precision=hi) * rs[None, None]
            llf = llf.reshape(nyc * nxc, 3, cov)
            tl = jnp.take(coeff, pos, axis=-1)
            vals, dist = quant_cost(coeff, qfm, fxa, fba, tabs, idx,
                                    cov, (llf, tl))
            rate = _token_cost_dev(vals, 0).sum(-1)
            outs.append(vals.astype(jnp.int16).reshape(
                nyc, nxc, 3, -1))
            outs.append((rate + lam * dist).reshape(nyc, nxc))
        if special_static:
            blocks_pix = planes.reshape(3, ys_b, 8, xs_b, 8) \
                .transpose(1, 3, 0, 2, 4).reshape(ys_b * xs_b, 3, 64)
            dcb = dq_dc.transpose(1, 2, 0).reshape(ys_b * xs_b, 3)
            inv_qac = (1.0 / qff.ravel())[:, None]
            fxr = fx_blk.ravel()
            fbr = fb_blk.ravel()
            # screen-content eligibility: host-computed bool per block
            # (single source of truth with the host RD path)
            eligible = elig.ravel()
            for (sid, r0_d, R1_d, A_d) in special_static:
                t1 = blocks_pix[:, 1] - dcb[:, 1, None] * r0_d[1][None]
                gY = jnp.einsum("nk,kj->nj", t1, A_d[1], precision=hi)
                qy = _quantize_biased_dev(gY / inv_qac, 1, dz)
                dqY = _adjust_bias_dev(qy, 1) * inv_qac
                recY = jnp.einsum("nj,jk->nk", dqY, R1_d[1],
                                  precision=hi)
                # pixel-domain error matches the DCT8 dist scale
                # (ana rows norm^2 1/64, area 64 cancels)
                dist = np.float32(_D_WEIGHTS[1]) * jnp.sum(
                    (recY - t1) ** 2, axis=-1)
                valsS = [None, qy, None]
                for c, f in ((0, fxr), (2, fbr)):
                    tc = blocks_pix[:, c] \
                        - dcb[:, c, None] * r0_d[c][None]
                    sub = tc - f[:, None] * recY
                    g = jnp.einsum("nk,kj->nj", sub, A_d[c],
                                   precision=hi)
                    q = _quantize_biased_dev(g / inv_qac, c, dz)
                    rec = jnp.einsum(
                        "nj,jk->nk", _adjust_bias_dev(q, c) * inv_qac,
                        R1_d[c], precision=hi) + f[:, None] * recY
                    dist = dist + np.float32(_D_WEIGHTS[c]) \
                        * jnp.sum((rec - tc) ** 2, axis=-1)
                    valsS[c] = q
                vs = jnp.stack(valsS, axis=1)         # (N, 3, 63)
                rate = _token_cost_dev(vs, 0).sum(-1)
                costS = jnp.where(eligible, rate + lam * dist,
                                  np.float32(1e30))
                outs.append(vs.astype(jnp.int16).reshape(
                    ys_b, xs_b, 3, -1))
                outs.append(costS.reshape(ys_b, xs_b))
        # costs ship as ONE small flat f32 buffer (the greedy decision
        # needs only costs); the value grids STAY ON DEVICE — the host
        # gathers just the winners afterwards (fetch_selected) instead
        # of fetching the full candidate grids, almost all of which
        # lose.
        cflat = jnp.concatenate([outs[k].reshape(-1)
                                 for k in range(1, len(outs), 2)])
        return tuple(outs[k] for k in range(0, len(outs), 2)) + (cflat,)

    meta = [(sid, cy, cx, nyc, nxc, cov)
            for (sid, cy, cx, nyc, nxc, cov, *_r) in cand_static]
    meta += [(sid, 1, 1, ys_b, xs_b, 1) for sid in specials]
    return jax.jit(fn), meta


def run_front_dispatch(pad_f32: np.ndarray, gab_iters: int = 4):
    """Dispatch stage 1 asynchronously; pair with run_front_fetch.
    Callers can run independent host work (e.g. the patch detector)
    while the device computes and the d2h transfer is in flight."""
    ph, pw, _ = pad_f32.shape
    ys_b, xs_b = ph // 8, pw // 8
    fn = _front(ph, pw, gab_iters)
    planes, co, small_d = fn(pad_f32)
    return planes, co, small_d, ys_b, xs_b


def run_front(pad_f32: np.ndarray, gab_iters: int = 4):
    """Host entry for stage 1: (ph, pw, 3) float32 sRGB-encoded in
    [0, 1].  Returns (device planes, device co, mask np, ytox np,
    ytob np, co_dc np (3, ys_b, xs_b)).  gab_iters=0 skips the gaborish
    sharpening (fast decoding-speed tiers)."""
    return run_front_fetch(run_front_dispatch(pad_f32, gab_iters))


def run_front_fetch(pending):
    """Block on a run_front_dispatch handle (one small d2h fetch)."""
    planes, co, small_d, ys_b, xs_b = pending
    ty, tx = -(-ys_b // 8), -(-xs_b // 8)
    small = np.asarray(small_d)
    nb = ys_b * xs_b
    nt = ty * tx
    mask = small[:nb].reshape(ys_b, xs_b)
    y2 = small[nb:nb + nt].reshape(ty, tx)
    xyn = small[nb + nt:nb + 2 * nt].reshape(ty, tx)
    byn = small[nb + 2 * nt:nb + 3 * nt].reshape(ty, tx)
    co_dc = small[nb + 3 * nt:].reshape(3, ys_b, xs_b).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fx = np.where(y2 > 1e-9, xyn / y2, 0.0)
        fb = np.where(y2 > 1e-9, byn / y2, 0.0)
    ytox = np.clip(np.round(fx * 84.0), -128, 127).astype(np.int32)
    ytob = np.clip(np.round(fb * 84.0), -128, 127).astype(np.int32)
    return planes, co, mask, ytox, ytob, co_dc


def run_costs_dispatch(planes, co, qf_map, fx_blk, fb_blk, dq_dc, igs,
                       lam, cands, deadzone, specials=(),
                       special_eligible=None):
    """Dispatch stage 2 asynchronously; pair with run_costs_fetch.
    The caller can run independent host work (DC tree learning) while
    the device computes."""
    import jax.numpy as jnp
    ys_b, xs_b = qf_map.shape
    fn, meta = _costs(ys_b, xs_b, tuple(cands), float(deadzone),
                      tuple(specials))
    args = [planes, co, jnp.asarray(qf_map.astype(np.int32)),
            jnp.asarray(fx_blk.astype(np.float32)),
            jnp.asarray(fb_blk.astype(np.float32)),
            jnp.asarray(dq_dc.astype(np.float32)),
            np.float32(igs), np.float32(lam)]
    if specials:
        if special_eligible is None:
            special_eligible = np.ones((ys_b, xs_b), bool)
        args.append(jnp.asarray(special_eligible.astype(np.bool_)))
    res = fn(*args)
    return res[:-1], res[-1], meta, qf_map


def run_costs_fetch(pending):
    """Block on a run_costs_dispatch handle and fetch the COST grids
    only (one small f32 transfer).  Returns (cost8, cost_data {sid:
    (cost, qfm)}, vals_list-on-device, meta)."""
    vals_list, cflat_d, meta, qf_map = pending
    ys_b, xs_b = qf_map.shape
    cflat = np.asarray(cflat_d)
    cost8 = cflat[:ys_b * xs_b].astype(np.float64).reshape(ys_b, xs_b)
    cost_data = {}
    co_ = ys_b * xs_b
    for (sid, cy, cx, nyc, nxc, cov) in meta:
        cost = cflat[co_:co_ + nyc * nxc].astype(np.float64).reshape(
            nyc, nxc)
        co_ += nyc * nxc
        qfm = qf_map[:nyc * cy, :nxc * cx].reshape(
            nyc, cy, nxc, cx).min(axis=(1, 3)).astype(np.int32)
        cost_data[sid] = (cost, qfm)
    return cost8, cost_data, vals_list, meta


def _bucket_pow2(n: int) -> int:
    return max(8, 1 << (int(n) - 1).bit_length()) if n else 8


@functools.lru_cache(maxsize=1)
def _sel_gather_jit():
    import jax
    import jax.numpy as jnp

    def fn(arrs, idxs):
        outs = []
        for a, ix in zip(arrs, idxs):
            flat = a.reshape((-1,) + a.shape[2:])
            g = jnp.take(flat, ix, axis=0, mode="clip")
            outs.append(g.reshape(-1))
        return jnp.concatenate(outs)

    return jax.jit(fn)


def fetch_selected_dispatch(vals_list, meta, acs_map):
    """Start the device gather of the winning anchors' values and
    return a handle; pair with fetch_selected_fetch.  Callers can run
    independent host work (AC-metadata tree learning) while the gather
    and its d2h transfer are in flight."""
    ys_b, xs_b = acs_map.shape
    by_all, bx_all = np.nonzero(acs_map >= 0)
    sid_all = acs_map[by_all, bx_all]
    srcs, idxs, anchors = [], [], []
    # source 0: DCT8 anchors from the vals8 grid
    m8 = sid_all == 0
    idx8 = (by_all[m8] * xs_b + bx_all[m8]).astype(np.int32)
    srcs.append(vals_list[0])
    idxs.append(idx8)
    anchors.append((0, 1, list(zip(by_all[m8], bx_all[m8]))))
    for k, (sid, cy, cx, nyc, nxc, cov) in enumerate(meta):
        m = sid_all == sid
        if not m.any():
            continue
        ix = ((by_all[m] // cy) * nxc + bx_all[m] // cx).astype(np.int32)
        srcs.append(vals_list[k + 1])
        idxs.append(ix)
        anchors.append((sid, cov, list(zip(by_all[m], bx_all[m]))))
    idx_pad = []
    for ix in idxs:
        pad = _bucket_pow2(len(ix))
        ip = np.zeros(pad, np.int32)
        ip[:len(ix)] = ix
        idx_pad.append(ip)
    flat_d = _sel_gather_jit()(tuple(srcs), tuple(idx_pad))
    return flat_d, anchors, idx_pad, srcs


class SelectedFlat:
    """Winner coefficient values as ONE flat int32 array (anchor-major,
    then channel-major, covered-prefix zeros included), with per-anchor
    (by, bx, sid) arrays in raster order.  The token writers consume
    this directly; `as_map()` materializes the legacy per-block dict
    for the Python oracle paths."""

    __slots__ = ("bys", "bxs", "sids", "sizes", "offs", "vals")

    def __init__(self, bys, bxs, sids, sizes, offs, vals):
        self.bys, self.bxs, self.sids = bys, bxs, sids
        self.sizes = sizes            # num_coeffs per anchor
        self.offs = offs              # int64 (n+1,) into vals, 3*size
        self.vals = vals              # int32 flat

    def transform(self, fn):
        """New SelectedFlat with fn applied to the value array."""
        return SelectedFlat(self.bys, self.bxs, self.sids, self.sizes,
                            self.offs, fn(self.vals))

    def as_map(self):
        vals_map = {}
        for i in range(len(self.bys)):
            sz = int(self.sizes[i])
            v = self.vals[int(self.offs[i]):int(self.offs[i + 1])] \
                .astype(np.int64).reshape(3, sz)
            vals_map[(int(self.bys[i]), int(self.bxs[i]))] = \
                {c: v[c] for c in range(3)}
        return vals_map


def fetch_selected_fetch(pending):
    """Block on a fetch_selected_dispatch handle; returns a
    SelectedFlat (vectorized scatter per source — the per-anchor dict
    build was an encoder hotspot)."""
    flat_d, anchors, idx_pad, srcs = pending
    flat = np.asarray(flat_d)
    bys_l, bxs_l, sids_l, sizes_l = [], [], [], []
    scat = []       # (rows (m, 3, tlen), cov, tlen, first_idx)
    off = 0
    for (sid, cov, pos), ip, src in zip(anchors, idx_pad, srcs):
        tlen = int(src.shape[-1])
        m = len(pos)
        rows = flat[off:off + len(ip) * 3 * tlen].reshape(
            len(ip), 3, tlen)[:m]
        off += len(ip) * 3 * tlen
        if m:
            pa = np.asarray(pos, np.int64).reshape(m, 2)
            bys_l.append(pa[:, 0])
            bxs_l.append(pa[:, 1])
            sids_l.append(np.full(m, sid, np.int32))
            sizes_l.append(np.full(m, cov + tlen, np.int64))
            scat.append((rows, cov, tlen, sum(len(b) for b in bys_l[:-1])))
    if not bys_l:
        z = np.zeros(0, np.int64)
        return SelectedFlat(z, z, z.astype(np.int32), z,
                            np.zeros(1, np.int64), np.zeros(0, np.int32))
    bys = np.concatenate(bys_l)
    bxs = np.concatenate(bxs_l)
    sids = np.concatenate(sids_l)
    sizes = np.concatenate(sizes_l)
    # raster order across sources
    order = np.argsort(bys * (bxs.max() + 1) + bxs, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    bys, bxs, sids, sizes = bys[order], bxs[order], sids[order], \
        sizes[order]
    offs = np.zeros(len(bys) + 1, np.int64)
    np.cumsum(3 * sizes, out=offs[1:])
    vals = np.zeros(int(offs[-1]), np.int32)
    for rows, cov, tlen, first in scat:
        m = rows.shape[0]
        dst = offs[inv[first:first + m]]
        idx = (dst[:, None, None]
               + np.arange(3)[None, :, None] * (cov + tlen)
               + cov + np.arange(tlen)[None, None, :])
        vals[idx] = rows
    return SelectedFlat(bys, bxs, sids, sizes, offs, vals)


def fetch_selected(vals_list, meta, acs_map):
    """Synchronous winner gather (dispatch + fetch)."""
    return fetch_selected_fetch(
        fetch_selected_dispatch(vals_list, meta, acs_map))


def run_costs(planes, co, qf_map, fx_blk, fb_blk, dq_dc, igs, lam,
              cands, deadzone):
    """Synchronous stage 2 with full host materialization (tests /
    compatibility; the encode path uses dispatch/fetch +
    fetch_selected).  Returns (vals8, cost8, {sid: (vals, cost, qf)})."""
    pending = run_costs_dispatch(planes, co, qf_map, fx_blk, fb_blk,
                                 dq_dc, igs, lam, cands, deadzone)
    cost8, cost_data, vals_list, meta = run_costs_fetch(pending)
    ys_b, xs_b = qf_map.shape
    vals8 = np.zeros((ys_b, xs_b, 3, 64), np.int64)
    vals8[..., 1:] = np.asarray(vals_list[0]).reshape(ys_b, xs_b, 3, 63)
    cand_data = {}
    for k, (sid, cy, cx, nyc, nxc, cov) in enumerate(meta):
        tail = np.asarray(vals_list[k + 1])
        vals = np.zeros(tail.shape[:3] + (cov + tail.shape[3],),
                        np.int64)
        vals[..., cov:] = tail
        cost, qfm = cost_data[sid]
        cand_data[sid] = (vals, cost, qfm)
    return vals8, cost8, cand_data
