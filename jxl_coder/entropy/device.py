"""Device-side entropy decode for VarDCT AC pass groups.

The SURVEY's #1 hard part (rANS on the device): per-group rANS streams are
independent, so G groups decode in LOCKSTEP — one lane per group — with
a jitted `lax.while_loop` whose body decodes exactly one hybrid-uint
token per active lane (rANS alias-table step + renormalization + raw
bits), drives the per-lane AC context state machine (nonzero counts,
zero-density runs, neighbour prediction), and scatters coefficients
into a device-resident output buffer.

Everything data-independent is precomputed on host from headers the
host parses anyway (the AC strategy/qf maps decoded in LF groups):
per-block contexts, neighbour owner ids, output offsets, alias tables
expanded to dense 4096-entry LUTs, cluster maps and hybrid-uint
configs.  The device consumes only the raw section BYTES (the ~1 MB
compressed stream instead of the ~100 MB dequantized coefficients the
host path uploads), so this is also the h2d bandwidth fix for the
end-to-end path.

Bit-exactness: this mirrors entropy.ans.AnsState.read_symbol /
coder.HybridUintConfig.read_value / vardct.dec_real.read_pass_group
operation-for-operation; tests compare coefficient-for-coefficient
against the host decoder on real libjxl streams.

Reference semantics: the event-loop hot path of
/root/reference/jxlcoder/src/main/cpp/interop/JxlDecoding.cpp:74-175
(group rANS decode inside libjxl.so, threaded on CPU) — re-expressed
as SPMD lanes on the device.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from .. import backend
from .ans import ANS_TAB_SIZE, ANS_LOG_TAB_SIZE, ANS_SIGNATURE

_SIG_STATE = ANS_SIGNATURE << 16


def entropy_device_enabled() -> bool:
    """Device entropy decode is opt-in: JXL_ENTROPY=1.

    The lockstep kernel is the bit-exact reference for on-device
    entropy decode; it becomes the default only if it beats the host
    C++ path end to end on the GPU (not measured yet, ROADMAP A5).
    Production decode overlaps host entropy with device
    reconstruction instead (api.decode_batch)."""
    return backend.knob("JXL_ENTROPY", "0") not in ("", "0")


# --------------------------------------------------------------------------
# Host-side packing


def pack_code(code) -> Optional[dict]:
    """EntropyCode -> dense device tables, or None when the stream uses
    a backend the device path doesn't cover (prefix codes, LZ77)."""
    if code.use_prefix or code.lz77.enabled:
        return None
    ncl = len(code.alias_tables)
    sym = np.empty((ncl, ANS_TAB_SIZE), np.int32)
    off = np.empty((ncl, ANS_TAB_SIZE), np.int32)
    freq = np.empty((ncl, ANS_TAB_SIZE), np.int32)
    idx = np.arange(ANS_TAB_SIZE)
    for ci, t in enumerate(code.alias_tables):
        bucket = idx >> t.log_entry
        pos = idx & (t.entry_size - 1)
        cut = np.asarray(t.cutoffs, np.int32)[bucket]
        right = np.asarray(t.right, np.int32)[bucket]
        offs = np.asarray(t.offsets, np.int32)[bucket]
        greater = pos >= cut
        s = np.where(greater, right, bucket)
        sym[ci] = s
        off[ci] = np.where(greater, offs + pos - cut, pos)
        fr = np.asarray(t.freq, np.int32)
        freq[ci] = fr[np.minimum(s, len(fr) - 1)]
    return dict(
        cluster_map=np.asarray(code.cluster_map, np.int32),
        sym=sym.reshape(-1), off=off.reshape(-1), freq=freq.reshape(-1),
        cfg_se=np.asarray([c.split_exponent for c in code.configs],
                          np.int32),
        cfg_msb=np.asarray([c.msb_in_token for c in code.configs],
                           np.int32),
        cfg_lsb=np.asarray([c.lsb_in_token for c in code.configs],
                           np.int32),
    )


def build_group_schedule(lf, sub, gw: int, gh: int, dc_q, hf) -> dict:
    """Host-known control data for one group's AC token stream: the
    block schedule in decode order with per-(block, channel-slot)
    contexts, output offsets, and neighbour owner ids (the only
    data-dependent context input is the decoded nonzero count, which
    lives on device).  Mirrors dec_real.read_pass_group's control flow.
    """
    from ..vardct.strategies import STRATEGIES
    from ..vardct.dec_real import (dc_context_idx, NONZERO_BUCKETS,
                                   ZERO_DENSITY_CTX_COUNT,
                                   BitstreamError)
    bcm = lf.bcm
    num_ctxs = bcm.num_ctxs
    owner = np.full((gh, gw), -1, np.int32)
    size_l: List[int] = []
    cov_l: List[int] = []
    l2c_l: List[int] = []
    bctx_l: List[List[int]] = []
    pmode_l: List[int] = []
    left_l: List[int] = []
    top_l: List[int] = []
    sid_l: List[int] = []
    pos_l: List[tuple] = []
    bid = 0
    for by in range(gh):
        for bx in range(gw):
            acs = int(sub.acs_map[by, bx])
            if acs < 0:
                continue
            strat = STRATEGIES.get(acs)
            if strat is None:
                raise BitstreamError("invalid AC strategy %d" % acs)
            qf = int(sub.qf_map[by, bx])
            dc_idx = dc_context_idx(
                bcm, (dc_q[1, by, bx], dc_q[0, by, bx], dc_q[2, by, bx]))
            bctx_l.append([bcm.context(dc_idx, qf, strat.order_bucket, c)
                           for c in (1, 0, 2)])
            size_l.append(strat.num_coeffs)
            cov_l.append(strat.covered)
            l2c_l.append(strat.log2_covered)
            sid_l.append(acs)
            pos_l.append((by, bx))
            left_l.append(int(owner[by, bx - 1]) if bx > 0 else -1)
            top_l.append(int(owner[by - 1, bx]) if by > 0 else -1)
            if by == 0 and bx == 0:
                pmode_l.append(0)       # constant 32
            elif by == 0:
                pmode_l.append(1)       # left
            elif bx == 0:
                pmode_l.append(2)       # top
            else:
                pmode_l.append(3)       # (left + top + 1) // 2
            owner[by:by + strat.cy, bx:bx + strat.cx] = bid
            bid += 1
    nblk = bid
    size = np.asarray(size_l, np.int32)
    # output base offsets: (block, slot) in decode order, slot-major
    # within a block (channels decode (1, 0, 2) = slots 0, 1, 2)
    outb = np.zeros((nblk, 3), np.int32)
    csum = 0
    for b in range(nblk):
        for s in range(3):
            outb[b, s] = csum
            csum += int(size[b])
    return dict(
        nblk=nblk, total=csum,
        size=size, cov=np.asarray(cov_l, np.int32),
        l2c=np.asarray(l2c_l, np.int32),
        bctx=np.asarray(bctx_l, np.int32),       # (nblk, 3) raw bctx
        pmode=np.asarray(pmode_l, np.int32),
        left=np.asarray(left_l, np.int32),
        top=np.asarray(top_l, np.int32),
        outb=outb, sid=np.asarray(sid_l, np.int32),
        pos=np.asarray(pos_l, np.int32),
    )


def _pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << int(n - 1).bit_length())


class GroupInput:
    """One group's stream input: section bytes + host-read prologue."""

    __slots__ = ("buf_words", "init_state", "start_bit", "ctx_base",
                 "sched")

    def __init__(self, section_bytes: bytes, histo_bits: int,
                 num_ctxs: int, sched: dict):
        from ..bitstream.reader import BitReader
        from ..vardct.dec_real import (NONZERO_BUCKETS,
                                       ZERO_DENSITY_CTX_COUNT)
        br = BitReader(section_bytes)
        histo_index = br.u(histo_bits) if histo_bits else 0
        self.init_state = br.u(32)
        self.start_bit = histo_bits + 32
        self.ctx_base = histo_index * num_ctxs * (
            NONZERO_BUCKETS + ZERO_DENSITY_CTX_COUNT)
        pad = (-len(section_bytes)) % 4 + 8
        self.buf_words = np.frombuffer(
            section_bytes + b"\0" * pad, "<u4")
        self.sched = sched


# --------------------------------------------------------------------------
# Device kernel

_KNZ = None
_KFREQ = None
_NZLUT = None


def _luts():
    global _KNZ, _KFREQ, _NZLUT
    if _KNZ is None:
        from ..vardct.dec_real import K_NUM_NZ_CTX, K_COEFF_FREQ_CTX
        _KNZ = np.asarray(K_NUM_NZ_CTX, np.int32)
        kf = np.asarray(K_COEFF_FREQ_CTX, np.int32)
        kf[0] = 0  # index 0 is never used (k >= covered >= 1)
        _KFREQ = kf
        p = np.arange(65)
        _NZLUT = np.where(p < 8, p, 4 + p // 2).astype(np.int32)
    return _KNZ, _KFREQ, _NZLUT


@functools.lru_cache(maxsize=64)
def _compiled_kernel(G: int, maxB: int, Lw: int, chunk: int,
                     num_ctxs: int):
    """One lockstep chunk: lax.scan over `chunk` steps, each decoding
    one token per active lane.  Decoded tokens stream out through the
    scan ys as (value, write-position) logs — nothing frame-sized lives
    in the carry (XLA may copy loop carries per iteration, so a carried
    output buffer would be rewritten every step)."""
    import jax
    import jax.numpy as jnp

    backend.use_compile_cache()
    knz_t, kfreq_t, nzlut_t = (jnp.asarray(t) for t in _luts())
    u32 = jnp.uint32
    i32 = jnp.int32
    ar = jnp.arange(G)

    def read_window(bufs, bit):
        """32-bit little-endian window at per-lane bit offsets."""
        wi = jnp.minimum(bit >> 5, Lw - 2)
        w0 = jnp.take_along_axis(bufs, wi[:, None], 1)[:, 0]
        w1 = jnp.take_along_axis(bufs, wi[:, None] + 1, 1)[:, 0]
        sh = (bit & 31).astype(u32)
        low = w0 >> sh
        high = jnp.where(sh == 0, u32(0), w1 << (u32(32) - sh))
        return low | high

    def fn(carry0, bufs, nblk, size_a, cov_a, l2c_a,
           bctx_a, zdoff_a, outb_a, pmode_a, left_a, top_a,
           cluster_map, sym_t, off_t, freq_t, cfg_se, cfg_msb, cfg_lsb):

        def body(c, _):
            (st, bit, bi, ph, mode, k, nzeros, prev, err, done,
             nzh) = c
            active = ~(done | err)
            bi_c = jnp.minimum(bi, maxB - 1)
            size = jnp.take_along_axis(size_a, bi_c[:, None], 1)[:, 0]
            cov = jnp.take_along_axis(cov_a, bi_c[:, None], 1)[:, 0]
            l2c = jnp.take_along_axis(l2c_a, bi_c[:, None], 1)[:, 0]
            slot = bi_c * 3 + ph
            bctxv = jnp.take_along_axis(bctx_a, slot[:, None], 1)[:, 0]
            zdoff = jnp.take_along_axis(zdoff_a, slot[:, None], 1)[:, 0]
            outb = jnp.take_along_axis(outb_a, slot[:, None], 1)[:, 0]
            # ---- context ----
            lid = jnp.take_along_axis(left_a, bi_c[:, None], 1)[:, 0]
            tid = jnp.take_along_axis(top_a, bi_c[:, None], 1)[:, 0]
            pm = jnp.take_along_axis(pmode_a, bi_c[:, None], 1)[:, 0]
            lval = jnp.take_along_axis(
                nzh, (ph * (maxB + 1) + lid + 1)[:, None], 1)[:, 0]
            tval = jnp.take_along_axis(
                nzh, (ph * (maxB + 1) + tid + 1)[:, None], 1)[:, 0]
            pred = jnp.where(
                pm == 0, 32,
                jnp.where(pm == 1, lval,
                          jnp.where(pm == 2, tval,
                                    (lval + tval + 1) >> 1)))
            pred = jnp.minimum(pred, 64)
            ctx_nz = bctxv + jnp.take(nzlut_t, pred) * num_ctxs
            nzl = jnp.clip((nzeros + cov - 1) >> l2c, 0, 63)
            kk = jnp.clip(k >> l2c, 0, 63)
            ctx_zd = zdoff + (jnp.take(knz_t, nzl)
                              + jnp.take(kfreq_t, kk)) * 2 + prev
            is_nz = mode == 0
            ctx = jnp.where(active, jnp.where(is_nz, ctx_nz, ctx_zd), 0)
            cl = jnp.take(cluster_map, ctx)
            # ---- rANS symbol (ans.AnsState.read_symbol) ----
            idx = (st & u32(ANS_TAB_SIZE - 1)).astype(i32)
            flat = cl * ANS_TAB_SIZE + idx
            sym = jnp.take(sym_t, flat)
            soff = jnp.take(off_t, flat)
            sfreq = jnp.take(freq_t, flat)
            st2 = (sfreq.astype(u32) * (st >> ANS_LOG_TAB_SIZE)
                   + soff.astype(u32))
            need = st2 < u32(1 << 16)
            w16 = read_window(bufs, bit) & u32(0xFFFF)
            st2 = jnp.where(need, (st2 << 16) | w16, st2)
            st2 = jnp.where(active, st2, st)
            bit = bit + jnp.where(need & active, 16, 0)
            # ---- hybrid uint (coder.HybridUintConfig.read_value) ----
            se = jnp.take(cfg_se, cl)
            msb = jnp.take(cfg_msb, cl)
            lsb = jnp.take(cfg_lsb, cl)
            split = jnp.left_shift(1, se)
            big = sym >= split
            nbits = se - (msb + lsb) + ((sym - split) >> (msb + lsb))
            nbits = jnp.where(big, nbits, 0)
            err = err | (active & (nbits >= 32))
            nbits = jnp.clip(nbits, 0, 31)
            raw = (read_window(bufs, bit)
                   & ((u32(1) << nbits.astype(u32)) - 1)).astype(i32)
            low = sym & (jnp.left_shift(1, lsb) - 1)
            msbits = ((sym >> lsb) & (jnp.left_shift(1, msb) - 1)) \
                | jnp.left_shift(1, msb)
            bigval = jnp.left_shift(
                jnp.left_shift(msbits, nbits) | raw, lsb) | low
            value = jnp.where(big, bigval, sym)
            bit = bit + jnp.where(active & big, nbits, 0)
            # ---- semantic update ----
            upd_nz = active & is_nz
            upd_cf = active & ~is_nz
            nz = value
            err = err | (upd_nz & (nz >= size - cov + 1))
            spread = (nz + cov - 1) >> l2c
            hslot = ph * (maxB + 1) + bi_c + 1
            old = jnp.take_along_axis(nzh, hslot[:, None], 1)[:, 0]
            nzh = nzh.at[ar, hslot].set(
                jnp.where(upd_nz, spread, old))
            # unpack_signed (§A.4)
            vv = jnp.where(value & 1, -((value + 1) >> 1), value >> 1)
            nonzero = (value != 0).astype(i32)
            wpos = jnp.where(upd_cf, outb + k, -1)
            nzeros = jnp.where(upd_cf, nzeros - nonzero,
                               jnp.where(upd_nz, nz, nzeros))
            k2 = jnp.where(upd_cf, k + 1, jnp.where(upd_nz, cov, k))
            prev = jnp.where(upd_cf, nonzero,
                             jnp.where(upd_nz,
                                       jnp.where(nz > (size >> 4), 0, 1),
                                       prev))
            mode = jnp.where(upd_nz, 1, mode)
            err = err | (active & (mode == 1) & (nzeros > 0)
                         & (k2 >= size))
            # ---- advance phase / block ----
            adv = active & (mode == 1) & (nzeros == 0)
            ph2 = jnp.where(adv, ph + 1, ph)
            mode = jnp.where(adv, 0, mode)
            bi2 = jnp.where(ph2 == 3, bi + 1, bi)
            ph2 = jnp.where(ph2 == 3, 0, ph2)
            done = done | (active & (bi2 >= nblk))
            return ((st2, bit, bi2, ph2, mode, k2, nzeros, prev, err,
                     done, nzh), (vv, wpos))

        carry, ys = jax.lax.scan(body, carry0, None, length=chunk)
        st_f, err_f, done_f = carry[0], carry[8], carry[9]
        ok = done_f & (~err_f) & (st_f == u32(_SIG_STATE))
        all_done = jnp.all(done_f | err_f)
        return carry, ys[0], ys[1], ok, all_done

    return jax.jit(fn)


def decode_pass_groups_device(pack: dict, groups: List[GroupInput],
                              num_ctxs: int, chunk: int = 8192):
    """Decode G group streams in lockstep on device, in chunks of
    `chunk` tokens per lane with early exit between chunks.

    Returns (out, ok): out is (G, Cmax) int32 scan-order coefficients
    (numpy; the device streams (value, position) token logs and the
    host places them with one vectorized assignment per chunk), ok a
    (G,) bool numpy array (final-state + bounds checks per lane)."""
    import jax
    import jax.numpy as jnp
    from ..vardct.dec_real import NONZERO_BUCKETS, ZERO_DENSITY_CTX_COUNT

    G0 = len(groups)
    G = max(8, -(-G0 // 8) * 8)
    maxB = _pow2(max(g.sched["nblk"] for g in groups), lo=8)
    Lw = _pow2(max(len(g.buf_words) for g in groups), lo=16)
    Cmax = max(g.sched["total"] for g in groups)

    bufs = np.zeros((G, Lw), np.uint32)
    init_state = np.zeros(G, np.uint32)
    start_bit = np.zeros(G, np.int32)
    nblk = np.zeros(G, np.int32)
    size_a = np.ones((G, maxB), np.int32)
    cov_a = np.ones((G, maxB), np.int32)
    l2c_a = np.zeros((G, maxB), np.int32)
    bctx_a = np.zeros((G, maxB * 3), np.int32)
    zdoff_a = np.zeros((G, maxB * 3), np.int32)
    outb_a = np.zeros((G, maxB * 3), np.int32)
    pmode_a = np.zeros((G, maxB), np.int32)
    left_a = np.full((G, maxB), -1, np.int32)
    top_a = np.full((G, maxB), -1, np.int32)
    for gi, g in enumerate(groups):
        s = g.sched
        n = s["nblk"]
        bufs[gi, :len(g.buf_words)] = g.buf_words
        init_state[gi] = g.init_state
        start_bit[gi] = g.start_bit
        nblk[gi] = n
        size_a[gi, :n] = s["size"]
        cov_a[gi, :n] = s["cov"]
        l2c_a[gi, :n] = s["l2c"]
        bctx_a[gi, :n * 3] = (g.ctx_base + s["bctx"]).reshape(-1)
        zdoff_a[gi, :n * 3] = (
            g.ctx_base + num_ctxs * NONZERO_BUCKETS
            + ZERO_DENSITY_CTX_COUNT * s["bctx"]).reshape(-1)
        outb_a[gi, :n * 3] = s["outb"].reshape(-1)
        pmode_a[gi, :n] = s["pmode"]
        left_a[gi, :n] = s["left"]
        top_a[gi, :n] = s["top"]

    fn = _compiled_kernel(G, maxB, Lw, chunk, num_ctxs)
    zero = jnp.zeros(G, jnp.int32)
    carry = (jnp.asarray(init_state), jnp.asarray(start_bit.astype(
        np.int32)), zero, zero, zero, zero, zero, zero,
        jnp.zeros(G, bool), jnp.asarray(nblk <= 0), jnp.zeros(
            (G, 3 * (maxB + 1)), jnp.int32))
    args = (jnp.asarray(bufs), jnp.asarray(nblk),
            jnp.asarray(size_a), jnp.asarray(cov_a), jnp.asarray(l2c_a),
            jnp.asarray(bctx_a), jnp.asarray(zdoff_a),
            jnp.asarray(outb_a), jnp.asarray(pmode_a),
            jnp.asarray(left_a), jnp.asarray(top_a),
            jnp.asarray(pack["cluster_map"]),
            jnp.asarray(pack["sym"]), jnp.asarray(pack["off"]),
            jnp.asarray(pack["freq"]), jnp.asarray(pack["cfg_se"]),
            jnp.asarray(pack["cfg_msb"]), jnp.asarray(pack["cfg_lsb"]))
    out = np.zeros((G0, Cmax), np.int32)
    ok = None
    step_limit = 3 * maxB + Cmax + 64
    garange = np.arange(G0)
    for _ in range(step_limit // chunk + 1):
        carry, vals, poss, okd, all_done = fn(carry, *args)
        vals = np.asarray(vals)       # (chunk, G)
        poss = np.asarray(poss)
        # host placement: every coefficient token wrote (pos, val)
        m = poss[:, :G0] >= 0
        s_idx, g_idx = np.nonzero(m)
        out[g_idx, poss[s_idx, g_idx]] = vals[s_idx, g_idx]
        if bool(all_done):
            ok = np.asarray(okd)[:G0]
            break
    if ok is None:
        ok = np.asarray(okd)[:G0] & False  # step limit blown: all bad
    return out, ok


def unpack_to_blockarrays(out_row: np.ndarray, sched: dict, hf,
                          pass_index: int):
    """Scan-order device output -> flat BlockArrays (order permutation
    applied per (pass, order-bucket, channel) as read_pass_group does),
    fully vectorized per strategy family — the device-entropy tokens
    never become per-block Python objects (VERDICT r2 weak #2)."""
    from ..vardct.dec_real import BlockArrays
    from ..vardct.strategies import STRATEGIES
    n = int(sched["nblk"])
    sid_a = np.asarray(sched["sid"][:n], np.int32)
    size_a = np.asarray(sched["size"][:n], np.int32)
    cov_a = np.asarray(sched["cov"][:n], np.int32)
    pos = np.asarray(sched["pos"][:n])
    outb = np.asarray(sched["outb"][:n])        # (n, 3) slots (1, 0, 2)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(3 * size_a.astype(np.int64), out=offs[1:])
    coeffs = np.zeros(max(int(offs[-1]), 1), np.int32)
    # device output slots are channel order (1, 0, 2); BlockArrays
    # stores channels 0, 1, 2 -> source slot per channel:
    slot_of_c = (1, 0, 2)
    for sid in np.unique(sid_a).tolist():
        sel = np.nonzero(sid_a == sid)[0]
        size = int(size_a[sel[0]])
        cov = int(cov_a[sel[0]])
        strat = STRATEGIES[int(sid)]
        k = size - cov
        ks = np.arange(cov, size)
        for c in range(3):
            src = outb[sel, slot_of_c[c]][:, None] + ks[None, :]
            vals = out_row[src]                  # (m, k)
            order = hf.orders.get((pass_index, strat.order_bucket, c))
            destk = order[cov:] if order is not None else ks
            dest = (offs[sel][:, None] + c * size
                    + np.asarray(destk, np.int64)[None, :])
            coeffs[dest] = vals
    return BlockArrays(sid_a, pos[:, 1].astype(np.int32),
                       pos[:, 0].astype(np.int32), size_a, offs, coeffs)
