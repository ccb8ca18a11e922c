"""Craft real-format VarDCT streams (single group, any strategy mix,
filters controllable) and feed them to libjxl — the numerical oracle
for dequant tables, transform conventions and scan orders.
"""
import sys, os
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ.setdefault("JXL_NO_NATIVE", "1")

import numpy as np

from jxl_coder.bitstream.writer import BitWriter
from jxl_coder.bitstream.reader import pack_signed
from jxl_coder.bitstream.headers import (ImageHeader, ImageMetadata,
                                             SizeHeader)
from jxl_coder.bitstream.frame_header import (FrameHeader, Encoding,
                                                  write_frame_header,
                                                  write_toc)
from jxl_coder.codec import write_image_header
from jxl_coder.entropy.coder import TokenStream
from jxl_coder.modular.image import Channel, ModularImage
from jxl_coder.modular.stream import GroupHeader, encode_modular_stream
from jxl_coder.modular.tree import Tree
from jxl_coder.vardct.strategies import STRATEGIES
from jxl_coder.vardct.dec_real import (nonzero_ctx, zero_density_ctx,
                                           DEFAULT_CTX_MAP)

NUM_CTXS = 15  # default block ctx map


def block_context(qf, ord_, c):
    idx = (c ^ 1) if c < 2 else 2
    idx = idx * 13 + ord_
    return DEFAULT_CTX_MAP[idx]


def write_ac_group(ts, varblocks, xs_b, ys_b):
    """varblocks: list of (bx, by, strategy_id, {c: scan_values}).
    Values are scan-indexed ints (slots [0, covered) ignored)."""
    anchors = {(vb[1], vb[0]): vb for vb in varblocks}
    nz_map = np.zeros((3, ys_b, xs_b), np.int32)
    covered = np.zeros((ys_b, xs_b), bool)
    qf_by_anchor = {}
    for by in range(ys_b):
        for bx in range(xs_b):
            if covered[by, bx]:
                continue
            vb = anchors.get((by, bx))
            if vb is None:
                raise ValueError(f"no varblock at anchor ({by},{bx})")
            _, _, sid, chans, qf = vb[0], vb[1], vb[2], vb[3], vb[4]
            s = STRATEGIES[sid]
            covered[by:by + s.cy, bx:bx + s.cx] = True
            cov, size, log2cov = s.covered, s.num_coeffs, s.log2_covered
            for c in (1, 0, 2):
                vals = chans[c]
                if by == 0:
                    predicted = 32 if bx == 0 else int(nz_map[c, by, bx - 1])
                elif bx == 0:
                    predicted = int(nz_map[c, by - 1, bx])
                else:
                    predicted = (int(nz_map[c, by - 1, bx])
                                 + int(nz_map[c, by, bx - 1]) + 1) // 2
                bctx = block_context(qf, s.order_bucket, c)
                nz = int(np.count_nonzero(vals[cov:]))
                nz_map[c, by:by + s.cy, bx:bx + s.cx] = \
                    (nz + cov - 1) >> log2cov
                ts.add(nonzero_ctx(predicted, bctx, NUM_CTXS), nz)
                ctx_off = NUM_CTXS * 37 + 458 * bctx
                prev = 0 if nz > (size >> 4) else 1
                nzeros = nz
                k = cov
                while nzeros > 0:
                    v = int(vals[k])
                    ctx = ctx_off + zero_density_ctx(nzeros, k, cov,
                                                     log2cov, prev)
                    ts.add(ctx, pack_signed(v))
                    prev = 1 if v else 0
                    nzeros -= prev
                    k += 1


def modular_substream(channels, predictor=0):
    bw = BitWriter()
    img = ModularImage(list(channels))
    tree = Tree.single_leaf(predictor=predictor)
    encode_modular_stream(bw, img, GroupHeader(), tree)
    return bw


def craft_blocks(dc, varblocks, gs=65536, qdc=16, W=64, H=64,
                 x_qm_scale=2, b_qm_scale=2, epf_iters=0, sharpness=0,
                 gab=False, splines=None, dct8_flat_weight=None,
                 dc_smoothing=False, extra_precision=0):
    """dc: (3, H/8, W/8) ints (Y, X, B).  varblocks: list of
    (bx, by, strategy_id, {c: scan_values}, qf) covering the grid."""
    ys_b, xs_b = H // 8, W // 8
    m = ImageMetadata()
    hdr = ImageHeader(size=SizeHeader(xsize=W, ysize=H), metadata=m)
    flags = (0 if dc_smoothing else 128) \
        | (0x10 if splines is not None else 0)
    fh = FrameHeader(encoding=Encoding.VARDCT, flags=flags,
                     x_qm_scale=x_qm_scale, b_qm_scale=b_qm_scale)
    fh.restoration_filter.gab = gab
    fh.restoration_filter.epf_iters = epf_iters

    sec = BitWriter()
    # LfGlobal
    if splines is not None:
        splines.write(sec)
    sec.bool(True)
    sec.u32(gs, (11, 1), (11, 2049), (12, 4097), (16, 8193))
    sec.u32(qdc, 16, (5, 1), (8, 1), (16, 1))
    sec.bool(True)    # default block ctx map
    sec.bool(True)    # cfl DC default
    sec.bool(False)   # no global tree
    # LfGroup
    sec.u(extra_precision, 2)
    dcw = modular_substream([
        Channel(xs_b, ys_b,
                data=np.ascontiguousarray(dc[i], np.int32).copy())
        for i in range(3)])
    sec.append_writer(dcw)
    nb = len(varblocks)
    upper = xs_b * ys_b
    cb = (upper - 1).bit_length() if upper > 1 else 0
    sec.u(nb - 1, cb)
    # blockinfo in anchor raster order
    order = sorted(varblocks, key=lambda vb: (vb[1], vb[0]))
    blockinfo = np.zeros((2, nb), np.int32)
    for i, vb in enumerate(order):
        blockinfo[0, i] = vb[2]
        blockinfo[1, i] = vb[4] - 1
    cw, ch = -(-xs_b // 8), -(-ys_b // 8)
    acmw = modular_substream([
        Channel(cw, ch, hshift=3, vshift=3,
                data=np.zeros((ch, cw), np.int32)),
        Channel(cw, ch, hshift=3, vshift=3,
                data=np.zeros((ch, cw), np.int32)),
        Channel(nb, 2, data=blockinfo),
        Channel(xs_b, ys_b,
                data=(np.ascontiguousarray(sharpness, np.int32)
                      if isinstance(sharpness, np.ndarray) else
                      np.full((ys_b, xs_b), sharpness, np.int32)))])
    sec.append_writer(acmw)
    # HfGlobal
    if dct8_flat_weight is None:
        sec.bool(True)
    else:
        # custom dequant: DCT8 table in kQuantModeDCT with one flat
        # band => uniform AC step 1/(64*w), independent of sigma —
        # used by the EPF asymptotic-kernel probes
        sec.bool(False)
        from jxl_coder.vardct.quant_tables import NUM_QUANT_TABLES
        for i in range(NUM_QUANT_TABLES):
            if i == 0:
                sec.u(6, 3)           # MODE_DCT
                sec.u(0, 4)           # one band
                for _c in range(3):
                    sec.f16(dct8_flat_weight)
            else:
                sec.u(0, 3)           # MODE_LIBRARY
    sec.u32(0, 0x5F, 0x13, 0, (13, 0))
    ts = TokenStream(NUM_CTXS * (37 + 458))
    write_ac_group(ts, order, xs_b, ys_b)
    ts.write(sec)
    sec.zero_pad_to_byte()
    payload = sec.to_bytes()
    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(payload)])
    return bw.to_bytes() + payload


def craft(dc, coeffs, gs=65536, qdc=16, qf=16, W=64, H=64,
          x_qm_scale=2, b_qm_scale=2):
    """Back-compat DCT8-only interface: coeffs (3, by, bx, 64) in
    STORED layout; converted to scan-index via zigzag."""
    from jxl_coder.vardct.dec_real import ZIGZAG8
    ys_b, xs_b = H // 8, W // 8
    varblocks = []
    for by in range(ys_b):
        for bx in range(xs_b):
            chans = {}
            for c in range(3):
                vals = np.zeros(64, np.int64)
                for p in range(1, 64):
                    vals[p] = coeffs[c, by, bx, ZIGZAG8[p]]
                chans[c] = vals
            varblocks.append((bx, by, 0, chans, qf))
    return craft_blocks(dc, varblocks, gs=gs, qdc=qdc, W=W, H=H,
                        x_qm_scale=x_qm_scale, b_qm_scale=b_qm_scale)


if __name__ == "__main__":
    import refjxl
    dc = np.zeros((3, 8, 8), np.int64)
    coeffs = np.zeros((3, 8, 8, 64), np.int64)
    data = craft(dc, coeffs)
    print("stream:", len(data), "bytes")
    out, info = refjxl.decode(data)
    print("decoded:", out.shape, "uniq:", np.unique(out))
    # multi-strategy smoke: one DCT16X16 + 60 DCT8
    vbs = [(0, 0, 4, {c: np.zeros(256, np.int64) for c in range(3)}, 16)]
    for by in range(8):
        for bx in range(8):
            if bx < 2 and by < 2:
                continue
            vbs.append((bx, by, 0,
                        {c: np.zeros(64, np.int64) for c in range(3)}, 16))
    data = craft_blocks(dc, vbs)
    out, info = refjxl.decode(data)
    print("mixed:", out.shape, "uniq:", np.unique(out))
