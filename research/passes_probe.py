import numpy as np, sys
sys.path.insert(0, '/root/repo'); sys.path.insert(0, '/root/repo/research')
import vardct_write as VW
from jxl_coder.bitstream.writer import BitWriter
from jxl_coder.bitstream.headers import ImageHeader, ImageMetadata, SizeHeader
from jxl_coder.bitstream.frame_header import (FrameHeader, Encoding, Passes,
    write_frame_header, write_toc)
from jxl_coder.codec import write_image_header
from jxl_coder.entropy.coder import TokenStream
from jxl_coder.modular.image import Channel
from jxl_coder.vardct.enc_real import NUM_CTXS

def craft_two_pass(dc, varblocks, shift=1, gs=65536, qdc=16, W=64, H=64):
    """varblocks: (bx, by, strategy, {c: scan vals (TOTAL)}, qf); values
    split into pass0 = v >> shift (arithmetic), pass1 = v - (p0 << shift)."""
    ys_b, xs_b = H // 8, W // 8
    m = ImageMetadata()
    hdr = ImageHeader(size=SizeHeader(xsize=W, ysize=H), metadata=m)
    fh = FrameHeader(encoding=Encoding.VARDCT, flags=128,
                     x_qm_scale=2, b_qm_scale=2)
    fh.passes = Passes(num_passes=2, num_downsample=0, shift=[shift])
    fh.restoration_filter.gab = False
    fh.restoration_filter.epf_iters = 0
    # LfGlobal
    lfg = BitWriter()
    lfg.bool(True)
    lfg.u32(gs, (11, 1), (11, 2049), (12, 4097), (16, 8193))
    lfg.u32(qdc, 16, (5, 1), (8, 1), (16, 1))
    lfg.bool(True); lfg.bool(True); lfg.bool(False)
    lfg.zero_pad_to_byte()
    # LfGroup
    lgw = BitWriter()
    lgw.u(0, 2)
    lgw.append_writer(VW.modular_substream([
        Channel(xs_b, ys_b, data=np.ascontiguousarray(dc[i], np.int32).copy())
        for i in range(3)]))
    nb = len(varblocks)
    upper = xs_b * ys_b
    cb = (upper - 1).bit_length() if upper > 1 else 0
    lgw.u(nb - 1, cb)
    order = sorted(varblocks, key=lambda vb: (vb[1], vb[0]))
    blockinfo = np.zeros((2, nb), np.int32)
    for i, vb in enumerate(order):
        blockinfo[0, i] = vb[2]
        blockinfo[1, i] = vb[4] - 1
    cw, ch = -(-xs_b // 8), -(-ys_b // 8)
    lgw.append_writer(VW.modular_substream([
        Channel(cw, ch, hshift=3, vshift=3, data=np.zeros((ch, cw), np.int32)),
        Channel(cw, ch, hshift=3, vshift=3, data=np.zeros((ch, cw), np.int32)),
        Channel(nb, 2, data=blockinfo),
        Channel(xs_b, ys_b, data=np.zeros((ys_b, xs_b), np.int32))]))
    lgw.zero_pad_to_byte()
    # split values
    passes_vals = [[], []]
    for (bx, by, sid, chans, qf) in order:
        p0 = {}; p1 = {}
        for c, v in chans.items():
            v = np.asarray(v, np.int64)
            v0 = v >> shift
            p0[c] = v0
            p1[c] = v - (v0 << shift)
        passes_vals[0].append((bx, by, sid, p0, qf))
        passes_vals[1].append((bx, by, sid, p1, qf))
    # HfGlobal: per pass used_orders=0 + histograms
    hf = BitWriter()
    hf.bool(True)  # default dequant
    # num_histograms bits only if ng>1 (ng==1 here)
    group_secs = []
    for p in range(2):
        hf.u32(0, 0x5F, 0x13, 0, (13, 0))   # used_orders for pass p
        ts = TokenStream(NUM_CTXS * (37 + 458), use_ans=True)
        VW.write_ac_group(ts, passes_vals[p], xs_b, ys_b)
        shared = ts.write_histograms(hf)
        gw = BitWriter()
        ts.write_symbols(gw, shared)
        gw.zero_pad_to_byte()
        group_secs.append(gw.to_bytes())
    hf.zero_pad_to_byte()
    payloads = [lfg.to_bytes(), lgw.to_bytes(), hf.to_bytes()] + group_secs
    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(p) for p in payloads])
    return bw.to_bytes() + b"".join(payloads)
