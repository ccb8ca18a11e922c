"""Incremental parser for real (libjxl-emitted) VarDCT frames.

Research harness: parse a generated lossy stream section by section,
using section byte-ends and refjxl pixel output as oracles.
"""
import sys, os
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ["JXL_NO_NATIVE"] = "1"

import numpy as np
import refjxl
from jxl_coder.bitstream.reader import BitReader, unpack_signed
from jxl_coder.bitstream.headers import read_image_header
from jxl_coder.bitstream.frame_header import read_frame_header, read_toc
from jxl_coder.codec import read_dc_quant
from jxl_coder.entropy.coder import (read_cluster_map, EntropyCode,
                                         EntropyDecoder)
from jxl_coder.modular.tree import decode_tree
from jxl_coder.modular.stream import decode_modular_stream
from jxl_coder.modular.image import Channel, ModularImage


def parse_lf_global(sbr, fh, xs_blocks, ys_blocks):
    """Returns (quantizer, block_ctx_map-ish, global_tree, global_code)."""
    assert fh.flags == 0, "patches/splines/noise not handled yet"
    dcq = read_dc_quant(sbr)
    gs = sbr.u32((11, 1), (11, 2049), (12, 4097), (16, 8193))
    qdc = sbr.u32(16, (5, 1), (8, 1), (16, 1))
    # BlockCtxMap
    if sbr.u(1):
        ctx_map = list(DEFAULT_CTX_MAP)
        dc_th = [[], [], []]
        qf_th = []
    else:
        dc_th = []
        num_dc = 1
        for c in range(3):
            nt = sbr.u(4)
            dc_th.append([unpack_signed(
                sbr.u32((4, 0), (8, 16), (16, 272), (32, 65808)))
                for _ in range(nt)])
            num_dc *= nt + 1
        nq = sbr.u(4)
        qf_th = [sbr.u32((2, 0), (3, 4), (5, 12), (8, 44)) + 1
                 for _ in range(nq)]
        size = 3 * 13 * num_dc * (len(qf_th) + 1)
        ctx_map = read_cluster_map(sbr, size)
    num_ctxs = max(ctx_map) + 1
    # CfL DC
    if sbr.u(1):
        cfl = dict(color_factor=84, base_x=0.0, base_b=0.9352192,
                   ytox_dc=0, ytob_dc=0)
    else:
        cf = sbr.u32(84, 256, (8, 2), (16, 258))
        bx = sbr.f16()
        bb = sbr.f16()
        yx = sbr.u(8) - 128
        yb = sbr.u(8) - 128
        cfl = dict(color_factor=cf, base_x=bx, base_b=bb,
                   ytox_dc=yx, ytob_dc=yb)
    # modular global (VarDCT: no color channels; extra channels only)
    gtree = gcode = None
    if sbr.u(1):
        gtree = decode_tree(sbr, 1 << 22)
        gcode = EntropyCode(sbr, (len(gtree.nodes) + 1) // 2)
    return dict(dcq=dcq, gs=gs, qdc=qdc, ctx_map=ctx_map,
                num_ctxs=num_ctxs, dc_th=dc_th, qf_th=qf_th, cfl=cfl,
                gtree=gtree, gcode=gcode)


DEFAULT_CTX_MAP = [
    0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 6, 6, 6,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14]


def parse_lf_group(sbr, lf, xs_b, ys_b):
    ep = sbr.u(2)
    dc_img = ModularImage([Channel(xs_b, ys_b) for _ in range(3)])
    decode_modular_stream(sbr, dc_img, stream_id=1,
                          global_tree=lf["gtree"], global_code=lf["gcode"])
    # AcMetadata
    upper = xs_b * ys_b
    nbits = max(1, (upper - 1).bit_length()) if upper > 1 else 0
    count = sbr.u(nbits) + 1
    cw = -(-xs_b // 8)
    ch = -(-ys_b // 8)
    ac_img = ModularImage([
        Channel(cw, ch, hshift=3, vshift=3),
        Channel(cw, ch, hshift=3, vshift=3),
        Channel(count, 2), Channel(xs_b, ys_b)])
    # ACMetadata(g) stream id = 1 + 2*num_dc_groups + g
    decode_modular_stream(sbr, ac_img, stream_id=3,
                          global_tree=lf["gtree"], global_code=lf["gcode"])
    return dict(extra_precision=ep, dc=dc_img, nb=count, acm=ac_img)


ZIGZAG8 = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

K_COEFF_FREQ_CTX = [
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30]
K_NUM_NZ_CTX = [
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206]
K_ZERO_DENSITY_CTX_COUNT = 458


def zero_density_ctx(nzeros_left, k, covered, log2cov, prev):
    nzeros_left = (nzeros_left + covered - 1) >> log2cov
    k >>= log2cov
    return (K_NUM_NZ_CTX[nzeros_left] + K_COEFF_FREQ_CTX[k]) * 2 + prev


def nonzero_ctx(predicted, block_ctx, num_ctxs):
    if predicted >= 64:
        predicted = 64
    ctx = predicted if predicted < 8 else 4 + predicted // 2
    return ctx * num_ctxs + block_ctx


def block_context(ctx_map, num_dc_ctxs, qf_th, dc_idx, qf, ord_, c):
    qf_idx = sum(1 for t in qf_th if qf > t)
    idx = (c ^ 1) if c < 2 else 2
    idx = idx * 13 + ord_
    idx = idx * (len(qf_th) + 1) + qf_idx
    idx = idx * num_dc_ctxs + dc_idx
    return ctx_map[idx]


def parse_hf_global(sbr, lf, num_groups):
    assert sbr.u(1) == 1, "non-default dequant matrices unsupported"
    nb = max(0, (num_groups - 1).bit_length())
    num_histograms = 1 + sbr.u(nb)
    used_orders = sbr.u32(0x5F, 0x13, 0, (13, 0))
    orders = {}
    if used_orders:
        pcode = EntropyCode(sbr, 8)
        pdec = EntropyDecoder(sbr, code=pcode)
        # kStrategyOrder for raw strategies; only DCT8 (ord 0) needed now
        for ord_ in range(13):
            if used_orders & (1 << ord_):
                if ord_ != 0:
                    raise NotImplementedError("order %d" % ord_)
                for c in range(3):
                    perm = read_permutation(pdec, 1, 64)
                    orders[(ord_, c)] = [ZIGZAG8[p] for p in perm]
        if not pdec.check_final_state():
            raise ValueError("perm checksum")
    num_ac_ctx = num_histograms * lf["num_ctxs"] * (37 + 458)
    accode = EntropyCode(sbr, num_ac_ctx)
    return dict(num_histograms=num_histograms, used_orders=used_orders,
                orders=orders, accode=accode)


def read_permutation(pdec, skip, size):
    def ctx_of(v):
        # HybridUintConfig(0,0,0) token of v, clamped to 7
        token = v if v == 0 else (v.bit_length())
        return min(token, 7)
    end = pdec.read(ctx_of(size)) + skip
    assert end <= size
    lehmer = [0] * size
    last = 0
    for i in range(skip, end):
        lehmer[i] = pdec.read(ctx_of(last))
        last = lehmer[i]
    # decode Lehmer code to permutation over [0, size)
    temp = list(range(size))
    perm = []
    for i in range(size):
        idx = lehmer[i]
        perm.append(temp.pop(idx))
    return perm


def parse_pass_group(sbr, lf, hf, lg, xs_b, ys_b):
    dec = EntropyDecoder(sbr, code=hf["accode"])
    acm = lg["acm"]
    acs_row = acm.channels[2].data[0]
    qf_row = acm.channels[2].data[1]
    num_ctxs = lf["num_ctxs"]
    num_dc_ctxs = 1
    for th in lf["dc_th"]:
        num_dc_ctxs *= len(th) + 1
    coeffs = {0: np.zeros((ys_b, xs_b, 64), np.int32),
              1: np.zeros((ys_b, xs_b, 64), np.int32),
              2: np.zeros((ys_b, xs_b, 64), np.int32)}
    order = hf["orders"].get((0, 0)) or ZIGZAG8
    nz_left = {c: np.full(xs_b, 32, np.int32) for c in range(3)}
    # per-row nzeros maps for prediction (top row + left neighbor)
    nz_map = {c: np.zeros((ys_b, xs_b), np.int32) for c in range(3)}
    bi = 0
    for by in range(ys_b):
        for bx in range(xs_b):
            acs = acs_row[bi]
            qf = qf_row[bi] + 1
            bi += 1
            assert acs == 0, "non-DCT8 not yet"
            for c in (1, 0, 2):
                ordc = hf["orders"].get((0, c)) or ZIGZAG8
                if by == 0:
                    predicted = 32 if bx == 0 else int(nz_map[c][by, bx - 1])
                elif bx == 0:
                    predicted = int(nz_map[c][by - 1, bx])
                else:
                    predicted = (int(nz_map[c][by - 1, bx])
                                 + int(nz_map[c][by, bx - 1]) + 1) // 2
                bctx = block_context(lf["ctx_map"], num_dc_ctxs,
                                     lf["qf_th"], 0, qf, 0, c)
                nz = dec.read(nonzero_ctx(predicted, bctx, num_ctxs))
                nz_map[c][by, bx] = nz
                if nz > 63:
                    raise ValueError("nzeros too big %d" % nz)
                ctx_off = num_ctxs * 37 + K_ZERO_DENSITY_CTX_COUNT * bctx
                prev = 0 if nz > 64 // 16 else 1
                nzeros = nz
                k = 1
                while nzeros > 0:
                    ctx = ctx_off + zero_density_ctx(nzeros, k, 1, 0, prev)
                    u = dec.read(ctx)
                    v = unpack_signed(u)
                    coeffs[c][by, bx, ordc[k]] = v
                    prev = 1 if v else 0
                    nzeros -= prev
                    k += 1
    ok = dec.check_final_state()
    return coeffs, ok


if __name__ == "__main__":
    img = (np.sin(np.arange(64)[:, None] / 5) * 90
           + np.cos(np.arange(64)[None, :] / 9) * 60
           + 128).clip(0, 255).astype(np.uint8)[..., None].repeat(3, -1)
    d = refjxl.encode(img, lossless=False, effort=3, distance=1.0)
    br = BitReader(d)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    toc = read_toc(br, 1)
    sec = toc.section(0)
    sbr = BitReader(d[sec.offset:sec.offset + sec.size])
    lf = parse_lf_global(sbr, fh, 8, 8)
    print("lf_global ok: gs=%d qdc=%d num_ctxs=%d pos=%d"
          % (lf["gs"], lf["qdc"], lf["num_ctxs"], sbr.pos))
    lg = parse_lf_group(sbr, lf, 8, 8)
    print("lf_group ok: ep=%d nb=%d pos=%d" % (lg["extra_precision"],
                                               lg["nb"], sbr.pos))
    hf = parse_hf_global(sbr, lf, 1)
    print("hf_global ok: nh=%d used_orders=%#x pos=%d"
          % (hf["num_histograms"], hf["used_orders"], sbr.pos))
    coeffs, ok = parse_pass_group(sbr, lf, hf, lg, 8, 8)
    print("pass group: final_state_ok=%s pos=%d of %d"
          % (ok, sbr.pos, sec.size * 8))
    for c in range(3):
        print("  c%d: nz=%d max=%d" % (c, (coeffs[c] != 0).sum(),
                                       np.abs(coeffs[c]).max()))
