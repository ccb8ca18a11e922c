"""Pin the VarDCT EPF empirically: craft pixel-exact Y planes via full
coefficient blocks, toggle epf_iters in the frame header, and read the
impulse/step responses from libjxl's float output."""
import sys, os
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ.setdefault("JXL_NO_NATIVE", "1")

import numpy as np
import refjxl
from vardct_write import craft
import vardct_write as VW

bias = 0.0037930732552754493
cbrt_bias = np.cbrt(bias)
M = np.array([[0.30, 0.622, 0.078],
              [0.23, 0.692, 0.078],
              [0.24342268924547819, 0.20476744424496821, 0.5518098665095536]])

IDCT = np.zeros((8, 8))
for k in range(8):
    for x in range(8):
        a = 1.0 if k == 0 else np.sqrt(2)
        IDCT[k, x] = a * np.cos(np.pi * (2 * x + 1) * k / 16)
DCTM = np.linalg.inv(IDCT.T)   # forward: coeffs = DCTM @ pixels @ DCTM.T


def srgb_to_xyb(f):
    lin = np.where(np.abs(f) <= 0.0404482362771082, f / 12.92,
                   np.sign(f) * ((np.abs(f) + 0.055) / 1.055) ** 2.4)
    mixed = lin @ M.T
    g = np.cbrt(mixed + bias) - cbrt_bias
    return (g[..., 0] - g[..., 1]) / 2, (g[..., 0] + g[..., 1]) / 2, g[..., 2]


def plane_to_stream(Yplane, qf=64, gs=65536, epf_iters=0, sharpness=0,
                    qdc=1):
    """Build a stream whose decoded Y approximates Yplane, X=0, B=Y."""
    from jxl_coder.vardct.tables_real import DCT8_TABLE
    H, W = Yplane.shape
    ys_b, xs_b = H // 8, W // 8
    igs = 65536.0 / gs
    inv_qac = igs / qf
    dc = np.zeros((3, ys_b, xs_b), np.int64)
    coeffs = np.zeros((3, ys_b, xs_b, 64), np.int64)
    dc_step = 0.001953125 * igs / qdc
    for by in range(ys_b):
        for bx in range(xs_b):
            blk = Yplane[by*8:(by+1)*8, bx*8:(bx+1)*8]
            co = DCTM @ blk @ DCTM.T       # (ky, kx)
            stored = co.T                   # transposed storage
            dc[0, by, bx] = round(stored[0, 0] / dc_step)
            steps = DCT8_TABLE[1].reshape(8, 8) * inv_qac
            q = np.zeros((8, 8), np.int64)
            flat = stored.copy()
            flat[0, 0] = 0
            with np.errstate(divide='ignore', invalid='ignore'):
                q = np.round(np.where(steps > 0, flat / steps, 0)).astype(np.int64)
            q[0, 0] = 0
            coeffs[1, by, bx] = q.reshape(64)
    return craft_epf(dc, coeffs, gs=gs, qdc=qdc, qf=qf,
                     W=W, H=H, epf_iters=epf_iters, sharpness=sharpness)


def craft_epf(dc, coeffs, gs, qdc, qf, W, H, epf_iters, sharpness):
    """craft() with configurable epf_iters + uniform sharpness."""
    import numpy as np
    from jxl_coder.bitstream.writer import BitWriter
    from jxl_coder.bitstream.headers import (ImageHeader, ImageMetadata,
                                                 SizeHeader)
    from jxl_coder.bitstream.frame_header import (FrameHeader, Encoding,
                                                      write_frame_header,
                                                      write_toc)
    from jxl_coder.codec import write_image_header
    from jxl_coder.entropy.coder import TokenStream
    from jxl_coder.modular.image import Channel
    ys_b, xs_b = H // 8, W // 8
    m = ImageMetadata()
    hdr = ImageHeader(size=SizeHeader(xsize=W, ysize=H), metadata=m)
    fh = FrameHeader(encoding=Encoding.VARDCT, flags=128,
                     x_qm_scale=2, b_qm_scale=2)
    fh.restoration_filter.gab = False
    fh.restoration_filter.epf_iters = epf_iters
    sec = BitWriter()
    sec.bool(True)
    sec.u32(gs, (11, 1), (11, 2049), (12, 4097), (16, 8193))
    sec.u32(qdc, 16, (5, 1), (8, 1), (16, 1))
    sec.bool(True); sec.bool(True); sec.bool(False)
    sec.u(0, 2)
    dcw = VW.modular_substream([Channel(xs_b, ys_b,
                                        data=np.ascontiguousarray(dc[i], np.int32))
                                for i in range(3)])
    sec.append_writer(dcw)
    nb = xs_b * ys_b
    cb = (nb - 1).bit_length() if nb > 1 else 0
    sec.u(nb - 1, cb)
    bi = np.zeros((2, nb), np.int32); bi[1, :] = qf - 1
    acmw = VW.modular_substream([
        Channel(-(-xs_b//8), -(-ys_b//8), hshift=3, vshift=3,
                data=np.zeros((-(-ys_b//8), -(-xs_b//8)), np.int32)),
        Channel(-(-xs_b//8), -(-ys_b//8), hshift=3, vshift=3,
                data=np.zeros((-(-ys_b//8), -(-xs_b//8)), np.int32)),
        Channel(nb, 2, data=bi),
        Channel(xs_b, ys_b,
                data=np.full((ys_b, xs_b), sharpness, np.int32))])
    sec.append_writer(acmw)
    sec.bool(True)
    sec.u32(0, 0x5F, 0x13, 0, (13, 0))
    ts = TokenStream(VW.NUM_CTXS * (37 + 458))
    VW.write_ac_group(ts, coeffs, np.zeros((ys_b, xs_b), np.int64),
                      np.full((ys_b, xs_b), qf, np.int64))
    ts.write(sec)
    sec.zero_pad_to_byte()
    payload = sec.to_bytes()
    bw = BitWriter()
    write_image_header(bw, hdr)
    write_frame_header(bw, fh, hdr)
    write_toc(bw, [len(payload)])
    return bw.to_bytes() + payload


def decode_Y(data):
    out, _ = refjxl.decode(data, as_float=True)
    X, Y, B = srgb_to_xyb(out.astype(np.float64))
    return Y


if __name__ == "__main__":
    # E1: impulse response of pass structure at tiny amplitude
    H = W = 64
    base = np.full((H, W), 0.5)
    eps = 0.004
    imp = base.copy(); imp[27, 29] += eps   # interior, not block border
    for iters in (0, 1, 2, 3):
        d0 = plane_to_stream(base, epf_iters=iters)
        d1 = plane_to_stream(imp, epf_iters=iters)
        Y0 = decode_Y(d0); Y1 = decode_Y(d1)
        R = (Y1 - Y0) / eps
        ys, xs = np.nonzero(np.abs(R) > 0.01)
        print(f"iters={iters}: taps at", sorted(set(zip(ys-27, xs-29))))
        for dy in range(-3, 4):
            print("   ", " ".join("%7.4f" % R[27+dy, 29+dx]
                                  for dx in range(-3, 4)))
