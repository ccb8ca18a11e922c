"""Does the lockstep device rANS kernel win in the BATCH regime?

Single-frame it loses to the host C++ path.  Lanes scale with the
group count, so a K-frame batch decoded in ONE lockstep call has K x
the lanes at (ideally) the same wall.  This probe measures the kernel
at lane multiplicity 1/2/4/8 by duplicating the real 4K frame's group
streams, and compares per-frame cost with the host C++ entropy path.
"""

import os
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
os.environ["JXL_DEVICE"] = "1"

import numpy as np

from jxl_coder import backend  # noqa: E402

backend.use_compile_cache()

from jxl_coder.bitstream.reader import BitReader
from jxl_coder.bitstream import container as container_mod
from jxl_coder.bitstream.headers import read_image_header
from jxl_coder.bitstream.frame_header import read_frame_header, read_toc
from jxl_coder.vardct import dec_real
from jxl_coder.entropy import device as ENTDEV


def main():
    data = open(os.path.join(REPO, ".bench_cache", "bench4k_v2.jxl"), "rb").read()
    cs = container_mod.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    toc = read_toc(br, n)

    # host baseline: full parse (entropy + marshalling) wall
    t0 = time.perf_counter()
    state = dec_real.decode_vardct_frame(cs, hdr, fh, toc,
                                         parse_only=True)
    host_parse = time.perf_counter() - t0
    print(f"host parse_only (C++ entropy): {host_parse:.2f} s/frame")

    # re-parse the front sections directly (the state dict does not
    # carry hf/lgs)
    w, h = fh.coded_size(hdr)
    xs_b, ys_b = -(-w // 8), -(-h // 8)
    npasses = fh.passes.num_passes
    single = len(toc.entries) == 1
    assert not single

    def brs(idx):
        s = toc.section(idx)
        return BitReader(cs[s.offset:s.offset + s.size])

    lf = dec_real.read_lf_global(brs(0), fh, hdr, w, h,
                                 allow_ec_failure=True)
    lf_gd_b = 256
    gx_lf = -(-xs_b // lf_gd_b)
    lgs = []
    for gi in range(ndc):
        lx = (gi % gx_lf) * lf_gd_b
        ly = (gi // gx_lf) * lf_gd_b
        gw = min(lf_gd_b, xs_b - lx)
        gh = min(lf_gd_b, ys_b - ly)
        lgs.append((lx, ly, dec_real.read_lf_group(
            brs(1 + gi), lf, gw, gh, gi, ndc, use_dc_frame=False)))
    hf = dec_real.read_hf_global(brs(1 + ndc), lf, ng, npasses, ndc)
    histo_bits = (hf.num_histograms - 1).bit_length() \
        if hf.num_histograms > 1 else 0

    packs = [ENTDEV.pack_code(hf.accodes[p]) for p in range(npasses)]
    if any(p is None for p in packs):
        print("stream uses prefix/LZ77 — device kernel n/a")
        return
    num_ctxs = lf.bcm.num_ctxs

    from jxl_coder.vardct.dec_real import _lf_group_view
    gd_b = 32
    gx = -(-xs_b // gd_b)

    scheds = []
    gins0 = []
    for gi in range(ng):
        ax = (gi % gx) * gd_b
        ay = (gi // gx) * gd_b
        gw = min(gd_b, xs_b - ax)
        gh = min(gd_b, ys_b - ay)
        lgi = (ay // lf_gd_b) * gx_lf + (ax // lf_gd_b)
        lx, ly, lg = lgs[lgi]
        sub = _lf_group_view(lg, ax - lx, ay - ly, gw, gh)
        dc_q = np.stack([sub.dc.channels[1].data,
                         sub.dc.channels[0].data,
                         sub.dc.channels[2].data])
        sched = ENTDEV.build_group_schedule(lf, sub, gw, gh, dc_q, hf)
        scheds.append(sched)
        s = toc.section(2 + ndc + 0 * ng + gi)
        gins0.append(ENTDEV.GroupInput(
            cs[s.offset:s.offset + s.size], histo_bits, num_ctxs,
            scheds[gi]))

    for mult in (1, 2, 4, 8):
        gins = gins0 * mult
        t0 = time.perf_counter()
        out, ok = ENTDEV.decode_pass_groups_device(packs[0], gins,
                                                   num_ctxs)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, ok = ENTDEV.decode_pass_groups_device(packs[0], gins,
                                                   num_ctxs)
        dt2 = time.perf_counter() - t0
        assert ok.all(), np.nonzero(~ok)[0][:8]
        per_frame = min(dt, dt2) / mult
        print(f"x{mult} ({len(gins)} lanes): {min(dt, dt2):.2f} s total"
              f" -> {per_frame:.2f} s/frame-equivalent", flush=True)


if __name__ == "__main__":
    main()
