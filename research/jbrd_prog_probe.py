"""Progressive jbrd grammar forensics (round 3).

Builds libjpeg(-turbo) progressive JPEGs via PIL, has system libjxl 0.7
construct them, and bit-parses the resulting jbrd payloads to pin the
scan-section grammar.  Findings (implemented in jpeg/jbrd.py, details
in docs/JBRD_FORMAT.md):

- the per-scan component count is stored ONCE (scan 0's, U32 Val(1..4));
  DC scans cover all components, AC scans exactly one
- field order is Ss(6) Se(6) Al(4) Ah(4)  [Al FIRST]
- per-component order is (comp_idx, ac_tbl, dc_tbl)
- a 2-bit refinement-ZRL count follows each scan's reset points; its
  entry layout is still unpinned (nonzero observed on files whose AC
  refinement scans emit ZRLs), as is a variable-length all-zero region
  between the scan list and the tail fields (~5 bits per AC scan on
  some files, 4 on others)

Run: python research/jbrd_prog_probe.py
"""
import io
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
from PIL import Image

import refjxl
from jxl_coder.bitstream import container as C
from jxl_coder.bitstream.reader import BitReader
from jxl_coder.jpeg import jbrd as JB
from jxl_coder.jpeg.parser import parse_jpeg
from jxl_coder.utils import brotli_ffi


def probe(jpeg: bytes, label: str) -> None:
    j = parse_jpeg(jpeg)
    ljx = refjxl.jpeg_construct(jpeg)
    payload = C.extract_codestream(ljx).jpeg_reconstruction_data
    bstart = None
    for k in range(len(payload)):
        try:
            if len(brotli_ffi.decompress(payload[k:])) > 0:
                bstart = k
                break
        except Exception:
            pass
    d = JB.jbrd_from_jpeg(j)
    br = BitReader(payload)
    br.u(1)
    for _ in d.marker_order:
        br.u(6)
    napp = sum(1 for m in d.marker_order if 0xE0 <= m <= 0xEF)
    for _ in range(napp):
        br.u32(*JB._U32_APP_TYPE)
        br.u(16)
    for _ in range(sum(1 for m in d.marker_order if m == 0xFE)):
        br.u(16)
    nq = br.u32(*JB._U32_COUNT4)
    for _ in range(nq):
        br.u(1)
        br.u(2)
        br.u(1)
    ct = br.u(2)
    ncomp = 1 if ct == 0 else 3
    for _ in range(ncomp):
        br.u(2)
    nh = br.u32(*JB._U32_NUM_HUFF)
    for _ in range(nh):
        br.u(1)
        br.u(2)
        br.u(1)
        counts = [br.u32(*JB._U32_HUFF_COUNT) for _ in range(17)]
        for _ in range(sum(counts)):
            br.u32(*JB._U32_HUFF_VALUE)
    nc0 = br.u32(*JB._U32_COUNT4)
    print(f"{label}: scans={len(j.scans)} scan0-count={nc0}")
    for i, s in enumerate(j.scans):
        ss, se = br.u(6), br.u(6)
        al, ah = br.u(4), br.u(4)
        nc = nc0 if ss == 0 else 1
        comps = [(br.u(2), br.u(2), br.u(2)) for _ in range(nc)]
        nr = br.u32(*JB._U32_NUM_RESET)
        mystery = br.u(2)
        ok = (ss, se, ah, al) == (s.Ss, s.Se, s.Ah, s.Al)
        flag = "" if ok and not mystery else \
            f"  <-- {'HDR MISMATCH' if not ok else ''} mystery={mystery}"
        print(f"  scan{i}: ({ss},{se},{ah},{al}) comps(idx,ac,dc)="
              f"{comps} resets={nr}{flag}")
    trailing = bstart * 8 - br.pos
    bits = "".join(str(br.u(1)) for _ in range(max(trailing, 0)))
    print(f"  trailing-to-brotli: {trailing} bits: {bits[:64]}"
          f"{'...' if trailing > 64 else ''}")


def main():
    rng = np.random.default_rng(3)
    img = np.clip(rng.normal(128, 18, (24, 32, 3)), 0,
                  255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, progressive=True,
                              subsampling=0)
    probe(buf.getvalue(), "colour 24x32 q80 444")
    buf = io.BytesIO()
    Image.fromarray(img[:, :, 0]).save(buf, "JPEG", quality=80,
                                       progressive=True)
    probe(buf.getvalue(), "gray 24x32 q80")


if __name__ == "__main__":
    main()
