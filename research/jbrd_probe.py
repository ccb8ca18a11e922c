"""Workbench: pin the jbrd (JPEG bitstream reconstruction data) field
serialization against libjxl 0.7's output, differentially.

jbrd payload = JXL-Fields bundle (bit-packed) + Brotli(concatenated
marker payload bytes).  This script generates controlled JPEG variants,
extracts the bundle, and parses it with the current grammar hypothesis,
reporting mismatches against ground truth parsed from the JPEG itself.
"""
import io
import struct
import sys

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")

import numpy as np
import refjxl
from PIL import Image
from jxl_coder.bitstream.reader import BitReader
from jxl_coder.jpeg.parser import parse_jpeg


def get_jbrd(jxl):
    pos = 0
    while pos < len(jxl):
        size = struct.unpack('>I', jxl[pos:pos + 4])[0]
        typ = jxl[pos + 4:pos + 8]
        if typ == b'jbrd':
            return jxl[pos + 8:pos + size]
        pos += size if size else len(jxl)
    return None


def jpeg_markers(jpg):
    i = 2
    out = []
    while i < len(jpg) - 1:
        assert jpg[i] == 0xFF, hex(jpg[i])
        m = jpg[i + 1]
        ln = 0
        if m not in (0xd8, 0xd9, 0x01) and not (0xd0 <= m <= 0xd7):
            ln = struct.unpack('>H', jpg[i + 2:i + 4])[0]
        out.append((m, jpg[i + 2:i + 2 + ln]))
        if m == 0xDA:
            break
        i += 2 + ln
    return out


def make_jpeg(**kw):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, kw.pop("shape", (16, 16, 3))).astype(
        np.uint8)
    if img.ndim == 3 and kw.pop("gray", False):
        img = img[..., 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def parse_bundle(jb, jpg, verbose=True):
    """Current grammar hypothesis; returns (ok, info)."""
    j = parse_jpeg(jpg)
    mk = jpeg_markers(jpg)
    br = BitReader(jb)
    log = []

    def note(*a):
        if verbose:
            print(*a)

    is_gray = br.u(1)
    note('is_gray', is_gray)
    order = []
    while True:
        m = br.u(6) + 0xc0
        order.append(m)
        if m == 0xd9:
            break
        if len(order) > 200:
            raise ValueError('marker loop')
    note('order', [hex(m) for m in order])
    napp = sum(1 for m in order if 0xe0 <= m <= 0xef)
    ncom = sum(1 for m in order if m == 0xfe)
    # APP marker types + sizes
    for i in range(napp):
        t = br.u32((0, 0), (0, 1), (0, 2), (0, 3))
        ln = br.u(16)
        note(f'app[{i}] type {t} len {ln}')
    for i in range(ncom):
        ln = br.u(16)
        note(f'com[{i}] len {ln}')
    # quant tables
    nq = br.u32((0, 1), (0, 2), (0, 3), (0, 4))
    note('num_quant', nq)
    for i in range(nq):
        prec = br.u(1)
        idx = br.u(2)
        is_last = br.u(1)
        note(f'quant[{i}] prec {prec} index {idx} is_last {is_last}')
    # component ids
    comp_type = br.u(2)
    note('comp_id_type', comp_type)
    ncomp = 1 if is_gray else 3
    if comp_type == 2:
        for i in range(ncomp):
            cid = br.u(8)
            note(f'comp[{i}] id {cid}')
    for i in range(ncomp):
        q = br.u(2)
        note(f'comp[{i}] quant_idx {q}')
    note('bitpos', br.pos)
    return br, order


if __name__ == '__main__':
    jpg = make_jpeg(quality=50, subsampling=0)
    jb = get_jbrd(refjxl.jpeg_construct(jpg))
    parse_bundle(jb, jpg)
