"""Differential jbrd validation: our write_jbrd(jbrd_from_jpeg(jpg))
must byte-match the jbrd payload libjxl 0.7 emits for the same JPEG
(bundle part; the brotli part is compared decompressed since encoder
output can differ).  Any mismatch prints the first differing bit so the
grammar can be pinned field by field."""
import io
import struct
import sys

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")

import numpy as np
import refjxl
from PIL import Image

from jxl_coder.jpeg import jbrd as J
from jxl_coder.jpeg.parser import parse_jpeg
from jxl_coder.utils import brotli_ffi


def get_jbrd(jxl):
    pos = 0
    while pos < len(jxl):
        size = struct.unpack('>I', jxl[pos:pos + 4])[0]
        typ = jxl[pos + 4:pos + 8]
        if typ == b'jbrd':
            return jxl[pos + 8:pos + size]
        pos += size if size else len(jxl)
    return None


def make_jpeg(shape=(16, 16, 3), gray=False, seed=0, **kw):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if gray:
        img = img[..., 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def split_bundle(payload):
    """bundle bits end at the first byte boundary after the parse; we
    approximate by parsing with our reader and returning (bundle_bytes,
    brotli_bytes)."""
    d = J.parse_jbrd(payload)
    # re-derive the split point by re-parsing
    from jxl_coder.bitstream.reader import BitReader
    return d


def compare(name, jpg):
    ref = get_jbrd(refjxl.jpeg_construct(jpg))
    if ref is None:
        print(f"{name}: libjxl produced no jbrd box!")
        return False
    j = parse_jpeg(jpg)
    ours = J.write_jbrd(J.jbrd_from_jpeg(j))
    if ours == ref:
        print(f"{name}: EXACT ({len(ref)} bytes)")
        return True
    # find first differing byte / bit
    n = min(len(ours), len(ref))
    for i in range(n):
        if ours[i] != ref[i]:
            x, y = ours[i], ref[i]
            bit = (x ^ y) & -(x ^ y)
            print(f"{name}: first diff at byte {i} (bit offset "
                  f"~{i*8 + bit.bit_length()-1}): ours {x:08b} ref {y:08b}"
                  f"  (lens {len(ours)}/{len(ref)})")
            break
    else:
        print(f"{name}: prefix equal, length differs "
              f"{len(ours)} vs {len(ref)}")
    # also try parsing the ref bundle with our parser
    try:
        d = J.parse_jbrd(ref)
        print(f"   ref parses: markers={[hex(m) for m in d.marker_order]}"
              f" quant={d.quant} ctype={d.component_type}"
              f" ri={d.restart_interval} pads={len(d.padding_bits)}"
              f" tail={len(d.tail_data)}")
    except Exception as e:
        print(f"   ref does NOT parse with our grammar: {e!r}")
    return False


if __name__ == '__main__':
    cases = [
        ("q50 444", make_jpeg(quality=50, subsampling=0)),
        ("q80 420", make_jpeg(quality=80, subsampling=2)),
        ("q90 422", make_jpeg(quality=90, subsampling=1)),
        ("gray", make_jpeg(gray=True, quality=75)),
        ("restart", make_jpeg(shape=(64, 64, 3), quality=60,
                              subsampling=0, restart_marker_blocks=2)),
        ("optimized", make_jpeg(quality=85, subsampling=0,
                                optimize=True)),
        ("comment", make_jpeg(quality=70, subsampling=0,
                              comment=b"hello jbrd")),
        ("exif", make_jpeg(quality=70, subsampling=0,
                           exif=Image.Exif().tobytes())),
        ("big", make_jpeg(shape=(120, 90, 3), quality=92,
                          subsampling=0)),
    ]
    ok = 0
    for name, jpg in cases:
        try:
            ok += bool(compare(name, jpg))
        except Exception as e:
            print(f"{name}: EXCEPTION {e!r}")
    print(f"{ok}/{len(cases)} exact")
