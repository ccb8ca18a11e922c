"""Device-side (lockstep lanes) AC entropy decode vs the host oracle.

The kernel must be BIT-EXACT against the host read_pass_group on real
streams (libjxl-encoded and own-encoder), including multi-group frames
with multi-size strategies and per-group histogram selection.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "research"))

try:
    import refjxl  # noqa: E402
    HAVE_LIBJXL = True
except Exception:
    HAVE_LIBJXL = False

from jxl_coder import api  # noqa: E402


def _decode_both(data):
    out_host, _ = api.decode(data)
    os.environ["JXL_ENTROPY"] = "1"
    try:
        out_dev, _ = api.decode(data)
    finally:
        os.environ["JXL_ENTROPY"] = "0"
    return out_host, out_dev


@pytest.mark.skipif(not HAVE_LIBJXL, reason="system libjxl missing")
@pytest.mark.parametrize("dist,effort", [(2.0, 7), (1.0, 5)])
def test_device_entropy_bit_exact_libjxl_stream(dist, effort):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (120, 300, 3)).astype(np.uint8)
    # smooth + noise mix exercises several strategy families
    yy, xx = np.mgrid[0:120, 0:300]
    img[..., 0] = np.clip(
        100 + 80 * np.sin(yy / 17) + (img[..., 0] >> 3), 0, 255)
    data = refjxl.encode_ex(img, distance=dist, effort=effort)
    out_host, out_dev = _decode_both(data)
    assert np.array_equal(out_host, out_dev)


def test_device_entropy_bit_exact_own_stream():
    from jxl_coder.vardct.enc_real import encode_vardct_real
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:288]
    img = np.clip(np.stack([yy * 2 + rng.integers(0, 32, (96, 288)),
                            xx, xx // 2 + yy], -1), 0, 255).astype(
        np.uint8)
    data = encode_vardct_real(img, distance=1.0, effort=7)
    out_host, out_dev = _decode_both(data)
    assert np.array_equal(out_host, out_dev)
