"""Device encoder front end (enc_device) vs the host float64 oracle.

The device path (XYB + sharpen + DCT analysis + masking + CfL + RD
quantize/cost on the accelerator) may flip float32 quantization ties,
so streams are compared by decode quality, not bytes.
"""
import os

import numpy as np
import pytest

from jxl_coder import api
from jxl_coder.vardct.enc_real import encode_vardct_real


def _test_image(h=160, w=256):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([120 + 80 * np.sin(yy / 29) + 20 * np.cos(xx / 13),
                    110 + 70 * np.sin((xx + yy) / 43),
                    100 + 60 * np.cos(yy / 17)], -1)
    img += rng.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture
def device_encoder(monkeypatch):
    monkeypatch.setenv("JXL_DEVICE", "1")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def test_device_encode_matches_host_quality(device_encoder):
    img = _test_image()
    d_dev = encode_vardct_real(img, distance=1.0, effort=7)
    os.environ["JXL_DEVICE"] = "0"
    d_host = encode_vardct_real(img, distance=1.0, effort=7)
    out_dev, _ = api.decode(d_dev)
    out_host, _ = api.decode(d_host)
    p_dev, p_host = _psnr(out_dev, img), _psnr(out_host, img)
    # same RD point: size within 2%, PSNR within 0.1 dB
    assert abs(len(d_dev) - len(d_host)) <= max(64, len(d_host) * 0.02)
    assert abs(p_dev - p_host) < 0.1, (p_dev, p_host)


def test_device_encode_distances(device_encoder):
    img = _test_image(96, 128)
    prev_bytes = None
    for dist in (0.5, 1.0, 2.5):
        d = encode_vardct_real(img, distance=dist, effort=5)
        out, _ = api.decode(d)
        assert out.shape == img.shape
        if prev_bytes is not None:
            assert len(d) < prev_bytes      # coarser -> smaller
        prev_bytes = len(d)


def test_device_encode_uint16(device_encoder):
    img = (_test_image(80, 96).astype(np.uint16) << 8)
    d = encode_vardct_real(img, distance=1.0, effort=5, bit_depth=16)
    out, _ = api.decode(d)
    assert out.dtype == np.uint16
    assert _psnr(out >> 8, img >> 8) > 27
