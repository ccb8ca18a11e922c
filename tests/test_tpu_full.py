"""Device (JAX) full-strategy VarDCT reconstruction vs the host path.

The device pipeline (vardct/device_full.py) runs dequant + CfL + every
inverse transform + filters + XYB->sRGB in float32 on device; the host
reference computes in float64.  Output may differ by at most 1 output
code on rounding-boundary pixels.
"""

import ctypes.util
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "research"))

HAVE_LIBJXL = bool(ctypes.util.find_library("jxl"))

from jxl_coder import api  # noqa: E402


def _test_image(h=192, w=256, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([
        128 + 100 * np.sin(xx / 37) * np.cos(yy / 23),
        128 + 80 * np.cos(xx / 11 + yy / 53),
        128 + 60 * np.sin((xx + yy) / 29)], -1)
    img += rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _host_vs_device(data):
    prev = os.environ.get("JXL_DEVICE")
    try:
        os.environ["JXL_DEVICE"] = "0"
        host, _ = api.decode(data)
        os.environ["JXL_DEVICE"] = "1"
        dev, _ = api.decode(data)
    finally:
        if prev is None:
            os.environ.pop("JXL_DEVICE", None)
        else:
            os.environ["JXL_DEVICE"] = prev
    return host, dev


def test_device_matches_host_own_encoder():
    img = _test_image()
    data = api.encode(img, lossless=False, quality=85, effort=7)
    host, dev = _host_vs_device(data)
    d = np.abs(host.astype(int) - dev.astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


@pytest.mark.skipif(not HAVE_LIBJXL, reason="libjxl not available")
@pytest.mark.parametrize("effort,distance", [(7, 1.0), (8, 4.0),
                                             (3, 1.5)])
def test_device_matches_host_libjxl_streams(effort, distance):
    import refjxl
    img = _test_image()
    data = refjxl.encode(img, lossless=False, effort=effort,
                         distance=distance)
    host, dev = _host_vs_device(data)
    d = np.abs(host.astype(int) - dev.astype(int))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-3


def test_device_matches_host_16bit_corpus():
    from conftest import asset
    data = asset("hdr_cosmos.jxl")
    host, dev = _host_vs_device(data)
    assert host.dtype == dev.dtype == np.uint16
    d = np.abs(host.astype(int) - dev.astype(int))
    # 16-bit output quantizer: f32-vs-f64 boundary flips scale with the
    # finer step; bound stays tiny relative to the 65535 range
    assert d.max() <= 64, d.max()


def test_multihost_dryrun_two_processes():
    """jax.distributed 2-process x 2-device CPU mesh: the GOP-sharded
    decode must produce bit-exact shards in every process
    (SURVEY §7 step 10, BASELINE 2-host metric skeleton)."""
    from jxl_coder.parallel.multihost import multihost_dryrun
    multihost_dryrun(2, 2)


def test_decode_batch_pipelined(monkeypatch):
    """api.decode_batch: pipelined host-parse + device-reconstruct path
    matches decode() per file (<=1), incl. a modular fallback file."""
    monkeypatch.setenv("JXL_DEVICE", "1")
    from jxl_coder import api
    from jxl_coder.vardct.enc_real import encode_vardct_real
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:96, 0:160]
    datas = []
    for k in range(3):
        img = np.clip(np.stack([
            120 + 60 * np.sin(yy / (11 + k)) + rng.integers(0, 24, yy.shape),
            xx % 200, (xx + yy) % 220], -1), 0, 255).astype(np.uint8)
        datas.append(encode_vardct_real(img, distance=1.0, effort=5))
    img0, _ = api.decode(datas[0])
    datas.append(api.encode(img0, lossless=True))   # modular fallback
    outs = api.decode_batch(datas)
    for data, out in zip(datas, outs):
        ref, _ = api.decode(data)
        assert out.shape == ref.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_device_int8_exception_path(monkeypatch):
    """Values beyond int8 must flow through the exception scatter: a
    high-contrast image at tiny distance produces coefficients in the
    hundreds."""
    monkeypatch.setenv("JXL_DEVICE", "1")
    from jxl_coder import api
    from jxl_coder.vardct.enc_real import encode_vardct_real
    yy, xx = np.mgrid[0:64, 0:128]
    img = np.clip(128 + 127 * np.sin(yy / 3.2) * np.sin(xx / 3.5),
                  0, 255).astype(np.uint8)
    img = np.stack([img, img, img], -1)
    # coefficients reach ~670 here: several families take the int8 +
    # exception-scatter form, one falls back to int16 (verified by the
    # probe in the commit message)
    data = encode_vardct_real(img, distance=0.1, effort=3)
    monkeypatch.setenv("JXL_DEVICE", "0")
    host, _ = api.decode(data)
    monkeypatch.setenv("JXL_DEVICE", "1")
    dev, _ = api.decode(data)
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1


def test_device_dispatch_default(monkeypatch):
    """With JXL_DEVICE unset, the device path is THE path whenever
    an accelerator backend is attached (host fallback on CPU-only
    hosts); the env var remains a force-override both ways.  Mirrors
    the reference, where the threaded codec path is simply the decode
    path (interop/JxlDecoding.cpp:46-60)."""
    from jxl_coder import backend
    from jxl_coder.vardct import device_full as TF
    monkeypatch.delenv("JXL_DEVICE", raising=False)

    monkeypatch.setattr(backend, "accelerator_present", lambda: True)
    assert TF.device_enabled()
    monkeypatch.setattr(backend, "accelerator_present", lambda: False)
    assert not TF.device_enabled()

    # overrides beat autodetect in both directions
    monkeypatch.setenv("JXL_DEVICE", "1")
    assert TF.device_enabled()
    monkeypatch.setattr(backend, "accelerator_present", lambda: True)
    monkeypatch.setenv("JXL_DEVICE", "0")
    assert not TF.device_enabled()


def test_device_dispatch_autodetect_cpu():
    """Under the CPU-forced test harness, autodetect resolves False."""
    from jxl_coder import backend
    assert backend.accelerator_present() is False


def test_multihost_encode_dryrun_two_processes():
    """GOP-sharded ENCODE across 2 jax.distributed processes: the
    bitstreams must be byte-identical to the single-process run
    (BASELINE configs 3-4)."""
    from jxl_coder.parallel.multihost import multihost_encode_dryrun
    r = multihost_encode_dryrun(2, 2, timeout=600.0)
    assert r["byte_identical"]
