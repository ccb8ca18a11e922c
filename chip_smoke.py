"""Smoke test of the device path on one NVIDIA GPU.

Drives the public API once per phase at real image sizes and compares
each result with the float64 host path, which is the same call with
JXL_DEVICE=0 in the same process:

  a  api.decode of a 3840x2160 e7 d1.0 stream to sRGB8: at most 1 code
     apart, and under 1e-3 of the pixels differ at all
  b  api.decode_batch of 4 distinct 3840x2160 streams: the bound of (a)
     for every image
  c  api.decode of a 1920x1080 16-bit lossy stream: at most 64 codes
  d  api.decode_sampled of the stream of (a) to 1/4 size: at most 1
     code apart from the host XYB planes box-averaged the same way
  e  api.decode of a 1920x1080 stream coded at 960x540 with noise and
     2x upsampling (the device post stages): at most 1 code
  f  api.encode(quality=90, effort=7) of a 4000x3000 image with the
     device front end against the host front end (JXL_ENC_DEVICE=0):
     bytes within 2%, decoded PSNR within 0.1 dB

The decode phases also check that the device program ran
(device_full._compiled was called); phase (f) checks the same of the
encoder front (enc_device._front).  Inputs are made from --seed.

    python chip_smoke.py [--seed N]      # phases a-f on one GPU
    python chip_smoke.py --four          # only the GOP-sharded decode
                                         # over four GPUs, 16 frames,
                                         # against one device

It refuses to start unless JAX's first device is a GPU, exits non-zero
when any phase fails, and prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

UHD = (2160, 3840)
FHD = (1080, 1920)
CAMERA = (3000, 4000)
BATCH = 4
FOUR_FRAMES = 16


# ---------------------------------------------------------------------------
# inputs

def photo(h: int, w: int, seed: int, dtype=np.uint8) -> np.ndarray:
    """Seeded photo-like content: smooth colour fields, hard-edged
    rectangles of flat colour, fine texture and sensor noise, so the
    encoder picks a mix of transform sizes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        f = rng.uniform(40.0, 400.0, 4)
        ph = rng.uniform(0.0, 6.28, 4)
        img[..., c] = (120 + 50 * np.sin(yy / f[0] + ph[0])
                       + 40 * np.cos(xx / f[1] + ph[1])
                       + 25 * np.sin((xx + yy) / f[2] + ph[2])
                       + 8 * np.sin(xx / 3.1 + ph[3]) * np.sin(yy / 2.7))
    for _ in range(24):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        bh, bw = rng.integers(h // 40 + 1, h // 6 + 2), \
            rng.integers(w // 40 + 1, w // 6 + 2)
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(20, 235, 3)
    img += rng.normal(0.0, 3.0, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255)
    if dtype == np.uint16:
        return np.clip(img * 257.0, 0, 65535).astype(np.uint16)
    return img.astype(np.uint8)


def upsampled_noise_stream(h: int, w: int, seed: int) -> bytes:
    """A (2h, 2w) stream coded at (h, w) with 2x upsampling and a noise
    lut, written by the repo's own encoder."""
    from jxl_coder.bitstream.frame_header import FrameHeader
    from jxl_coder.bitstream.headers import (ImageHeader, ImageMetadata,
                                             SizeHeader)
    from jxl_coder.bitstream.writer import BitWriter
    from jxl_coder.codec import write_image_header
    from jxl_coder.vardct.enc_real import encode_vardct_real
    hdr = ImageHeader(size=SizeHeader(xsize=2 * w, ysize=2 * h),
                      metadata=ImageMetadata())
    fh = FrameHeader(is_last=True, upsampling=2)
    bw = BitWriter()
    write_image_header(bw, hdr)
    encode_vardct_real(photo(h, w, seed), distance=1.0, effort=7, fh=fh,
                       hdr=hdr, into_bw=bw,
                       noise_lut=[0.2, 0.18, 0.16, 0.14, 0.12, 0.1,
                                  0.08, 0.06])
    return bw.to_bytes()


# ---------------------------------------------------------------------------
# helpers

@contextlib.contextmanager
def env(name: str, value):
    """Set (or, for None, unset) one environment variable for a block."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.total += duration


def device_calls() -> int:
    """Calls of the jitted frame program so far."""
    from jxl_coder.vardct import device_full as TF
    info = TF._compiled.cache_info()
    return info.hits + info.misses


def front_calls() -> int:
    from jxl_coder.vardct import enc_device as ENCDEV
    info = ENCDEV._front.cache_info()
    return info.hits + info.misses


def compare(dev, host, max_code, max_frac=None) -> dict:
    """Code difference of two pixel arrays; raises when out of bound."""
    assert dev.shape == host.shape, (dev.shape, host.shape)
    assert dev.dtype == host.dtype, (dev.dtype, host.dtype)
    d = np.abs(dev.astype(np.int64) - host.astype(np.int64))
    res = {"max_diff": int(d.max()), "frac_diff": float((d > 0).mean())}
    assert res["max_diff"] <= max_code, res
    if max_frac is not None:
        assert res["frac_diff"] < max_frac, res
    return res


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def parse_frame(data: bytes):
    """(codestream, image header, frame header, TOC) of a one-frame
    stream."""
    from jxl_coder.bitstream import container
    from jxl_coder.bitstream.frame_header import read_frame_header, read_toc
    from jxl_coder.bitstream.headers import read_image_header
    from jxl_coder.bitstream.reader import BitReader
    cs = container.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    return cs, hdr, fh, read_toc(br, n)


def host_sampled(data: bytes, down: int) -> np.ndarray:
    """Host oracle of the device ('down', k) stage: float64 XYB planes
    box-averaged over k x k (edge-padded), then the host sRGB8 output."""
    from jxl_coder.vardct import dec_real
    with env("JXL_DEVICE", "0"):
        xyb = dec_real.decode_vardct_frame(*parse_frame(data),
                                           return_xyb=True)

    def pool(p):
        p = np.asarray(p, np.float64)
        p = np.pad(p, ((0, (-p.shape[0]) % down), (0, (-p.shape[1]) % down)),
                   mode="edge")
        return p.reshape(p.shape[0] // down, down, p.shape[1] // down,
                         down).mean(axis=(1, 3))

    return dec_real.xyb_planes_to_srgb8(pool(xyb[0]), pool(xyb[1]),
                                        pool(xyb[2]))


# ---------------------------------------------------------------------------
# phases

class Smoke:
    """The phases, at sizes a caller may shrink.  device_env is the
    JXL_DEVICE value of the device calls: None is the default (auto)."""

    def __init__(self, seed=0, uhd=UHD, fhd=FHD, camera=CAMERA,
                 batch=BATCH, device_env=None, log=print):
        self.seed = seed
        self.uhd, self.fhd, self.camera = uhd, fhd, camera
        self.batch = batch
        self.device_env = device_env
        self.log = log
        self.clock = CompileClock()
        self._uhd_streams = None

    def uhd_streams(self):
        from jxl_coder import api
        if self._uhd_streams is None:
            h, w = self.uhd
            self._uhd_streams = [
                api.encode(photo(h, w, self.seed + k), lossless=False,
                           quality=90, effort=7)
                for k in range(self.batch)]
        return self._uhd_streams

    def timed(self, fn):
        c0, t0 = self.clock.total, time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, self.clock.total - c0

    def device(self, fn):
        """(result, wall s, compile s) of fn under the device setting;
        fails unless the jitted frame program ran."""
        n0 = device_calls()
        with env("JXL_DEVICE", self.device_env):
            out, wall, comp = self.timed(fn)
        assert device_calls() > n0, "device program did not run"
        return out, wall, comp

    def host(self, fn):
        with env("JXL_DEVICE", "0"):
            return self.timed(fn)[:2]

    def phase_a(self):
        from jxl_coder import api
        data = self.uhd_streams()[0]
        (dev, _), wall, comp = self.device(lambda: api.decode(data))
        (_, _), warm, _ = self.device(lambda: api.decode(data))
        (host, _), host_s = self.host(lambda: api.decode(data))
        assert dev.dtype == np.uint8 and dev.shape == self.uhd + (3,)
        return dict(device_s=wall, device_warm_s=warm, compile_s=comp,
                    host_s=host_s, bytes=len(data),
                    **compare(dev, host, 1, 1e-3))

    def phase_b(self):
        from jxl_coder import api
        datas = self.uhd_streams()
        n0 = device_calls()
        outs, wall, comp = self.device(lambda: api.decode_batch(datas))
        assert device_calls() - n0 >= len(datas), "frames left the device"
        worst = {"max_diff": 0, "frac_diff": 0.0}
        host_s = 0.0
        for data, out in zip(datas, outs):
            (host, _), s = self.host(lambda: api.decode(data))
            host_s += s
            r = compare(out, host, 1, 1e-3)
            worst = {k: max(worst[k], r[k]) for k in worst}
        return dict(device_s=wall, compile_s=comp, host_s=host_s,
                    images=len(datas), **worst)

    def phase_c(self):
        from jxl_coder import api
        h, w = self.fhd
        data = api.encode(photo(h, w, self.seed + 10, np.uint16),
                          lossless=False, quality=90, effort=7)
        (dev, _), wall, comp = self.device(lambda: api.decode(data))
        (host, _), host_s = self.host(lambda: api.decode(data))
        assert dev.dtype == np.uint16
        return dict(device_s=wall, compile_s=comp, host_s=host_s,
                    **compare(dev, host, 64))

    def phase_d(self):
        from jxl_coder import api
        data = self.uhd_streams()[0]
        h, w = self.uhd
        th, tw = -(-h // 4), -(-w // 4)
        (out, _), wall, comp = self.device(
            lambda: api.decode_sampled(data, tw, th))
        host, host_s = self.timed(lambda: host_sampled(data, 4))[:2]
        assert out.shape == (th, tw, 4), out.shape
        return dict(device_s=wall, compile_s=comp, host_s=host_s,
                    **compare(out[..., :3], host, 1))

    def phase_e(self):
        from jxl_coder import api
        h, w = self.fhd
        data = upsampled_noise_stream(h // 2, w // 2, self.seed + 20)
        (dev, _), wall, comp = self.device(lambda: api.decode(data))
        (host, _), host_s = self.host(lambda: api.decode(data))
        assert dev.shape == (h // 2 * 2, w // 2 * 2, 3), dev.shape
        return dict(device_s=wall, compile_s=comp, host_s=host_s,
                    **compare(dev, host, 1))

    def phase_f(self):
        from jxl_coder import api
        h, w = self.camera
        img = photo(h, w, self.seed + 30)
        n0 = front_calls()
        with env("JXL_DEVICE", self.device_env):
            d_dev, wall, comp = self.timed(lambda: api.encode(
                img, lossless=False, quality=90, effort=7))
        assert front_calls() > n0, "encoder front did not run on device"
        with env("JXL_DEVICE", self.device_env), \
                env("JXL_ENC_DEVICE", "0"):
            d_host, host_s, _ = self.timed(lambda: api.encode(
                img, lossless=False, quality=90, effort=7))
        with env("JXL_DEVICE", self.device_env):
            p_dev = psnr(api.decode(d_dev)[0], img)
            p_host = psnr(api.decode(d_host)[0], img)
        res = dict(device_s=wall, compile_s=comp, host_s=host_s,
                   bytes_device=len(d_dev), bytes_host=len(d_host),
                   psnr_device=p_dev, psnr_host=p_host)
        assert abs(len(d_dev) - len(d_host)) <= 0.02 * len(d_host), res
        assert abs(p_dev - p_host) < 0.1, res
        return res

    def phase_four(self, n_devices=4, frames=FOUR_FRAMES):
        """GOP-sharded decode (parallel.multihost.sharded_gop_real) of
        `frames` distinct frames over a 1-D mesh of n_devices, each
        frame against the one-device program at <= 1 code."""
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from jxl_coder import api
        from jxl_coder.parallel.multihost import sharded_gop_real
        from jxl_coder.vardct import device_full as TF
        assert len(jax.devices()) >= n_devices, jax.devices()
        h, w = self.fhd
        data = api.encode(photo(h, w, self.seed + 40), lossless=False,
                          quality=90, effort=7)
        state = _parse_state(data)
        static, args, mask = TF.prepare_exec(state)
        # distinct frames: the per-frame DC planes are offset
        dcs = np.stack([args[1] + np.float32(0.002 * f)
                        for f in range(frames)])
        bargs = jax.tree.map(
            lambda a, b: (np.broadcast_to(a, (frames,) + np.shape(a))
                          .copy() if b else a), args, mask)
        bargs = (bargs[0], dcs) + tuple(bargs[2:])
        mesh = Mesh(np.array(jax.devices()[:n_devices]), ("f",))
        gargs = jax.tree.map(
            lambda a, b: jax.device_put(
                a, NamedSharding(mesh, P("f") if b else P())), bargs, mask)
        fn = sharded_gop_real(mesh, static, mask)
        out, wall, comp = self.timed(
            lambda: jax.block_until_ready(fn(*gargs)))
        _, warm, _ = self.timed(lambda: jax.block_until_ready(fn(*gargs)))
        one = TF._compiled(**static)
        worst = {"max_diff": 0, "frac_diff": 0.0}
        out = np.asarray(out)
        for f in range(frames):
            ref = np.asarray(one(args[0], dcs[f], *args[2:]))
            r = compare(out[f], ref, 1)
            worst = {k: max(worst[k], r[k]) for k in worst}
        return dict(device_s=wall, device_warm_s=warm, compile_s=comp,
                    frames=frames, devices=n_devices, **worst)

    def run(self, names):
        for name in names:
            res = getattr(self, "phase_" + name)()
            self.log(json.dumps({"phase": name, **res}))


def _parse_state(data: bytes) -> dict:
    """The host-parsed device inputs of a one-frame stream."""
    from jxl_coder.vardct.dec_real import decode_vardct_frame
    with env("JXL_DEVICE", "1"):
        state = decode_vardct_frame(*parse_frame(data), parse_only=True)
    assert isinstance(state, dict), "stream is not device-eligible"
    return state


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the GOP-sharded decode over 4 GPUs")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    from jxl_coder import backend, native
    cache = backend.use_compile_cache()
    for line in card_lines():
        print(line)
    print(json.dumps({"jax": jax.__version__,
                      "native_host_library": native.get_lib() is not None,
                      "compile_cache": cache,
                      "devices": len(devs)}))
    sys.stdout.flush()
    smoke = Smoke(seed=args.seed, log=lambda s: print(s, flush=True))
    t0 = time.perf_counter()
    if args.four:
        assert len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}"
        smoke.run(["four"])
    else:
        smoke.run(["a", "b", "c", "d", "e", "f"])
    print(json.dumps({"total_s": time.perf_counter() - t0}))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
