"""Headline benchmark: 4K VarDCT decode on one GPU, against a
baseline measured from the system libjxl 0.7 on the same host.

Prints ONE JSON line.  Fields:
  metric/value/unit     — device reconstruction throughput for the REAL
                          multi-strategy 4K frame (actually-parsed
                          coefficients: the 4K test stream is entropy-
                          decoded on the host once, and the device
                          pipeline — dequant + CfL + multi-size IDCT +
                          gaborish + EPF + XYB->sRGB — is timed on the
                          parsed state; BASELINE.md config[2]).
  end_to_end_mps        — steady-state batched bytes->pixels MP/s:
                          api.decode_batch pipelines host entropy
                          decode with device dispatch and the d2h
                          pixel fetch of earlier frames.
  end_to_end_single_mps — one-shot api.decode wall time (cold pipeline)
                          for the same stream.
  libjxl_*_mps          — system libjxl 0.7 measured on the same host
                          (1 and 2 threads), plus the 8-thread
                          extrapolation at the measured 1->2 scaling
                          efficiency.
  vs_baseline           — value / (2 x libjxl-8-thread extrapolation),
                          i.e. headroom over the BASELINE.md target of
                          2x libjxl 8-thread CPU decode.

The K-frame device loop runs via lax.scan so one dispatch covers K
frames; completion is awaited with block_until_ready.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.environ["JXL_DEVICE"] = "1"

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
STREAM_CACHE = os.path.join(CACHE, "bench4k_v2.jxl")
W, H = 3840, 2160
K = 16


def _test_frame():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rng = np.random.default_rng(42)
    img = np.stack([
        128 + 90 * np.sin(yy / 97) + 40 * np.cos(xx / 53),
        120 + 80 * np.sin((xx + yy) / 71) + 30 * np.sin(xx / 29),
        110 + 70 * np.cos(yy / 41) + 50 * np.sin(xx / 113)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _get_stream():
    """4K d1.0 e7 stream; prefer the system libjxl encoder (a true
    reference stream with adaptive quant + multi-size strategies),
    falling back to our own encoder."""
    if os.path.exists(STREAM_CACHE):
        return open(STREAM_CACHE, "rb").read(), "cached"
    img = _test_frame()
    src = "jxl_coder-encoder"
    try:
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "research"))
        import refjxl
        data = refjxl.encode_ex(img, distance=1.0, effort=7)
        src = "libjxl-0.7-e7-d1.0"
    except (ImportError, OSError):
        from jxl_coder.vardct.enc_real import encode_vardct_real
        data = encode_vardct_real(img, distance=1.0, effort=7)
    os.makedirs(CACHE, exist_ok=True)
    with open(STREAM_CACHE, "wb") as f:
        f.write(data)
    return data, src


def _measure_libjxl(data):
    try:
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "research"))
        import refjxl
        # warm-up + best-of-6: take the MAX across reps so the
        # baseline reflects libjxl's capability, not the host's load at
        # that moment
        _ = refjxl.measure_decode_mps(data, 1, reps=1)
        m1 = refjxl.measure_decode_mps(data, 1, reps=6)
        m2 = refjxl.measure_decode_mps(data, 2, reps=6)
        # 1->2 thread efficiency is itself noisy; clamp to a plausible
        # band so a contended 2-thread rep can't halve the extrapolated
        # target
        eff = min(1.0, max(0.8, m2 / (2.0 * m1)))
        m8 = m1 * 8.0 * eff
        return m1, m2, m8
    except (ImportError, OSError):
        # system libjxl unavailable: no baseline
        return None, None, None


def main():
    import jax
    import jax.numpy as jnp
    from jxl_coder import backend

    backend.use_compile_cache()

    data, src = _get_stream()
    m1, m2, m8 = _measure_libjxl(data)

    from jxl_coder import api
    from jxl_coder.bitstream.reader import BitReader
    from jxl_coder.bitstream import container as container_mod
    from jxl_coder.bitstream.headers import read_image_header
    from jxl_coder.bitstream.frame_header import (read_frame_header,
                                                      read_toc)
    from jxl_coder.vardct import dec_real, device_full as TF

    # ---- end-to-end bytes -> pixels ----
    _ = api.decode(data)  # warm: XLA compile (persistent-cached) + code
    e2e = float("inf")
    for _i in range(2):
        t0 = time.perf_counter()
        out, _ = api.decode(data)
        e2e = min(e2e, time.perf_counter() - t0)
    e2e_single_mps = W * H / e2e / 1e6
    # steady-state: batched pipeline (host entropy || device || d2h)
    KB = 6
    t0 = time.perf_counter()
    outs = api.decode_batch([data] * KB)
    bt = time.perf_counter() - t0
    assert len(outs) == KB and outs[0].shape[:2] == (H, W)
    e2e_mps = KB * W * H / bt / 1e6

    # ---- lossy encode (device front end: XYB/DCT/RD on accelerator) --
    crop = np.asarray(out[:512, :512, :3], np.uint8)
    _ = api.encode(crop, lossless=False, quality=90)     # warm/compile
    et = float("inf")
    for _i in range(3):
        t0 = time.perf_counter()
        enc_bytes = api.encode(crop, lossless=False, quality=90)
        et = min(et, time.perf_counter() - t0)
    enc_mps = 512 * 512 / et / 1e6
    # same-shape same-distance libjxl encode baseline (e7 d1.0, the
    # settings quality=90 maps to), so the record shows the ratio
    libjxl_enc_mps = None
    try:
        import refjxl
        _ = refjxl.encode_ex(crop, distance=1.0, effort=7)
        let = float("inf")
        for _i in range(3):
            t0 = time.perf_counter()
            _ = refjxl.encode_ex(crop, distance=1.0, effort=7)
            let = min(let, time.perf_counter() - t0)
        libjxl_enc_mps = 512 * 512 / let / 1e6
    except (ImportError, OSError):
        pass

    # ---- feature-path decode: a noisy FHD stream (written by the
    # system libjxl) through the device post stages.  Wall time
    # includes the d2h transfer; the stage metric below is the
    # transfer-free number. ----
    noisy_mps = None
    NC = os.path.join(CACHE, "bench_noisy_fhd.jxl")
    ndata = None
    if os.path.exists(NC):
        ndata = open(NC, "rb").read()
    else:
        try:
            sys.path.insert(0, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "research"))
            from encopts import encode_opts
            nimg = np.asarray(_test_frame()[:1080, :1920], np.uint8)
            ndata = encode_opts(nimg, {6: 1}, lossless=False,
                                distance=1.0)
        except (ImportError, OSError):
            pass
        if ndata is not None:
            os.makedirs(CACHE, exist_ok=True)
            with open(NC, "wb") as f:
                f.write(ndata)
    if ndata is not None:
        _ = api.decode(ndata)      # warm/compile
        nt = float("inf")
        for _i in range(2):
            t0 = time.perf_counter()
            nout, _ = api.decode(ndata)
            nt = min(nt, time.perf_counter() - t0)
        assert nout.shape[:2] == (1080, 1920)
        noisy_mps = 1920 * 1080 / nt / 1e6

    # ---- modular inverse transforms on device (opt-in path): steady-
    # state MP/s of the squeeze+RCT pixel math on a lossless FHD
    # frame, compiles and the one-shot warm excluded ----
    mimg = np.asarray(_test_frame()[:1080, :1920], np.uint8)
    mdata = api.encode(mimg, lossless=True, effort=3)
    os.environ["JXL_MODULAR_DEVICE"] = "1"
    try:
        mout, _ = api.decode(mdata)              # warm/compile
        assert np.array_equal(mout, mimg)
        mt = float("inf")
        for _i in range(2):
            t0 = time.perf_counter()
            mout, _ = api.decode(mdata)
            mt = min(mt, time.perf_counter() - t0)
    finally:
        os.environ.pop("JXL_MODULAR_DEVICE", None)
    modular_dev_mps = 1920 * 1080 / mt / 1e6

    # ---- parse once, time device reconstruction on the real state ----
    cs = container_mod.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    toc = read_toc(br, n)
    state = {}
    dec_real.decode_vardct_frame(cs, hdr, fh, toc, state_out=state)
    if state.get("blocks_glob") is None:
        raise SystemExit("device path unavailable for the bench stream")

    lf = state["lf"]
    desc, fams, qm, perm_inv = TF.prepare_families(
        lf, fh, state["blocks_glob"], state["qf_map"],
        state["ytox_glob"], state["ytob_glob"])
    ys_b, xs_b = state["qf_map"].shape
    rf = fh.restoration_filter
    if rf.gab and rf.gab_custom and rf.gab_weights is not None:
        gabw = tuple(float(g) for g in rf.gab_weights)
    else:
        gabw = (0.115169525, 0.061248592) * 3
    fn = TF._compiled(desc, ys_b * 8, xs_b * 8, int(state["bits"]),
                      bool(rf.gab), int(rf.epf_iters), gabw,
                      float(rf.epf_pass0_sigma_scale),
                      float(rf.epf_pass2_sigma_scale),
                      int(state["h"]), int(state["w"]))
    dc = jnp.asarray(np.stack([state["dc_glob"][c] for c in range(3)])
                     .astype(np.float32))
    qf = jnp.asarray(state["qf_map"].astype(np.int32))
    sharp = jnp.asarray(state["sharp_map"].astype(np.int32))
    igs = np.float32(lf.inv_global_scale)
    fams_d = jax.device_put(fams)
    qm_d = jnp.asarray(qm)
    perm_d = jnp.asarray(perm_inv)

    @jax.jit
    def run_k(fams_, dc_, qf_, sharp_, qm_, perm_):
        def body(carry, i):
            dc2 = dc_ + i.astype(jnp.float32) * 1e-6  # defeat CSE
            o = fn(fams_, dc2, qf_, sharp_, igs, qm_, perm_)
            return carry + jnp.sum(o.astype(jnp.uint32)), None
        total, _ = jax.lax.scan(body, jnp.uint32(0), jnp.arange(K))
        return total

    run_k(fams_d, dc, qf, sharp, qm_d, perm_d).block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_k(fams_d, dc, qf, sharp, qm_d, perm_d).block_until_ready()
        best = min(best, (time.perf_counter() - t0) / K)
    stage_mps = W * H / best / 1e6

    target = 2.0 * m8 if m8 else None
    print(json.dumps({
        "metric": "4k_vardct_device_decode_real_coeffs",
        "value": round(stage_mps, 2),
        "unit": "MP/s",
        "vs_baseline": (round(stage_mps / target, 3) if target
                        else None),
        "end_to_end_mps": round(e2e_mps, 3),
        "end_to_end_single_mps": round(e2e_single_mps, 3),
        "noisy_fhd_decode_mps": (round(noisy_mps, 3)
                                 if noisy_mps else None),
        "modular_device_fhd_mps": (round(modular_dev_mps, 3)
                                   if modular_dev_mps else None),
        "encode_512_mps": round(enc_mps, 3),
        "encode_512_s": round(et, 3),
        "libjxl_encode_512_mps": (round(libjxl_enc_mps, 3)
                                  if libjxl_enc_mps else None),
        "encode_vs_libjxl": (round(enc_mps / libjxl_enc_mps, 3)
                             if libjxl_enc_mps else None),
        "libjxl_1t_mps": round(m1, 1) if m1 else None,
        "libjxl_2t_mps": round(m2, 1) if m2 else None,
        "libjxl_8t_extrapolated_mps": round(m8, 1) if m8 else None,
        "baseline_target_mps": round(target, 1) if target else None,
        "stream": src,
        "n_varblocks": len(state["blocks_glob"]),
        "strategies": sorted({d[0] for d in desc}),
    }))


if __name__ == "__main__":
    main()
