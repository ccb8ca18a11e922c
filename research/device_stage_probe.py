"""Device-stage measurements of the 4K VarDCT decode on one GPU.

1. Variants of the jitted frame program (device_full._compiled) on one
   parsed 3840x2160 e7 d1.0 stream, timed in turns (A B C C B A): matmul
   precision HIGHEST / HIGH / DEFAULT, and "bigc", which runs the
   inverse transform of the 16x16, 16x8 and 8x16 families as one
   block-diagonal-over-channels matmul (3x the FLOPs, no transpose).
   Each variant's output is compared with the float64 host oracle.
2. A profiler trace of each chosen variant, split by named scope
   (synthesis per strategy family, gather and detile, filters, colour)
   with jxl_coder.utils.devtrace, and the device busy share.
3. The host/device crossover of api.decode at 128^2 .. 1024^2, which
   sets dec_real.DEVICE_MIN_BLOCKS.

    python research/device_stage_probe.py --only variants crossover
    XLA_FLAGS=--xla_gpu_enable_command_buffer= \
        python research/device_stage_probe.py --only trace \
        --variants highest bigc

The trace runs with command buffers off, so that every kernel carries
its HLO instruction name (see jxl_coder.utils.devtrace).  Prints one
JSON object per measurement and writes them to
<out>/device_stage_probe_<parts>.json.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402

SCOPE_KEYS = ("synth_", "gather_detile", "filters", "colour")
VARIANTS = ("highest", "high", "default", "bigc")
PER_CHANNEL = None     # device_full._inverse_tiles as shipped; set in main


def inverse_tiles_bigc(cm3, bh, bw):
    """device_full._inverse_tiles with the channels folded into one
    block-diagonal (3K, T*192) matrix, whose output columns are already
    flat tile rows: no transpose, 3x the FLOPs.  Only for families of
    more than one tile and K <= 256."""
    import jax.numpy as jnp
    from jxl_coder import backend
    from jxl_coder.vardct import device_full as TF
    K, T = bh * bw, (bh // 8) * (bw // 8)
    if T == 1 or K > 256:
        return PER_CHANNEL(cm3, bh, bw)
    big = np.zeros((3, K, T, 3, 64), np.float32)
    for c in range(3):
        big[c, :, :, c, :] = TF._inv_matrix(bh, bw).reshape(K, T, 64)
    n = cm3.shape[0]
    tiles = jnp.einsum("nk,kp->np", cm3.reshape(n, 3 * K),
                       big.reshape(3 * K, T * 192),
                       precision=backend.PRECISION)
    return tiles.reshape(n * T, 192)


def use_variant(name):
    """Point device_full at one variant and drop its compiled
    programs."""
    import jax
    from jxl_coder import backend
    from jxl_coder.vardct import device_full as TF
    backend.PRECISION = {"high": jax.lax.Precision.HIGH,
                         "default": jax.lax.Precision.DEFAULT}.get(
                             name, jax.lax.Precision.HIGHEST)
    TF._inverse_tiles = (inverse_tiles_bigc if name == "bigc"
                         else PER_CHANNEL)
    TF._compiled.cache_clear()


def timed_runs(fn, args, reps):
    """Per-run wall ms of fn(*args) ending in block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--size", type=int, nargs=2, default=CS.UHD,
                    metavar=("H", "W"))
    ap.add_argument("--crossover", type=int, nargs="*",
                    default=(128, 256, 512, 1024))
    ap.add_argument("--only", nargs="+",
                    default=("variants", "trace", "crossover"),
                    choices=("variants", "trace", "crossover"))
    ap.add_argument("--variants", nargs="+", default=VARIANTS[:3],
                    choices=VARIANTS)
    ap.add_argument("--rehearse", action="store_true",
                    help="allow the CPU backend (tiny sizes, no timings "
                         "worth keeping)")
    args_ = ap.parse_args(argv)
    import jax
    plat = jax.devices()[0].platform
    assert plat == "gpu" or args_.rehearse, jax.devices()
    from jxl_coder import api, backend
    from jxl_coder.vardct import device_full as TF
    global PER_CHANNEL
    PER_CHANNEL = TF._inverse_tiles
    backend.use_compile_cache()
    os.makedirs(args_.out, exist_ok=True)
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"card": CS.card_lines() if plat == "gpu" else None,
          "jax": jax.__version__,
          "device_kind": jax.devices()[0].device_kind})

    h, w = args_.size
    data = api.encode(CS.photo(h, w, 0), lossless=False, quality=90,
                      effort=7)
    with CS.env("JXL_DEVICE", "0"):
        host, _ = api.decode(data)
    state = CS._parse_state(data)
    static, args, _ = TF.prepare_exec(state)
    dargs = jax.device_put(args)
    emit({"stream_bytes": len(data),
          "families": [list(d[:3]) for d in static["desc"]]})

    if "variants" in args_.only:
        variants(args_, static, dargs, host, emit)
    if "trace" in args_.only:
        trace(args_, static, dargs, plat, emit)
    if "crossover" in args_.only:
        crossover(args_, data, emit)
    name = "_".join(list(args_.only) + list(args_.variants)) + (
        "_nocmdbuf" if "command_buffer=" in os.environ.get("XLA_FLAGS", "")
        else "")
    with open(os.path.join(args_.out, f"device_stage_probe_{name}.json"),
              "w") as f:
        json.dump(records, f, indent=1)


def variants(args_, static, dargs, host, emit):
    """Variants of the frame program, timed in turns."""
    from jxl_coder.vardct import device_full as TF
    h, w = host.shape[:2]
    variants = list(args_.variants)
    fns, outs = {}, {}
    for name in variants:
        use_variant(name)
        fns[name] = TF._compiled(**static)
        outs[name] = np.asarray(fns[name](*dargs))[:h, :w]
    use_variant("highest")
    times = {k: [] for k in variants}
    order = list(variants) + list(variants)[::-1]
    for name in order:
        times[name] += timed_runs(fns[name], dargs, args_.reps // 2)
    ref = outs[variants[0]]
    for name in variants:
        d_host = np.abs(outs[name].astype(int) - host.astype(int))
        d_ref = np.abs(outs[name].astype(int) - ref.astype(int))
        emit({"variant": name, "median_ms": float(np.median(times[name])),
              "min_ms": float(np.min(times[name])),
              "vs_host_max": int(d_host.max()),
              "vs_host_mean": float(d_host.mean()),
              "vs_host_frac": float((d_host > 0).mean()),
              "vs_first_max": int(d_ref.max()),
              "vs_first_mean": float(d_ref.mean())})


def trace(args_, static, dargs, plat, emit):
    for name in args_.variants:
        use_variant(name)
        trace_one(args_, name, static, dargs, plat, emit)
    use_variant("highest")


def trace_one(args_, variant, static, dargs, plat, emit):
    """Profiler trace of the frame program, split by named scope."""
    import jax
    from jxl_coder.utils import devtrace
    from jxl_coder.vardct import device_full as TF
    fn = TF._compiled(**static)
    scopes = devtrace.hlo_scopes(fn.lower(*dargs).compile().as_text())
    logdir = os.path.join(args_.out, "trace_4k_" + variant)
    runs = 5
    jax.block_until_ready(fn(*dargs))
    t0 = time.perf_counter()
    with jax.profiler.trace(logdir):
        for _ in range(runs):
            jax.block_until_ready(fn(*dargs))
    window_ms = (time.perf_counter() - t0) * 1e3
    events = devtrace.op_events(
        devtrace.xplane_path(logdir),
        "/device:GPU" if plat == "gpu" else "/host:CPU")
    split = devtrace.split_by_scope(events, scopes, SCOPE_KEYS)
    per_run = {k: v / runs / 1e6 for k, v in sorted(split.items())}
    stage = sum(per_run.values())
    busy = devtrace.busy_ns(events) / 1e6
    kernels = {}
    for e in events:
        kernels[e.name[:50]] = kernels.get(e.name[:50], 0.0) \
            + e.dur_ns / runs / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    unmapped = sorted({e.name[:60] for e in events
                       if devtrace.op_name_of(e, scopes) is None})[:20]
    emit({"variant": variant, "trace_split_ms_per_run": per_run,
          "device_ms_per_run": stage,
          "filters_share": per_run.get("filters", 0.0) / max(stage, 1e-9),
          "busy_ms_in_window": busy, "window_ms": window_ms,
          "idle_share": 1.0 - busy / window_ms,
          "top_kernels_ms": top,
          "events": len(events), "unmapped_ops": unmapped})


def crossover(args_, data, emit):
    """api.decode host against device at a few square sizes."""
    from jxl_coder import api
    for n in args_.crossover:
        d = api.encode(CS.photo(n, n, n), lossless=False, quality=90,
                       effort=7)
        rec = {"crossover_px": n, "blocks": (n // 8) ** 2}
        for mode in ("0", "1"):
            with CS.env("JXL_DEVICE", mode):
                t0 = time.perf_counter()
                api.decode(d)
                first = time.perf_counter() - t0
                best = float("inf")
                for _ in range(5):
                    t0 = time.perf_counter()
                    api.decode(d)
                    best = min(best, time.perf_counter() - t0)
            key = "host" if mode == "0" else "device"
            rec[key + "_first_ms"] = first * 1e3
            rec[key + "_warm_ms"] = best * 1e3
        emit(rec)
    for mode in ("0", None):
        with CS.env("JXL_DEVICE", mode):
            api.decode(data)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                api.decode(data)
                best = min(best, time.perf_counter() - t0)
        emit({"api_decode_4k": "host" if mode == "0" else "auto",
              "warm_ms": best * 1e3})


if __name__ == "__main__":
    main()
