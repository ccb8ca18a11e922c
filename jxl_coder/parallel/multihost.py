"""Multi-host scale-out: jax.distributed GOP sharding of the REAL
VarDCT reconstruction.

The scaling design of SURVEY.md §2.6/§7-step-10: animation frames/GOPs
shard across hosts (frames are independent after the host demux), and
within each host the devices split the GOP further.  The reference has
no cross-process story at all (it is a single-process mobile library);
this is the new design the north star requires.

Unlike the round-2 dryrun (a toy DCT8 program on rng inputs), the
program here IS the production multi-strategy path: each worker builds
a real codestream with the product encoder, entropy-decodes it on the
host (decode_vardct_frame(parse_only=True)), and the sharded program
vmaps device_full._build_fn — dequant + CfL + multi-size IDCT + gaborish
+ EPF + XYB->sRGB, identical to what api.decode dispatches — over a
GOP axis sharded across all processes' devices.

`multihost_dryrun()` runs it under real multi-process jax.distributed
(CPU platform, virtual devices), validates every process's addressable
output shards against the single-device product path (exact), and
measures the 1-process vs 2-process frames/s scaling efficiency
(BASELINE's ">=80% on 2 hosts" metric, on the CPU mesh).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

FRAMES_PER_DEVICE = 4


def _real_frame_state():
    """Encode a deterministic test image with the product encoder and
    host-parse it back to the device-ready state (the exact input of
    device_full.reconstruct_state_device)."""
    os.environ["JXL_DEVICE"] = "1"
    from ..bitstream.reader import BitReader
    from ..bitstream import container as container_mod
    from ..bitstream.headers import read_image_header
    from ..bitstream.frame_header import read_frame_header, read_toc
    from ..vardct.dec_real import decode_vardct_frame
    from ..vardct.enc_real import encode_vardct_real

    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:96, 0:160]
    img = np.clip(np.stack([
        120 + 70 * np.sin(yy / 13.0) + rng.integers(0, 24, yy.shape),
        (xx * 0.9) % 200, (xx + yy) % 220], -1), 0, 255).astype(np.uint8)
    data = encode_vardct_real(img, distance=1.0, effort=5)
    cs = container_mod.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    toc = read_toc(br, n)
    state = decode_vardct_frame(cs, hdr, fh, toc, parse_only=True)
    assert isinstance(state, dict), "test stream must be device-eligible"
    return state


def _exec_parts(state):
    """(static kwargs for _build_fn, single-frame args, batched-leaf
    mask) from a parsed state — the per-frame leaves shard on the GOP
    axis, the transform tables / qm / igs / perm_inv replicate."""
    from ..vardct import device_full as TF
    return TF.prepare_exec(state)


def _batch_args(args, mask, F):
    """Stack F copies of every batched leaf along a new leading axis."""
    import jax
    return jax.tree.map(
        lambda a, b: (np.broadcast_to(a, (F,) + np.shape(a)).copy()
                      if b else a), args, mask)


def sharded_gop_real(mesh, static, mask):
    """shard_map(vmap(real frame fn)) over the GOP axis "f": the
    production reconstruction, F frames split across every device of
    every process."""
    import jax
    from jax.sharding import PartitionSpec as P
    from ..vardct import device_full as TF
    from jax import shard_map

    fn1 = TF._build_fn(**static)
    in_axes = jax.tree.map(lambda b: 0 if b else None, mask)
    vf = jax.vmap(lambda *a: fn1(*a), in_axes=in_axes)
    in_specs = jax.tree.map(lambda b: P("f") if b else P(), mask)
    fn = shard_map(lambda *a: vf(*a), mesh=mesh,
                   in_specs=in_specs, out_specs=P("f"))
    return jax.jit(fn)


def worker_main(process_id: int, num_processes: int, port: int,
                devices_per_process: int) -> None:
    """One jax.distributed participant: real-format GOP-sharded decode
    + per-shard validation + throughput measurement."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=num_processes, process_id=process_id)
    n_dev = len(jax.devices())
    assert n_dev == num_processes * devices_per_process, n_dev

    state = _real_frame_state()
    static, args, mask = _exec_parts(state)
    F = FRAMES_PER_DEVICE * n_dev
    bargs = _batch_args(args, mask, F)

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()), ("f",))

    def to_global(arr, batched):
        sh = NamedSharding(mesh, P("f") if batched else P())
        return jax.make_array_from_callback(
            np.shape(arr), sh, lambda idx: np.asarray(arr)[idx])

    gargs = jax.tree.map(to_global, bargs, mask)
    fn = sharded_gop_real(mesh, static, mask)
    out = fn(*gargs)
    jax.block_until_ready(out)

    # validate own shards against the single-device PRODUCT path
    from ..vardct import device_full as TF
    ref = TF.reconstruct_state_device(state)
    h, w = int(state["h"]), int(state["w"])
    nbad = 0
    for shard in out.addressable_shards:
        local = np.asarray(shard.data)
        for f in range(local.shape[0]):
            if not np.array_equal(local[f, :h, :w], ref[:h, :w]):
                nbad += 1
    if nbad:
        print(f"[proc {process_id}] {nbad} frame shards diverge",
              file=sys.stderr)
        sys.exit(1)

    # steady-state throughput (compile excluded); best-of-reps so a
    # throttled/contended host does not corrupt the efficiency ratio
    reps = 5
    dt = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*gargs)
        jax.block_until_ready(out)
        dt = min(dt, time.perf_counter() - t0)
    fps = F / dt
    if process_id == 0:
        print(json.dumps({"frames": F, "fps": round(fps, 2),
                          "n_devices": n_dev,
                          "processes": num_processes}))
    print(f"[proc {process_id}] OK: "
          f"{len(out.addressable_shards)} local shards of {out.shape} "
          f"verified exactly vs the single-device product path",
          file=sys.stderr)


FRAMES_PER_DEVICE_ENC = 1


def _enc_frames(F: int):
    """F deterministic distinct test frames (identical on every
    process)."""
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:96, 0:160]
    noise = rng.integers(0, 24, (96, 160))
    frames = []
    for f in range(F):
        img = np.clip(np.stack([
            120 + 70 * np.sin((yy + 7 * f) / 13.0) + noise,
            (xx * 0.9 + 11 * f) % 200,
            (xx + yy + 29 * f) % 220], -1), 0, 255).astype(np.uint8)
        frames.append(img)
    return frames


def worker_encode_main(process_id: int, num_processes: int, port: int,
                       devices_per_process: int, total_frames: int) -> None:
    """GOP-sharded ENCODE participant: the F frames of an animation
    split frame-wise across every device of every process (frames are
    independent — the natural encode sharding axis, cf. the reference's
    encoder thread pool, jxl/thread_parallel_runner.h:46); each
    device's frames run the full product encoder (device front end +
    host bitstream) pinned to that device.  Bitstreams are reported as
    digests so the driver can check byte-identity against the
    single-process run."""
    import hashlib
    import jax
    jax.config.update("jax_platforms", "cpu")
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=num_processes, process_id=process_id)
    n_dev = len(jax.devices())
    assert n_dev == num_processes * devices_per_process, n_dev
    local = jax.local_devices()

    from ..vardct.enc_real import encode_vardct_real
    # weak scaling, like the decode dryrun: the GOP grows with the
    # device count (on this box host cores are the fixed resource, so
    # fixed-F strong scaling would only measure core contention);
    # byte-identity is still checked on the FIXED first
    # `total_frames` frames, which both runs encode.
    F = max(total_frames, FRAMES_PER_DEVICE_ENC * n_dev)
    frames = _enc_frames(F)
    mine = [f for f in range(F) if f % num_processes == process_id]

    # warm every local device's executables (device-pinned jits
    # compile per device; keep compiles out of the timed pass)
    for d in local:
        with jax.default_device(d):
            _ = encode_vardct_real(frames[mine[0]], distance=1.0,
                                   effort=5)

    # best-of-3: the 2-core box shows ~10% run-to-run noise, which
    # made the round-4 efficiency read a meaningless 1.11 (MULTICHIP
    # r04 review); three reps keep repeated dryruns within ~5%
    digests = {}
    wall = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        for k, f in enumerate(mine):
            with jax.default_device(local[k % len(local)]):
                blob = encode_vardct_real(frames[f], distance=1.0,
                                          effort=5)
            if f < total_frames:
                digests[f] = hashlib.sha256(blob).hexdigest()
        wall = min(wall, time.perf_counter() - t0)
    print(json.dumps({"pid": process_id, "frames": len(mine),
                      "wall": round(wall, 4), "digests": digests}))


def _run_encode_workers(num_processes, devices_per_process, timeout,
                        total_frames):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["JXL_DEVICE"] = "1"
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{devices_per_process}")
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "jxl_coder.parallel.multihost",
             str(pid), str(num_processes), str(port),
             str(devices_per_process), "encode", str(total_frames)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs, errs, fail = [], [], False
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            fail = True
        outs.append(out.decode(errors="replace"))
        errs.append(err.decode(errors="replace"))
        fail = fail or p.returncode != 0
    if fail:
        raise RuntimeError("multihost encode workers failed:\n"
                           + "\n".join(o + e for o, e in zip(outs, errs)))
    digests = {}
    wall = 0.0
    total = 0
    for o in outs:
        r = json.loads(o.strip().splitlines()[-1])
        digests.update({int(k): v for k, v in r["digests"].items()})
        wall = max(wall, r["wall"])
        total += r["frames"]
    return {"digests": digests, "wall": wall, "frames": total}


def multihost_encode_dryrun(num_processes: int = 2,
                            devices_per_process: int = 4,
                            timeout: float = 900.0) -> dict:
    """GOP-sharded animated/batch ENCODE under jax.distributed
    (BASELINE configs 3-4): frames encode across all devices of all
    processes; the N-process bitstreams must be byte-identical to the
    single-process run, and the frames/s scaling efficiency is
    measured.  Returns {"fps_1proc", "fps_nproc", "efficiency",
    "byte_identical"}."""
    n_dev = num_processes * devices_per_process
    # byte-identity is checked on these fixed frames; the per-run GOP
    # weak-scales with the device count
    F_CHECK = 4
    r1 = _run_encode_workers(1, devices_per_process, timeout, F_CHECK)
    rn = _run_encode_workers(num_processes, devices_per_process, timeout,
                             F_CHECK)
    identical = (r1["digests"] == rn["digests"]
                 and len(r1["digests"]) == F_CHECK)
    fps1 = r1["frames"] / r1["wall"]
    fpsn = rn["frames"] / rn["wall"]
    eff = fpsn / (num_processes * fps1)
    result = {"fps_1proc": round(fps1, 2), "fps_nproc": round(fpsn, 2),
              "num_processes": num_processes,
              "devices_per_process": devices_per_process,
              "efficiency": round(eff, 3),
              "byte_identical": bool(identical)}
    if not identical:
        raise RuntimeError(
            f"sharded encode bitstreams diverge: {result}")
    print(f"multihost_encode_dryrun: GOP-sharded encode OK — "
          f"{result['fps_1proc']} f/s @1proc vs {result['fps_nproc']} "
          f"f/s @{num_processes}proc ({devices_per_process} dev each): "
          f"scaling efficiency {eff:.2f}, bitstreams byte-identical")
    return result


def _run_workers(num_processes, devices_per_process, timeout):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["JXL_DEVICE"] = "1"
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{devices_per_process}")
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "jxl_coder.parallel.multihost",
             str(pid), str(num_processes), str(port),
             str(devices_per_process)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs, errs, fail = [], [], False
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            fail = True
        outs.append(out.decode(errors="replace"))
        errs.append(err.decode(errors="replace"))
        fail = fail or p.returncode != 0
    if fail:
        raise RuntimeError("multihost workers failed:\n"
                           + "\n".join(o + e for o, e in zip(outs, errs)))
    return json.loads(outs[0].strip().splitlines()[-1])


def multihost_dryrun(num_processes: int = 2,
                     devices_per_process: int = 4,
                     timeout: float = 900.0) -> dict:
    """Real-format GOP decode under jax.distributed: every process
    verifies its shards exactly against the single-device product path,
    and the 1-process vs N-process frames/s scaling efficiency is
    measured (CPU virtual devices; safe anywhere).  Returns
    {"fps_1": ..., "fps_n": ..., "efficiency": ...}."""
    r1 = _run_workers(1, devices_per_process, timeout)
    rn = _run_workers(num_processes, devices_per_process, timeout)
    eff = rn["fps"] / (num_processes * r1["fps"])
    result = {"fps_1proc": r1["fps"], "fps_nproc": rn["fps"],
              "num_processes": num_processes,
              "devices_per_process": devices_per_process,
              "efficiency": round(eff, 3)}
    print(f"multihost_dryrun: real-format GOP decode OK — "
          f"{r1['fps']} f/s @1proc vs {rn['fps']} f/s @{num_processes}"
          f"proc ({devices_per_process} dev each): scaling efficiency "
          f"{eff:.2f}")
    return result


if __name__ == "__main__":
    if len(sys.argv) > 5 and sys.argv[5] == "encode":
        worker_encode_main(int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), int(sys.argv[4]),
                           int(sys.argv[6]))
    else:
        worker_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                    int(sys.argv[4]))
