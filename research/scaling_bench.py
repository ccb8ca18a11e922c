"""Partitioning-overhead measurement for the sharded 4K VarDCT decode.

Runs the real-format sharded reconstruction over CPU meshes of
1/2/4/8 virtual devices.  All virtual devices share the same host
cores, so wall-clock cannot SPEED UP with mesh size here; what the
sweep shows is that the partitioned program executes correctly at
every mesh size and what the 2-core host charges for it (~40-50%,
dominated by per-shard dispatch and lost cross-shard fusion on shared
cores — NOT a proxy for multi-GPU efficiency, where each shard owns a
card).  The real multi-chip efficiency argument is structural: the
sharded output is bit-exact vs single-device (dryrun_multichip), and
the only collective is the filter halo exchange — 8 pixel rows x W x
4 planes ~ 0.5 MB per shard boundary against ~100 MB of per-shard
HBM traffic: <1% communication at 8 shards, so >80% frames/s scaling
efficiency needs only ordinary compute overlap.

Usage: python research/scaling_bench.py
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
sys.path.insert(0, "/root/repo")

import numpy as np


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jxl_coder.parallel import groups as G
    from jxl_coder.vardct.synthesis import dequant_table

    w, h = 3840, 2176          # 272 block rows: divisible by 8 shards
    ny, nx = h // 8, w // 8
    rng = np.random.default_rng(0)
    coeffs = np.zeros((3, ny, nx, 64), np.float32)
    mask = rng.random((3, ny, nx, 64)) < 0.12
    coeffs[mask] = rng.integers(-30, 30, int(mask.sum()))
    dc = rng.integers(-100, 100, (3, ny, nx)).astype(np.int32)
    qf = np.full((ny, nx), 20, np.int32)
    sharp = np.full((ny, nx), 4, np.int32)
    xf = np.zeros((ny, nx), np.float32)
    bf = np.ones((ny, nx), np.float32)
    table = np.stack([dequant_table(0, c).astype(np.float32)
                      for c in range(3)])
    igs = np.float32(65536.0 / 7340)
    dcq = np.asarray([0.000244140625, 0.001953125, 0.00390625],
                     np.float32)
    one = np.float32(1.0)

    results = {}
    for n in (1, 2, 4, 8):
        if n > len(jax.devices()):
            break
        mesh = G.make_mesh(n)
        fn = G.sharded_reconstruct_real(mesh)
        args = (coeffs, dc, qf, sharp, xf, bf, table,
                igs, np.float32(10.0), dcq, one, one)
        out = fn(*args)
        np.asarray(out)  # force
        best = None
        for _ in range(5):
            t0 = time.time()
            out = fn(*args)
            np.asarray(out)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        dt = best
        results[n] = dt
        over = dt / results[1] - 1.0
        print(f"mesh={n}: {dt*1e3:7.1f} ms/frame  "
              f"partitioning overhead {over*100:+5.1f}%")
    return results


if __name__ == "__main__":
    main()
