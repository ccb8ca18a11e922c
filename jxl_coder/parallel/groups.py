"""Group-grid sharding of the VarDCT decode over a device mesh.

The device equivalent of libjxl's resizable thread-pool runner
(SURVEY.md §2.6): groups/block-rows are embarrassingly parallel after the
TOC is parsed; cross-group context (Gaborish + EPF filter footprints) is
exchanged as 1-pixel-per-filter-pass halos via `jax.lax.ppermute` over the
mesh axis — device to device, never through the host.

Sharding layout: block rows (nY) are partitioned over the mesh axis "g".
Each shard runs the per-block dequant+IDCT (no halo needed), then
exchanges `halo` pixel rows with its neighbors, applies the filters on the
padded slab, and crops.  Output matches the single-device path.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..vardct import pipeline as pl


def make_mesh(n_devices: Optional[int] = None, axis: str = "g") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _exchange_halo(slab: jnp.ndarray, halo: int, axis_name: str):
    """slab: (C, rows, W) shard.  Returns slab padded with `halo` rows of
    real neighbor data on top/bottom (edge-replicated at global edges)."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    # send bottom rows down (they become the next shard's top halo)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i + 1, i) for i in range(n - 1)]
    bottom = slab[:, -halo:, :]
    top = slab[:, :halo, :]
    from_above = jax.lax.ppermute(bottom, axis_name, down)
    from_below = jax.lax.ppermute(top, axis_name, up)
    # boundary shards: edge-replicate own rows
    edge_top = jnp.repeat(slab[:, :1, :], halo, axis=1)
    edge_bottom = jnp.repeat(slab[:, -1:, :], halo, axis=1)
    from_above = jnp.where(idx == 0, edge_top, from_above)
    from_below = jnp.where(idx == n - 1, edge_bottom, from_below)
    return jnp.concatenate([from_above, slab, from_below], axis=1)


def sharded_reconstruct(mesh: Mesh, epf_iters: int = 1, gab: bool = True):
    """Build a jitted sharded decode fn over `mesh` (axis "g").

    Inputs must have nY divisible by the mesh size; use pad_to_shardable.
    Returns fn(ac, dc, qf, fx, fb, distance) -> (3, H, W) XYB.
    """
    axis = mesh.axis_names[0]
    halo = pl.filter_halo(epf_iters, gab)

    def per_shard(ac, dc, qf, fx, fb, distance):
        img = pl.dequant_idct(ac, dc, qf, fx, fb, distance)
        if halo == 0:
            return img
        inv_sigma = pl.inv_sigma_map(qf, distance)
        stacked = jnp.concatenate([img, inv_sigma[None]], axis=0)
        padded = _exchange_halo(stacked, halo, axis)
        return pl.apply_filters(padded[:3], padded[3], epf_iters, gab)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis), P(axis), P(axis),
                  P()),
        out_specs=P(None, axis))
    return jax.jit(fn)


def pad_to_shardable(ny: int, n_devices: int) -> int:
    """Block rows padded so each shard gets an equal slab."""
    per = -(-ny // n_devices)
    return per * n_devices


def pad_frame_arrays(ac, dc, qf, fx, fb, n_devices: int):
    """Pad block-row axis to a multiple of n_devices (qf padded with 8 to
    keep inv_sigma finite)."""
    ny = qf.shape[0]
    tot = pad_to_shardable(ny, n_devices)
    e = tot - ny
    if e == 0:
        return ac, dc, qf, fx, fb, ny
    ac = np.pad(ac, ((0, 0), (0, e), (0, 0), (0, 0), (0, 0)))
    dc = np.pad(dc, ((0, 0), (0, e), (0, 0)))
    qf = np.pad(qf, ((0, e), (0, 0)), constant_values=8)
    fx = np.pad(fx, ((0, e), (0, 0)))
    fb = np.pad(fb, ((0, e), (0, 0)))
    return ac, dc, qf, fx, fb, ny


# ---------------------------------------------------------------------------
# Real-format (wire-exact) sharded reconstruction
#
# Shards the post-entropy arrays of a real VarDCT frame (dec_real layout)
# over block rows.  Per shard: DC->XYB (+ adaptive DC smoothing with a
# 1-block-row halo), dequant+CfL+IDCT as matmuls, then an 8-pixel-row halo
# exchange between devices for gaborish + EPF stage 1, and the bit-exact
# XYB->sRGB8 conversion.  Matches the single-device
# `device_real.reconstruct_dct8_frame` output exactly (block-row count must
# be divisible by the mesh size).

def _fix_global_halo(padded, halo, idx, n):
    """Replace the halo rows of the first/last shard with edge replicas of
    the first/last REAL row — reproducing the single-device filters' edge
    padding semantics at the true image borders."""
    top_fix = padded.at[:, :halo, :].set(
        jnp.broadcast_to(padded[:, halo:halo + 1, :],
                         padded[:, :halo, :].shape))
    bot_fix = padded.at[:, -halo:, :].set(
        jnp.broadcast_to(padded[:, -halo - 1:-halo, :],
                         padded[:, -halo:, :].shape))
    padded = jnp.where(idx == 0, top_fix, padded)
    return jnp.where(idx == n - 1, bot_fix, padded)


def sharded_reconstruct_real(mesh: Mesh, gab: bool = True, epf: bool = True,
                             dc_smooth: bool = True):
    """Build a jitted sharded decoder for real-format DCT8 frames.

    `epf` takes the epf_iters count (bool True means 1); iters 1 and 2
    (the default-distance chain) are supported — the 8-pixel-row halo
    covers gaborish(1) + EPF1 reads(2+1) + EPF2(1).

    Returns fn(coeffs (3,ys,xs,64), dc (3,ys,xs), qf, sharp, xf, bf
    (ys,xs), table (3,64), igs, quant_dc, dcq (3,), qm_x, qm_b) ->
    (H, W, 3) uint8.  `ys` must be divisible by the mesh size.
    """
    from ..vardct import device_real as tr
    epf_iters = int(epf)
    axis = mesh.axis_names[0]
    n = int(np.prod(mesh.devices.shape))

    def per_shard(coeffs, dc, qf, sharp, xf, bf, table,
                  igs, quant_dc, dcq, qm_x, qm_b):
        idx = jax.lax.axis_index(axis)
        dc_steps = jnp.stack([dcq[0] * igs / quant_dc,
                              dcq[1] * igs / quant_dc,
                              dcq[2] * igs / quant_dc])
        dcp = tr.dc_xyb_planes(dc, dc_steps)
        if dc_smooth:
            # 3x3 on the DC grid: 1-block-row halo; global borders kept.
            ysh = dcp.shape[1]
            p = _exchange_halo(dcp, 1, axis)
            p = jnp.pad(p, ((0, 0), (0, 0), (1, 1)), mode="edge")
            c = p[:, 1:-1, 1:-1]
            w1, w2 = tr.DC_SMOOTH_W1, tr.DC_SMOOTH_W2
            w0 = 1.0 - 4.0 * (w1 + w2)
            sm = (w0 * c
                  + w1 * (p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
                          + p[:, 1:-1, :-2] + p[:, 1:-1, 2:])
                  + w2 * (p[:, :-2, :-2] + p[:, :-2, 2:]
                          + p[:, 2:, :-2] + p[:, 2:, 2:]))
            gap = jnp.max(jnp.abs(sm - c) / dc_steps[:, None, None], axis=0)
            gap = jnp.maximum(0.5, gap)
            mix = jnp.clip(3.0 - 4.0 * gap, 0.0, 1.0)
            out = c + (sm - c) * mix[None]
            grow = idx * ysh + jnp.arange(ysh)
            xs = dcp.shape[2]
            keep = ((grow == 0) | (grow == n * ysh - 1))[None, :, None] \
                | ((jnp.arange(xs) % (xs - 1) == 0))[None, None, :]
            dcp = jnp.where(keep, dcp, out)
        Xp, Yp, Bp = tr.synth_from_dcp(coeffs, dcp, qf, xf, bf, table,
                                       igs, qm_x, qm_b)
        if gab or epf:
            halo = 8  # 1 block row: covers gaborish(1) + EPF1 reads(3)
            slab = _exchange_halo(jnp.stack([Xp, Yp, Bp]), halo, axis)
            if gab:
                w1 = np.float32(0.115169525)
                w2 = np.float32(0.061248592)
                slab = jnp.stack([tr.gaborish_device(slab[c], w1, w2)
                                  for c in range(3)])
                # in-shard symmetric padding polluted only the outermost
                # halo row of interior shards (cropped); at the true image
                # borders restore edge-pad semantics for EPF's reads:
                slab = _fix_global_halo(slab, halo, idx, n)
            if epf_iters >= 1:
                sigma = (tr.EPF_SIGMA_PER * sharp.astype(jnp.float32)
                         * igs / jnp.maximum(qf.astype(jnp.float32), 1.0))
                sigp = _exchange_halo(sigma[None], 1, axis)[0]
                X2, Y2, B2 = tr.epf1_device(slab[0], slab[1], slab[2], sigp)
                if epf_iters >= 2:
                    # EPF1 polluted its outermost halo row (it read past
                    # the exchanged region); at true image borders the
                    # single-device path edge-replicates the EPF1 OUTPUT
                    # for pass 2 — restore both before the pass-2 reads.
                    slab2 = _fix_global_halo(jnp.stack([X2, Y2, B2]),
                                             halo, idx, n)
                    from ..vardct.device_full import _epf2_device
                    X2, Y2, B2 = _epf2_device(slab2[0], slab2[1],
                                              slab2[2], sigp, 6.5)
                slab = jnp.stack([X2, Y2, B2])
            slab = slab[:, halo:-halo, :]
            Xp, Yp, Bp = slab[0], slab[1], slab[2]
        return tr.xyb_to_srgb8_device(Xp, Yp, Bp)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis), P(axis), P(axis),
                  P(axis), P(), P(), P(), P(), P(), P()),
        out_specs=P(axis))
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Frame-level (GOP) sharding for animation decode

def sharded_frame_reconstruct(mesh: Mesh, epf_iters: int = 1,
                              gab: bool = True):
    """Batch-decode N frames with the frame axis sharded over the mesh —
    the GOP-sharding axis of SURVEY.md §2.6 (animation frames are
    independent for REPLACE blending).

    Returns fn(ac (N,3,nY,nX,8,8), dc (N,3,nY,nX), qf (N,nY,nX),
    fx, fb (N,nY,nX), distance) -> (N, 3, H, W) XYB.
    N must be divisible by the mesh size.
    """
    import jax.numpy as jnp
    axis = mesh.axis_names[0]
    halo = pl.filter_halo(epf_iters, gab)

    def one(ac, dc, qf, fx, fb, distance):
        img = pl.dequant_idct(ac, dc, qf, fx, fb, distance)
        img = pl.pad_rows(img, halo)
        inv = pl.pad_rows(pl.inv_sigma_map(qf, distance), halo)
        return pl.apply_filters(img, inv, epf_iters, gab)

    def per_shard(ac, dc, qf, fx, fb, distance):
        return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None))(
            ac, dc, qf, fx, fb, distance)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis))
    return jax.jit(fn)
