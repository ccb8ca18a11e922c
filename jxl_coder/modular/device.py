"""Modular inverse transforms on the device (jnp): RCT, palette and
squeeze pixel math over host-entropy-decoded planes.

The entropy lanes stay host-side (research/entropy_batch_probe.py), but
the post-entropy pixel math is elementwise work over whole planes —
separable passes that XLA fuses.
The inverse squeeze's sequential neighbour dependency runs as one
lax.scan over the squeeze axis with full rows/columns in lanes.

Bit-exact: integer ops mirror modular/transform.py (the host oracle)
op-for-op — arithmetic shifts, floor divisions and the SmoothTendency
truncating division translate 1:1 to jnp int32; tests cross-check
equality, not closeness.  Reference: the SIMD inverse-transform loops
inside libjxl's modular/transform/ (shipped prebuilt in the wrapper's
libjxl.so; SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import backend
from .image import Channel, ModularImage
from . import transform as T


def device_enabled() -> bool:
    """Opt-in (JXL_MODULAR_DEVICE=1).  The path is bit-exact, but
    each lax.scan shape compiles once; it becomes the default only if
    it beats the host path end to end on the GPU (not measured yet,
    ROADMAP C5)."""
    env = backend.knob("JXL_MODULAR_DEVICE")
    if env is not None and env != "":
        return env != "0"
    return False


def _smooth_tendency_jnp(a, b, c):
    import jax.numpy as jnp
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    c = c.astype(jnp.int32)
    zero = jnp.zeros_like(a)
    m1 = (a >= b) & (b >= c)
    x = (4 * a - 3 * c - b + 6) // 12
    x = jnp.where(x - (x & 1) > 2 * (a - b), 2 * (a - b) + 1, x)
    x = jnp.where(x + (x & 1) > 2 * (b - c), 2 * (b - c), x)
    out = jnp.where(m1, x, zero)
    m2 = (a <= b) & (b <= c)
    num = 4 * a - 3 * c - b - 6
    y = -((-num) // 12)
    y = jnp.where(y + (y & 1) < 2 * (a - b), 2 * (a - b) - 1, y)
    y = jnp.where(y - (y & 1) < 2 * (b - c), 2 * (b - c), y)
    return jnp.where(m2, y, out)


def _unsqueeze_1d_jnp(avg, res, out_len: int):
    """Device mirror of transform._unsqueeze_1d: inverse squeeze along
    the LAST axis via lax.scan (the left neighbour is the carry)."""
    import jax
    import jax.numpy as jnp
    na = avg.shape[-1]
    nr = res.shape[-1]
    avg = avg.astype(jnp.int32)
    res = res.astype(jnp.int32)
    # k-major layout for the scan
    avg_k = jnp.moveaxis(avg, -1, 0)               # (na, ...)
    next_k = jnp.concatenate([avg_k[1:], avg_k[-1:]], axis=0)
    if nr < na:
        pad = jnp.zeros((na - nr,) + res.shape[:-1], jnp.int32)
        res_k = jnp.concatenate([jnp.moveaxis(res, -1, 0), pad], axis=0)
    else:
        res_k = jnp.moveaxis(res, -1, 0)
    has_r = (jnp.arange(na) < nr)

    def step(left, xs):
        a, nxt, r, hr = xs
        diff = r + _smooth_tendency_jnp(left, a, nxt)
        half = jnp.sign(diff) * (jnp.abs(diff) >> 1)
        first = a + half
        second = first - diff
        out0 = jnp.where(hr, first, a)
        out1 = jnp.where(hr, second, a)
        return out1, (out0, out1)

    _, (o0, o1) = jax.lax.scan(step, avg_k[0],
                               (avg_k, next_k, res_k, has_r))
    out = jnp.stack([o0, o1], axis=1)              # (na, 2, ...)
    out = jnp.moveaxis(out.reshape((2 * na,) + o0.shape[1:]), 0, -1)
    return out[..., :out_len]


def _rct_inverse_jnp(c0, c1, c2, typ: int):
    import jax.numpy as jnp
    a, b, c = (x.astype(jnp.int32) for x in (c0, c1, c2))
    if typ == 0:
        return a, b, c
    if typ == 1:
        return a, b, c + a
    if typ == 2:
        return a, b + a, c
    if typ == 3:
        return a, b + a, c + a
    if typ == 4:
        return a, b + ((a + c) >> 1), c
    if typ == 5:
        c2_ = c + a
        return a, b + ((a + c2_) >> 1), c2_
    if typ == 6:
        y, co, cg = a, b, c
        tmp = y - (cg >> 1)
        g = cg + tmp
        bb = tmp - (co >> 1)
        r = bb + co
        return r, g, bb
    raise ValueError("bad RCT type")


def undo_transforms_device(image: ModularImage, header) -> bool:
    """Run the full inverse-transform chain on device; returns False
    (leaving the image untouched) when any piece is unsupported, so
    the caller falls back to the host oracle."""
    for t in header.transforms:
        if t.id == 0:
            pass
        elif t.id == 1:
            if t.nb_deltas:
                return False
        elif t.id == 2:
            pass
        else:
            return False
    import jax
    import jax.numpy as jnp

    chans = [jnp.asarray(np.ascontiguousarray(c.data, np.int32))
             for c in image.channels]
    metas = [(c.width, c.height, c.hshift, c.vshift)
             for c in image.channels]
    nb_meta = image.nb_meta_channels

    for t in reversed(header.transforms):
        if t.id == 0:                              # RCT
            b = t.begin_c
            if b < 0 or b + 3 > len(chans):
                return False
            perm = t.rct_type // 7
            typ = t.rct_type % 7
            outs = _rct_inverse_jnp(chans[b], chans[b + 1],
                                    chans[b + 2], typ)
            p = T._PERMUTATIONS[perm]
            result = [None, None, None]
            for i in range(3):
                result[p[i]] = outs[i]
            for i in range(3):
                chans[b + i] = result[i]
        elif t.id == 1:                            # palette
            bnc = t.begin_c
            pal = chans[0]                         # (n, colours)
            idx = chans[bnc + 1]
            nbcol = t.nb_colours
            outs = []
            for c in range(t.num_c):
                within = (idx >= 0) & (idx < nbcol)
                g = pal[c][jnp.clip(idx, 0, nbcol - 1)]
                out = jnp.where(within, g,
                                jnp.where(idx >= nbcol, idx - nbcol, 0))
                outs.append(out.astype(jnp.int32))
            w, h, hs, vs = metas[bnc + 1]
            chans = chans[1:bnc + 1] + outs + chans[bnc + 2:]
            metas = metas[1:bnc + 1] + [(w, h, hs, vs)] * t.num_c \
                + metas[bnc + 2:]
            nb_meta -= 1
        elif t.id == 2:                            # squeeze
            for s in reversed(t.squeezes):
                base = len(chans) - s.num_c
                for i in reversed(range(s.num_c)):
                    c = s.begin_c + i
                    res_idx = (s.begin_c + s.num_c + i
                               if s.in_place else base + i)
                    aw, ah, ahs, avs = metas[c]
                    rw, rh, _, _ = metas[res_idx]
                    if s.horizontal:
                        out_len = aw + rw
                        out = _unsqueeze_1d_jnp(chans[c],
                                                chans[res_idx], out_len)
                        metas[c] = (out_len, ah, ahs - 1, avs)
                    else:
                        out_len = ah + rh
                        out = _unsqueeze_1d_jnp(
                            jnp.swapaxes(chans[c], -1, -2),
                            jnp.swapaxes(chans[res_idx], -1, -2),
                            out_len)
                        out = jnp.swapaxes(out, -1, -2)
                        metas[c] = (aw, out_len, ahs, avs - 1)
                    chans[c] = out
                    del chans[res_idx]
                    del metas[res_idx]

    new_channels = []
    for arr, (w, h, hs, vs) in zip(chans, metas):
        new_channels.append(Channel(w, h, hs, vs,
                                    np.asarray(arr, np.int32)))
    image.channels = new_channels
    image.nb_meta_channels = nb_meta
    return True
