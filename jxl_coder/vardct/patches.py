"""Patch dictionary (FrameHeader flag kPatches) — decode + draw.

Patches copy rectangles out of previously stored reference frames
(frame_type kReferenceOnly, saved before the color transform, i.e. in
XYB space for xyb streams) and blend them into the current frame at
one or more positions.  Wire format and blend-mode semantics follow
dec_patch_dictionary.h (vendored public header): a 10-context entropy
stream of reference rectangles, delta-coded positions, and per-
(color+extra-channel) blending descriptors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..bitstream.reader import BitReader, BitstreamError, unpack_signed

CTX_NUM_REF_PATCH = 0
CTX_REFERENCE_FRAME = 1
CTX_PATCH_SIZE = 2
CTX_PATCH_REFERENCE_POSITION = 3
CTX_PATCH_POSITION = 4
CTX_PATCH_BLEND_MODE = 5
CTX_PATCH_OFFSET = 6
CTX_PATCH_COUNT = 7
CTX_PATCH_ALPHA_CHANNEL = 8
CTX_PATCH_CLAMP = 9
NUM_PATCH_CONTEXTS = 10

# PatchBlendMode
BLEND_NONE = 0
BLEND_REPLACE = 1
BLEND_ADD = 2
BLEND_MUL = 3
BLEND_BLEND_ABOVE = 4
BLEND_BLEND_BELOW = 5
BLEND_ALPHA_ADD_ABOVE = 6
BLEND_ALPHA_ADD_BELOW = 7
NUM_BLEND_MODES = 8


def _uses_alpha(mode):
    return mode in (BLEND_BLEND_ABOVE, BLEND_BLEND_BELOW,
                    BLEND_ALPHA_ADD_ABOVE, BLEND_ALPHA_ADD_BELOW)


def _uses_clamp(mode):
    return _uses_alpha(mode) or mode == BLEND_MUL


@dataclasses.dataclass
class RefRect:
    ref: int
    x0: int
    y0: int
    xsize: int
    ysize: int


@dataclasses.dataclass
class Patch:
    rect_idx: int
    x: int
    y: int
    blendings: List[tuple]  # (mode, alpha_channel, clamp) per channel set


@dataclasses.dataclass
class PatchDictionary:
    rects: List[RefRect]
    patches: List[Patch]

    @staticmethod
    def read(br: BitReader, xsize: int, ysize: int,
             num_extra: int) -> "PatchDictionary":
        from ..entropy.coder import EntropyDecoder
        dec = EntropyDecoder(br, NUM_PATCH_CONTEXTS)
        num_ref_patch = dec.read(CTX_NUM_REF_PATCH)
        if num_ref_patch > (1 << 24):
            raise BitstreamError("too many patch rects")
        rects: List[RefRect] = []
        patches: List[Patch] = []
        total = 0
        for _ in range(num_ref_patch):
            ref = dec.read(CTX_REFERENCE_FRAME)
            if ref >= 4:
                raise BitstreamError("bad patch reference frame")
            x0 = dec.read(CTX_PATCH_REFERENCE_POSITION)
            y0 = dec.read(CTX_PATCH_REFERENCE_POSITION)
            rxs = dec.read(CTX_PATCH_SIZE) + 1
            rys = dec.read(CTX_PATCH_SIZE) + 1
            rects.append(RefRect(ref, x0, y0, rxs, rys))
            id_count = dec.read(CTX_PATCH_COUNT) + 1
            total += id_count
            if total > (1 << 24):
                raise BitstreamError("too many patches")
            px = py = 0
            for i in range(id_count):
                if i == 0:
                    px = dec.read(CTX_PATCH_POSITION)
                    py = dec.read(CTX_PATCH_POSITION)
                else:
                    px += unpack_signed(dec.read(CTX_PATCH_OFFSET))
                    py += unpack_signed(dec.read(CTX_PATCH_OFFSET))
                if px + rxs > xsize or py + rys > ysize or px < 0 or py < 0:
                    raise BitstreamError("patch outside the frame")
                blendings = []
                for _j in range(num_extra + 1):
                    mode = dec.read(CTX_PATCH_BLEND_MODE)
                    if mode >= NUM_BLEND_MODES:
                        raise BitstreamError("bad patch blend mode")
                    alpha_channel = 0
                    if _uses_alpha(mode) and num_extra > 1:
                        alpha_channel = dec.read(CTX_PATCH_ALPHA_CHANNEL)
                        if alpha_channel >= num_extra:
                            raise BitstreamError("bad patch alpha channel")
                    clamp = False
                    if _uses_clamp(mode):
                        clamp = bool(dec.read(CTX_PATCH_CLAMP))
                    blendings.append((mode, alpha_channel, clamp))
                patches.append(Patch(len(rects) - 1, px, py, blendings))
        if not dec.check_final_state():
            raise BitstreamError("patch dictionary checksum failed")
        return PatchDictionary(rects, patches)

    def apply(self, planes: List[np.ndarray],
              ref_frames: Dict[int, List[np.ndarray]],
              ec_planes: List[np.ndarray] = None) -> None:
        """Draw patches in place.  planes: [X, Y, B] float; ec_planes:
        float extra-channel planes at frame resolution (optional).
        Colour channels share blendings[0]; extra channel i uses
        blendings[1 + i]."""
        ecs = ec_planes or []
        for p in self.patches:
            r = self.rects[p.rect_idx]
            ref = ref_frames.get(r.ref)
            if ref is None:
                raise BitstreamError(
                    f"patch references missing frame slot {r.ref}")
            self._draw(p, r, ref, planes, ecs)

    def _draw(self, p: Patch, r: RefRect,
              ref: List[np.ndarray], planes, ecs) -> None:
        ys = slice(p.y, p.y + r.ysize)
        xs = slice(p.x, p.x + r.xsize)
        rys = slice(r.y0, r.y0 + r.ysize)
        rxs = slice(r.x0, r.x0 + r.xsize)

        def alpha_plane(idx, new):
            if idx < len(ecs):
                return (ecs[idx][ys, xs] if not new
                        else ref[3 + idx][rys, rxs])
            return None

        groups = [(p.blendings[0], [0, 1, 2])]
        for i in range(len(ecs)):
            bi = p.blendings[1 + i] if 1 + i < len(p.blendings) \
                else p.blendings[0]
            groups.append((bi, [3 + i]))
        for (mode, alpha_channel, clamp), chans in groups:
            if mode == BLEND_NONE:
                continue
            for c in chans:
                dst = planes[c] if c < 3 else ecs[c - 3]
                if c < 3:
                    src = ref[c][rys, rxs] if c < len(ref) else None
                else:
                    src = ref[c][rys, rxs] if c < len(ref) else None
                if src is None:
                    continue
                if mode == BLEND_REPLACE:
                    dst[ys, xs] = src
                elif mode == BLEND_ADD:
                    dst[ys, xs] += src
                elif mode == BLEND_MUL:
                    s = np.clip(src, 0.0, 1.0) if clamp else src
                    dst[ys, xs] *= s
                elif mode in (BLEND_BLEND_ABOVE, BLEND_BLEND_BELOW):
                    fa = alpha_plane(alpha_channel, True)
                    ba = alpha_plane(alpha_channel, False)
                    if fa is None or ba is None:
                        dst[ys, xs] = src
                        continue
                    if mode == BLEND_BLEND_BELOW:
                        fa, ba = ba, fa
                        old, new = src, dst[ys, xs]
                    else:
                        old, new = dst[ys, xs], src
                    if clamp:
                        fa = np.clip(fa, 0.0, 1.0)
                    na = fa + ba * (1.0 - fa)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        out = np.where(
                            na > 0,
                            (new * fa + old * ba * (1.0 - fa))
                            / np.where(na > 0, na, 1.0), 0.0)
                    dst[ys, xs] = out
                elif mode in (BLEND_ALPHA_ADD_ABOVE, BLEND_ALPHA_ADD_BELOW):
                    fa = alpha_plane(alpha_channel, True)
                    if fa is None:
                        dst[ys, xs] += src
                        continue
                    if clamp:
                        fa = np.clip(fa, 0.0, 1.0)
                    dst[ys, xs] += fa * src


def patches_to_affine(pd: "PatchDictionary", h: int, w: int,
                      ref_frames: Dict[int, List[np.ndarray]]):
    """Per-pixel affine equivalent of PatchDictionary.apply for the
    colour channels with no extra-channel planes (the decode path's
    call shape): X_out = X_in * mul + add.  Every blend mode is affine
    in the destination, and sequential patches compose by in-place
    updates of (mul, add).  Consumed by the device reconstruction
    (device_full post stages); apply() stays the host oracle."""
    mul = np.ones((3, h, w), np.float32)
    add = np.zeros((3, h, w), np.float32)
    for p in pd.patches:
        r = pd.rects[p.rect_idx]
        ref = ref_frames.get(r.ref)
        if ref is None:
            raise BitstreamError(
                f"patch references missing frame slot {r.ref}")
        ys = slice(p.y, p.y + r.ysize)
        xs = slice(p.x, p.x + r.xsize)
        rys = slice(r.y0, r.y0 + r.ysize)
        rxs = slice(r.x0, r.x0 + r.xsize)
        mode, _alpha_channel, clamp = p.blendings[0]
        if mode == BLEND_NONE:
            continue
        for c in (0, 1, 2):
            src = ref[c][rys, rxs] if c < len(ref) else None
            if src is None:
                continue
            src = src.astype(np.float32)
            if mode == BLEND_ADD or mode in (BLEND_ALPHA_ADD_ABOVE,
                                             BLEND_ALPHA_ADD_BELOW):
                # ALPHA_ADD without EC planes degrades to plain ADD
                # (apply(): alpha_plane returns None)
                add[c][ys, xs] += src
            elif mode == BLEND_MUL:
                s = np.clip(src, 0.0, 1.0) if clamp else src
                mul[c][ys, xs] *= s
                add[c][ys, xs] *= s
            else:
                # REPLACE; BLEND_* without EC planes degrades to
                # REPLACE (apply(): alpha_plane returns None)
                mul[c][ys, xs] = 0.0
                add[c][ys, xs] = src
    return mul, add
