"""ctypes loader for the native host codec (hostcodec.cpp).

Compiles on first use (g++ -O3) and falls back to the pure-Python path
when a toolchain isn't available.  The Python implementation remains the
bit-exactness oracle; tests/test_native.py cross-checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostcodec.cpp")

_lib = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_DIR, f"libhostcodec-{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-ffp-contract=off", "-pthread", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so_path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    c = ctypes
    lib.entropy_new.restype = c.c_void_p
    lib.entropy_new.argtypes = [
        c.c_char_p, c.c_size_t, c.c_size_t, c.c_int32,
        c.POINTER(c.c_int32), c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.entropy_read_one.restype = c.c_int64
    lib.entropy_read_one.argtypes = [c.c_void_p, c.c_int32]
    lib.entropy_read_many.restype = None
    lib.entropy_read_many.argtypes = [c.c_void_p, c.c_int32, c.c_int64,
                                      c.POINTER(c.c_int64)]
    lib.entropy_bit_pos.restype = c.c_size_t
    lib.entropy_bit_pos.argtypes = [c.c_void_p]
    lib.entropy_error.restype = c.c_int
    lib.entropy_error.argtypes = [c.c_void_p]
    lib.entropy_free.restype = None
    lib.entropy_free.argtypes = [c.c_void_p]
    lib.entropy_set_ans.restype = None
    lib.entropy_set_ans.argtypes = [
        c.c_void_p, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32, c.c_uint32]
    lib.entropy_ans_state.restype = c.c_uint32
    lib.entropy_ans_state.argtypes = [c.c_void_p]
    lib.xyb_to_srgb.restype = None
    lib.xyb_to_srgb.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.c_int64, c.POINTER(c.c_double), c.c_double, c.c_double,
        c.c_int, c.c_void_p]
    lib.filter_chain.restype = None
    lib.filter_chain.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.c_int, c.c_int, c.c_int,
        c.c_double, c.c_double, c.c_double, c.c_double, c.c_double,
        c.c_double, c.c_int, c.POINTER(c.c_double), c.c_int, c.c_int,
        c.c_double, c.c_double]
    lib.decode_channel_native.restype = c.c_int
    lib.decode_channel_native.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_int32), c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.POINTER(c.c_int32),
        c.POINTER(c.POINTER(c.c_int64)), c.c_int32,
        c.c_int32, c.c_int32]
    lib.ma_split_costs.restype = None
    lib.ma_split_costs.argtypes = [
        c.POINTER(c.c_int32), c.c_int32, c.c_int64,
        c.POINTER(c.c_int32), c.c_int32, c.c_int32,
        c.POINTER(c.c_double), c.POINTER(c.c_double)]
    lib.wp_forward.restype = None
    lib.wp_forward.argtypes = [
        c.POINTER(c.c_int64), c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.POINTER(c.c_int64)]
    lib.decode_ac_group_native.restype = c.c_int
    lib.decode_ac_group_native.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32)]
    lib.encode_channel_native.restype = c.c_int
    lib.encode_channel_native.argtypes = [
        c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_int32), c.c_int32, c.c_int32,
        c.c_int32, c.c_int32,
        c.POINTER(c.c_int32),
        c.POINTER(c.POINTER(c.c_int64)), c.c_int32,
        c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.encode_ac_tokens.restype = c.c_int64
    lib.encode_ac_tokens.argtypes = [
        c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.pack_family_i16.restype = c.c_int64
    lib.pack_family_i16.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.POINTER(c.c_int32), c.c_int64, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int16)]
    lib.pack_family_i8.restype = c.c_int64
    lib.pack_family_i8.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.POINTER(c.c_int32), c.c_int64, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int8), c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.lf_walk_native.restype = c.c_int64
    lib.lf_walk_native.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int64,
        c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_uint8), c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.ma_best_split_native.restype = None
    lib.ma_best_split_native.argtypes = [
        c.POINTER(c.c_int32), c.c_int32, c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_double),
        c.POINTER(c.c_double), c.POINTER(c.c_int32)]
    lib.ans_quantize_best.restype = c.c_int32
    lib.ans_quantize_best.argtypes = [
        c.POINTER(c.c_int64), c.c_int32, c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.POINTER(c.c_int32)]
    lib.greedy_decide_native.restype = c.c_int32
    lib.greedy_decide_native.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_int32),
        c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_double), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.cluster_histograms_native.restype = c.c_int32
    lib.cluster_histograms_native.argtypes = [
        c.POINTER(c.c_int64), c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32)]
    lib.ans_stream_encode.restype = c.c_int64
    lib.ans_stream_encode.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.c_int32), c.c_int32,
        c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_uint8), c.c_int64]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("JXL_NO_NATIVE"):
            _lib = None
        else:
            _lib = _build_and_load()
    return _lib


def encode_channel_tokens(tree, data, chan_index, stream_id, wp_params,
                          prev_planes, use_wp, max_prop):
    """Native mirror of modular/stream.encode_channel's per-pixel walk:
    returns (ctx int32 array, packed-residual int32 array) or None when
    the native library is unavailable or the walk hit an error."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    cols = []
    for n in tree.nodes:
        cols.append([n.property, n.splitval, n.left, n.right,
                     n.predictor, n.offset, n.multiplier, n.ctx])
    tree_a = np.asarray(cols, np.int32).reshape(-1)
    wp_a = np.asarray([wp_params.p1, wp_params.p2, wp_params.p3a,
                       wp_params.p3b, wp_params.p3c, wp_params.p3d,
                       wp_params.p3e, wp_params.w0, wp_params.w1,
                       wp_params.w2, wp_params.w3], np.int32)
    h, w = data.shape
    data32 = np.ascontiguousarray(data, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    prev64 = [np.ascontiguousarray(p, np.int64) for p in prev_planes]
    PrevArr = i64p * max(1, len(prev64))
    prev_ptrs = PrevArr(*[p.ctypes.data_as(i64p) for p in prev64]) \
        if prev64 else PrevArr()
    out_ctx = np.empty(h * w, np.int32)
    out_val = np.empty(h * w, np.int32)
    rc = lib.encode_channel_native(
        tree_a.ctypes.data_as(i32p), len(tree.nodes),
        data32.ctypes.data_as(i32p), w, h, chan_index, stream_id,
        wp_a.ctypes.data_as(i32p), prev_ptrs, len(prev64),
        1 if use_wp else 0, max_prop,
        out_ctx.ctypes.data_as(i32p), out_val.ctypes.data_as(i32p))
    if rc != 0:
        return None
    return out_ctx, out_val


class NativeEntropy:
    """Native mirror of an EntropyDecoder (prefix or ANS path)."""

    def __init__(self, dec, br):
        """dec: a parsed Python EntropyDecoder; br: its BitReader, already
        positioned after the entropy headers (and, for ANS, after the
        initial state read)."""
        import numpy as np
        lib = get_lib()
        assert lib is not None
        self.lib = lib
        self._buf = bytes(br.data)  # keep alive
        self.dec = dec
        self.use_ans = not dec.use_prefix
        # Pack tables once per shared EntropyCode: every AC group of a
        # pass reuses the same histograms (HfGlobal), so cache the
        # packed arrays on the code object.
        pack = getattr(dec.code, "_native_pack", None)
        if pack is None:
            if self.use_ans:
                num_clusters = len(dec.alias_tables)
                lengths = []
                offsets = [0] * (num_clusters + 1)
            else:
                num_clusters = len(dec.prefix_codes)
                lengths = []
                offsets = [0]
                for pc in dec.prefix_codes:
                    lengths.extend(pc.lengths)
                    offsets.append(len(lengths))
            cmap = np.asarray(dec.cluster_map, np.int32)
            lengths_a = np.asarray(lengths, np.int32)
            offsets_a = np.asarray(offsets, np.int32)
            configs = []
            for cfg in dec.configs:
                configs.extend([cfg.split_exponent, cfg.msb_in_token,
                                cfg.lsb_in_token])
            configs_a = np.asarray(configs, np.int32)
            lz = dec.lz77
            lz_a = np.asarray([
                1 if lz.enabled else 0, lz.min_symbol, lz.min_length,
                lz.length_config.split_exponent,
                lz.length_config.msb_in_token,
                lz.length_config.lsb_in_token], np.int32)
            ans_pack = None
            if self.use_ans:
                la = dec.log_alpha
                n = 1 << la
                cut = np.zeros((num_clusters, n), np.int32)
                rgt = np.zeros((num_clusters, n), np.int32)
                off = np.zeros((num_clusters, n), np.int32)
                frq = np.zeros((num_clusters, n), np.int32)
                for cl, at in enumerate(dec.alias_tables):
                    cut[cl, :len(at.cutoffs)] = at.cutoffs
                    rgt[cl, :len(at.right)] = at.right
                    off[cl, :len(at.offsets)] = at.offsets
                    frq[cl, :len(at.freq)] = at.freq
                ans_pack = (la, cut, rgt, off, frq)
            pack = (num_clusters, cmap, lengths_a, offsets_a, configs_a,
                    lz_a, ans_pack)
            try:
                dec.code._native_pack = pack
            except AttributeError:
                pass
        (num_clusters, cmap, lengths_a, offsets_a, configs_a, lz_a,
         ans_pack) = pack
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._keep = pack
        self.ctx = lib.entropy_new(
            self._buf, len(self._buf), br.pos,
            len(dec.cluster_map) - (1 if dec.lz77.enabled else 0),
            cmap.ctypes.data_as(i32p), len(cmap), num_clusters,
            lengths_a.ctypes.data_as(i32p),
            offsets_a.ctypes.data_as(i32p),
            configs_a.ctypes.data_as(i32p),
            lz_a.ctypes.data_as(i32p))
        if self.use_ans:
            la, cut, rgt, off, frq = ans_pack
            lib.entropy_set_ans(
                self.ctx, la,
                cut.ctypes.data_as(i32p), rgt.ctypes.data_as(i32p),
                off.ctypes.data_as(i32p), frq.ctypes.data_as(i32p),
                num_clusters, ctypes.c_uint32(dec.ans.state))

    def read(self, ctx_id: int) -> int:
        return self.lib.entropy_read_one(self.ctx, ctx_id)

    def decode_channel(self, tree, data_out, chan_index, stream_id,
                       wp_params, prev_planes, max_prop, use_wp) -> None:
        import numpy as np
        h, w = data_out.shape
        cols = []
        for i, n in enumerate(tree.nodes):
            cols.append([n.property, n.splitval, n.left, n.right,
                         n.predictor, n.offset, n.multiplier, n.ctx])
        tree_a = np.asarray(cols, np.int32).reshape(-1)
        wp_a = np.asarray([wp_params.p1, wp_params.p2, wp_params.p3a,
                           wp_params.p3b, wp_params.p3c, wp_params.p3d,
                           wp_params.p3e, wp_params.w0, wp_params.w1,
                           wp_params.w2, wp_params.w3], np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        prev64 = [np.ascontiguousarray(p, np.int64) for p in prev_planes]
        PrevArr = i64p * max(1, len(prev64))
        prev_ptrs = PrevArr(*[p.ctypes.data_as(i64p) for p in prev64]) \
            if prev64 else PrevArr()
        assert data_out.dtype == np.int32
        target = data_out
        if not data_out.flags.c_contiguous:
            target = np.ascontiguousarray(data_out)
        rc = self.lib.decode_channel_native(
            self.ctx, tree_a.ctypes.data_as(i32p), len(tree.nodes),
            target.ctypes.data_as(i32p), w, h, chan_index, stream_id,
            wp_a.ctypes.data_as(i32p), prev_ptrs, len(prev64),
            1 if use_wp else 0, max_prop)
        if target is not data_out:
            data_out[...] = target
        if rc != 0:
            from ..bitstream.reader import BitstreamError
            raise BitstreamError(f"native decode error {rc}")

    @property
    def bit_pos(self) -> int:
        return self.lib.entropy_bit_pos(self.ctx)

    def error(self) -> int:
        return self.lib.entropy_error(self.ctx)

    def sync_back(self, dec, br):
        """Propagate stream position + ANS state back to the Python
        decoder so final-state checks and subsequent reads line up."""
        br.pos = self.bit_pos
        if self.use_ans and dec.ans is not None:
            dec.ans.state = int(self.lib.entropy_ans_state(self.ctx))

    def close(self):
        if self.ctx:
            self.lib.entropy_free(self.ctx)
            self.ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
