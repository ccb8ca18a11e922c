"""Empirical search for the real-bitstream ANS entropy micro-layout.

Oracle: art.jxl's 60-byte LfGlobal section.  A candidate layout must
carry the FULL decode chain: tree histograms -> ANS tokens -> valid MA
tree -> ANS final state -> group header -> data histograms -> 3x
1024x1024 channel planes -> final state -> end of stream.  The chain is
over-determined, so a surviving candidate is the real format.

Search dimensions (all combinations):
  sym:    simple-dist symbol coding (varint-U8 / u(8) / u(log_alpha))
  cnt:    two-symbol first count width (12 / 11 / 10 bits)
  refill: ANS renorm after symbol decode vs before symbol decode
  state0: initial state read as u(32) vs 2x u(16) high-low
  order:  two-symbol layout [two][v1][v2][c] vs [v1][two][v2][c]
"""

import itertools
import sys

sys.path.insert(0, "/root/repo")

import numpy as np

from jxl_coder.bitstream.reader import BitReader, BitstreamError
from jxl_coder.entropy.ans import AliasTable, ANS_TAB_SIZE
from jxl_coder.entropy.coder import HybridUintConfig, Lz77Params


def u8(br):
    if br.u(1) == 0:
        return 0
    n = br.u(3)
    return (1 << n) + br.u(n)


class Cand:
    def __init__(self, sym, cnt, refill, state0, order):
        self.sym = sym
        self.cnt = cnt
        self.refill = refill
        self.state0 = state0
        self.order = order

    def __repr__(self):
        return (f"Cand(sym={self.sym}, cnt={self.cnt}, "
                f"refill={self.refill}, state0={self.state0}, "
                f"order={self.order})")


def read_symbol_coded(br, cand, log_alpha):
    if cand.sym == "varint":
        return u8(br)
    if cand.sym == "u8":
        return br.u(8)
    return br.u(log_alpha)


def read_dist(br, cand, log_alpha):
    """Returns counts list or raises."""
    if br.u(1):  # simple
        if cand.order == "two_first":
            two = br.u(1)
            v1 = read_symbol_coded(br, cand, log_alpha)
            if two:
                v2 = read_symbol_coded(br, cand, log_alpha)
            else:
                v2 = None
        else:
            v1 = read_symbol_coded(br, cand, log_alpha)
            two = br.u(1)
            v2 = read_symbol_coded(br, cand, log_alpha) if two else None
        if v2 is None:
            counts = [0] * (v1 + 1)
            counts[v1] = ANS_TAB_SIZE
            return counts
        if v1 == v2:
            raise BitstreamError("dup")
        c1 = br.u(cand.cnt) << (12 - cand.cnt)
        counts = [0] * (max(v1, v2) + 1)
        counts[v1] = c1
        counts[v2] = ANS_TAB_SIZE - c1
        if counts[v2] <= 0:
            raise BitstreamError("bad count")
        return counts
    if br.u(1):  # flat
        n = u8(br) + 1
        if n > (1 << log_alpha):
            raise BitstreamError("flat too big")
        from jxl_coder.entropy.ans import flat_counts
        return flat_counts(n)
    raise BitstreamError("complex (not searched)")


class AnsReader:
    def __init__(self, br, cand):
        self.br = br
        self.cand = cand
        if cand.state0 == "u32":
            self.state = br.u(32)
        else:
            hi = br.u(16)
            lo = br.u(16)
            self.state = (hi << 16) | lo
        self.reads = 0

    def read(self, table):
        if self.cand.refill == "pre":
            if self.state < (1 << 16):
                self.state = ((self.state << 16) | self.br.u(16)) \
                    & 0xFFFFFFFF
        idx = self.state & (ANS_TAB_SIZE - 1)
        sym, off, freq = table.lookup(idx)
        self.state = freq * (self.state >> 12) + off
        if self.cand.refill == "post":
            if self.state < (1 << 16):
                self.state = ((self.state << 16) | self.br.u(16)) \
                    & 0xFFFFFFFF
        self.reads += 1
        return sym

    def final_ok(self):
        return self.state == 0x130000


def try_candidate(sec, cand, verbose=False):
    br = BitReader(sec)
    assert br.u(1) == 1  # have_global_tree
    # tree stream header (trusted parse)
    lz = Lz77Params.read(br)
    if br.u(1) != 1:
        raise BitstreamError("cmap not simple")
    nb = br.u(2)
    cmap = [br.u(nb) for _ in range(7)]
    if br.u(1) != 0:
        raise BitstreamError("prefix path")
    log_alpha = br.u(2) + 5
    ncl = max(cmap) + 1
    cfgs = [HybridUintConfig.read(br, log_alpha) for _ in range(ncl)]
    dists = [read_dist(br, cand, log_alpha) for _ in range(ncl)]
    tables = [AliasTable(d, log_alpha) for d in dists]
    ans = AnsReader(br, cand)

    def read_hybrid(ctx):
        cl = cmap[ctx]
        token = ans.read(tables[cl])
        if lz.enabled and token >= lz.min_symbol:
            raise BitstreamError("lz77 copy in tree")
        return cfgs[cl].read_value(token, br)

    # decode tree
    from jxl_coder.bitstream.reader import unpack_signed
    nodes = []
    to_decode = 1
    leaves = 0
    while to_decode > 0:
        if len(nodes) > 64:
            raise BitstreamError("tree too big")
        to_decode -= 1
        prop1 = read_hybrid(1)
        if prop1 == 0:
            pred = read_hybrid(2)
            if pred > 13:
                raise BitstreamError("bad predictor")
            off = unpack_signed(read_hybrid(3))
            mlog = read_hybrid(4)
            if mlog > 30:
                raise BitstreamError("bad mul log")
            mbits = read_hybrid(5)
            nodes.append(("leaf", pred, off, (mbits + 1) << mlog, leaves))
            leaves += 1
        else:
            sv = unpack_signed(read_hybrid(0))
            nodes.append(("split", prop1 - 1, sv))
            to_decode += 2
    if not ans.final_ok():
        raise BitstreamError(f"tree final state {ans.state:#x}")
    return nodes, br.pos, cand


def main():
    sec = open("/root/reference/app/src/main/assets/art.jxl", "rb")\
        .read()[13:73]
    hits = []
    for sym, cnt, refill, state0, order in itertools.product(
            ("varint", "u8", "ulog"), (12, 11, 10),
            ("post", "pre"), ("u32", "hi_lo"),
            ("two_first", "v1_first")):
        cand = Cand(sym, cnt, refill, state0, order)
        try:
            nodes, pos, _ = try_candidate(sec, cand)
            hits.append((cand, nodes, pos))
            print("HIT:", cand)
            for n in nodes:
                print("   ", n)
            print("   bitpos after tree:", pos)
        except Exception as e:
            pass
    print(f"{len(hits)} candidate(s) survived the tree oracle")
    return hits


if __name__ == "__main__":
    main()
