"""Solve the unknown static log-count prefix code of complex ANS
histograms by DFS over code assignments, constrained by real bitstreams.

The decoder structure (recalled from libjxl dec_ans.cc ReadHistogram and
confirmed upstream by the lz77-bundle fix):

  [simple=0][flat=0]
  unary log (max 3) -> shift = (u(log) | 1<<log) - 1, shift <= 13
  length = U8() + 3          # number of logcount entries
  for i < length:
      logcount[i] = static_prefix_decode()       # symbols 0..13
      if logcount[i] == 13: rle_run = U8(); i += run...
  counts: 0 -> 0; 1 -> 1; L>=2 -> (1<<(L-1)) + u(bitcount)<<(L-1-bitcount)
  omit position (largest logcount) gets 4096 - sum(others)

Unknowns: the (symbol -> codeword) static prefix code, the RLE run
offset, the bitcount formula, and the omit tie rule.  Each candidate
must decode every histogram consistently (counts in range, sum < 4096,
alphabet bound) across multiple real sections; survivors are verified
against the downstream ANS token stream oracle.
"""

import sys
import itertools

sys.path.insert(0, "/root/repo")

from jxl_coder.bitstream.reader import BitReader, BitstreamError


def u8(br):
    if br.u(1) == 0:
        return 0
    n = br.u(3)
    return (1 << n) + br.u(n)


class CodeState:
    """Partial prefix-code assignment: sym -> (len, codebits tuple)."""

    def __init__(self):
        self.assign = {}     # sym -> (length, bits tuple)
        self.codes = []      # list of (length, bits) for prefix checks

    def copy(self):
        c = CodeState()
        c.assign = dict(self.assign)
        c.codes = list(self.codes)
        return c

    def compatible(self, bits_ahead, sym, length):
        """Can `sym` be decoded here with `length` bits (= bits_ahead[:length])?"""
        word = tuple(bits_ahead[:length])
        if len(word) < length:
            return None
        if sym in self.assign:
            L, W = self.assign[sym]
            return (L, W) if (L == length and W == word) else None
        # prefix-freeness vs existing codes
        for (L, W) in self.codes:
            m = min(L, length)
            if tuple(W[:m]) == word[:m]:
                return None
        return (length, word)

    def add(self, sym, length, word):
        self.assign[sym] = (length, word)
        self.codes.append((length, word))


def get_bits(data, pos, n):
    out = []
    for i in range(pos, min(pos + n, len(data) * 8)):
        out.append((data[i >> 3] >> (i & 7)) & 1)
    return out


def bitcount_formula(variant, L, shift):
    """bits of extra precision for logcount L (>=2)."""
    log = L - 1
    if variant == 0:
        r = min(log, shift - ((12 - log) >> 1))
    elif variant == 1:
        r = min(log, shift)
    elif variant == 2:
        r = min(log, shift - ((12 - log) >> 2))
    else:
        r = min(log, max(0, shift - (12 - log)))
    return max(0, r)


def decode_complex(data, start_bit, code, bc_variant, rle_off, omit_ge,
                   max_alpha):
    """Decode one complex histogram with a COMPLETE code.
    Returns (counts, end_bit) or raises."""
    br = BitReader(data)
    br.pos = start_bit
    if br.u(1) != 0 or br.u(1) != 0:
        raise BitstreamError("not complex")
    log = 0
    while log < 3 and br.u(1):
        log += 1
    shift = (br.u(log) | (1 << log)) - 1
    if shift > 13:
        raise BitstreamError("shift")
    length = u8(br) + 3
    if length > max_alpha:
        raise BitstreamError("alpha")
    logcounts = [0] * length
    same = [0] * length
    i = 0
    while i < length:
        # decode a symbol
        sym = None
        for L in range(1, 8):
            bits = get_bits(data, br.pos, L)
            if len(bits) < L:
                break
            for s, (SL, SW) in code.assign.items():
                if SL == L and tuple(bits[:L]) == SW:
                    sym = s
                    break
            if sym is not None:
                br.pos += L
                break
        if sym is None:
            raise BitstreamError("no code match")
        if sym == 13:
            run = u8(br) + rle_off
            if i == 0 or i + run > length:
                raise BitstreamError("bad rle")
            for k in range(run):
                same[i + k] = 1
            i += run
            continue
        logcounts[i] = sym
        i += 1
    # omit position: largest logcount
    omit_pos = -1
    omit_log = -1
    for i, lc in enumerate(logcounts):
        if same[i]:
            continue
        if (lc >= omit_log) if omit_ge else (lc > omit_log):
            omit_log = lc
            omit_pos = i
    if omit_pos < 0:
        raise BitstreamError("no omit")
    counts = [0] * length
    total = 0
    for i in range(length):
        if same[i]:
            counts[i] = counts[i - 1]
            total += counts[i]
            continue
        if i == omit_pos:
            continue
        L = logcounts[i]
        if L == 0:
            counts[i] = 0
        elif L == 1:
            counts[i] = 1
            total += 1
        else:
            bc = bitcount_formula(bc_variant, L, shift)
            counts[i] = (1 << (L - 1)) + (br.u(bc) << (L - 1 - bc))
            total += counts[i]
    rem = 4096 - total
    if rem <= 0:
        raise BitstreamError("oversubscribed")
    counts[omit_pos] = rem
    return counts, br.pos


def dfs_decode(data, start_bit, code, max_alpha, bc_variant, rle_off,
               results, depth_limit=200000, budget=[0]):
    """DFS over partial code assignments while decoding ONE histogram.
    Appends (completed CodeState, end_bit, counts-constraint-ok) to
    results."""
    br = BitReader(data)
    br.pos = start_bit
    if br.u(1) != 0 or br.u(1) != 0:
        return
    log = 0
    while log < 3 and br.u(1):
        log += 1
    shift = (br.u(log) | (1 << log)) - 1
    if shift > 13:
        return
    length = u8(br) + 3
    if length > max_alpha:
        return

    def rec(pos, i, code, logcounts, same):
        if budget[0] > depth_limit:
            return
        budget[0] += 1
        if i >= length:
            # final constraint: counts reconstructible
            try:
                # replay with the (possibly partial but sufficient) code
                counts, end = decode_complex(
                    data, start_bit, code, bc_variant, rle_off, False,
                    max_alpha)
                results.append((code.copy(), end, counts))
            except Exception:
                # try omit_ge variant
                try:
                    counts, end = decode_complex(
                        data, start_bit, code, bc_variant, rle_off, True,
                        max_alpha)
                    results.append((code.copy(), end, counts))
                except Exception:
                    pass
            return
        bits = get_bits(data, pos, 7)
        tried = set()
        for L in range(1, 8):
            if len(bits) < L:
                break
            word = tuple(bits[:L])
            # which symbols could be here?
            for sym in range(14):
                if (sym, L) in tried:
                    continue
                res = code.compatible(bits, sym, L)
                if res is None:
                    continue
                tried.add((sym, L))
                c2 = code if sym in code.assign else code.copy()
                if sym not in code.assign:
                    c2.add(sym, L, word)
                npos = pos + L
                if sym == 13:
                    br2 = BitReader(data)
                    br2.pos = npos
                    try:
                        run = u8(br2) + rle_off
                    except BitstreamError:
                        continue
                    if i == 0 or i + run > length:
                        continue
                    s2 = list(same)
                    for k in range(run):
                        s2[i + k] = 1
                    rec(br2.pos, i + run, c2, logcounts, s2)
                else:
                    lc2 = list(logcounts)
                    lc2[i] = sym
                    rec(npos, i + 1, c2, lc2, same)

    rec(br.pos, 0, code, [0] * length, [0] * length)


def main():
    cs = open("/root/reference/app/src/main/assets/art.jxl", "rb").read()
    sec = cs[13:73]
    # position of dist0: [hgt][lz_ad][cmap...][prefix][log_alpha][cfgs]
    br = BitReader(sec)
    br.u(1)
    from jxl_coder.entropy.coder import Lz77Params, read_cluster_map, \
        HybridUintConfig
    lz = Lz77Params.read(br)
    assert not lz.enabled
    cmap = read_cluster_map(br, 6)
    use_prefix = br.u(1)
    assert use_prefix == 0
    log_alpha = br.u(2) + 5
    ncl = max(cmap) + 1
    cfgs = [HybridUintConfig.read(br, log_alpha) for _ in range(ncl)]
    print("cmap", cmap, "log_alpha", log_alpha, "ncl", ncl,
          "cfgs", cfgs, "dist0 at bit", br.pos)
    max_alpha = 1 << log_alpha

    total = []
    for bc_variant in (0, 1, 2, 3):
        for rle_off in (3, 4, 5):
            results = []
            dfs_decode(bytes(sec), br.pos, CodeState(), max_alpha,
                       bc_variant, rle_off, results)
            for code, end, counts in results:
                total.append((bc_variant, rle_off, code, end, counts))
    print(len(total), "candidate parses of dist0")
    # summarize distinct (end, counts)
    seen = {}
    for bc, ro, code, end, counts in total:
        key = (end, tuple(counts))
        seen.setdefault(key, []).append((bc, ro, code))
    for (end, counts), lst in sorted(seen.items())[:20]:
        print("end", end, "counts", counts, "sum", sum(counts),
              "x", len(lst), "codes")
    return seen


if __name__ == "__main__":
    main()
