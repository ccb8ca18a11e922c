"""rANS entropy coding (ISO/IEC 18181-1 §C.2.3-C.2.6).

State machine: 32-bit state, 12-bit table (ANS_TAB_SIZE=4096), 16-bit
renormalization, alias-table symbol lookup.  Streams verify by final state
== ANS_SIGNATURE << 16.

The per-group streams are independent — group-grid parallelism on the
device (SURVEY.md §2.6); the host reference implementation here is the
bit-exact oracle for the vectorized device lanes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..bitstream.reader import BitReader, BitstreamError
from ..bitstream.writer import BitWriter
from .prefix import ceil_log2

ANS_LOG_TAB_SIZE = 12
ANS_TAB_SIZE = 1 << ANS_LOG_TAB_SIZE
ANS_SIGNATURE = 0x13


def read_u8(br: BitReader) -> int:
    """varint U8 per §C.2.3: 0 -> 0 else (1<<n) + u(n)."""
    if br.u(1) == 0:
        return 0
    n = br.u(3)
    return (1 << n) + br.u(n)


def write_u8(bw: BitWriter, value: int) -> None:
    if value == 0:
        bw.u(0, 1)
        return
    bw.u(1, 1)
    n = value.bit_length() - 1
    bw.u(n, 3)
    bw.u(value - (1 << n), n)


def flat_counts(alphabet_size: int) -> List[int]:
    """Deterministic flat distribution summing to ANS_TAB_SIZE.

    Matches CreateFlatHistogram (ans_common.cc): every symbol gets
    total//n and the first total%n symbols get one extra."""
    base = ANS_TAB_SIZE // alphabet_size
    rem = ANS_TAB_SIZE - base * alphabet_size
    return [base + (1 if i < rem else 0) for i in range(alphabet_size)]


# Static prefix code for log-counts in the "complex" distribution encoding:
# symbol -> (code length, codeword bits read LSB-first).  Pinned by
# extracting the unique structurally-valid 128-entry peek LUT from a
# reference libjxl binary and cross-validated on real bitstreams.
LOGCOUNT_CODE = {
    0: (5, 17), 1: (4, 11), 2: (4, 15), 3: (4, 3), 4: (4, 9),
    5: (4, 7), 6: (3, 4), 7: (3, 2), 8: (3, 5), 9: (3, 6),
    10: (3, 0), 11: (6, 33), 12: (7, 1), 13: (7, 65),
}
# 7-bit peek decode table
_LOGCOUNT_LUT = [None] * 128
for _sym, (_len, _word) in LOGCOUNT_CODE.items():
    for _hi in range(1 << (7 - _len)):
        _LOGCOUNT_LUT[(_hi << _len) | _word] = (_len, _sym)


def _read_logcount(br: BitReader) -> int:
    peek = br.peek(7)
    ln, sym = _LOGCOUNT_LUT[peek]
    br.skip(ln)
    return sym


def read_ans_distribution(br: BitReader, log_alphabet_size: int) -> List[int]:
    """Decode a histogram (counts summing to ANS_TAB_SIZE)."""
    max_alpha = 1 << log_alphabet_size
    if br.u(1):  # simple
        if br.u(1):  # two symbols
            v1 = read_u8(br)
            v2 = read_u8(br)
            if v1 == v2:
                raise BitstreamError("simple dist: equal symbols")
            c1 = br.u(12)
            size = max(v1, v2) + 1
            counts = [0] * size
            counts[v1] = c1
            counts[v2] = ANS_TAB_SIZE - c1
            return counts
        v = read_u8(br)
        counts = [0] * (v + 1)
        counts[v] = ANS_TAB_SIZE
        return counts
    if br.u(1):  # flat
        alphabet_size = read_u8(br) + 1
        if alphabet_size > max_alpha:
            raise BitstreamError("flat dist alphabet too large")
        return flat_counts(alphabet_size)
    # complex: RLE-coded log counts + extra precision bits
    length = 0
    while length < 3 and br.u(1):
        length += 1
    shift = (br.u(length) | (1 << length)) - 1
    if shift > 13:
        raise BitstreamError("ANS dist shift too large")
    alphabet_size = read_u8(br) + 3
    if alphabet_size > max_alpha:
        raise BitstreamError("complex dist alphabet too large")
    logcounts = [0] * alphabet_size
    same = [0] * alphabet_size
    omit_log = -1
    omit_pos = -1
    i = 0
    while i < alphabet_size:
        logcounts[i] = _read_logcount(br)
        if logcounts[i] == ANS_LOG_TAB_SIZE + 1:  # RLE marker (13)
            rle_length = read_u8(br)
            same[i] = rle_length + 5
            i += rle_length + 4
            continue
        if logcounts[i] > omit_log:
            omit_log = logcounts[i]
            omit_pos = i
        i += 1
    if omit_pos < 0 or (omit_pos + 1 < alphabet_size
                        and logcounts[omit_pos + 1] == 13):
        raise BitstreamError("invalid omit position")
    counts = [0] * alphabet_size
    total_count = 0
    prev = 0
    rle_i = 0
    i = 0
    while i < alphabet_size:
        if same[i]:
            # RLE: same[i]-1 copies of the previous count
            rle_length = same[i] - 1
            if i == 0:
                raise BitstreamError("RLE at start")
            for k in range(rle_length):
                if i + k >= alphabet_size:
                    raise BitstreamError("RLE overrun")
                counts[i + k] = counts[i - 1]
            total_count += counts[i - 1] * rle_length
            i += rle_length
            continue
        if i == omit_pos:
            i += 1
            continue
        code = logcounts[i]
        if code == 0:
            counts[i] = 0
        elif code == 1:
            counts[i] = 1
            total_count += 1
        else:
            bitcount = _population_count_precision(code - 1, shift)
            counts[i] = (1 << (code - 1)) + (br.u(bitcount)
                                             << (code - 1 - bitcount))
            total_count += counts[i]
        i += 1
    counts[omit_pos] = ANS_TAB_SIZE - total_count
    if counts[omit_pos] <= 0:
        raise BitstreamError("complex dist oversubscribed")
    return counts


def _population_count_precision(logcount: int, shift: int) -> int:
    r = min(logcount, shift - ((ANS_LOG_TAB_SIZE - logcount) >> 1))
    return max(0, r)


def write_ans_distribution(bw: BitWriter, counts: List[int],
                           num_tokens: int = 0) -> List[int]:
    """Write a histogram; returns the counts a decoder will read back
    (the complex form may quantize them, so the encoder's ANS tables
    MUST be built from the return value)."""
    nz = [(s, c) for s, c in enumerate(counts) if c > 0]
    if sum(c for _, c in counts_items(counts)) != ANS_TAB_SIZE:
        raise ValueError("counts must sum to ANS_TAB_SIZE")
    if len(nz) == 1:
        bw.u(1, 1)
        bw.u(0, 1)
        write_u8(bw, nz[0][0])
        return counts
    if len(nz) == 2:
        bw.u(1, 1)
        bw.u(1, 1)
        (v1, c1), (v2, _) = nz
        write_u8(bw, v1)
        write_u8(bw, v2)
        bw.u(c1, 12)
        return counts
    if counts == flat_counts(len(counts)):
        bw.u(0, 1)
        bw.u(1, 1)
        write_u8(bw, len(counts) - 1)
        return counts
    return write_ans_distribution_complex(bw, counts, num_tokens)


def normalize_counts(hist: List[int]) -> List[int]:
    """Largest-remainder normalization to ANS_TAB_SIZE keeping every
    observed symbol at count >= 1."""
    total = sum(hist)
    if total == 0:
        return [ANS_TAB_SIZE] + [0] * (len(hist) - 1)
    raw = [c * ANS_TAB_SIZE / total for c in hist]
    out = [0] * len(hist)
    for i, (c, r) in enumerate(zip(hist, raw)):
        if c > 0:
            out[i] = max(1, int(r))
    diff = ANS_TAB_SIZE - sum(out)
    if diff > 0:
        order = sorted(range(len(hist)),
                       key=lambda i: -(raw[i] - out[i]))
        k = 0
        while diff > 0:
            i = order[k % len(order)]
            if hist[i] > 0:
                out[i] += 1
                diff -= 1
            k += 1
    elif diff < 0:
        order = sorted(range(len(hist)), key=lambda i: -out[i])
        k = 0
        while diff < 0:
            i = order[k % len(order)]
            if out[i] > 1:
                out[i] -= 1
                diff += 1
            k += 1
    return out


def _logcount_of(c: int) -> int:
    return 0 if c == 0 else (1 if c == 1 else c.bit_length())


def _u8_bits(v: int) -> int:
    return 1 if v == 0 else 4 + (v.bit_length() - 1)


def _quantize_for_shift(counts: List[int], shift: int):
    """Quantize counts to shift-representable values (omit position
    absorbs the normalization remainder exactly — the decoder computes
    it, so it has no representability constraint).  Returns
    (final_counts, omit_pos) or None when the shift can't work.
    Vectorized for large alphabets (the shift search calls this 14x
    per histogram); small alphabets keep the scalar loop (numpy call
    overhead dominates below ~48 symbols)."""
    if len(counts) < 48:
        return _quantize_for_shift_scalar(counts, shift)
    import numpy as np
    c = np.asarray(counts, np.int64)
    alphabet = len(c)
    code = np.frexp(np.maximum(c, 1).astype(np.float64))[1].astype(
        np.int64)                       # bit_length for c >= 1
    logm1 = code - 1
    bitcount = np.maximum(
        0, np.minimum(logm1, shift - ((ANS_LOG_TAB_SIZE - logm1) >> 1)))
    step = np.int64(1) << (logm1 - bitcount)
    base = np.int64(1) << logm1
    qq = base + ((c - base + step // 2) // step) * step
    qq = np.where(qq >= (base << 1), (base << 1) - step, qq)
    q = np.where(c <= 1, c, qq)
    # the decoder omits the FIRST position whose logcount strictly
    # exceeds all before it == first occurrence of the max logcount;
    # iterate until our omit choice agrees with that rule
    omit = int(np.argmax(q))            # first max (ties -> lowest i)
    total = int(q.sum())
    for _ in range(alphabet + 1):
        rem = ANS_TAB_SIZE - (total - int(q[omit]))
        if rem <= 0:
            return None
        old = int(q[omit])
        q[omit] = rem
        total += rem - old
        logs = np.where(q == 0, 0,
                        np.frexp(np.maximum(q, 1).astype(np.float64))[1])
        logs = np.where(q == 1, 1, logs)
        dec_omit = int(np.argmax(logs))
        if dec_omit == omit:
            return q.tolist(), omit
        q[omit] = old
        total += old - rem
        omit = dec_omit
    return None


def _quantize_for_shift_scalar(counts: List[int], shift: int):
    alphabet = len(counts)
    q = [0] * alphabet
    for i, c in enumerate(counts):
        if c <= 1:
            q[i] = c
            continue
        code = c.bit_length()
        bitcount = _population_count_precision(code - 1, shift)
        step = 1 << (code - 1 - bitcount)
        base = 1 << (code - 1)
        qq = base + ((c - base + step // 2) // step) * step
        if qq >= (1 << code):
            qq = (1 << code) - step
        q[i] = qq
    omit = max(range(alphabet), key=lambda i: (q[i], -i))
    for _ in range(alphabet + 1):
        rest = sum(q) - q[omit]
        rem = ANS_TAB_SIZE - rest
        if rem <= 0:
            return None
        old = q[omit]
        q[omit] = rem
        logs = [_logcount_of(c) for c in q]
        dec_omit = max(range(alphabet), key=lambda i: (logs[i], -i))
        if dec_omit == omit:
            return q, omit
        q[omit] = old
        omit = dec_omit
    return None


def _rle_runs(q: List[int], omit_pos: int):
    """Greedy RLE spans [(start, length)]: positions whose count equals
    the previous position's, length 4..259, never covering omit_pos or
    starting right after it (spec validity rule)."""
    alphabet = len(q)
    runs = []
    i = 1
    while i < alphabet:
        if i == omit_pos or i == omit_pos + 1:
            i += 1
            continue
        j = i
        while (j < alphabet and j != omit_pos and q[j] == q[i - 1]
               and j - i < 259):
            j += 1
        if j - i >= 4:
            runs.append((i, j - i))
            i = j
        else:
            i += 1
    return runs


def _complex_cost_bits(q, omit_pos, runs, shift):
    covered = set()
    for s, ln in runs:
        covered.update(range(s, s + ln))
    bits = 0
    for i, c in enumerate(q):
        if i in covered:
            continue
        code = _logcount_of(c)
        bits += LOGCOUNT_CODE[code][0]
        if i != omit_pos and code > 1:
            bits += _population_count_precision(code - 1, shift)
    for s, ln in runs:
        bits += LOGCOUNT_CODE[13][0] + _u8_bits(ln - 4)
    return bits


def _quantize_best_native(counts, num_tokens):
    """Native shift search (hostcodec.cpp ans_quantize_best): same
    search loop, costs and tie order as the Python loop below.
    Returns (total, shift, q, omit, runs) or None."""
    try:
        from .. import native as native_mod
        lib = native_mod.get_lib()
    except Exception:
        lib = None
    if lib is None or not hasattr(lib, "ans_quantize_best"):
        return None
    import ctypes
    import numpy as np
    c64 = np.asarray(counts, np.int64)
    q_out = np.empty(len(counts), np.int64)
    shift_out = ctypes.c_int32()
    omit_out = ctypes.c_int32()
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ans_quantize_best(
        c64.ctypes.data_as(i64p), len(counts), int(num_tokens),
        ctypes.byref(shift_out), q_out.ctypes.data_as(i64p),
        ctypes.byref(omit_out))
    if rc != 0:
        return None
    q = q_out.tolist()
    omit = int(omit_out.value)
    return (0.0, int(shift_out.value), q, omit, _rle_runs(q, omit))


def write_ans_distribution_complex(bw: BitWriter, counts: List[int],
                                   num_tokens: int = 0) -> List[int]:
    """Full 'complex' histogram form with encoder-side shift selection
    and RLE runs (the wire format of §C.2.4; the reader already
    supports both).  Chooses the shift minimizing header bits plus the
    expected coding regret num_tokens * KL(counts || quantized).
    Returns the counts the decoder reads back."""
    if sum(counts) != ANS_TAB_SIZE:
        raise ValueError("counts must sum to ANS_TAB_SIZE")
    alphabet_size = len(counts)
    while alphabet_size > 3 and counts[alphabet_size - 1] == 0:
        alphabet_size -= 1
    if alphabet_size < 3:
        alphabet_size = 3
    counts = list(counts[:alphabet_size]) + [0] * (alphabet_size
                                                   - len(counts))
    best = _quantize_best_native(counts, num_tokens)
    if best is None:
        import math
        for shift in range(14):
            res = _quantize_for_shift(counts, shift)
            if res is None:
                continue
            q, omit = res
            runs = _rle_runs(q, omit)
            hdr = _complex_cost_bits(q, omit, runs, shift)
            kl = 0.0
            for c, c2 in zip(counts, q):
                if c > 0:
                    if c2 <= 0:
                        kl = math.inf
                        break
                    kl += (c / ANS_TAB_SIZE) * math.log2(c / c2)
            total = hdr + max(0.0, kl) * num_tokens
            if best is None or total < best[0]:
                best = (total, shift, q, omit, runs)
    _, shift, q, omit_pos, runs = best
    bw.u(0, 1)   # not simple
    bw.u(0, 1)   # not flat
    v = shift + 1
    n = v.bit_length() - 1
    for _ in range(n):
        bw.u(1, 1)
    if n < 3:
        bw.u(0, 1)
    if n:
        bw.u(v - (1 << n), n)
    write_u8(bw, alphabet_size - 3)
    run_at = {s: ln for s, ln in runs}
    in_run = set()
    for s, ln in runs:
        in_run.update(range(s, s + ln))
    for i, c in enumerate(q):
        if i in run_at:
            ln, word = LOGCOUNT_CODE[13]
            bw.u(word, ln)
            write_u8(bw, run_at[i] - 4)
            continue
        if i in in_run:
            continue
        code = _logcount_of(c)
        ln, word = LOGCOUNT_CODE[code]
        bw.u(word, ln)
    for i, c in enumerate(q):
        if i in in_run or i == omit_pos:
            continue
        code = _logcount_of(c)
        if code <= 1:
            continue
        bitcount = _population_count_precision(code - 1, shift)
        rem = c - (1 << (code - 1))
        bw.u(rem >> (code - 1 - bitcount), bitcount)
    return q


def counts_items(counts):
    return list(enumerate(counts))


def estimate_ans_distribution_bits(counts: List[int],
                                   num_tokens: int = 0) -> float:
    """Header size (bits) a write_ans_distribution call would emit,
    without building a stream.  Used by histogram clustering, where
    merge decisions need a size, not bytes; a coarser shift grid than
    the real writer keeps it fast (the estimate being a few bits high
    only makes a merge marginally more/less attractive — any clustering
    yields a valid stream)."""
    nz = [(s, c) for s, c in enumerate(counts) if c > 0]
    if len(nz) == 1:
        return 2 + _u8_bits(nz[0][0])
    if len(nz) == 2:
        return 2 + _u8_bits(nz[0][0]) + _u8_bits(nz[1][0]) + 12
    if counts == flat_counts(len(counts)):
        return 2 + _u8_bits(len(counts) - 1)
    import math
    alphabet_size = len(counts)
    while alphabet_size > 3 and counts[alphabet_size - 1] == 0:
        alphabet_size -= 1
    alphabet_size = max(alphabet_size, 3)
    c2 = list(counts[:alphabet_size]) + [0] * (alphabet_size
                                               - len(counts))
    best = None
    for shift in (1, 3, 5, 7, 9, 11, 13):
        res = _quantize_for_shift(c2, shift)
        if res is None:
            continue
        q, omit = res
        runs = _rle_runs(q, omit)
        # 2 flag bits + <=4-bit shift token + u8 alphabet size
        hdr = (_complex_cost_bits(q, omit, runs, shift) + 6
               + _u8_bits(alphabet_size - 3))
        kl = 0.0
        for c, c2q in zip(c2, q):
            if c > 0:
                if c2q <= 0:
                    kl = math.inf
                    break
                kl += (c / ANS_TAB_SIZE) * math.log2(c / c2q)
        total = hdr + max(0.0, kl) * num_tokens
        if best is None or total < best[0]:
            best = (total, hdr)
    return float(best[1]) if best else 6.0 * alphabet_size + 40.0


# --------------------------------------------------------------------------
# Alias table

class AliasTable:
    """Deterministic alias mapping per §C.2.4."""

    def __init__(self, counts: List[int], log_alphabet_size: int):
        self.log_alpha = log_alphabet_size
        self.log_entry = ANS_LOG_TAB_SIZE - log_alphabet_size
        self.entry_size = 1 << self.log_entry
        n_buckets = 1 << log_alphabet_size
        counts = list(counts) + [0] * (n_buckets - len(counts))
        self.freq = list(counts)

        cutoffs = list(counts)
        right = [0] * n_buckets
        offsets = [0] * n_buckets

        # single-symbol histogram: spread across all buckets
        nz = [s for s, c in enumerate(counts) if c > 0]
        if len(nz) == 1:
            s = nz[0]
            for i in range(n_buckets):
                cutoffs[i] = 0
                right[i] = s
                offsets[i] = i * self.entry_size
            self.cutoffs, self.right, self.offsets = cutoffs, right, offsets
            return

        underfull = [i for i in range(n_buckets)
                     if cutoffs[i] < self.entry_size]
        overfull = [i for i in range(n_buckets)
                    if cutoffs[i] > self.entry_size]
        # LIFO stacks in ascending build order: highest indices pair first
        # (matches the reference construction exactly)
        while overfull:
            o = overfull.pop()
            if not underfull:
                raise BitstreamError("alias construction failed")
            u = underfull.pop()
            by = self.entry_size - cutoffs[u]
            cutoffs[o] -= by
            right[u] = o
            offsets[u] = cutoffs[o]
            if cutoffs[o] < self.entry_size:
                underfull.append(o)
            elif cutoffs[o] > self.entry_size:
                overfull.append(o)
        for i in range(n_buckets):
            if cutoffs[i] == self.entry_size:
                right[i] = i
                offsets[i] = 0
                cutoffs[i] = self.entry_size  # full self bucket
        self.cutoffs, self.right, self.offsets = cutoffs, right, offsets

    def lookup(self, idx: int) -> Tuple[int, int, int]:
        """idx in [0, ANS_TAB_SIZE) -> (symbol, offset, freq)."""
        bucket = idx >> self.log_entry
        pos = idx & (self.entry_size - 1)
        if pos >= self.cutoffs[bucket]:
            sym = self.right[bucket]
            off = self.offsets[bucket] + pos - self.cutoffs[bucket]
        else:
            sym = bucket
            off = pos
        return sym, off, self.freq[sym]

    def reverse_map(self):
        """symbol offset -> table idx, for the encoder."""
        rmap = {}
        for idx in range(ANS_TAB_SIZE):
            sym, off, _ = self.lookup(idx)
            rmap[(sym, off)] = idx
        return rmap


# --------------------------------------------------------------------------
# Stream reader / writer

class AnsState:
    """Shared rANS state over one bitstream (all clusters share state)."""

    def __init__(self, br: BitReader):
        self.br = br
        self.state = br.u(32)

    def read_symbol(self, table: AliasTable) -> int:
        idx = self.state & (ANS_TAB_SIZE - 1)
        sym, off, freq = table.lookup(idx)
        self.state = freq * (self.state >> ANS_LOG_TAB_SIZE) + off
        if self.state < (1 << 16):
            self.state = ((self.state << 16) | self.br.u(16)) & 0xFFFFFFFF
        return sym

    def check_final_state(self) -> bool:
        return self.state == (ANS_SIGNATURE << 16)


class AnsEncoder:
    """Mirror-image encoder: push symbols, then emit in reverse."""

    def __init__(self):
        self.tokens: List[Tuple[AliasTable, int]] = []

    def push(self, table: AliasTable, symbol: int) -> None:
        self.tokens.append((table, symbol))

    def encode(self) -> Tuple[int, List[Optional[int]]]:
        """Returns (initial_state_for_decoder, words) where words[i] is the
        16-bit word the decoder refills right after decoding token i (or
        None)."""
        state = ANS_SIGNATURE << 16
        words: List[Optional[int]] = [None] * len(self.tokens)
        rmaps = {}
        for i in range(len(self.tokens) - 1, -1, -1):
            table, sym = self.tokens[i]
            key = id(table)
            if key not in rmaps:
                rmaps[key] = table.reverse_map()
            freq = table.freq[sym]
            if freq == 0:
                raise ValueError(f"encoding symbol {sym} with zero freq")
            # renorm (decoder will refill after decoding token i)
            if state >= (freq << (32 - ANS_LOG_TAB_SIZE)):
                words[i] = state & 0xFFFF
                state >>= 16
            off = state % freq
            idx = rmaps[key][(sym, off)]
            state = (state // freq) << ANS_LOG_TAB_SIZE | idx
        return state, words
