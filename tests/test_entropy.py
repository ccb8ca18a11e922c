"""Entropy core roundtrip tests: prefix codes, rANS, hybrid uints,
clustered token streams."""

import random

import pytest

from jxl_coder.bitstream.reader import BitReader
from jxl_coder.bitstream.writer import BitWriter
from jxl_coder.entropy.prefix import (
    PrefixCode, read_prefix_code, write_prefix_code, build_code_lengths)
from jxl_coder.entropy import ans as A
from jxl_coder.entropy.coder import (
    HybridUintConfig, TokenStream, EntropyDecoder)


def test_bitwriter_roundtrip():
    bw = BitWriter()
    vals = [(5, 3), (0, 1), (1023, 10), (1, 1), (0xFFFF, 16)]
    for v, n in vals:
        bw.u(v, n)
    br = BitReader(bw.to_bytes())
    for v, n in vals:
        assert br.u(n) == v


def test_u64_writer_roundtrip():
    for v in [0, 1, 16, 17, 272, 273, 4095, 4096, 1 << 20, (1 << 40) + 12345,
              (1 << 63) + 7]:
        bw = BitWriter()
        bw.u64(v)
        assert BitReader(bw.to_bytes()).u64() == v


def test_u32_writer_roundtrip():
    spec = (0, (4, 1), (8, 17), (16, 273))
    for v in [0, 1, 16, 17, 272, 273, 65808]:
        bw = BitWriter()
        bw.u32(v, *spec)
        assert BitReader(bw.to_bytes()).u32(*spec) == v


def _roundtrip_prefix(hist, symbols, alphabet):
    lengths = build_code_lengths(hist, alphabet)
    bw = BitWriter()
    write_prefix_code(bw, lengths, alphabet)
    code = PrefixCode(lengths)
    for s in symbols:
        code.write(bw, s)
    br = BitReader(bw.to_bytes())
    dec = read_prefix_code(br, alphabet)
    assert dec.lengths == lengths, (dec.lengths, lengths)
    for s in symbols:
        assert dec.read(br) == s


def test_prefix_simple_codes():
    rng = random.Random(0)
    # 2, 3, 4 symbol codes
    for active in ([3], [1, 7], [2, 5, 9], [0, 3, 8, 12]):
        hist = [0] * 16
        for i, s in enumerate(active):
            hist[s] = 1 << (8 - i)  # skewed
        symbols = [rng.choice(active) for _ in range(200)]
        _roundtrip_prefix(hist, symbols, 16)


def test_prefix_complex_code():
    rng = random.Random(1)
    alphabet = 40
    hist = [0] * alphabet
    for s in range(alphabet):
        hist[s] = rng.randint(0, 100)
    hist[7] = 1000
    symbols = [s for s in range(alphabet) for _ in range(hist[s])]
    rng.shuffle(symbols)
    _roundtrip_prefix(hist, symbols[:500], alphabet)


def test_prefix_uniformish_code():
    # all symbols equal weight -> uniform lengths via complex serialization
    alphabet = 32
    hist = [10] * alphabet
    symbols = list(range(alphabet)) * 3
    _roundtrip_prefix(hist, symbols, alphabet)


# ---- ANS -----------------------------------------------------------------

def test_ans_distribution_simple_roundtrip():
    for counts in ([0, 4096], [1000, 3096], [0, 0, 0, 4096]):
        bw = BitWriter()
        A.write_ans_distribution(bw, counts)
        br = BitReader(bw.to_bytes())
        dec = A.read_ans_distribution(br, 8)
        assert dec == counts


def test_ans_flat_roundtrip():
    counts = A.flat_counts(11)
    assert sum(counts) == A.ANS_TAB_SIZE
    bw = BitWriter()
    A.write_ans_distribution(bw, counts)
    br = BitReader(bw.to_bytes())
    assert A.read_ans_distribution(br, 8) == counts


def test_alias_table_bijection():
    rng = random.Random(2)
    for trial in range(5):
        alpha = rng.randint(2, 20)
        cuts = sorted(rng.sample(range(1, A.ANS_TAB_SIZE), alpha - 1))
        counts = [b - a for a, b in zip([0] + cuts, cuts + [A.ANS_TAB_SIZE])]
        table = A.AliasTable(counts, 5 if alpha <= 32 else 8)
        seen = {}
        for idx in range(A.ANS_TAB_SIZE):
            sym, off, freq = table.lookup(idx)
            assert 0 <= off < freq
            assert (sym, off) not in seen
            seen[(sym, off)] = idx
        for s, c in enumerate(counts):
            for off in range(c):
                assert (s, off) in seen


def test_ans_stream_roundtrip():
    rng = random.Random(3)
    counts = [100, 2000, 1500, 400, 96]
    counts[-1] = A.ANS_TAB_SIZE - sum(counts[:-1])
    table = A.AliasTable(counts, 5)
    symbols = rng.choices(range(5), weights=counts, k=1000)
    enc = A.AnsEncoder()
    for s in symbols:
        enc.push(table, s)
    state, words = enc.encode()
    bw = BitWriter()
    bw.u(state, 32)
    for w in words:
        if w is not None:
            bw.u(w, 16)
    br = BitReader(bw.to_bytes())
    dec = A.AnsState(br)
    out = [dec.read_symbol(table) for _ in range(len(symbols))]
    assert out == symbols
    assert dec.check_final_state()


# ---- hybrid uint ---------------------------------------------------------

def test_hybrid_uint_tokenize_inverse():
    rng = random.Random(4)
    for cfg in [HybridUintConfig(4, 4, 0), HybridUintConfig(4, 1, 0),
                HybridUintConfig(4, 2, 1), HybridUintConfig(0, 0, 0),
                HybridUintConfig(7, 3, 2)]:
        for v in list(range(64)) + [rng.randint(0, 1 << 24)
                                    for _ in range(200)]:
            token, extra, nbits = cfg.tokenize(v)
            bw = BitWriter()
            if nbits:
                bw.u(extra, nbits)
            br = BitReader(bw.to_bytes() or b"\0")
            assert cfg.read_value(token, br) == v, (cfg, v)


def test_hybrid_config_serialization():
    for log_alpha in (5, 8, 15):
        for cfg in [HybridUintConfig(4, 2, 1), HybridUintConfig(0, 0, 0),
                    HybridUintConfig(log_alpha, 0, 0)]:
            bw = BitWriter()
            cfg.write(bw, log_alpha)
            br = BitReader(bw.to_bytes() or b"\0")
            assert HybridUintConfig.read(br, log_alpha) == cfg


# ---- full token stream ---------------------------------------------------

def test_token_stream_roundtrip_single_context():
    rng = random.Random(5)
    values = [rng.randint(0, 1000) for _ in range(2000)] + [0] * 500
    ts = TokenStream(1)
    for v in values:
        ts.add(0, v)
    bw = BitWriter()
    ts.write(bw)
    br = BitReader(bw.to_bytes())
    dec = EntropyDecoder(br, 1)
    out = [dec.read(0) for _ in values]
    assert out == values
    assert dec.check_final_state()


def test_token_stream_roundtrip_multi_context():
    rng = random.Random(6)
    ncontexts = 6
    tokens = [(rng.randrange(ncontexts), rng.randint(0, 1 << rng.randint(0, 20)))
              for _ in range(3000)]
    ts = TokenStream(ncontexts)
    for c, v in tokens:
        ts.add(c, v)
    bw = BitWriter()
    ts.write(bw)
    br = BitReader(bw.to_bytes())
    dec = EntropyDecoder(br, ncontexts)
    for c, v in tokens:
        assert dec.read(c) == v
    assert dec.check_final_state()


def test_estimate_ans_distribution_bits_tracks_writer():
    """The clustering size estimate must stay close to the real wire
    size across distribution shapes (simple forms exact, complex form
    within a handful of bits — it searches a coarser shift grid)."""
    rng = random.Random(11)
    cases = []
    # simple: single symbol, pair, flat
    cases.append([A.ANS_TAB_SIZE] + [0] * 7)
    cases.append([0, 700, A.ANS_TAB_SIZE - 700] + [0] * 5)
    cases.append(A.flat_counts(11))
    # complex: geometric-ish, noisy, sparse tails
    for _ in range(12):
        n = rng.randint(4, 64)
        h = [max(0, int(1000 * (0.6 ** i) + rng.randint(-20, 20)))
             for i in range(n)]
        if sum(h) == 0:
            h[0] = 5
        cases.append(A.normalize_counts(h))
    for counts in cases:
        ntok = sum(counts) // 8
        est = A.estimate_ans_distribution_bits(counts, num_tokens=ntok)
        bw = BitWriter()
        A.write_ans_distribution(bw, list(counts), num_tokens=ntok)
        real = bw.bit_pos
        assert abs(est - real) <= max(12, 0.15 * real), \
            (counts[:8], est, real)


def test_cluster_histograms_vectorized_matches_dict():
    """The dense-array clustering must reproduce the dict oracle's
    assignments (same algorithm, costs and tie order)."""
    import numpy as np
    from jxl_coder.entropy import coder as EC
    rng = np.random.default_rng(0)
    for _trial in range(4):
        n = int(rng.integers(5, 150))
        hists = []
        for _ in range(n):
            T = int(rng.integers(1, 60))
            h = {int(s): int(rng.integers(1, 500))
                 for s in rng.integers(0, T, rng.integers(0, 12))}
            hists.append(h)
        a, ka = EC.cluster_histograms(hists)
        b, kb = EC._cluster_histograms_dict(hists)
        assert (a, ka) == (b, kb)
