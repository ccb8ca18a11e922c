// Native host codec core: bit reader + prefix-code entropy decode +
// LZ77 + modular channel prediction loop.
//
// This is the equivalent of the reference's native runtime layer
// (SURVEY.md §2.5: libjxl's C++ decode loops): byte-level work stays on
// the host but runs at native speed; the Python layer parses headers
// and owns orchestration, the device owns pixel math.
//
// Semantics mirror jxl_coder/{entropy/coder.py, modular/*.py}
// EXACTLY (the Python implementation is the bit-exactness oracle; see
// tests/test_native.py for the cross-check).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hostcodec.cpp -o libhostcodec.so

#include <cstdint>
#include <cmath>
#include <thread>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <utility>

extern "C" {

// ---------------------------------------------------------------------
// Bit reader (LSB-first)

struct BitReader {
    const uint8_t* data;
    size_t nbytes;
    size_t pos;  // bit position
    int overrun;
};

static inline uint64_t br_u(BitReader* br, int n) {
    if (n == 0) return 0;
    size_t end = br->pos + (size_t)n;
    if (end > br->nbytes * 8) { br->overrun = 1; return 0; }
    size_t byte0 = br->pos >> 3;
    int shift = (int)(br->pos & 7);
    uint64_t window;
    if (byte0 + 8 <= br->nbytes && n <= 56) {
        // hot path: one unaligned little-endian load covers shift+n
        // bits (shift <= 7, n <= 56)
        memcpy(&window, br->data + byte0, 8);
    } else {
        window = 0;
        size_t avail = br->nbytes - byte0;
        int need = (shift + n + 7) / 8;
        for (int i = 0; i < need && (size_t)i < avail && i < 8; i++)
            window |= (uint64_t)br->data[byte0 + i] << (8 * i);
    }
    uint64_t val = (window >> shift) & ((n >= 64) ? ~0ull : ((1ull << n) - 1));
    br->pos = end;
    return val;
}

// ---------------------------------------------------------------------
// Prefix codes: decode via (length, reversed-code) lookup

struct PrefixCode {
    // per length 1..15: map reversed-code -> symbol
    std::unordered_map<uint32_t, int32_t> dec[16];
    int32_t single;  // >= 0 when single-symbol code
};

struct HybridConfig {
    int32_t split_exponent, msb, lsb;
};

struct AliasCluster {
    std::vector<int32_t> cutoffs, right, offsets, freq;
};

// one cache line of data per alias bucket instead of four separate
// heap vectors (read_symbol_ans is the hottest load in the decoder)
struct AliasEntry {
    int32_t cutoff, right, offset;
    uint32_t freq_bucket, freq_right;
};

struct EntropyCtx {
    BitReader br;
    int32_t num_contexts;
    std::vector<int32_t> cluster_map;  // size num_contexts (+1 if lz77)
    std::vector<PrefixCode> codes;
    std::vector<HybridConfig> configs;
    // ANS path
    int32_t use_ans = 0;
    int32_t log_alpha = 0, log_entry = 0;
    uint32_t ans_state = 0;
    std::vector<AliasCluster> alias;
    std::vector<AliasEntry> alias_flat;  // (cluster << log_alpha) + bucket
    // lz77
    int32_t lz_enabled, lz_min_symbol, lz_min_length;
    HybridConfig lz_len_config;
    int32_t dist_ctx;
    std::vector<int64_t> window;
    int64_t copy_pos, copy_len, num_decoded;
    int error;  // nonzero on malformed stream
};

static inline int read_symbol_ans(EntropyCtx* ctx, int cluster) {
    uint32_t state = ctx->ans_state;
    uint32_t idx = state & 0xFFF;
    uint32_t bucket = idx >> ctx->log_entry;
    uint32_t pos = idx & ((1u << ctx->log_entry) - 1);
    const AliasEntry& e =
        ctx->alias_flat[((uint32_t)cluster << ctx->log_alpha) + bucket];
    int sym;
    uint32_t off, freq;
    if ((int32_t)pos < e.cutoff) {
        sym = bucket;
        off = pos;
        freq = e.freq_bucket;
    } else {
        sym = e.right;
        off = e.offset + (pos - e.cutoff);
        freq = e.freq_right;
    }
    state = freq * (state >> 12) + off;
    if (state < (1u << 16))
        state = (state << 16) | (uint32_t)br_u(&ctx->br, 16);
    ctx->ans_state = state;
    return sym;
}

static inline int read_symbol(EntropyCtx* ctx, int cluster) {
    if (ctx->use_ans) return read_symbol_ans(ctx, cluster);
    PrefixCode& pc = ctx->codes[cluster];
    if (pc.single >= 0) return pc.single;
    uint32_t code = 0;
    for (int ln = 1; ln <= 15; ln++) {
        code |= (uint32_t)br_u(&ctx->br, 1) << (ln - 1);
        auto it = pc.dec[ln].find(code);
        if (it != pc.dec[ln].end()) return it->second;
    }
    ctx->error = 1;
    return 0;
}

static inline int64_t read_uint_cfg(EntropyCtx* ctx, const HybridConfig& c,
                                    int64_t token) {
    int64_t split = 1ll << c.split_exponent;
    if (token < split) return token;
    int msb = c.msb, lsb = c.lsb;
    int64_t n = c.split_exponent - (msb + lsb)
        + ((token - split) >> (msb + lsb));
    if (n >= 32) { ctx->error = 2; return 0; }
    int64_t low = token & ((1ll << lsb) - 1);
    token >>= lsb;
    int64_t msbits = (token & ((1ll << msb) - 1)) | (1ll << msb);
    return ((((msbits << n) | (int64_t)br_u(&ctx->br, (int)n)) << lsb)
            | low);
}

static int64_t entropy_read(EntropyCtx* ctx, int context) {
    if (!ctx->lz_enabled) {
        int cluster = ctx->cluster_map[context];
        int64_t token = read_symbol(ctx, cluster);
        return read_uint_cfg(ctx, ctx->configs[cluster], token);
    }
    if (ctx->copy_len > 0) {
        ctx->copy_len--;
        int64_t v = ctx->window[ctx->copy_pos++];
        ctx->window.push_back(v);
        ctx->num_decoded++;
        return v;
    }
    int cluster = ctx->cluster_map[context];
    int64_t token = read_symbol(ctx, cluster);
    if (token >= ctx->lz_min_symbol) {
        int64_t length = ctx->lz_min_length
            + read_uint_cfg(ctx, ctx->lz_len_config,
                            token - ctx->lz_min_symbol);
        int dcl = ctx->cluster_map[ctx->dist_ctx];
        int64_t dtok = read_symbol(ctx, dcl);
        int64_t dval = read_uint_cfg(ctx, ctx->configs[dcl], dtok);
        int64_t distance = dval + 1;  // dist_multiplier == 0 path
        if (distance > ctx->num_decoded) distance = ctx->num_decoded;
        if (distance > (1 << 20)) distance = 1 << 20;
        if (distance <= 0) { ctx->error = 3; return 0; }
        ctx->copy_pos = ctx->num_decoded - distance;
        ctx->copy_len = length - 1;
        int64_t v = ctx->window[ctx->copy_pos++];
        ctx->window.push_back(v);
        ctx->num_decoded++;
        return v;
    }
    int64_t v = read_uint_cfg(ctx, ctx->configs[cluster], token);
    ctx->window.push_back(v);
    ctx->num_decoded++;
    return v;
}

// ---------------------------------------------------------------------
// Public entropy API

// code_lengths_flat: concatenated per-cluster length arrays;
// code_offsets[i]..code_offsets[i+1] delimit cluster i's alphabet.
EntropyCtx* entropy_new(const uint8_t* data, size_t nbytes, size_t bit_pos,
                        int32_t num_contexts,
                        const int32_t* cluster_map, int32_t map_len,
                        int32_t num_clusters,
                        const int32_t* code_lengths_flat,
                        const int32_t* code_offsets,
                        const int32_t* configs_flat,  // 3 per cluster
                        const int32_t* lz77_params    // [enabled, min_sym,
                                                      //  min_len, se, msb,
                                                      //  lsb]
                        ) {
    EntropyCtx* ctx = new EntropyCtx();
    ctx->br.data = data;
    ctx->br.nbytes = nbytes;
    ctx->br.pos = bit_pos;
    ctx->br.overrun = 0;
    ctx->num_contexts = num_contexts;
    ctx->cluster_map.assign(cluster_map, cluster_map + map_len);
    ctx->error = 0;
    ctx->copy_pos = ctx->copy_len = ctx->num_decoded = 0;
    ctx->lz_enabled = lz77_params[0];
    ctx->lz_min_symbol = lz77_params[1];
    ctx->lz_min_length = lz77_params[2];
    ctx->lz_len_config = {lz77_params[3], lz77_params[4], lz77_params[5]};
    ctx->dist_ctx = num_contexts;
    ctx->codes.resize(num_clusters);
    ctx->configs.resize(num_clusters);
    for (int cl = 0; cl < num_clusters; cl++) {
        ctx->configs[cl] = {configs_flat[3 * cl], configs_flat[3 * cl + 1],
                            configs_flat[3 * cl + 2]};
        int lo = code_offsets[cl], hi = code_offsets[cl + 1];
        PrefixCode& pc = ctx->codes[cl];
        pc.single = -1;
        int nz = 0, last = -1;
        for (int s = lo; s < hi; s++)
            if (code_lengths_flat[s] > 0) { nz++; last = s - lo; }
        if (nz <= 1) { pc.single = last < 0 ? 0 : last; continue; }
        // canonical code assignment identical to prefix.py
        int alpha = hi - lo;
        int max_len = 0;
        for (int s = 0; s < alpha; s++)
            if (code_lengths_flat[lo + s] > max_len)
                max_len = code_lengths_flat[lo + s];
        std::vector<int> bl_count(max_len + 1, 0);
        for (int s = 0; s < alpha; s++)
            if (code_lengths_flat[lo + s])
                bl_count[code_lengths_flat[lo + s]]++;
        std::vector<uint32_t> next_code(max_len + 2, 0);
        uint32_t code = 0;
        for (int ln = 1; ln <= max_len; ln++) {
            code = (code + bl_count[ln - 1]) << 1;
            next_code[ln] = code;
        }
        for (int s = 0; s < alpha; s++) {
            int ln = code_lengths_flat[lo + s];
            if (!ln) continue;
            uint32_t c = next_code[ln]++;
            // reverse bits
            uint32_t r = 0;
            for (int b = 0; b < ln; b++) { r = (r << 1) | (c & 1); c >>= 1; }
            pc.dec[ln][r] = s;
        }
    }
    return ctx;
}

int64_t entropy_read_one(EntropyCtx* ctx, int32_t context) {
    return entropy_read(ctx, context);
}

void entropy_read_many(EntropyCtx* ctx, int32_t context, int64_t n,
                       int64_t* out) {
    for (int64_t i = 0; i < n; i++) out[i] = entropy_read(ctx, context);
}

size_t entropy_bit_pos(EntropyCtx* ctx) { return ctx->br.pos; }

// Configure the ANS path: alias tables flattened per cluster
// (cutoffs/right/offsets/freq, each (1<<log_alpha) entries per cluster).
void entropy_set_ans(EntropyCtx* ctx, int32_t log_alpha,
                     const int32_t* cutoffs, const int32_t* right,
                     const int32_t* offsets, const int32_t* freq,
                     int32_t num_clusters, uint32_t init_state) {
    ctx->use_ans = 1;
    ctx->log_alpha = log_alpha;
    ctx->log_entry = 12 - log_alpha;
    int n = 1 << log_alpha;
    ctx->alias_flat.resize((size_t)num_clusters * n);
    for (int cl = 0; cl < num_clusters; cl++) {
        for (int b = 0; b < n; b++) {
            AliasEntry& e = ctx->alias_flat[(size_t)cl * n + b];
            e.cutoff = cutoffs[cl * n + b];
            e.right = right[cl * n + b];
            e.offset = offsets[cl * n + b];
            // freq is indexed by SYMBOL (alphabet <= 1<<log_alpha);
            // the two reachable symbols' freqs ride in the entry
            e.freq_bucket = (uint32_t)freq[cl * n + b];
            int r = e.right;
            e.freq_right = (r >= 0 && r < n)
                ? (uint32_t)freq[cl * n + r] : 0;
        }
    }
    ctx->ans_state = init_state;
}

uint32_t entropy_ans_state(EntropyCtx* ctx) { return ctx->ans_state; }
int entropy_error(EntropyCtx* ctx) {
    return ctx->error | (ctx->br.overrun ? 16 : 0);
}
void entropy_free(EntropyCtx* ctx) { delete ctx; }

// ---------------------------------------------------------------------
// Modular channel decode

static inline int64_t floordiv(int64_t a, int64_t b) {
    int64_t q = a / b, r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

static inline int64_t unpack_signed(int64_t u) {
    return (u & 1) ? -((u + 1) >> 1) : (u >> 1);
}

static inline int64_t clamped_gradient(int64_t N, int64_t W, int64_t NW) {
    int64_t m = N < W ? N : W;
    int64_t M = N > W ? N : W;
    int64_t grad = N + W - NW;
    if (NW > M) return m;
    if (NW < m) return M;
    return grad;
}

static const uint32_t kDivLookup[64] = {
    16777216, 8388608, 5592405, 4194304, 3355443, 2796202, 2396745, 2097152,
    1864135, 1677721, 1525201, 1398101, 1290555, 1198372, 1118481, 1048576,
    986895, 932067, 883011, 838860, 798915, 762600, 729444, 699050,
    671088, 645277, 621378, 599186, 578524, 559240, 541200, 524288,
    508400, 493447, 479349, 466033, 453438, 441505, 430185, 419430,
    409200, 399457, 390167, 381300, 372827, 364722, 356962, 349525,
    342392, 335544, 328965, 322638, 316551, 310689, 305040, 299593,
    294337, 289262, 284359, 279620, 275036, 270600, 266305, 262144};

// Reference-exact weighted predictor (cf. modular/predict.py WPState):
// two row-halves swapped per row without clearing, reciprocal-table
// division, W/WW error propagation through the prev-row x+1 slot.
struct WPStateC {
    int64_t p1, p2, p3a, p3b, p3c, p3d, p3e, w[4];
    std::vector<int64_t> pred_cur[4], pred_prev[4];
    std::vector<int64_t> err_cur, err_prev;
    int64_t pred, prop, subpred[4];
    int width;
    void init(const int32_t* params, int w_) {
        p1 = params[0]; p2 = params[1]; p3a = params[2]; p3b = params[3];
        p3c = params[4]; p3d = params[5]; p3e = params[6];
        w[0] = params[7]; w[1] = params[8]; w[2] = params[9];
        w[3] = params[10];
        width = w_;
        for (int k = 0; k < 4; k++) {
            pred_cur[k].assign(w_ + 2, 0);
            pred_prev[k].assign(w_ + 2, 0);
        }
        err_cur.assign(w_ + 2, 0);
        err_prev.assign(w_ + 2, 0);
        pred = prop = 0;
    }
    void new_row() {
        for (int k = 0; k < 4; k++) std::swap(pred_cur[k], pred_prev[k]);
        std::swap(err_cur, err_prev);
        // no clearing: cur slots are written before any read
    }
    static int floor_log2(int64_t v) {
        int r = -1;
        while (v) { v >>= 1; r++; }
        return r;
    }
    int64_t predict(int x, int y, int w_, int64_t W, int64_t N, int64_t NW,
                    int64_t NE, int64_t NN) {
        int pos_ne = x < w_ - 1 ? x + 1 : x;
        int pos_nw = x > 0 ? x - 1 : x;
        int64_t wts[4];
        for (int k = 0; k < 4; k++) {
            int64_t esum = pred_prev[k][x] + pred_prev[k][pos_ne]
                + pred_prev[k][pos_nw];
            int shift = floor_log2(esum + 1) - 5;
            if (shift < 0) shift = 0;
            wts[k] = 4 + ((w[k] * (int64_t)kDivLookup[esum >> shift])
                          >> shift);
        }
        int64_t W3 = W << 3, N3 = N << 3, NW3 = NW << 3, NE3 = NE << 3,
                NN3 = NN << 3;
        int64_t teW = x > 0 ? err_cur[x - 1] : 0;
        int64_t teN = err_prev[x];
        int64_t teNW = err_prev[pos_nw];
        int64_t teNE = err_prev[pos_ne];
        int64_t sumWN = teN + teW;
        int64_t p = teW;
        int64_t ap = p < 0 ? -p : p;
        int64_t a = teN < 0 ? -teN : teN;
        if (a > ap) { p = teN; ap = a; }
        a = teNW < 0 ? -teNW : teNW;
        if (a > ap) { p = teNW; ap = a; }
        a = teNE < 0 ? -teNE : teNE;
        if (a > ap) { p = teNE; ap = a; }
        prop = p;
        subpred[0] = W3 + NE3 - N3;
        subpred[1] = N3 - (((sumWN + teNE) * p1) >> 5);
        subpred[2] = W3 - (((sumWN + teNW) * p2) >> 5);
        subpred[3] = N3 - ((teNW * p3a + teN * p3b + teNE * p3c
                            + (NN3 - N3) * p3d + (NW3 - W3) * p3e) >> 5);
        int64_t wsum = wts[0] + wts[1] + wts[2] + wts[3];
        int logw = floor_log2(wsum) - 4;
        wsum = 0;
        for (int k = 0; k < 4; k++) { wts[k] >>= logw; wsum += wts[k]; }
        int64_t s = (wsum >> 1) - 1;
        for (int k = 0; k < 4; k++) s += subpred[k] * wts[k];
        int64_t pr = (s * (int64_t)kDivLookup[wsum - 1]) >> 24;
        if (((teN ^ teW) | (teN ^ teNW)) <= 0) {
            int64_t lo = W3 < NE3 ? W3 : NE3;
            if (N3 < lo) lo = N3;
            int64_t hi = W3 > NE3 ? W3 : NE3;
            if (N3 > hi) hi = N3;
            if (pr < lo) pr = lo;
            if (pr > hi) pr = hi;
        }
        pred = pr;
        return (pr + 3) >> 3;
    }
    void update(int x, int64_t value) {
        int64_t v3 = value << 3;
        err_cur[x] = pred - v3;
        for (int k = 0; k < 4; k++) {
            int64_t e = subpred[k] - v3;
            if (e < 0) e = -e;
            e = (e + 3) >> 3;
            pred_cur[k][x] = e;
            pred_prev[k][x + 1] += e;
        }
    }
};

static inline int64_t predict_one(int p, int64_t W, int64_t N, int64_t NW,
                                  int64_t NE, int64_t NN, int64_t WW,
                                  int64_t NEE, int64_t wp_pred3,
                                  int* err) {
    switch (p) {
        case 0: return 0;
        case 1: return W;
        case 2: return N;
        case 3: return (W + N) / 2;  // trunc toward zero, per reference
        case 4: {
            int64_t g = W + N - NW;
            int64_t dW = g - W; if (dW < 0) dW = -dW;
            int64_t dN = g - N; if (dN < 0) dN = -dN;
            return dW < dN ? W : N;  // ties go to N
        }
        case 5: return clamped_gradient(N, W, NW);
        case 6: return wp_pred3;  // WPStateC.predict descales
        case 7: return NE;
        case 8: return NW;
        case 9: return WW;
        case 10: return (W + NW) / 2;
        case 11: return (NW + N) / 2;
        case 12: return (N + NE) / 2;
        case 13: return (6 * N - 2 * NN + 7 * W + WW + NEE + 3 * NE + 8)
                     / 16;
    }
    *err = 1;
    return 0;
}

// Forward weighted-predictor pass over KNOWN data (encoder-side MA
// learning; cf. modular/learn.py wp_planes): fills the WP prediction
// plane and the property-15 plane.  Neighbor edge rules match the
// decode loop below exactly.
void wp_forward(const int64_t* D, int32_t w, int32_t h,
                const int32_t* wp_params,
                int64_t* out_pred, int64_t* out_prop) {
    WPStateC wp;
    wp.init(wp_params, w);
    for (int y = 0; y < h; y++) {
        if (y > 0) wp.new_row();
        for (int x = 0; x < w; x++) {
            int64_t W = x > 0 ? D[y * w + x - 1]
                       : (y > 0 ? D[(y - 1) * w + x] : 0);
            int64_t N = y > 0 ? D[(y - 1) * w + x] : W;
            int64_t NW = (x > 0 && y > 0) ? D[(y - 1) * w + x - 1] : W;
            int64_t NE = (x + 1 < w && y > 0) ? D[(y - 1) * w + x + 1]
                                              : N;
            int64_t NN = y > 1 ? D[(y - 2) * w + x] : N;
            out_pred[y * w + x] = wp.predict(x, y, w, W, N, NW, NE, NN);
            out_prop[y * w + x] = wp.prop;
            wp.update(x, D[y * w + x]);
        }
    }
}

// MA-tree split search inner loop (encoder learning; cf.
// modular/learn.py _learn_node): given per-predictor token ids and a
// bucket id per sample, fill costs[p][j] = ent(right(j)) + ent(left(j))
// where right(j) = samples with bucket <= j, using the same
// entropy-estimate formula as learn._ent (n*log2(n) - sum x*log2(x)
// + hist . raw_bits), in float64.
void ma_split_costs(const int32_t* tokens /* (P, n) */, int32_t P,
                    int64_t n, const int32_t* bucket /* (n,) */,
                    int32_t B, int32_t T, const double* rb /* (T,) */,
                    double* out_costs /* (P, B-1) */) {
    std::vector<int64_t> h2((size_t)P * B * T, 0);
    for (int p = 0; p < P; p++) {
        const int32_t* tp = tokens + (size_t)p * n;
        int64_t* hp = h2.data() + (size_t)p * B * T;
        for (int64_t i = 0; i < n; i++) {
            hp[(size_t)bucket[i] * T + tp[i]]++;
        }
    }
    std::vector<int64_t> cum((size_t)T, 0);
    std::vector<int64_t> tot((size_t)T, 0);
    auto ent = [&](const int64_t* h) {
        int64_t s = 0;
        double xl = 0.0, rbits = 0.0;
        for (int t = 0; t < T; t++) {
            int64_t x = h[t];
            if (x > 0) {
                s += x;
                xl += (double)x * std::log2((double)x);
                rbits += (double)x * rb[t];
            }
        }
        if (s == 0) return 0.0;
        return (double)s * std::log2((double)s) - xl + rbits;
    };
    std::vector<int64_t> left((size_t)T, 0);
    for (int p = 0; p < P; p++) {
        const int64_t* hp = h2.data() + (size_t)p * B * T;
        std::fill(cum.begin(), cum.end(), 0);
        std::fill(tot.begin(), tot.end(), 0);
        for (int b = 0; b < B; b++)
            for (int t = 0; t < T; t++) tot[t] += hp[(size_t)b * T + t];
        for (int j = 0; j < B - 1; j++) {
            for (int t = 0; t < T; t++) cum[t] += hp[(size_t)j * T + t];
            for (int t = 0; t < T; t++) left[t] = tot[t] - cum[t];
            out_costs[(size_t)p * (B - 1) + j] =
                ent(cum.data()) + ent(left.data());
        }
    }
}

// tree_flat: 7 int32 per node:
//   [property, splitval, left, right, predictor, offset, multiplier]
//   leaf ctx = node index order of leaves (precomputed on Python side
//   as the 8th column)
// Actually 8 columns with ctx last.
int decode_channel_native(
    EntropyCtx* ctx,
    const int32_t* tree_flat, int32_t n_nodes,
    int32_t* out, int32_t w, int32_t h,
    int32_t chan_index, int32_t stream_id,
    const int32_t* wp_params,  // 11 ints
    const int64_t** prev_planes, int32_t n_prev,
    int32_t use_wp, int32_t max_prop) {

    const int COLS = 8;
    WPStateC wp;
    if (use_wp) wp.init(wp_params, w);
    int errflag = 0;

    for (int y = 0; y < h; y++) {
        if (use_wp && y > 0) wp.new_row();
        int64_t prev_grad = 0;
        for (int x = 0; x < w; x++) {
            int64_t W = x > 0 ? out[y * w + x - 1]
                       : (y > 0 ? out[(y - 1) * w + x] : 0);
            int64_t N = y > 0 ? out[(y - 1) * w + x] : W;
            int64_t NW = (x > 0 && y > 0) ? out[(y - 1) * w + x - 1] : W;
            int64_t NE = (x + 1 < w && y > 0) ? out[(y - 1) * w + x + 1]
                                              : N;
            int64_t NN = y > 1 ? out[(y - 2) * w + x] : N;
            int64_t WW = x > 1 ? out[y * w + x - 2] : W;
            int64_t NEE = (x + 2 < w && y > 0) ? out[(y - 1) * w + x + 2]
                                               : NE;
            int64_t wp_pred = 0, wp_prop = 0;
            if (use_wp) {
                wp_pred = wp.predict(x, y, w, W, N, NW, NE, NN);
                wp_prop = wp.prop;
            }
            int64_t grad = W + N - NW;
            int node = 0;
            if (max_prop >= 0) {
                while (tree_flat[node * COLS + 0] >= 0) {
                    int prop = tree_flat[node * COLS + 0];
                    int64_t v;
                    switch (prop) {
                        case 0: v = chan_index; break;
                        case 1: v = stream_id; break;
                        case 2: v = y; break;
                        case 3: v = x; break;
                        case 4: v = N < 0 ? -N : N; break;
                        case 5: v = W < 0 ? -W : W; break;
                        case 6: v = N; break;
                        case 7: v = W; break;
                        case 8: v = W - prev_grad; break;
                        case 9: v = grad; break;
                        case 10: v = W - NW; break;
                        case 11: v = NW - N; break;
                        case 12: v = N - NE; break;
                        case 13: v = N - NN; break;
                        case 14: v = W - WW; break;
                        case 15: v = wp_prop; break;
                        default: {
                            int pi = (prop - 16) >> 2;
                            int sub = (prop - 16) & 3;
                            if (pi < n_prev) {
                                const int64_t* pp = prev_planes[pi];
                                int64_t pv = pp[y * w + x];
                                int64_t vleft = x ? pp[y * w + x - 1] : 0;
                                int64_t vtop = y ? pp[(y - 1) * w + x]
                                                 : vleft;
                                int64_t vtl = (x && y)
                                    ? pp[(y - 1) * w + x - 1] : vleft;
                                int64_t vpred = clamped_gradient(
                                    vtop, vleft, vtl);
                                switch (sub) {
                                    case 0: v = pv < 0 ? -pv : pv; break;
                                    case 1: v = pv; break;
                                    case 2: {
                                        int64_t dvv = pv - vpred;
                                        v = dvv < 0 ? -dvv : dvv;
                                        break;
                                    }
                                    default: v = pv - vpred; break;
                                }
                            } else v = 0;
                            break;
                        }
                    }
                    node = (v > tree_flat[node * COLS + 1])
                        ? tree_flat[node * COLS + 2]
                        : tree_flat[node * COLS + 3];
                }
            }
            prev_grad = grad;
            int predictor = tree_flat[node * COLS + 4];
            int64_t offset = tree_flat[node * COLS + 5];
            int64_t multiplier = tree_flat[node * COLS + 6];
            int leaf_ctx = tree_flat[node * COLS + 7];
            int64_t pred = predict_one(predictor, W, N, NW, NE, NN, WW,
                                       NEE, wp_pred, &errflag);
            int64_t residual = entropy_read(ctx, leaf_ctx);
            int64_t val = pred + offset
                + multiplier * unpack_signed(residual);
            out[y * w + x] = (int32_t)val;
            if (use_wp) wp.update(x, val);
        }
    }
    return errflag | ctx->error | (ctx->br.overrun ? 16 : 0);
}

// ---------------------------------------------------------------------
// VarDCT AC pass-group decode (scan-indexed quantized coefficients)

static const uint16_t kCoeffFreqCtx[64] = {
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};
static const uint16_t kCoeffNumNonzeroCtx[64] = {
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

// anchors_flat: per anchor 10 ints:
//   [bx, by, cov, log2cov, size, cx, cy, out_offset, bctx0|..(see below)]
// layout: bx, by, cov, log2cov, size, cx, cy, out_offset,
//         bctx_x, bctx_y, bctx_b  (11 ints)
// orders: for (bucket_used_index, channel): order_offsets lookup done in
// Python; per anchor we get 3 offsets into orders_flat (or -1 = identity).
int decode_ac_group_native(
    EntropyCtx* ctx,
    const int32_t* anchors_flat, int32_t n_anchors,
    const int32_t* order_offsets,  // 3 per anchor (x,y,b); -1 identity
    const int32_t* orders_flat,
    int32_t xs_b, int32_t ys_b,
    int32_t num_ctxs, int32_t ctx_base,
    int32_t* out_values  // concatenated per anchor: 3 * size ints
    ) {
    std::vector<int32_t> nz_map(3 * ys_b * xs_b, 0);
    const int A = 11;
    for (int ai = 0; ai < n_anchors; ai++) {
        const int32_t* a = anchors_flat + ai * A;
        int bx = a[0], by = a[1], cov = a[2], log2cov = a[3], size = a[4];
        int cx = a[5], cy = a[6];
        int64_t out_off = a[7];
        int bctx_c[3] = {a[8], a[9], a[10]};   // x, y, b
        static const int corder[3] = {1, 0, 2};
        for (int ci = 0; ci < 3; ci++) {
            int c = corder[ci];
            int bctx = bctx_c[c];
            int32_t* vals = out_values + out_off + (int64_t)c * size;
            int predicted;
            int32_t* nzrow = nz_map.data() + c * ys_b * xs_b;
            if (by == 0)
                predicted = bx == 0 ? 32 : nzrow[bx - 1];
            else if (bx == 0)
                predicted = nzrow[(by - 1) * xs_b + bx];
            else
                predicted = (nzrow[(by - 1) * xs_b + bx]
                             + nzrow[by * xs_b + bx - 1] + 1) / 2;
            if (predicted >= 64) predicted = 64;
            int pctx = predicted < 8 ? predicted : 4 + predicted / 2;
            int64_t nz = entropy_read(ctx,
                                      ctx_base + pctx * num_ctxs + bctx);
            if (nz >= size - cov + 1) { ctx->error = 8; return 8; }
            int spread = (int)((nz + cov - 1) >> log2cov);
            for (int yy = 0; yy < cy; yy++)
                for (int xx = 0; xx < cx; xx++)
                    nzrow[(by + yy) * xs_b + bx + xx] = spread;
            const int32_t* order = order_offsets[ai * 3 + c] >= 0
                ? orders_flat + order_offsets[ai * 3 + c] : nullptr;
            int ctx_off = ctx_base + num_ctxs * 37 + 458 * bctx;
            int prev = nz > (size >> 4) ? 0 : 1;
            int64_t nzeros = nz;
            for (int k = cov; nzeros > 0; k++) {
                if (k >= size) { ctx->error = 9; return 9; }
                int nzl = (int)((nzeros + cov - 1) >> log2cov);
                int kk = k >> log2cov;
                int zctx = ctx_off
                    + (kCoeffNumNonzeroCtx[nzl] + kCoeffFreqCtx[kk]) * 2
                    + prev;
                int64_t u = entropy_read(ctx, zctx);
                int64_t v = unpack_signed(u);
                int p = order ? order[k] : k;
                vals[p] = (int32_t)v;
                prev = v != 0;
                nzeros -= prev;
            }
        }
    }
    return ctx->error | (ctx->br.overrun ? 16 : 0);
}

// Encode mirror of decode_channel_native: same MA-tree property walk
// and predictors over KNOWN channel data, emitting (leaf ctx,
// pack_signed residual) token pairs (replaces the Python per-pixel
// loop that dominates WP-tree modular encoding).
int encode_channel_native(
    const int32_t* tree_flat, int32_t n_nodes,
    const int32_t* data, int32_t w, int32_t h,
    int32_t chan_index, int32_t stream_id,
    const int32_t* wp_params,
    const int64_t** prev_planes, int32_t n_prev,
    int32_t use_wp, int32_t max_prop,
    int32_t* out_ctx, int32_t* out_val) {
    const int COLS = 8;
    WPStateC wp;
    if (use_wp) wp.init(wp_params, w);
    int errflag = 0;
    int64_t m = 0;
    for (int y = 0; y < h; y++) {
        if (use_wp && y > 0) wp.new_row();
        int64_t prev_grad = 0;
        for (int x = 0; x < w; x++) {
            int64_t W = x > 0 ? data[y * w + x - 1]
                       : (y > 0 ? data[(y - 1) * w + x] : 0);
            int64_t N = y > 0 ? data[(y - 1) * w + x] : W;
            int64_t NW = (x > 0 && y > 0) ? data[(y - 1) * w + x - 1] : W;
            int64_t NE = (x + 1 < w && y > 0) ? data[(y - 1) * w + x + 1]
                                              : N;
            int64_t NN = y > 1 ? data[(y - 2) * w + x] : N;
            int64_t WW = x > 1 ? data[y * w + x - 2] : W;
            int64_t NEE = (x + 2 < w && y > 0) ? data[(y - 1) * w + x + 2]
                                               : NE;
            int64_t wp_pred = 0, wp_prop = 0;
            if (use_wp) {
                wp_pred = wp.predict(x, y, w, W, N, NW, NE, NN);
                wp_prop = wp.prop;
            }
            int64_t grad = W + N - NW;
            int node = 0;
            if (max_prop >= 0) {
                while (tree_flat[node * COLS + 0] >= 0) {
                    int prop = tree_flat[node * COLS + 0];
                    int64_t v;
                    switch (prop) {
                        case 0: v = chan_index; break;
                        case 1: v = stream_id; break;
                        case 2: v = y; break;
                        case 3: v = x; break;
                        case 4: v = N < 0 ? -N : N; break;
                        case 5: v = W < 0 ? -W : W; break;
                        case 6: v = N; break;
                        case 7: v = W; break;
                        case 8: v = W - prev_grad; break;
                        case 9: v = grad; break;
                        case 10: v = W - NW; break;
                        case 11: v = NW - N; break;
                        case 12: v = N - NE; break;
                        case 13: v = N - NN; break;
                        case 14: v = W - WW; break;
                        case 15: v = wp_prop; break;
                        default: {
                            int pi = (prop - 16) >> 2;
                            int sub = (prop - 16) & 3;
                            if (pi < n_prev) {
                                const int64_t* pp = prev_planes[pi];
                                int64_t pv = pp[y * w + x];
                                int64_t vleft = x ? pp[y * w + x - 1] : 0;
                                int64_t vtop = y ? pp[(y - 1) * w + x]
                                                 : vleft;
                                int64_t vtl = (x && y)
                                    ? pp[(y - 1) * w + x - 1] : vleft;
                                int64_t vpred = clamped_gradient(
                                    vtop, vleft, vtl);
                                switch (sub) {
                                    case 0: v = pv < 0 ? -pv : pv; break;
                                    case 1: v = pv; break;
                                    case 2: {
                                        int64_t dvv = pv - vpred;
                                        v = dvv < 0 ? -dvv : dvv;
                                        break;
                                    }
                                    default: v = pv - vpred; break;
                                }
                            } else v = 0;
                            break;
                        }
                    }
                    node = (v > tree_flat[node * COLS + 1])
                        ? tree_flat[node * COLS + 2]
                        : tree_flat[node * COLS + 3];
                }
            }
            prev_grad = grad;
            int predictor = tree_flat[node * COLS + 4];
            int64_t offset = tree_flat[node * COLS + 5];
            int64_t multiplier = tree_flat[node * COLS + 6];
            int leaf_ctx = tree_flat[node * COLS + 7];
            int64_t pred = predict_one(predictor, W, N, NW, NE, NN, WW,
                                       NEE, wp_pred, &errflag);
            int64_t val = data[y * w + x];
            int64_t diff = val - pred - offset;
            if (multiplier != 1) {
                if (diff % multiplier != 0) { errflag |= 32; }
                diff = diff / multiplier;
            }
            out_ctx[m] = leaf_ctx;
            out_val[m] = (int32_t)(diff >= 0 ? (diff << 1)
                                             : ((-diff) << 1) - 1);
            m++;
            if (use_wp) wp.update(x, val);
        }
    }
    return errflag;
}

// ---------------------------------------------------------------------
// Encoder AC tokenization: the exact mirror of decode_ac_group_native's
// context walk, emitting (ctx, value) token pairs for the entropy
// writer (replaces the Python per-token loop in
// vardct/enc_real._write_ac_tokens).
// anchors_flat: 10 int32 per anchor [bx, by, cov, log2cov, size, cx,
// cy, bctx_x, bctx_y, bctx_b]; vals at val_offs[i] hold 3*size int32
// (channel-major X, Y, B) scan-ordered values.  Returns token count.
int64_t encode_ac_tokens(
    const int32_t* anchors_flat, int32_t n_anchors,
    const int64_t* val_offs, const int32_t* vals,
    int32_t xs_b, int32_t ys_b, int32_t num_ctxs,
    int32_t* out_ctx, int32_t* out_val) {
    std::vector<int32_t> nz_map((size_t)3 * ys_b * xs_b, 0);
    static const int corder[3] = {1, 0, 2};
    int64_t m = 0;
    for (int32_t ai = 0; ai < n_anchors; ai++) {
        const int32_t* a = anchors_flat + (size_t)ai * 10;
        int bx = a[0], by = a[1], cov = a[2], log2cov = a[3];
        int size = a[4], cx = a[5], cy = a[6];
        int bctx_c[3] = {a[7], a[8], a[9]};
        const int32_t* base = vals + val_offs[ai];
        for (int ci = 0; ci < 3; ci++) {
            int c = corder[ci];
            int bctx = bctx_c[c];
            const int32_t* v = base + (size_t)c * size;
            int32_t* nzrow = nz_map.data() + (size_t)c * ys_b * xs_b;
            int predicted;
            if (by == 0)
                predicted = bx == 0 ? 32 : nzrow[bx - 1];
            else if (bx == 0)
                predicted = nzrow[(by - 1) * xs_b + bx];
            else
                predicted = (nzrow[(by - 1) * xs_b + bx]
                             + nzrow[by * xs_b + bx - 1] + 1) / 2;
            if (predicted >= 64) predicted = 64;
            int pctx = predicted < 8 ? predicted : 4 + predicted / 2;
            int nz = 0;
            for (int k = cov; k < size; k++) nz += v[k] != 0;
            int spread = (nz + cov - 1) >> log2cov;
            for (int yy = 0; yy < cy; yy++)
                for (int xx = 0; xx < cx; xx++)
                    nzrow[(by + yy) * xs_b + bx + xx] = spread;
            out_ctx[m] = pctx * num_ctxs + bctx;
            out_val[m] = nz;
            m++;
            int ctx_off = num_ctxs * 37 + 458 * bctx;
            int prev = nz > (size >> 4) ? 0 : 1;
            int nzeros = nz;
            for (int k = cov; nzeros > 0; k++) {
                int32_t val = v[k];
                int nzl = (nzeros + cov - 1) >> log2cov;
                int kk = k >> log2cov;
                out_ctx[m] = ctx_off
                    + (kCoeffNumNonzeroCtx[nzl] + kCoeffFreqCtx[kk]) * 2
                    + prev;
                out_val[m] = val >= 0 ? (val << 1) : ((-val) << 1) - 1;
                m++;
                prev = val != 0;
                nzeros -= prev;
            }
        }
    }
    return m;
}

// ---------------------------------------------------------------------
// Device-marshalling pack: gather one strategy family's coefficients
// out of the flat BlockArrays layout into the dense (n, 3, nc) int16
// tensor the device consumes, applying the static scan->basis
// permutation in the same pass.  One C++ sweep replaces three numpy
// fancy-gathers over ~100 MB of temporaries (the round-3 e2e decode
// profile showed prepare_families dominating at 4-9 s/4K-frame on the
// 2-core host).  Returns the max |coefficient| seen (callers fall
// back to the int32 path when it exceeds int16).
// int8 variant: values outside int8 go into an exception list
// (flat index into the (nsel, 3, nc) tensor + true value), the int8
// slot holds 0 so the device applies them with one scatter-ADD.
// Returns the exception count, or -1 when it exceeds cap (caller
// falls back to the int16 pack).  Halves the host->device coefficient
// upload — the dominant e2e term on transfer-limited links.
int64_t pack_family_i8(const int32_t* coeffs, const int64_t* offs,
                       const int32_t* sel, int64_t nsel, int32_t nc,
                       const int32_t* perm,
                       int8_t* out, int64_t cap,
                       int32_t* fix_idx, int32_t* fix_val) {
    int64_t nexc = 0;
    for (int64_t i = 0; i < nsel; i++) {
        const int32_t* src = coeffs + offs[sel[i]];
        int8_t* dst = out + i * 3 * (int64_t)nc;
        for (int c = 0; c < 3; c++) {
            const int32_t* s = src + (int64_t)c * nc;
            int8_t* dx = dst + (int64_t)c * nc;
            int64_t base = (i * 3 + c) * (int64_t)nc;
            for (int32_t j = 0; j < nc; j++) {
                int32_t v = s[perm[j]];
                if (v >= -128 && v <= 127) {
                    dx[j] = (int8_t)v;
                } else {
                    if (nexc >= cap) return -1;
                    fix_idx[nexc] = (int32_t)(base + j);
                    fix_val[nexc] = v;
                    nexc++;
                    dx[j] = 0;
                }
            }
        }
    }
    return nexc;
}

int64_t pack_family_i16(const int32_t* coeffs, const int64_t* offs,
                        const int32_t* sel, int64_t nsel, int32_t nc,
                        const int32_t* perm,  // len nc: out[j]=in[perm[j]]
                        int16_t* out) {
    int64_t mx = 0;
    for (int64_t i = 0; i < nsel; i++) {
        const int32_t* src = coeffs + offs[sel[i]];
        int16_t* dst = out + i * 3 * (int64_t)nc;
        for (int c = 0; c < 3; c++) {
            const int32_t* s = src + (int64_t)c * nc;
            int16_t* d = dst + (int64_t)c * nc;
            for (int32_t j = 0; j < nc; j++) {
                int32_t v = s[perm[j]];
                int32_t a = v < 0 ? -v : v;
                if (a > mx) mx = a;
                d[j] = (int16_t)v;
            }
        }
    }
    return mx;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// Pixel pipeline kernels: fused XYB->sRGB conversion and the
// gaborish + EPF restoration chain.  These mirror the numpy reference
// implementations in vardct/dec_real.py (which remain the oracle);
// the colour transform reproduces the float32 FastLinearToSRGB bit
// tricks exactly (compile with -ffp-contract=off so no FMA creeps in).

extern "C" {

static const uint32_t kPow25to18[16] = {
    0x0, 0xa, 0x19, 0x26, 0x32, 0x41, 0x4d, 0x5c,
    0x68, 0x75, 0x83, 0x8f, 0xa0, 0xaa, 0xb9, 0xc6};
static const uint32_t kPow17to10[16] = {
    0x0, 0xb7, 0x4, 0xd, 0xcb, 0xe7, 0x41, 0x68,
    0x51, 0xd1, 0xeb, 0xf2, 0x0, 0xb7, 0x4, 0xd};

static inline float linear_to_srgb_f32(float v) {
    uint32_t vb;
    memcpy(&vb, &v, 4);
    uint32_t ub = (vb | 0x3e800000u) & 0x3effffffu;
    float v025;
    memcpy(&v025, &ub, 4);
    float d1 = v025 * 0.059914046f + -0.108894556f;
    float d2 = d1 * v025 + 0.107963754f;
    float pw = d2 * v025 + 0.018092343f;
    uint32_t exp = ((vb >> 23) - 118u) & 0xfu;
    uint32_t mb = (kPow25to18[exp] << 18) | (kPow17to10[exp] << 10)
        | 0x40000000u;
    float mul;
    memcpy(&mul, &mb, 4);
    if (v < 0.0031308f) return v * 12.92f;
    return pw * mul + -0.055f;
}

// X/Y/B: row-major (h, w) float64 planes; out: interleaved RGB
// uint8 (bits<=8) or uint16.  opsin_inv: 9 float64 (row-major 3x3).
static void xyb_to_srgb_range(const double* X, const double* Y,
                              const double* B, int64_t i0, int64_t i1,
                              const float* inv, float fb, float fcb,
                              int bits, void* out) {
    uint8_t* o8 = (uint8_t*)out;
    uint16_t* o16 = (uint16_t*)out;
    for (int64_t i = i0; i < i1; i++) {
        float x = (float)X[i], y = (float)Y[i], b = (float)B[i];
        float gr = y + x + fcb;
        float gg = y - x + fcb;
        float gb = b + fcb;
        float m0 = gr * gr * gr - fb;
        float m1 = gg * gg * gg - fb;
        float m2 = gb * gb * gb - fb;
        for (int c = 0; c < 3; c++) {
            float lin = m0 * inv[c * 3 + 0] + m1 * inv[c * 3 + 1]
                + m2 * inv[c * 3 + 2];
            float s = linear_to_srgb_f32(lin);
            if (bits <= 8) {
                float q = floorf(s * 255.0f + 0.5f);
                o8[i * 3 + c] = (uint8_t)(q < 0 ? 0 : (q > 255 ? 255 : q));
            } else {
                float q = floorf(s * 65535.0f + 0.5f);
                o16[i * 3 + c] =
                    (uint16_t)(q < 0 ? 0 : (q > 65535 ? 65535 : q));
            }
        }
    }
}

void xyb_to_srgb(const double* X, const double* Y, const double* B,
                 int64_t n, const double* opsin_inv, double bias,
                 double cbrt_bias, int bits, void* out) {
    float inv[9];
    for (int i = 0; i < 9; i++) inv[i] = (float)opsin_inv[i];
    const float fb = (float)bias;
    const float fcb = (float)cbrt_bias;
    unsigned nt = std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 8) nt = 8;
    if (n < 262144 || nt == 1) {
        xyb_to_srgb_range(X, Y, B, 0, n, inv, fb, fcb, bits, out);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; t++) {
        int64_t i0 = t * chunk;
        int64_t i1 = i0 + chunk < n ? i0 + chunk : n;
        if (i0 >= i1) break;
        ts.emplace_back(xyb_to_srgb_range, X, Y, B, i0, i1, inv, fb,
                        fcb, bits, out);
    }
    for (auto& th : ts) th.join();
}

static inline double edge_at(const double* p, int H, int W, int y, int x) {
    // libjxl Mirror(): -1 -> 0, -2 -> 1, H -> H-1, H+1 -> H-2
    if (y < 0) y = -y - 1;
    if (y >= H) y = 2 * H - 1 - y;
    if (x < 0) x = -x - 1;
    if (x >= W) x = 2 * W - 1 - x;
    return p[(int64_t)y * W + x];
}

static void gaborish_rows(const double* in, double* out, int H, int W,
                          double w1, double w2, int ya, int yb) {
    double norm = 1.0 + 4.0 * (w1 + w2);
    for (int y = ya; y < yb; y++) {
        // mirror (symmetric) padding: index -1 -> 0, H -> H-1
        int ym = y > 0 ? y - 1 : 0;
        int yp = y < H - 1 ? y + 1 : H - 1;
        const double* r0 = in + (int64_t)ym * W;
        const double* r1 = in + (int64_t)y * W;
        const double* r2 = in + (int64_t)yp * W;
        double* dst = out + (int64_t)y * W;
        for (int x = 0; x < W; x++) {
            int xm = x > 0 ? x - 1 : 0;
            int xp = x < W - 1 ? x + 1 : W - 1;
            double v = r1[x]
                + w1 * (r0[x] + r2[x] + r1[xm] + r1[xp])
                + w2 * (r0[xm] + r0[xp] + r2[xm] + r2[xp]);
            dst[x] = v / norm;
        }
    }
}

}  // extern "C" (templates below need C++ linkage)

// Per-channel SAD scales (X, Y, B) pinned by single-channel striped
// probes (research/epf_kernel_probe.py); the EPF weight slope is
// 2.53*kInv/sigma times the pass sigma scale, gated at sigma 0.2701.
static const double kEpfScale[3] = {23.51, 2.938, 2.057};
static const double kInvSigmaNum = -1.1715728752538099024;
static const double kEpfSlope = 2.530;
static const double kSigmaGate = 0.2701;

// Shared kernel: `offs[n_offs]` neighbours, patch or pointwise SAD.
template <int N_OFFS, bool PATCH>
static void epf_rows_impl(const double* const in[3], double* const out[3],
                          int H, int W, const double* sigma, int sh, int sw,
                          double slope_scale, const int (*offs)[2],
                          int ya, int yb) {
    static const int taps[5][2] = {{0,0},{0,1},{0,-1},{1,0},{-1,0}};
    (void)sh;
    for (int y = ya; y < yb; y++) {
        int border_y = (y % 8 == 0) || (y % 8 == 7);
        for (int x = 0; x < W; x++) {
            double sg = sigma[(int64_t)(y / 8) * sw + (x / 8)];
            int border = border_y || (x % 8 == 0) || (x % 8 == 7);
            if (sg < kSigmaGate) {
                for (int c = 0; c < 3; c++)
                    out[c][(int64_t)y * W + x] = in[c][(int64_t)y * W + x];
                continue;
            }
            double invs = kInvSigmaNum * kEpfSlope * slope_scale / sg;
            if (border) invs *= (2.0 / 3.0);
            double wsum = 1.0;
            double acc[3];
            for (int c = 0; c < 3; c++)
                acc[c] = in[c][(int64_t)y * W + x];
            for (int o = 0; o < N_OFFS; o++) {
                int dy = offs[o][0], dx = offs[o][1];
                double sad = 0.0;
                for (int c = 0; c < 3; c++) {
                    double s = 0.0;
                    if (PATCH) {
                        for (int t = 0; t < 5; t++) {
                            double a = edge_at(in[c], H, W, y + taps[t][0],
                                               x + taps[t][1]);
                            double b = edge_at(in[c], H, W,
                                               y + dy + taps[t][0],
                                               x + dx + taps[t][1]);
                            s += a > b ? a - b : b - a;
                        }
                    } else {
                        double a = in[c][(int64_t)y * W + x];
                        double b = edge_at(in[c], H, W, y + dy, x + dx);
                        s = a > b ? a - b : b - a;
                    }
                    sad += kEpfScale[c] * s;
                }
                double w = 1.0 + sad * invs;
                if (w < 0.0) w = 0.0;
                wsum += w;
                for (int c = 0; c < 3; c++)
                    acc[c] += w * edge_at(in[c], H, W, y + dy, x + dx);
            }
            for (int c = 0; c < 3; c++)
                out[c][(int64_t)y * W + x] = acc[c] / wsum;
        }
    }
}

static const int kOffsPlus4[4][2] = {{0,1},{0,-1},{1,0},{-1,0}};
static const int kOffsDiamond12[12][2] = {
    {0,1},{0,-1},{1,0},{-1,0},{1,1},{1,-1},{-1,1},{-1,-1},
    {0,2},{0,-2},{2,0},{-2,0}};

// EPF pass 0 (iters >= 3): 12-neighbour diamond, patch SAD.
static void epf0_rows(const double* const in[3], double* const out[3],
                      int H, int W, const double* sigma, int sh, int sw,
                      double pass0_scale, int ya, int yb) {
    epf_rows_impl<12, true>(in, out, H, W, sigma, sh, sw, pass0_scale,
                            kOffsDiamond12, ya, yb);
}

// EPF pass 1 (main): 4-neighbour cross, 5-tap patch SAD.
static void epf1_rows(const double* const in[3], double* const out[3],
                      int H, int W, const double* sigma, int sh, int sw,
                      int ya, int yb) {
    epf_rows_impl<4, true>(in, out, H, W, sigma, sh, sw, 1.0,
                           kOffsPlus4, ya, yb);
}

// EPF pass 2 (iters >= 2): 4-neighbour cross, pointwise SAD, slope
// scaled by pass2_sigma_scale.
static void epf2_rows(const double* const in[3], double* const out[3],
                      int H, int W, const double* sigma, int sh, int sw,
                      double sigma_scale, int ya, int yb) {
    epf_rows_impl<4, false>(in, out, H, W, sigma, sh, sw, sigma_scale,
                            kOffsPlus4, ya, yb);
}

template <typename F>
static void parallel_rows(int H, F fn) {
    unsigned nt = std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 8) nt = 8;
    if (H < 64 || nt == 1) { fn(0, H); return; }
    std::vector<std::thread> ts;
    int chunk = (H + (int)nt - 1) / (int)nt;
    for (unsigned t = 0; t < nt; t++) {
        int y0 = (int)t * chunk;
        int y1 = y0 + chunk < H ? y0 + chunk : H;
        if (y0 >= y1) break;
        ts.emplace_back([&fn, y0, y1]() { fn(y0, y1); });
    }
    for (auto& th : ts) th.join();
}

extern "C" {

static void gaborish_plane(const double* in, double* out, int H, int W,
                           double w1, double w2) {
    parallel_rows(H, [&](int ya, int yb) {
        gaborish_rows(in, out, H, W, w1, w2, ya, yb);
    });
}

static void epf0_pass(const double* const in[3], double* const out[3],
                      int H, int W, const double* sigma, int sh, int sw,
                      double pass0_scale) {
    parallel_rows(H, [&](int ya, int yb) {
        epf0_rows(in, out, H, W, sigma, sh, sw, pass0_scale, ya, yb);
    });
}

static void epf1_pass(const double* const in[3], double* const out[3],
                      int H, int W, const double* sigma, int sh, int sw) {
    parallel_rows(H, [&](int ya, int yb) {
        epf1_rows(in, out, H, W, sigma, sh, sw, ya, yb);
    });
}

static void epf2_pass(const double* const in[3], double* const out[3],
                      int H, int W, const double* sigma, int sh, int sw,
                      double sigma_scale) {
    parallel_rows(H, [&](int ya, int yb) {
        epf2_rows(in, out, H, W, sigma, sh, sw, sigma_scale, ya, yb);
    });
}

// Full restoration chain in place on (H, W) float64 planes.
void filter_chain(double* X, double* Y, double* B, int H, int W,
                  int gab, double w1x, double w2x, double w1y, double w2y,
                  double w1b, double w2b, int epf_iters,
                  const double* sigma, int sh, int sw,
                  double pass0_scale, double pass2_scale) {
    int64_t n = (int64_t)H * W;
    double* tmpX = (double*)malloc(n * 8);
    double* tmpY = (double*)malloc(n * 8);
    double* tmpB = (double*)malloc(n * 8);
    if (!tmpX || !tmpY || !tmpB) { free(tmpX); free(tmpY); free(tmpB); return; }
    double* cur[3] = {X, Y, B};
    double* alt[3] = {tmpX, tmpY, tmpB};
    if (gab) {
        gaborish_plane(cur[0], alt[0], H, W, w1x, w2x);
        gaborish_plane(cur[1], alt[1], H, W, w1y, w2y);
        gaborish_plane(cur[2], alt[2], H, W, w1b, w2b);
        for (int c = 0; c < 3; c++) { double* t = cur[c]; cur[c] = alt[c]; alt[c] = t; }
    }
    if (epf_iters >= 1 && sigma != nullptr) {
        const double* cin[3];
        if (epf_iters >= 3) {
            for (int c = 0; c < 3; c++) cin[c] = cur[c];
            epf0_pass(cin, alt, H, W, sigma, sh, sw, pass0_scale);
            for (int c = 0; c < 3; c++) { double* t = cur[c]; cur[c] = alt[c]; alt[c] = t; }
        }
        for (int c = 0; c < 3; c++) cin[c] = cur[c];
        epf1_pass(cin, alt, H, W, sigma, sh, sw);
        for (int c = 0; c < 3; c++) { double* t = cur[c]; cur[c] = alt[c]; alt[c] = t; }
        if (epf_iters >= 2) {
            for (int c = 0; c < 3; c++) cin[c] = cur[c];
            epf2_pass(cin, alt, H, W, sigma, sh, sw, pass2_scale);
            for (int c = 0; c < 3; c++) { double* t = cur[c]; cur[c] = alt[c]; alt[c] = t; }
        }
    }
    double* dst[3] = {X, Y, B};
    for (int c = 0; c < 3; c++) {
        if (cur[c] != dst[c]) memcpy(dst[c], cur[c], n * 8);
    }
    free(tmpX); free(tmpY); free(tmpB);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rANS stream writer: tokenize (hybrid uint) + reverse-pass state pushes +
// forward LSB-first bit emission.  Mirrors entropy/coder.py
// _write_symbols_ans / ans.AnsEncoder exactly.

extern "C" {

int64_t ans_stream_encode(
    const int32_t* ctxs, const int64_t* values, int64_t n,
    const int32_t* cmap, int32_t num_ctx,
    int32_t split_exp, int32_t msb, int32_t lsb,
    const int32_t* freq, const int32_t* cumfreq, const int32_t* rev,
    int32_t max_alpha,
    uint8_t* out, int64_t out_cap_bits)
{
    const int64_t split = (int64_t)1 << split_exp;
    int32_t* tok = (int32_t*)malloc((size_t)n * 4);
    uint64_t* extra = (uint64_t*)malloc((size_t)n * 8);
    uint8_t* nbits = (uint8_t*)malloc((size_t)n);
    int32_t* cls = (int32_t*)malloc((size_t)n * 4);
    int32_t* words = (int32_t*)malloc((size_t)n * 4);
    if (!tok || !extra || !nbits || !cls || !words) {
        free(tok); free(extra); free(nbits); free(cls); free(words);
        return -1;
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t v = values[i];
        cls[i] = num_ctx > 1 ? cmap[ctxs[i]] : 0;
        if (v < split) {
            tok[i] = (int32_t)v; extra[i] = 0; nbits[i] = 0;
        } else {
            int nlead = 63 - __builtin_clzll((uint64_t)v);
            int nb = nlead - msb - lsb;
            tok[i] = (int32_t)(split
                + (((int64_t)(nlead - split_exp) << (msb + lsb))
                   | (((v >> (nlead - msb)) & ((1 << msb) - 1)) << lsb)
                   | (v & ((1 << lsb) - 1))));
            extra[i] = ((uint64_t)v >> lsb) & (((uint64_t)1 << nb) - 1);
            nbits[i] = (uint8_t)nb;
        }
    }
    // reverse rANS pass (ANS_LOG_TAB_SIZE = 12, signature 0x13)
    uint32_t state = 0x13u << 16;
    for (int64_t i = n - 1; i >= 0; i--) {
        int32_t cl = cls[i];
        int32_t s = tok[i];
        if (s >= max_alpha) {
            free(tok); free(extra); free(nbits); free(cls); free(words);
            return -3;
        }
        uint32_t f = (uint32_t)freq[(int64_t)cl * max_alpha + s];
        if (f == 0) {
            free(tok); free(extra); free(nbits); free(cls); free(words);
            return -2;
        }
        if ((uint64_t)state >= ((uint64_t)f << 20)) {
            // single-symbol clusters have f == 4096: the shift must not
            // wrap in 32 bits
            words[i] = (int32_t)(state & 0xFFFF);
            state >>= 16;
        } else {
            words[i] = -1;
        }
        uint32_t off = state % f;
        int32_t idx = rev[(int64_t)cl * 4096
                          + cumfreq[(int64_t)cl * max_alpha + s] + off];
        state = ((state / f) << 12) | (uint32_t)idx;
    }
    // forward emission
    int64_t pos = 0;
#define PUT(val_, nb_) do { \
        uint64_t v_ = (val_); int rem_ = (nb_); \
        if (pos + rem_ > out_cap_bits) { \
            free(tok); free(extra); free(nbits); free(cls); free(words); \
            return -4; } \
        while (rem_ > 0) { \
            int bib_ = (int)(pos & 7); \
            int take_ = 8 - bib_; if (take_ > rem_) take_ = rem_; \
            out[pos >> 3] |= (uint8_t)((v_ & ((1u << take_) - 1)) << bib_); \
            v_ >>= take_; pos += take_; rem_ -= take_; } \
    } while (0)
    PUT(state, 32);
    for (int64_t i = 0; i < n; i++) {
        if (words[i] >= 0) PUT((uint32_t)words[i], 16);
        if (nbits[i]) PUT(extra[i], nbits[i]);
    }
#undef PUT
    free(tok); free(extra); free(nbits); free(cls); free(words);
    return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Histogram clustering (encoder): greedy seeded clustering + agglomerative
// refinement with ANS-header-size merge costs.  Mirrors
// entropy/coder.cluster_histograms (dense path) and the helpers in
// entropy/ans.py (normalize_counts, _quantize_for_shift, _rle_runs,
// _complex_cost_bits, estimate_ans_distribution_bits) exactly, including
// tie order.  Equivalent of libjxl's FastClusterHistograms +
// agglomerative merge behind JxlEncoderAddImageFrame
// (/root/reference vendors it inside libjxl.so).

namespace cluster_impl {

static const int kLogTab = 12;
static const int kTabSize = 1 << kLogTab;
// LOGCOUNT_CODE lengths (entropy/ans.py:57)
static const int kLogCountLen[14] = {5,4,4,4,4,4,3,3,3,3,3,6,7,7};

static inline int bit_length(int64_t v) {
    return v <= 0 ? 0 : 64 - (int)__builtin_clzll((uint64_t)v);
}
static inline int logcount_of(int64_t c) {
    return c == 0 ? 0 : (c == 1 ? 1 : bit_length(c));
}
static inline int u8_bits(int64_t v) {
    return v == 0 ? 1 : 4 + (bit_length(v) - 1);
}
static inline int pop_precision(int logcount, int shift) {
    int r = logcount < (shift - ((kLogTab - logcount) >> 1))
        ? logcount : (shift - ((kLogTab - logcount) >> 1));
    return r > 0 ? r : 0;
}

// Shannon cost (bits) of coding a histogram with its own distribution.
static double hist_cost(const int64_t* h, int T) {
    long double tot = 0, xl = 0;
    for (int t = 0; t < T; t++) {
        int64_t c = h[t];
        if (c > 0) { tot += c; xl += (long double)c * log2l((long double)c); }
    }
    if (tot <= 0) return 0.0;
    return (double)(tot * log2l(tot) - xl);
}

// normalize_counts (ans.py:202): largest-remainder to kTabSize with
// every observed symbol kept >= 1.  hist/out length = alpha.
static void normalize_counts(const int64_t* hist, int alpha, int64_t* out) {
    long double total = 0;
    for (int i = 0; i < alpha; i++) total += hist[i];
    if (total <= 0) {
        out[0] = kTabSize;
        for (int i = 1; i < alpha; i++) out[i] = 0;
        return;
    }
    std::vector<double> raw(alpha);
    int64_t sum = 0;
    for (int i = 0; i < alpha; i++) {
        raw[i] = (double)((long double)hist[i] * kTabSize / total);
        out[i] = hist[i] > 0 ? (int64_t)raw[i] : 0;   // trunc == floor (>=0)
        if (hist[i] > 0 && out[i] < 1) out[i] = 1;
        sum += out[i];
    }
    int64_t diff = kTabSize - sum;
    std::vector<int> order(alpha);
    for (int i = 0; i < alpha; i++) order[i] = i;
    if (diff > 0) {
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
            return (raw[a] - (double)out[a]) > (raw[b] - (double)out[b]); });
        size_t k = 0;
        while (diff > 0) {
            int i = order[k % alpha];
            if (hist[i] > 0) { out[i]++; diff--; }
            k++;
        }
    } else if (diff < 0) {
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
            return out[a] > out[b]; });
        size_t k = 0;
        while (diff < 0) {
            int i = order[k % alpha];
            if (out[i] > 1) { out[i]--; diff++; }
            k++;
        }
    }
}

// _quantize_for_shift_scalar (ans.py:291).  Returns omit pos or -1.
static int quantize_for_shift(const int64_t* counts, int alpha, int shift,
                              int64_t* q) {
    for (int i = 0; i < alpha; i++) {
        int64_t c = counts[i];
        if (c <= 1) { q[i] = c; continue; }
        int code = bit_length(c);
        int bitcount = pop_precision(code - 1, shift);
        int64_t step = (int64_t)1 << (code - 1 - bitcount);
        int64_t base = (int64_t)1 << (code - 1);
        int64_t qq = base + ((c - base + step / 2) / step) * step;
        if (qq >= ((int64_t)1 << code)) qq = ((int64_t)1 << code) - step;
        q[i] = qq;
    }
    int omit = 0;
    for (int i = 1; i < alpha; i++) if (q[i] > q[omit]) omit = i;
    int64_t total = 0;
    for (int i = 0; i < alpha; i++) total += q[i];
    for (int iter = 0; iter <= alpha; iter++) {
        int64_t rem = kTabSize - (total - q[omit]);
        if (rem <= 0) return -1;
        int64_t old = q[omit];
        q[omit] = rem;
        int dec_omit = 0, best_log = -1;
        for (int i = 0; i < alpha; i++) {
            int lg = logcount_of(q[i]);
            if (lg > best_log) { best_log = lg; dec_omit = i; }
        }
        if (dec_omit == omit) return omit;
        q[omit] = old;
        omit = dec_omit;
    }
    return -1;
}

// _rle_runs (ans.py:322) + _complex_cost_bits (ans.py:346) fused.
static int complex_cost_bits(const int64_t* q, int alpha, int omit,
                             int shift) {
    int bits = 0;
    int i = 1;
    std::vector<std::pair<int,int>> runs;
    while (i < alpha) {
        if (i == omit || i == omit + 1) { i++; continue; }
        int j = i;
        while (j < alpha && j != omit && q[j] == q[i - 1] && j - i < 259)
            j++;
        if (j - i >= 4) { runs.emplace_back(i, j - i); i = j; }
        else i++;
    }
    std::vector<uint8_t> covered(alpha, 0);
    for (auto& r : runs)
        for (int k = r.first; k < r.first + r.second; k++) covered[k] = 1;
    for (int k = 0; k < alpha; k++) {
        if (covered[k]) continue;
        int code = logcount_of(q[k]);
        bits += kLogCountLen[code];
        if (k != omit && code > 1) bits += pop_precision(code - 1, shift);
    }
    for (auto& r : runs)
        bits += kLogCountLen[13] + u8_bits(r.second - 4);
    return bits;
}

// estimate_ans_distribution_bits (ans.py:441): header size with the
// coarse shift grid; num_tokens weights the KL regret in shift choice.
static double estimate_dist_bits(const int64_t* counts, int alpha0,
                                 int64_t num_tokens) {
    int nnz = 0, first = -1, second = -1;
    for (int i = 0; i < alpha0; i++)
        if (counts[i] > 0) {
            if (nnz == 0) first = i; else if (nnz == 1) second = i;
            nnz++;
        }
    if (nnz == 1) return 2 + u8_bits(first);
    if (nnz == 2) return 2 + u8_bits(first) + u8_bits(second) + 12;
    // flat check (ans.py flat_counts)
    {
        int64_t base = kTabSize / alpha0;
        int64_t remn = kTabSize - base * alpha0;
        bool flat = true;
        for (int i = 0; i < alpha0; i++)
            if (counts[i] != base + (i < remn ? 1 : 0)) { flat = false; break; }
        if (flat) return 2 + u8_bits(alpha0 - 1);
    }
    int alpha = alpha0;
    while (alpha > 3 && counts[alpha - 1] == 0) alpha--;
    if (alpha < 3) alpha = 3;
    std::vector<int64_t> q(alpha);
    double best_total = 0; int best_hdr = -1;
    for (int shift = 1; shift <= 13; shift += 2) {
        int omit = quantize_for_shift(counts, alpha, shift, q.data());
        if (omit < 0) continue;
        int hdr = complex_cost_bits(q.data(), alpha, omit, shift) + 6
            + u8_bits(alpha - 3);
        double kl = 0.0; bool inf = false;
        for (int i = 0; i < alpha; i++) {
            if (counts[i] > 0) {
                if (q[i] <= 0) { inf = true; break; }
                kl += ((double)counts[i] / kTabSize)
                    * log2((double)counts[i] / (double)q[i]);
            }
        }
        if (kl < 0.0) kl = 0.0;
        double total = inf ? 1e300 : hdr + kl * (double)num_tokens;
        if (best_hdr < 0 || total < best_total) {
            best_total = total; best_hdr = hdr;
        }
    }
    if (best_hdr < 0) return 6.0 * alpha + 40.0;
    return (double)best_hdr;
}

// hist_bits_row (coder.py:284): serialized-header size of one histogram.
static double hist_bits_row(const int64_t* row, int T) {
    int maxs = -1;
    int64_t ntok = 0;
    int nnz = 0;
    for (int t = 0; t < T; t++)
        if (row[t] > 0) { maxs = t; ntok += row[t]; nnz++; }
    if (maxs < 0) return 0.0;
    if (maxs > 255) return 6.0 * nnz + 40.0;
    std::vector<int64_t> norm(maxs + 1);
    normalize_counts(row, maxs + 1, norm.data());
    return estimate_dist_bits(norm.data(), maxs + 1, ntok);
}

}  // namespace cluster_impl

extern "C" {

// Full clustering: H is n x T row-major int64 counts.  Fills out_map[n],
// returns the number of clusters (>=1) or -1 on error.
int32_t cluster_histograms_native(const int64_t* H, int32_t n, int32_t T,
                                  int32_t max_clusters, int32_t* out_map) {
    using namespace cluster_impl;
    if (n <= 0 || T <= 0 || max_clusters <= 0) return -1;
    std::vector<int64_t> totals(n, 0);
    std::vector<double> selfc(n);
    for (int i = 0; i < n; i++) {
        const int64_t* row = H + (int64_t)i * T;
        for (int t = 0; t < T; t++) totals[i] += row[t];
        selfc[i] = hist_cost(row, T);
    }
    std::vector<int> order(n);
    for (int i = 0; i < n; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return totals[a] > totals[b]; });
    // ---- seeding ----
    std::vector<std::vector<int64_t>> S;
    std::vector<double> seed_cost;
    std::vector<int> assign(n, 0);
    std::vector<int64_t> merged(T);
    for (int oi = 0; oi < n; oi++) {
        int i = order[oi];
        if (totals[i] == 0) continue;
        const int64_t* row = H + (int64_t)i * T;
        int best = -1; double bestc = 1e300;
        for (size_t si = 0; si < S.size(); si++) {
            for (int t = 0; t < T; t++) merged[t] = S[si][t] + row[t];
            double extra = hist_cost(merged.data(), T) - seed_cost[si]
                - selfc[i];
            if (extra < bestc) { bestc = extra; best = (int)si; }
        }
        if ((best < 0 || bestc > 60.0) && (int)S.size() < max_clusters) {
            S.emplace_back(row, row + T);
            seed_cost.push_back(selfc[i]);
            assign[i] = (int)S.size() - 1;
        } else {
            assign[i] = best;
            for (int t = 0; t < T; t++) S[best][t] += row[t];
            seed_cost[best] = hist_cost(S[best].data(), T);
        }
    }
    int k = (int)S.size();
    if (k == 0) {
        for (int i = 0; i < n; i++) out_map[i] = 0;
        return 1;
    }
    // ---- agglomerative refinement ----
    std::vector<double> bits(k), cost(k);
    for (int c = 0; c < k; c++) {
        bits[c] = hist_bits_row(S[c].data(), T);
        cost[c] = hist_cost(S[c].data(), T);
    }
    std::vector<int> remap(k);
    for (int c = 0; c < k; c++) remap[c] = c;
    std::vector<uint8_t> alive(k, 1);
    // pair cache: delta for (i,j), i<j; merged recomputed on take
    std::vector<double> pd((size_t)k * k, 0.0);
    std::vector<uint8_t> pd_valid((size_t)k * k, 0);
    int n_alive = k;
    while (n_alive > 1) {
        double best_delta = 0.0; int bi = -1, bj = -1;
        for (int i = 0; i < k; i++) {
            if (!alive[i]) continue;
            for (int j = i + 1; j < k; j++) {
                if (!alive[j]) continue;
                size_t key = (size_t)i * k + j;
                double delta;
                if (pd_valid[key]) delta = pd[key];
                else {
                    for (int t = 0; t < T; t++)
                        merged[t] = S[i][t] + S[j][t];
                    double mc = hist_cost(merged.data(), T);
                    double mb = hist_bits_row(merged.data(), T);
                    delta = (mc - cost[i] - cost[j])
                        - (bits[i] + bits[j] - mb);
                    pd[key] = delta; pd_valid[key] = 1;
                }
                if (delta < best_delta) {
                    best_delta = delta; bi = i; bj = j;
                }
            }
        }
        if (bi < 0) break;
        for (int t = 0; t < T; t++) S[bi][t] += S[bj][t];
        bits[bi] = hist_bits_row(S[bi].data(), T);
        cost[bi] = hist_cost(S[bi].data(), T);
        alive[bj] = 0;
        n_alive--;
        for (int t2 = 0; t2 < k; t2++) {
            size_t a = t2 < bi ? (size_t)t2 * k + bi : (size_t)bi * k + t2;
            size_t b = t2 < bj ? (size_t)t2 * k + bj : (size_t)bj * k + t2;
            pd_valid[a] = 0; pd_valid[b] = 0;
        }
        for (int t2 = 0; t2 < k; t2++)
            if (remap[t2] == bj) remap[t2] = bi;
    }
    // densify
    std::vector<int> dense(k, -1);
    int nd = 0;
    for (int ci = 0; ci < n; ci++) {
        int g = remap[assign[ci]];
        if (dense[g] < 0) dense[g] = nd++;
        out_map[ci] = dense[g];
    }
    return nd;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy AC-strategy winner pass (encoder): largest-first placement over
// precomputed RD cost grids.  Mirrors vardct/enc_real._greedy_decide
// exactly (incl. the cumsum(0).cumsum(1) summed-area construction order,
// so float rounding matches the numpy oracle).

extern "C" {

int32_t greedy_decide_native(
    const double* cost8, const int32_t* qf_map,
    int32_t ys_b, int32_t xs_b,
    const int32_t* cdesc, int32_t K,       // K x 5: sid, cy, cx, nyc, nxc
    const double* cgrid_all, const int32_t* qgrid_all,
    const int64_t* goffs,                  // K+1 offsets into the grids
    int32_t* acs_out, int32_t* qf_out)
{
    const int64_t W = xs_b, H = ys_b;
    // sat = cost8.cumsum(axis=0).cumsum(axis=1), zero-padded
    std::vector<double> col((size_t)H * W);
    for (int64_t x = 0; x < W; x++) {
        double run = 0.0;
        for (int64_t y = 0; y < H; y++) {
            run += cost8[y * W + x];
            col[y * W + x] = run;
        }
    }
    std::vector<double> sat((size_t)(H + 1) * (W + 1), 0.0);
    for (int64_t y = 0; y < H; y++) {
        double run = 0.0;
        for (int64_t x = 0; x < W; x++) {
            run += col[y * W + x];
            sat[(y + 1) * (W + 1) + (x + 1)] = run;
        }
    }
    auto c8sum = [&](int64_t by, int64_t bx, int64_t cy, int64_t cx) {
        return sat[(by + cy) * (W + 1) + bx + cx]
            - sat[by * (W + 1) + bx + cx]
            - sat[(by + cy) * (W + 1) + bx]
            + sat[by * (W + 1) + bx];
    };
    for (int64_t i = 0; i < H * W; i++) acs_out[i] = -1;
    memcpy(qf_out, qf_map, (size_t)H * W * 4);
    for (int64_t by = 0; by < H; by++) {
        for (int64_t bx = 0; bx < W; bx++) {
            if (acs_out[by * W + bx] != -1) continue;
            bool placed = false;
            for (int32_t k = 0; k < K; k++) {
                int32_t sid = cdesc[k * 5], cy = cdesc[k * 5 + 1],
                    cx = cdesc[k * 5 + 2], nxc = cdesc[k * 5 + 4];
                if (by % cy || bx % cx) continue;
                if (by + cy > H || bx + cx > W) continue;
                bool free_ = true;
                for (int64_t yy = by; yy < by + cy && free_; yy++)
                    for (int64_t xx = bx; xx < bx + cx; xx++)
                        if (acs_out[yy * W + xx] != -1) {
                            free_ = false; break;
                        }
                if (!free_) continue;
                int64_t gi = goffs[k] + (by / cy) * nxc + bx / cx;
                double cm = cgrid_all[gi];
                double thresh = (int64_t)cy * cx > 4 ? 0.90 : 0.98;
                if (cm < c8sum(by, bx, cy, cx) * thresh) {
                    int32_t q = qgrid_all[gi];
                    for (int64_t yy = by; yy < by + cy; yy++)
                        for (int64_t xx = bx; xx < bx + cx; xx++) {
                            acs_out[yy * W + xx] = -2;
                            qf_out[yy * W + xx] = q;
                        }
                    acs_out[by * W + bx] = sid;
                    placed = true;
                    break;
                }
            }
            if (!placed) acs_out[by * W + bx] = 0;
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ANS distribution writer shift search (encoder): pick the (shift,
// quantized counts, omit position) minimizing header bits + KL regret.
// Mirrors entropy/ans.write_ans_distribution_complex's search loop
// (full shift grid 0..13); bit emission stays in Python.

extern "C" {

int32_t ans_quantize_best(const int64_t* counts, int32_t alpha,
                          int64_t num_tokens, int32_t* shift_out,
                          int64_t* q_out, int32_t* omit_out)
{
    using namespace cluster_impl;
    std::vector<int64_t> q(alpha);
    double best_total = 0.0;
    int best_shift = -1;
    for (int shift = 0; shift < 14; shift++) {
        int omit = quantize_for_shift(counts, alpha, shift, q.data());
        if (omit < 0) continue;
        int hdr = complex_cost_bits(q.data(), alpha, omit, shift);
        double kl = 0.0; bool inf = false;
        for (int i = 0; i < alpha; i++) {
            if (counts[i] > 0) {
                if (q[i] <= 0) { inf = true; break; }
                kl += ((double)counts[i] / kTabSize)
                    * log2((double)counts[i] / (double)q[i]);
            }
        }
        if (kl < 0.0) kl = 0.0;
        double total = inf ? 1e300 : hdr + kl * (double)num_tokens;
        if (best_shift < 0 || total < best_total) {
            best_total = total;
            best_shift = shift;
            memcpy(q_out, q.data(), (size_t)alpha * 8);
            *omit_out = omit;
        }
    }
    *shift_out = best_shift;
    return best_shift < 0 ? -1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MA-tree split search, whole node in one call (encoder learning):
// for each allowed property, build the quantile thresholds
// (np.quantile 'nearest' == sorted[nearbyint(q*(n-1))], half-even),
// bucketize, run the split-cost scan, and return the per-property
// best (cost, splitval).  Mirrors modular/learn._learn_node's
// property loop; ma_split_costs above stays the per-property oracle.

extern "C" {

void ma_best_split_native(
    const int32_t* tokens /* (P, n) */, int32_t P, int64_t n,
    const int32_t* props /* (K, n) */, const int32_t* prop_ids,
    int32_t K, int32_t n_buckets, int32_t T,
    const double* rb /* (T,) */,
    double* out_cost /* (K,) */, int32_t* out_split /* (K,) */)
{
    std::vector<int32_t> sorted(n);
    std::vector<int64_t> sv;
    std::vector<int32_t> bucket(n);
    std::vector<double> costs;
    for (int32_t k = 0; k < K; k++) {
        const int32_t* pv = props + (size_t)k * n;
        out_cost[k] = 1e300;
        out_split[k] = 0;
        memcpy(sorted.data(), pv, (size_t)n * 4);
        std::sort(sorted.begin(), sorted.end());
        if (sorted[0] == sorted[n - 1]) continue;
        sv.clear();
        for (int32_t j = 0; j < n_buckets; j++) {
            double q = 0.02 + (0.98 - 0.02) * j / (n_buckets - 1);
            long idx = (long)nearbyint(q * (double)(n - 1));
            int64_t v = sorted[idx];
            if (sv.empty() || v != sv.back()) {
                // keep sorted unique (quantiles are monotone)
                if (!sv.empty() && v < sv.back()) continue;
                sv.push_back(v);
            }
        }
        int32_t B = (int32_t)sv.size() + 1;
        if (B < 2) continue;
        for (int64_t i = 0; i < n; i++) {
            // searchsorted left: #{j: sv[j] < v} ... == lower_bound
            bucket[i] = (int32_t)(std::lower_bound(sv.begin(), sv.end(),
                                                   (int64_t)pv[i])
                                  - sv.begin());
        }
        costs.assign((size_t)P * (B - 1), 0.0);
        ma_split_costs(tokens, P, n, bucket.data(), B, T, rb,
                       costs.data());
        // argmin with pred-major, split-ascending tie order
        double best = 1e300;
        int64_t bi = 0;
        for (int64_t i2 = 0; i2 < (int64_t)P * (B - 1); i2++) {
            if (costs[i2] < best) { best = costs[i2]; bi = i2; }
        }
        out_cost[k] = best;
        out_split[k] = (int32_t)sv[bi % (B - 1)];
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LF-group varblock walk (decode): raster over the group, consuming one
// AC-metadata entry per uncovered anchor.  Mirrors
// vardct/dec_real.read_lf_group's Python loop exactly.

extern "C" {

// returns consumed entry count, or -1 invalid strategy, -2 overflow,
// -3 too few entries
int64_t lf_walk_native(const int32_t* acs_row, const int32_t* qf_row,
                       int64_t count, int32_t xs_b, int32_t ys_b,
                       const int32_t* cx_l, const int32_t* cy_l,
                       const uint8_t* valid_l, int32_t n_sids,
                       int32_t* acs_map, int32_t* qf_map)
{
    const int64_t W = xs_b;
    for (int64_t i = 0; i < (int64_t)ys_b * W; i++) acs_map[i] = -1;
    int64_t vi = 0;
    for (int32_t by = 0; by < ys_b; by++) {
        for (int32_t bx = 0; bx < xs_b; bx++) {
            if (acs_map[by * W + bx] != -1) continue;
            if (vi >= count) return -3;
            int32_t s = acs_row[vi];
            if (s < 0 || s >= n_sids || !valid_l[s]) return -1;
            int32_t cx = cx_l[s], cy = cy_l[s];
            if (bx + cx > xs_b || by + cy > ys_b) return -2;
            int32_t q = qf_row[vi] + 1;
            for (int32_t yy = by; yy < by + cy; yy++)
                for (int32_t xx = bx; xx < bx + cx; xx++) {
                    acs_map[yy * W + xx] = -2;
                    qf_map[yy * W + xx] = q;
                }
            acs_map[by * W + bx] = s;
            vi++;
        }
    }
    return vi;
}

}  // extern "C"
