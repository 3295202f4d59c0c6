// Native host prep of the PyTorch/CUDA port (built with g++, not nvcc).
//
// The port's own copy of the preprocessing half of native/strique_native.cpp
// (the CPU aligner there is not needed by the port): per-read signal
// preprocessing (median filter, uint8 quantization, greyscale open/close,
// minmax tail statistics), the per-read host cost that feeds the device
// pipeline.  tests/test_torch_copies.py pins preprocess_read_lut's outputs
// byte-equal to the original's.  Besides, the port's own batch decode of
// Viterbi paths into repeat counts and float64 log_p (decode_paths), which
// tests/test_torch_decode_native.py holds to the NumPy helpers of
// ops/viterbi.py.
//
// Exposed as a plain C ABI consumed via ctypes (strique_tpu_torch/native.py).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// preprocessing
// ---------------------------------------------------------------------------

// Median filter kernel 3 with zero-padded edges (scipy.signal.medfilt).
void medfilt3_f64(const double* x, int64_t n, double* out) {
    if (n == 0) return;
    auto med3 = [](double a, double b, double c) {
        double lo = std::min(a, b), hi = std::max(a, b);
        return std::max(lo, std::min(hi, c));
    };
    out[0] = med3(0.0, x[0], n > 1 ? x[1] : 0.0);
    for (int64_t i = 1; i + 1 < n; ++i) out[i] = med3(x[i - 1], x[i], x[i + 1]);
    if (n > 1) out[n - 1] = med3(x[n - 2], x[n - 1], 0.0);
}

static double median_inplace(std::vector<double>& v) {
    if (v.empty()) return std::nan("");
    size_t mid = v.size() / 2;
    std::nth_element(v.begin(), v.begin() + mid, v.end());
    double hi = v[mid];
    if (v.size() % 2) return hi;
    std::nth_element(v.begin(), v.begin() + mid - 1, v.begin() + mid);
    return 0.5 * (v[mid - 1] + hi);
}

// Mean absolute deviation about the median (reference STRique.py:142-143).
double mad_f64(const double* x, int64_t n) {
    std::vector<double> v(x, x + n);
    double med = median_inplace(v);
    double s = 0;
    for (int64_t i = 0; i < n; ++i) s += std::fabs(x[i] - med);
    return s / n;
}

double median_f64(const double* x, int64_t n) {
    std::vector<double> v(x, x + n);
    return median_inplace(v);
}

// np.clip semantics: NaN propagates (std::min/max would clamp it to a
// bound, silently diverging from the NumPy reference on degenerate
// signals whose percentile tails are empty).
static inline double clip_np(double v, double lo, double hi) {
    if (v < lo) return lo;
    if (v > hi) return hi;
    return v;  // covers NaN
}

// Windowed min/max with clip-to-valid borders; erosion window [-l, w-1-l],
// dilation [-(w-1-l), +l] (scipy.ndimage grey ops, even footprint).
// van Herk / Gil-Werman sliding extremum: per block of w samples compute a
// forward prefix extremum and a backward suffix extremum, then every
// window [a, b] (b - a + 1 == w) straddles at most one block boundary and
// equals ext(suffix[a], prefix[b]).  Three branch-free linear passes the
// compiler vectorizes, replacing the branchy monotonic deque (which was
// itself ~2x the vH-GW cost).  Pure selection over the same value sets —
// bit-identical to the direct min/max scan.
static void win_reduce(const double* x, int64_t n, int left, int right, bool is_min,
                       double* out) {
    if (n == 0) return;
    const int64_t w = (int64_t)left + right + 1;
    static thread_local std::vector<double> pre_buf, suf_buf;
    pre_buf.resize(n);
    suf_buf.resize(n);
    double* pre = pre_buf.data();
    double* suf = suf_buf.data();
    for (int64_t s = 0; s < n; s += w) {
        int64_t e = std::min(s + w, n);
        double acc = x[s];
        pre[s] = acc;
        if (is_min)
            for (int64_t i = s + 1; i < e; ++i) pre[i] = acc = std::min(acc, x[i]);
        else
            for (int64_t i = s + 1; i < e; ++i) pre[i] = acc = std::max(acc, x[i]);
        acc = x[e - 1];
        suf[e - 1] = acc;
        if (is_min)
            for (int64_t i = e - 2; i >= s; --i) suf[i] = acc = std::min(acc, x[i]);
        else
            for (int64_t i = e - 2; i >= s; --i) suf[i] = acc = std::max(acc, x[i]);
    }
    // left-clipped windows [0, i+right]: i + right < w, so the window lies
    // inside block 0 and prefix[b] covers exactly [0, b]
    int64_t i = 0;
    for (int64_t stop = std::min<int64_t>(left, n); i < stop; ++i)
        out[i] = pre[std::min<int64_t>(i + right, n - 1)];
    // interior full windows: straddle (or exactly fill) blocks — the
    // suffix/prefix union covers exactly [i-left, i+right]
    int64_t end_main = n - right;
    if (is_min)
        for (; i < end_main; ++i) out[i] = std::min(suf[i - left], pre[i + right]);
    else
        for (; i < end_main; ++i) out[i] = std::max(suf[i - left], pre[i + right]);
    // right-clipped windows [i-left, n-1]: suffix[a] alone when a sits in
    // the last block, else suffix[a] + the last block's full prefix
    for (; i < n; ++i) {
        int64_t a = i - left;
        if (a / w == (n - 1) / w)
            out[i] = suf[a];
        else
            out[i] = is_min ? std::min(suf[a], pre[n - 1])
                            : std::max(suf[a], pre[n - 1]);
    }
}

// quantize + open/close chain (reference STRique.py:591-595); w = 8.
void morph_open_close_f64(const double* flt, int64_t n, double med, double mad,
                          double* out) {
    const int w = 8, l = w / 2;
    std::vector<double> q(n), t(n);
    for (int64_t i = 0; i < n; ++i) {
        double v = (flt[i] - med) / mad * 24.0 + 127.0;
        v = std::min(255.0, std::max(0.0, v));
        q[i] = std::floor(v);
    }
    win_reduce(q.data(), n, l, w - 1 - l, true, t.data());    // erode
    win_reduce(t.data(), n, w - 1 - l, l, false, q.data());   // dilate (open)
    win_reduce(q.data(), n, w - 1 - l, l, false, t.data());   // dilate
    win_reduce(t.data(), n, l, w - 1 - l, true, out);         // erode (close)
}

// Percentile anchor positions (numpy linear interpolation); the exact
// expressions below are the bit-identity contract shared by every tail
// implementation in this file (selection, histogram, fused flt stats).
struct TailAnchors { int64_t lo1, hi1, lo99, hi99; double w1, w99; };

static TailAnchors tail_anchors(int64_t n) {
    auto anchor = [&](double q, int64_t* lo, int64_t* hi, double* w) {
        double pos = (n - 1) * q / 100.0;
        *lo = (int64_t)std::floor(pos);
        *hi = std::min(*lo + 1, n - 1);
        *w = pos - *lo;
    };
    TailAnchors a;
    anchor(1.0, &a.lo1, &a.hi1, &a.w1);
    anchor(99.0, &a.lo99, &a.hi99, &a.w99);
    return a;
}

// Selection-based tail medians over a caller-supplied scratch copy ``v``
// of ``x`` (nth_element is permutation-independent, so callers may have
// already run other selections on v — results stay bit-identical).
static void minmax_tails_core(std::vector<double>& v, const double* x, int64_t n,
                              double* m5, double* m95) {
    TailAnchors a = tail_anchors(n);
    // partition: ranks [0, hi1] at the front, ranks [lo99, n) at the back
    std::nth_element(v.begin(), v.begin() + a.hi1, v.end());
    std::sort(v.begin(), v.begin() + a.hi1 + 1);
    std::nth_element(v.begin() + a.hi1 + 1, v.begin() + std::max(a.lo99, a.hi1 + 1), v.end());
    std::sort(v.begin() + std::max(a.lo99, a.hi1 + 1), v.end());
    double q5 = v[a.lo1] * (1.0 - a.w1) + v[a.hi1] * a.w1;
    double q95 = v[a.lo99] * (1.0 - a.w99) + v[a.hi99] * a.w99;
    // tail sizes by linear count over the raw data (a range-limited
    // binary search misses tail elements that land in the *other* sorted
    // block when the blocks touch at tiny n, e.g. n == 2);
    // the tail ranks themselves always lie inside the sorted regions:
    // q5 <= v[hi1] pins ranks [0, c5) into the sorted front, and
    // q95 >= v[lo99] pins ranks [n - c95, n) into the sorted back
    // (or, at tiny n, the two blocks jointly cover the whole array).
    int64_t c5 = 0, c95 = 0;
    for (int64_t i = 0; i < n; ++i) {
        c5 += x[i] < q5;
        c95 += x[i] > q95;
    }
    *m5 = c5 ? 0.5 * (v[(c5 - 1) / 2] + v[c5 / 2]) : std::nan("");
    *m95 = c95 ? 0.5 * (v[n - c95 + (c95 - 1) / 2] + v[n - c95 + c95 / 2]) : std::nan("");
}

// Tail medians for minmax normalization (reference STRique.py:152-158).
// Returns m5 and m95: medians of the <1st / >99th percentile tails.
// Selection-based: only the ~n/100 elements of each tail are ever sorted
// (two nth_element partitions + two tiny sorts), replacing the full
// O(n log n) sort that dominated per-read prep.  Every output is an exact
// function of order statistics, so results are bit-identical to the
// sort-everything version.
void minmax_tails_f64(const double* x, int64_t n, double* m5, double* m95) {
    std::vector<double> v(x, x + n);
    minmax_tails_core(v, x, n, m5, m95);
}

// Tail medians of the quantized morph channel via a 256-bin histogram.
// The open/close output consists of exact integers 0..255 (floor-quantized
// bins survive grey morphology unchanged), so every order statistic the
// generic minmax_tails_f64 selects is a histogram lookup: one O(n) count
// pass replaces two nth_element partitions over a scratch copy.  The
// interpolation/count/median expressions replicate minmax_tails_f64
// operation-for-operation, so results are bit-identical.
static void minmax_tails_hist256(const double* x, int64_t n, double* m5, double* m95) {
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++hist[(int)x[i]];
    int64_t cum[257];
    cum[0] = 0;
    for (int v = 0; v < 256; ++v) cum[v + 1] = cum[v] + hist[v];
    auto kth = [&](int64_t k) -> double {  // 0-based order statistic
        int v = 0;
        while (cum[v + 1] <= k) ++v;
        return (double)v;
    };
    TailAnchors a = tail_anchors(n);
    double q5 = kth(a.lo1) * (1.0 - a.w1) + kth(a.hi1) * a.w1;
    double q95 = kth(a.lo99) * (1.0 - a.w99) + kth(a.hi99) * a.w99;
    int64_t c5 = 0, c95 = 0;
    for (int v = 0; v < 256; ++v) {
        if ((double)v < q5) c5 += hist[v];
        if ((double)v > q95) c95 += hist[v];
    }
    *m5 = c5 ? 0.5 * (kth((c5 - 1) / 2) + kth(c5 / 2)) : std::nan("");
    *m95 = c95 ? 0.5 * (kth(n - c95 + (c95 - 1) / 2) + kth(n - c95 + c95 / 2))
               : std::nan("");
}

// med + MAD + minmax tail medians of the flt channel from ONE scratch copy
// (the standalone helpers each re-copy the channel; the nth_element
// partitions are permutation-independent, so chaining all three
// selections on one buffer is bit-identical).
static void flt_stats(const double* x, int64_t n, double* med, double* mad,
                      double* m5, double* m95) {
    static thread_local std::vector<double> v;
    v.assign(x, x + n);
    *med = median_inplace(v);
    double s = 0;
    for (int64_t i = 0; i < n; ++i) s += std::fabs(x[i] - *med);
    *mad = s / n;
    minmax_tails_core(v, x, n, m5, m95);
}

// Full per-read preprocessing: raw signal -> normalized morph/flt channels.
// model[4] = {m5_mod, m95_mod, clip_lo, clip_hi}.
void preprocess_read(const double* raw, int64_t n, const double* model,
                     double* morph_n, double* flt_n) {
    std::vector<double> flt(n), morph(n);
    medfilt3_f64(raw, n, flt.data());
    double med, mad, f5, f95;
    flt_stats(flt.data(), n, &med, &mad, &f5, &f95);
    morph_open_close_f64(flt.data(), n, med, mad, morph.data());
    auto norm = [&](const double* ch, double m5, double m95, double* out) {
        double half_sig = (m95 - m5) / 2.0, mid_sig = m5 + half_sig;
        double half_mod = (model[1] - model[0]) / 2.0, mid_mod = model[0] + half_mod;
        double scale = half_mod / half_sig, off = mid_mod - mid_sig * scale;
        for (int64_t i = 0; i < n; ++i)
            out[i] = clip_np(ch[i] * scale + off, model[2], model[3]);
    };
    double mo5, mo95;
    minmax_tails_hist256(morph.data(), n, &mo5, &mo95);
    norm(morph.data(), mo5, mo95, morph_n);
    norm(flt.data(), f5, f95, flt_n);
}

// Upload-oriented preprocessing: same math as preprocess_read, but the
// morph channel is returned as its uint8 quantization bins plus a 256-entry
// float32 level table (morph is floor-quantized to 0..255 before the
// minmax affine, so bins+LUT reproduce the float32 morph bit-exactly at a
// quarter of the transfer bytes); flt is returned as float32 directly.
void preprocess_read_lut(const double* raw, int64_t n, const double* model,
                         float* flt32, double* flt64, uint8_t* q_out,
                         float* lut256) {
    std::vector<double> flt(n), morph(n);
    medfilt3_f64(raw, n, flt.data());
    double med, mad, f5, f95;
    flt_stats(flt.data(), n, &med, &mad, &f5, &f95);
    morph_open_close_f64(flt.data(), n, med, mad, morph.data());
    auto affine = [&](double m5, double m95) {
        double half_sig = (m95 - m5) / 2.0, mid_sig = m5 + half_sig;
        double half_mod = (model[1] - model[0]) / 2.0, mid_mod = model[0] + half_mod;
        double scale = half_mod / half_sig;
        return std::pair<double, double>(scale, mid_mod - mid_sig * scale);
    };
    double mo5, mo95;
    minmax_tails_hist256(morph.data(), n, &mo5, &mo95);
    auto mo = affine(mo5, mo95);
    for (int64_t i = 0; i < n; ++i)
        q_out[i] = (uint8_t)morph[i];  // open/close of floor-bins stays in 0..255
    for (int v = 0; v < 256; ++v)
        lut256[v] = (float)clip_np(v * mo.first + mo.second, model[2], model[3]);
    auto fo = affine(f5, f95);
    for (int64_t i = 0; i < n; ++i) {
        double v = clip_np(flt[i] * fo.first + fo.second, model[2], model[3]);
        flt64[i] = v;
        flt32[i] = (float)v;
    }
}
}  // extern "C"

// ---------------------------------------------------------------------------
// batch decode of Viterbi paths: repeat counts and float64 log_p
// ---------------------------------------------------------------------------

namespace {

// NumPy's pairwise summation of a[0, n) (its pairwise_sum: PW_BLOCKSIZE
// 128, eight accumulators), the same additions in the same order.  The
// order is kept, and not a plain or compensated sum, because `count`
// writes log_p in full and its TSV is held byte-equal to the JAX CLI's,
// whose log_p is NumPy's sum (tests/test_torch_cli.py); an exactly rounded
// sum differs from NumPy's in the last bit on about a third of such rows.
// Checked bit-equal against NumPy 2.0.2 on every row tried; NumPy 2.3.5
// gave one row of seven 1.6e-16 apart, so another release may reorder.
double pairwise_sum(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// ``ndarray.sum()`` of a contiguous float64 vector: the reduction runs in
// blocks of NumPy's 8192-element buffer, each summed pairwise and added in
// turn to an accumulator that starts at 0.0.
double numpy_sum(const double* a, int64_t n) {
    const int64_t block = 8192;
    double acc = 0.0;
    for (int64_t lo = 0; lo < n; lo += block) acc += pairwise_sum(a + lo, std::min(block, n - lo));
    return acc;
}

// One row: count-state visits and log_p over its first n steps, its terms
// staged in ``terms`` (n doubles) to be summed as NumPy sums them.
// Returns false when a state lies outside [0, S).
template <typename P>
bool decode_row(const P* path, const double* x, int64_t n, int64_t S, const double* c,
                const double* mu, const double* sigma, const uint8_t* is_uniform,
                const double* log_uni, const double* log_start, const double* log_end,
                const double* log_trans, const int64_t* count_states, double* terms,
                int64_t* visits, double* log_p) {
    uint64_t top = 0;
    for (int64_t i = 0; i < n; ++i) top = std::max(top, (uint64_t)(int64_t)path[i]);
    if (top >= (uint64_t)S) return false;
    // path_logp_f64's emissions: np.where(is_uniform, log_uni, c - 0.5 * d**2)
    // with d = (x - mu) / sigma, the choice a select of bits (a branch on
    // is_uniform mispredicts wherever a path mixes both kinds of state)
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t s = path[i];
        const double d = (x[i] - mu[s]) / sigma[s];
        const double e = c[s] - 0.5 * (d * d);
        const uint64_t take_uni = 0 - (uint64_t)is_uniform[s];
        uint64_t ub, eb;
        std::memcpy(&ub, &log_uni[s], 8);
        std::memcpy(&eb, &e, 8);
        const uint64_t bits = (ub & take_uni) | (eb & ~take_uni);
        std::memcpy(&terms[i], &bits, 8);
        v += count_states[s];
    }
    double lp = log_start[path[0]] + numpy_sum(terms, n) + log_end[path[n - 1]];
    // and log_trans[path[:-1], path[1:]]
    for (int64_t i = 0; i + 1 < n; ++i) terms[i] = log_trans[(int64_t)path[i] * S + path[i + 1]];
    lp += numpy_sum(terms, n - 1);
    *visits = v;
    *log_p = lp;
    return true;
}

}  // namespace

extern "C" {

// Decode one batch's rows in one call: row r's path (uint8 when
// path_itemsize is 1, int32 when 4) and float64 segment, each lens[r] >= 1
// long, give visits[r] (the count states' visits) and log_p[r], the path's
// log-probability as ops/viterbi.py's path_logp_f64 computes it, sum for
// sum.  c[s] = -0.5 * log(2 * pi * sigma[s]**2), computed by the caller
// once an HMM; log_trans is (S, S) row-major.  Serial.  Returns -1, or the
// first row whose path holds a state outside [0, S).
int64_t decode_paths(int64_t n_rows, const void* const* paths, int64_t path_itemsize,
                     const double* const* segs, const int64_t* lens, int64_t S,
                     const double* c, const double* mu, const double* sigma,
                     const uint8_t* is_uniform, const double* log_uni,
                     const double* log_start, const double* log_end,
                     const double* log_trans, const int64_t* count_states,
                     int64_t* visits, double* log_p) {
    int64_t longest = 0;
    for (int64_t r = 0; r < n_rows; ++r) longest = std::max(longest, lens[r]);
    std::vector<double> terms(longest);
    for (int64_t r = 0; r < n_rows; ++r) {
        const bool ok = path_itemsize == 1
            ? decode_row((const uint8_t*)paths[r], segs[r], lens[r], S, c, mu, sigma,
                         is_uniform, log_uni, log_start, log_end, log_trans, count_states,
                         terms.data(), visits + r, log_p + r)
            : decode_row((const int32_t*)paths[r], segs[r], lens[r], S, c, mu, sigma,
                         is_uniform, log_uni, log_start, log_end, log_trans, count_states,
                         terms.data(), visits + r, log_p + r);
        if (!ok) return r;
    }
    return -1;
}
}  // extern "C"
