// devac: the port's native host library (RLE codec, joint histogram,
// maximum-weight independent set).
//
// A copy of native/devac.cpp, the code kept as it is: the same comparator,
// the same branch order (take, then skip), the same node budget and greedy
// fallback, so that its selections, strings and tables are bitwise those of
// deva_tpu's library built with the same flags. One departure, in
// rle_decode alone: a string is checked before a byte is written (a run
// that is negative or ends past h * w, or a count longer than 11 digits,
// returns -1), where deva_tpu's copy writes every run and reports the
// length afterwards, out of its buffer on such a string. A well-formed
// string decodes as it does there; a malformed one goes to the caller's
// Python decoder either way (utils/rle.py).
//
// The reference leans on native libraries for these host paths:
// pycocotools' C RLE codec (reference:deva/inference/result_utils.py:182-184)
// and gurobi/CBC for the consensus integer program
// (reference:deva/inference/consensus_automatic.py:28-79). Host C++ behind a
// plain C ABI, loaded via ctypes by deva_tpu_torch/utils/native.py, which
// builds it with g++ -O3 -shared -fPIC into deva_tpu_torch/_build/ at first
// use. It lives under csrc/host/ so that ops/cuda_build.py (csrc/*.cu,
// csrc/*.cuh) neither compiles it with nvcc nor hashes it.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// COCO RLE codec: column-major runs of alternating 0/1 starting with zeros,
// run lengths delta-coded vs counts[i-2], packed as 6-bit chars (offset 48).
// ---------------------------------------------------------------------------

// mask: row-major [h, w] uint8. out: char buffer. Returns bytes written or
// -1 if out_cap too small.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   char* out, int64_t out_cap) {
    std::vector<int64_t> counts;
    counts.reserve(1024);
    uint8_t prev = 0;
    int64_t run = 0;
    // column-major traversal
    for (int64_t x = 0; x < w; ++x) {
        for (int64_t y = 0; y < h; ++y) {
            uint8_t v = mask[y * w + x] ? 1 : 0;
            if (v == prev) {
                ++run;
            } else {
                counts.push_back(run);
                prev = v;
                run = 1;
            }
        }
    }
    counts.push_back(run);
    // counts currently starts with the zero-run (possibly 0-length when the
    // mask starts with 1). The loop above starts with prev=0 so the first
    // emitted run is always the number of leading zeros. Edge: if mask starts
    // with 1, the first count is 0 — which is what the format wants.

    int64_t p = 0;
    for (size_t i = 0; i < counts.size(); ++i) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        bool more = true;
        while (more) {
            int64_t digit = x & 0x1f;
            x >>= 5;
            more = !((x == 0 && !(digit & 0x10)) ||
                     (x == -1 && (digit & 0x10)));
            if (more) digit |= 0x20;
            if (p >= out_cap) return -1;
            out[p++] = static_cast<char>(digit + 48);
        }
    }
    return p;
}

// s: encoded string of length slen. out: row-major [h, w] uint8. Returns
// the pixels the runs cover (h * w for a well-formed string), or -1 where a
// run is negative or ends past h * w; out is written only within its
// h * w bytes.
int64_t rle_decode(const char* s, int64_t slen, int64_t h, int64_t w,
                   uint8_t* out) {
    const int64_t total = h * w;
    std::vector<int64_t> counts;
    counts.reserve(1024);
    int64_t i = 0;
    while (i < slen) {
        int64_t x = 0;
        int64_t k = 0;
        bool more = true;
        int64_t c = 0;
        while (more) {
            // 11 digits hold 55 bits: no count of a valid string needs
            // more, and shifting by 5 * k stays defined
            if (i >= slen || k >= 11) return -1;
            c = s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (counts.size() > 2) x += counts[counts.size() - 2];
        if (x < 0 || x > total) return -1;
        counts.push_back(x);
    }
    int64_t pos = 0;
    for (int64_t cnt : counts) {
        if (cnt > total - pos) return -1;
        pos += cnt;
    }
    std::memset(out, 0, static_cast<size_t>(total));
    pos = 0;
    uint8_t val = 0;
    for (int64_t cnt : counts) {
        if (val) {
            for (int64_t j = pos; j < pos + cnt; ++j) {
                // column-major position j -> row-major (y, x)
                int64_t x = j / h, y = j % h;
                out[y * w + x] = 1;
            }
        }
        pos += cnt;
        val ^= 1;
    }
    return pos;
}

// ---------------------------------------------------------------------------
// Joint histogram: out[a[i] * k + b[i]] += 1 (the one-pass intersection
// table used by segment matching and pairwise tube IoU).
// ---------------------------------------------------------------------------

void joint_hist(const int64_t* a, const int64_t* b, int64_t n, int64_t k,
                int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[a[i] * k + b[i]] += 1;
    }
}

// ---------------------------------------------------------------------------
// Maximum-weight independent set (the consensus integer program): exact
// branch-and-bound per connected component with a greedy fallback when the
// node budget is exhausted. Mirrors inference/ilp.py's Python solver.
// ---------------------------------------------------------------------------

namespace {

struct MWIS {
    int64_t n;
    const double* w;
    const uint8_t* conflict;  // [n, n]
    std::vector<int> order;   // component nodes sorted by weight desc
    std::vector<double> suffix;
    double best_val;
    std::vector<uint8_t> best_sel, cur_sel;
    int64_t calls, budget;

    bool adj(int u, int v) const { return conflict[(int64_t)u * n + v] != 0; }

    void rec(size_t i, double cur, std::vector<uint8_t>& banned) {
        if (++calls > budget) return;
        if (cur + suffix[i] <= best_val) return;
        if (i == order.size()) {
            if (cur > best_val) {
                best_val = cur;
                best_sel = cur_sel;
            }
            return;
        }
        int u = order[i];
        if (!banned[u]) {
            std::vector<int> newly;
            for (size_t j = i + 1; j < order.size(); ++j) {
                int v = order[j];
                if (!banned[v] && adj(u, v)) {
                    banned[v] = 1;
                    newly.push_back(v);
                }
            }
            cur_sel[u] = 1;
            rec(i + 1, cur + w[u], banned);
            cur_sel[u] = 0;
            for (int v : newly) banned[v] = 0;
        }
        rec(i + 1, cur, banned);
    }
};

}  // namespace

// weights: [n]; conflict: [n, n] 0/1; out: [n] selection flags.
void mwis_solve(const double* weights, const uint8_t* conflict, int64_t n,
                int64_t budget, uint8_t* out) {
    std::memset(out, 0, static_cast<size_t>(n));
    std::vector<int> comp_id(n, -1);
    int n_comp = 0;
    // connected components over the conflict graph
    for (int64_t s = 0; s < n; ++s) {
        if (comp_id[s] >= 0) continue;
        std::vector<int64_t> stack = {s};
        comp_id[s] = n_comp;
        while (!stack.empty()) {
            int64_t u = stack.back();
            stack.pop_back();
            for (int64_t v = 0; v < n; ++v) {
                if (comp_id[v] < 0 && conflict[u * n + v]) {
                    comp_id[v] = n_comp;
                    stack.push_back(v);
                }
            }
        }
        ++n_comp;
    }

    for (int c = 0; c < n_comp; ++c) {
        MWIS solver;
        solver.n = n;
        solver.w = weights;
        solver.conflict = conflict;
        for (int64_t u = 0; u < n; ++u)
            if (comp_id[u] == c) solver.order.push_back(static_cast<int>(u));
        std::sort(solver.order.begin(), solver.order.end(),
                  [&](int a, int b) { return weights[a] > weights[b]; });
        solver.suffix.assign(solver.order.size() + 1, 0.0);
        for (int64_t i = static_cast<int64_t>(solver.order.size()) - 1;
             i >= 0; --i) {
            solver.suffix[i] = solver.suffix[i + 1] +
                std::max(0.0, weights[solver.order[i]]);
        }
        solver.best_val = -1e300;
        solver.best_sel.assign(n, 0);
        solver.cur_sel.assign(n, 0);
        solver.calls = 0;
        solver.budget = budget;
        std::vector<uint8_t> banned(n, 0);
        solver.rec(0, 0.0, banned);
        if (solver.calls > solver.budget) {
            // greedy fallback: positive weights best-first
            std::vector<uint8_t> gr_banned(n, 0);
            for (int u : solver.order) {
                if (weights[u] > 0 && !gr_banned[u]) {
                    out[u] = 1;
                    for (int64_t v = 0; v < n; ++v)
                        if (conflict[(int64_t)u * n + v]) gr_banned[v] = 1;
                }
            }
        } else {
            for (int64_t u = 0; u < n; ++u)
                if (solver.best_sel[u]) out[u] = 1;
        }
    }
}

}  // extern "C"
