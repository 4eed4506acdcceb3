// Native host kernels for bluest_tpu_torch (copied from bluest_tpu/_native).
//
// The reference ships a pybind11 extension for its group-structure scatter
// kernels (cmisc.cpp); on TPU those became XLA einsums (core/psi.py).  What
// remains genuinely host-side in this framework is the combinatorial
// runtime around the allocation problem, and that is what lives here:
//
//   * all-cliques enumeration of the model graph (the group generator,
//     replacing networkx enumerate_all_cliques) -- exponential in the
//     worst case and pure pointer-chasing, i.e. exactly the kind of work
//     that belongs in C++ rather than Python once M grows past ~20;
//   * the floor/ceil corner sweep of the integer projection: feasibility
//     filtering of all 2^LL corners against budget/coverage/cap rows.
//
// Exposed with a plain C ABI and loaded via ctypes (no pybind11 in the
// build image); the package falls back to the pure-Python implementations
// when the shared library has not been built.
//
// Build: make -C bluest_tpu_torch/_native

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct CliqueSink {
    int32_t* out;        // fixed-width records: size, v0..v_{w-2} (-1 pad)
    int64_t cap;         // max int32 slots
    int32_t width;       // record width = max_size + 1
    int64_t used = 0;
    int64_t count = 0;
    bool overflow = false;

    void emit(const std::vector<int32_t>& clique) {
        if (used + width > cap) {
            overflow = true;
            return;
        }
        out[used] = static_cast<int32_t>(clique.size());
        int64_t p = used + 1;
        for (int32_t v : clique) out[p++] = v;
        for (; p < used + width; ++p) out[p] = -1;
        used += width;
        ++count;
    }
};

void grow(const uint64_t* masks, int max_size, std::vector<int32_t>& clique,
          uint64_t cand, CliqueSink& sink) {
    if (static_cast<int>(clique.size()) >= max_size || sink.overflow) return;
    uint64_t c = cand;
    while (c) {
        const int v = __builtin_ctzll(c);
        c &= c - 1;
        clique.push_back(v);
        sink.emit(clique);
        const uint64_t higher = (v >= 63) ? 0ULL : ~((1ULL << (v + 1)) - 1ULL);
        grow(masks, max_size, clique, cand & masks[v] & higher, sink);
        clique.pop_back();
        if (sink.overflow) return;
    }
}

}  // namespace

extern "C" {

// All cliques of size <= max_size over nodes listed in `universe`
// (length n_universe).  adj: row-major MxM uint8 adjacency (no self loops
// required).  Output: packed (size, members...) int32 records; returns the
// number of cliques, or -1 if out_cap was too small.
int64_t bluest_enumerate_cliques(const uint8_t* adj, int32_t M,
                                 int32_t max_size, const int32_t* universe,
                                 int32_t n_universe, int32_t* out,
                                 int64_t out_cap) {
    if (M > 64) return -2;
    uint64_t masks[64];
    for (int i = 0; i < M; ++i) {
        uint64_t m = 0;
        for (int j = 0; j < M; ++j)
            if (j != i && adj[static_cast<int64_t>(i) * M + j]) m |= 1ULL << j;
        masks[i] = m;
    }
    uint64_t allowed = 0;
    for (int32_t k = 0; k < n_universe; ++k) allowed |= 1ULL << universe[k];

    CliqueSink sink{out, out_cap, max_size + 1};
    std::vector<int32_t> clique;
    clique.reserve(max_size);
    for (int32_t k = 0; k < n_universe; ++k) {
        const int v = universe[k];
        clique.push_back(v);
        sink.emit(clique);
        const uint64_t higher = (v >= 63) ? 0ULL : ~((1ULL << (v + 1)) - 1ULL);
        grow(masks, max_size, clique, masks[v] & allowed & higher, sink);
        clique.pop_back();
        if (sink.overflow) return -1;
    }
    return sink.count;
}

// Feasibility filter over all 2^LL floor/ceil corners (the hot host loop
// of the integer projection, reference misc.py:239-292 semantics).
//
//   lb, ub           : (LL,) integer bounds of the free entries
//   base_cost        : cost of the frozen part of the allocation
//   w                : (LL,) costs of the free entries
//   budget           : <= 0 disables the budget row
//   e_rows, e_base   : (n_e, LL) coverage rows and their frozen parts;
//                      corner feasible iff e_base + e_row.m >= 1 per row
//   cap_rows, cap_rhs: (n_cap, LL) cap rows, frozen part included in rhs
//   keep             : (2^LL,) uint8 output mask
// Returns the number of feasible corners.
int64_t bluest_corner_filter(const int64_t* lb, const int64_t* ub, int32_t LL,
                             double base_cost, const double* w, double budget,
                             const double* e_rows, const double* e_base,
                             int32_t n_e, const double* cap_rows,
                             const double* cap_rhs, int32_t n_cap,
                             uint8_t* keep) {
    const int64_t n = 1LL << LL;
    int64_t kept = 0;
    std::vector<double> m(LL);
    for (int64_t bits = 0; bits < n; ++bits) {
        for (int32_t i = 0; i < LL; ++i)
            m[i] = static_cast<double>((bits >> i) & 1 ? ub[i] : lb[i]);
        bool ok = true;
        if (budget > 0) {
            double cost = base_cost;
            for (int32_t i = 0; i < LL; ++i) cost += w[i] * m[i];
            ok = cost <= 1.0001 * budget;
        }
        for (int32_t r = 0; ok && r < n_e; ++r) {
            double acc = e_base[r];
            const double* row = e_rows + static_cast<int64_t>(r) * LL;
            for (int32_t i = 0; i < LL; ++i) acc += row[i] * m[i];
            ok = acc >= 1.0;
        }
        for (int32_t r = 0; ok && r < n_cap; ++r) {
            double acc = 0.0;
            const double* row = cap_rows + static_cast<int64_t>(r) * LL;
            for (int32_t i = 0; i < LL; ++i) acc += row[i] * m[i];
            ok = acc <= cap_rhs[r];
        }
        keep[bits] = ok ? 1 : 0;
        kept += ok;
    }
    return kept;
}

// Dykstra projection of x (length L) onto {y >= 0, A_i . y <= b_i} for the
// q rows of A (row-major, q x L; nrm2[i] = |A_i|^2): n_sweeps alternating
// sweeps over the orthant and each halfspace with their correction terms,
// then the exact feasibility repair (clip, and scale the SUPPORT of each
// still-violated row down to its boundary; rows are elementwise >= 0).
// The arithmetic follows solvers/spg_alloc.py's capped_projection step by
// step; work holds (q + 2) * L doubles.
void bluest_dykstra(const double* x, const double* A, const double* b,
                    const double* nrm2, int32_t q, int32_t L,
                    int32_t n_sweeps, double* work, double* y) {
    double* P = work;                 // q x L halfspace corrections
    double* p0 = work + (int64_t)q * L;   // orthant correction
    double* z = p0 + L;
    for (int64_t j = 0; j < (int64_t)(q + 1) * L; ++j) work[j] = 0.0;
    for (int32_t j = 0; j < L; ++j) y[j] = x[j];
    for (int32_t s = 0; s < n_sweeps; ++s) {
        for (int32_t j = 0; j < L; ++j) {
            const double zz = y[j] + p0[j];
            const double yn = zz > 0.0 ? zz : 0.0;
            p0[j] = zz - yn;
            y[j] = yn;
        }
        for (int32_t i = 0; i < q; ++i) {
            const double* Ai = A + (int64_t)i * L;
            double* Pi = P + (int64_t)i * L;
            double dot = 0.0;
            for (int32_t j = 0; j < L; ++j) {
                z[j] = y[j] + Pi[j];
                dot += Ai[j] * z[j];
            }
            double t = dot - b[i];
            t = (t > 0.0 ? t : 0.0) / nrm2[i];
            for (int32_t j = 0; j < L; ++j) {
                const double yn = z[j] - t * Ai[j];
                Pi[j] = z[j] - yn;
                y[j] = yn;
            }
        }
    }
    for (int32_t j = 0; j < L; ++j) y[j] = y[j] > 0.0 ? y[j] : 0.0;
    for (int32_t i = 0; i < q; ++i) {
        const double* Ai = A + (int64_t)i * L;
        double v = 0.0;
        for (int32_t j = 0; j < L; ++j) v += Ai[j] * y[j];
        if (v > b[i]) {
            const double f = b[i] / (v > 1e-300 ? v : 1e-300);
            for (int32_t j = 0; j < L; ++j)
                if (Ai[j] > 0.0) y[j] *= f;
        }
    }
}

}  // extern "C"
