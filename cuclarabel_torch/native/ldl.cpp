// Sparse quasidefinite LDL^T factorization, left-looking, with signed
// dynamic regularization; plus a greedy minimum-degree ordering.
//
// Native-equivalent of the reference's L1 direct-LDL backends (the
// reference wraps the C QDLDL library via
// src/kktsolvers/direct-ldl/directldl_qdldl.jl).  This implementation
// deliberately uses a different factorization organization than QDLDL's
// up-looking scheme: the symbolic phase precomputes the complete row
// and column patterns of L once (elimination tree per Liu 1986; pattern
// material as in Davis, "Direct Methods for Sparse Linear Systems"),
// and the numeric phase is then a plain left-looking column sweep —
// column k of L is assembled by subtracting the contributions of every
// earlier column j with L[k,j] != 0 (read off the precomputed row
// pattern) into a dense accumulator, with one moving read-head per
// column.  No elimination-tree walks, marker arrays, or topological
// stacks exist at numeric time, which is what makes per-iteration
// refactorization cheap for the IPM use case.
//
// Input matrix: upper-triangular CSC (including diagonal), n x n.
// Output: unit lower-triangular L (strict lower triangle, CSC, row
// indices ascending) and diagonal D.  Quasidefinite matrices factor
// without pivoting (Vanderbei 1995); `dsigns` drives dynamic
// regularization: whenever sign(D[k]) != dsigns[k] or |D[k]| < eps,
// D[k] is replaced by dsigns[k] * delta (the reference backend's
// regularization semantics, directldl_qdldl.jl:18-25).
//
// Exported C ABI (used via ctypes from Python):
//   ldl_analyze   - elimination tree + column counts of L
//   ldl_pattern   - fill row/column patterns of L + A row map
//   ldl_refactor  - left-looking numeric factorization
//   ldl_solve     - triangular solve with the factors
//   mindeg_order  - greedy minimum-degree ordering of a graph

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>
#ifdef _OPENMP
#include <omp.h>
#endif

using std::int64_t;

extern "C" {

// Elimination tree (Liu's path-compression-free variant) and per-column
// nonzero counts of strict-lower L.  work: length n.  Returns nnz(L),
// or -1 if an entry lies below the diagonal.
int64_t ldl_analyze(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    int64_t* work, int64_t* Lcnt, int64_t* etree) {
    for (int64_t i = 0; i < n; i++) {
        work[i] = -1;
        Lcnt[i] = 0;
        etree[i] = -1;
    }
    for (int64_t k = 0; k < n; k++) {
        work[k] = k;
        for (int64_t p = Ap[k]; p < Ap[k + 1]; p++) {
            int64_t i = Ai[p];
            if (i > k) return -1;
            // ascend from i; every unvisited vertex j on the path has
            // L[k,j] != 0, contributing one entry to column j
            for (int64_t j = i; work[j] != k; j = etree[j]) {
                work[j] = k;
                Lcnt[j]++;
                if (etree[j] == -1) etree[j] = k;
            }
        }
    }
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) total += Lcnt[i];
    return total;
}

// Fill the symbolic structure for the left-looking sweep:
//   Lp (n+1), Li (nnzL)      — columns of strict-lower L, rows ascending
//   Rp (n+1), Rj (nnzL)      — rows of L (CSR), columns ascending
//   Up (n+1), Uj, Usrc (nnzA)— CSR view of the upper-CSC input, with
//                              Usrc mapping back to the CSC value slot
//                              (so row k of A scatters in O(row nnz))
// work: length 2n.
void ldl_pattern(int64_t n, const int64_t* Ap, const int64_t* Ai,
                 const int64_t* etree, const int64_t* Lcnt,
                 int64_t* Lp, int64_t* Li, int64_t* Rp, int64_t* Rj,
                 int64_t* Rpos, int64_t* Up, int64_t* Uj, int64_t* Usrc,
                 int64_t* work) {
    int64_t* mark = work;
    int64_t* fill = work + n;

    Lp[0] = 0;
    for (int64_t j = 0; j < n; j++) Lp[j + 1] = Lp[j] + Lcnt[j];
    for (int64_t j = 0; j < n; j++) {
        fill[j] = Lp[j];
        mark[j] = -1;
    }
    // k ascending => row indices within each column land ascending
    for (int64_t k = 0; k < n; k++) {
        mark[k] = k;
        for (int64_t p = Ap[k]; p < Ap[k + 1]; p++) {
            for (int64_t j = Ai[p]; mark[j] != k; j = etree[j]) {
                mark[j] = k;
                Li[fill[j]++] = k;
            }
        }
    }
    // CSR of L by transposition (gives each row's columns ascending);
    // Rpos records, for each row-pattern entry (k, j), the position of
    // row k within column j's storage — the level-parallel refactor
    // reads its per-column start offsets from here instead of the
    // sequential sweep's moving `head` cursors
    for (int64_t i = 0; i <= n; i++) Rp[i] = 0;
    int64_t nnzL = Lp[n];
    for (int64_t p = 0; p < nnzL; p++) Rp[Li[p] + 1]++;
    for (int64_t i = 0; i < n; i++) Rp[i + 1] += Rp[i];
    for (int64_t i = 0; i < n; i++) fill[i] = Rp[i];
    for (int64_t j = 0; j < n; j++) {
        for (int64_t p = Lp[j]; p < Lp[j + 1]; p++) {
            int64_t q = fill[Li[p]]++;
            Rj[q] = j;
            Rpos[q] = p;
        }
    }
    // CSR view of upper-CSC A with source slots
    for (int64_t i = 0; i <= n; i++) Up[i] = 0;
    for (int64_t p = 0; p < Ap[n]; p++) Up[Ai[p] + 1]++;
    for (int64_t i = 0; i < n; i++) Up[i + 1] += Up[i];
    for (int64_t i = 0; i < n; i++) fill[i] = Up[i];
    for (int64_t j = 0; j < n; j++) {
        for (int64_t p = Ap[j]; p < Ap[j + 1]; p++) {
            int64_t q = fill[Ai[p]]++;
            Uj[q] = j;
            Usrc[q] = p;
        }
    }
}

// Left-looking numeric factorization over the precomputed structure.
// head: work, length n (moving per-column read positions);
// c: work, length n (dense accumulator, must be zero on entry — it is
// restored to zero before returning).
// Returns the number of positive D entries, or -1 on a zero pivot.
int64_t ldl_refactor(int64_t n, const double* Ax,
                     const int64_t* Up, const int64_t* Uj,
                     const int64_t* Usrc,
                     const int64_t* Rp, const int64_t* Rj,
                     const int64_t* Lp, const int64_t* Li, double* Lx,
                     double* D, double* Dinv, const int64_t* dsigns,
                     int64_t reg_enable, double eps, double delta,
                     int64_t* head, double* c) {
    int64_t positive_d = 0;
    for (int64_t j = 0; j < n; j++) head[j] = Lp[j];

    for (int64_t k = 0; k < n; k++) {
        // c[i] = A[i,k] for i >= k, read through the CSR view of the
        // upper triangle (row k holds exactly the columns >= k)
        for (int64_t t = Up[k]; t < Up[k + 1]; t++) {
            c[Uj[t]] = Ax[Usrc[t]];
        }
        // subtract contributions of earlier columns j with L[k,j] != 0:
        // c[i] -= L[i,j] * (D[j] * L[k,j]) for i >= k
        for (int64_t t = Rp[k]; t < Rp[k + 1]; t++) {
            int64_t j = Rj[t];
            int64_t p0 = head[j];  // first entry with row >= k is row k
            double w = D[j] * Lx[p0];
            for (int64_t p = p0; p < Lp[j + 1]; p++) {
                c[Li[p]] -= Lx[p] * w;
            }
            head[j] = p0 + 1;
        }
        double dk = c[k];
        c[k] = 0.0;
        if (reg_enable &&
            (dk == 0.0 || (double)dsigns[k] * dk < eps)) {
            dk = (double)dsigns[k] * delta;
        }
        if (dk == 0.0) return -1;
        if (dk > 0.0) positive_d++;
        D[k] = dk;
        Dinv[k] = 1.0 / dk;
        for (int64_t p = Lp[k]; p < Lp[k + 1]; p++) {
            Lx[p] = c[Li[p]] * Dinv[k];
            c[Li[p]] = 0.0;
        }
    }
    return positive_d;
}

// Level-parallel numeric refactorization (honors the max_threads
// setting, the analog of the reference forwarding max_threads to its
// multithreaded Pardiso/MKL backends, settings.jl:108-110).
//
// Columns whose etree levels differ have a dependency (L[k,j] != 0
// implies j is a proper etree descendant of k, so level[j] < level[k]);
// columns WITHIN one level are independent and factor concurrently.
// level_cols lists columns grouped by level; level_starts (nlevels+1)
// delimits the groups.  Each thread uses its own dense accumulator
// (c_all is nthreads * n, zeroed).  Per-column arithmetic order is
// identical to the sequential sweep, so results match it bitwise.
// Returns the number of positive D entries, or -1 on a zero pivot.
int64_t ldl_refactor_mt(int64_t n, const double* Ax,
                        const int64_t* Up, const int64_t* Uj,
                        const int64_t* Usrc,
                        const int64_t* Rp, const int64_t* Rj,
                        const int64_t* Rpos,
                        const int64_t* Lp, const int64_t* Li, double* Lx,
                        double* D, double* Dinv, const int64_t* dsigns,
                        int64_t reg_enable, double eps, double delta,
                        const int64_t* level_cols,
                        const int64_t* level_starts, int64_t nlevels,
                        int64_t nthreads, double* c_all) {
    int64_t positive_d = 0;
    int64_t zero_pivot = 0;
#ifndef _OPENMP
    nthreads = 1;
#endif
#ifdef _OPENMP
    // ONE parallel region for the whole sweep (a region per level
    // would respawn/resync the team nlevels times; with chain-like
    // etrees that overhead dwarfs the arithmetic).  The omp-for per
    // level keeps the level barrier only.
#pragma omp parallel num_threads((int)nthreads) \
    reduction(+ : positive_d) reduction(| : zero_pivot)
#endif
    {
#ifdef _OPENMP
        double* c = c_all + (int64_t)omp_get_thread_num() * n;
#else
        double* c = c_all;
#endif
        for (int64_t lv = 0; lv < nlevels; lv++) {
            int64_t lo = level_starts[lv], hi = level_starts[lv + 1];
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 4)
#endif
            for (int64_t t0 = lo; t0 < hi; t0++) {
                int64_t k = level_cols[t0];
                for (int64_t t = Up[k]; t < Up[k + 1]; t++) {
                    c[Uj[t]] = Ax[Usrc[t]];
                }
                for (int64_t t = Rp[k]; t < Rp[k + 1]; t++) {
                    int64_t j = Rj[t];
                    int64_t p0 = Rpos[t];  // row k's slot in column j
                    double w = D[j] * Lx[p0];
                    for (int64_t p = p0; p < Lp[j + 1]; p++) {
                        c[Li[p]] -= Lx[p] * w;
                    }
                }
                double dk = c[k];
                c[k] = 0.0;
                if (reg_enable &&
                    (dk == 0.0 || (double)dsigns[k] * dk < eps)) {
                    dk = (double)dsigns[k] * delta;
                }
                if (dk == 0.0) {
                    zero_pivot |= 1;
                    dk = 1.0;  // keep going; the caller sees the flag
                }
                if (dk > 0.0) positive_d++;
                D[k] = dk;
                Dinv[k] = 1.0 / dk;
                for (int64_t p = Lp[k]; p < Lp[k + 1]; p++) {
                    Lx[p] = c[Li[p]] * Dinv[k];
                    c[Li[p]] = 0.0;
                }
            }
        }
    }
    return zero_pivot ? -1 : positive_d;
}

// Solve (L + I) D (L + I)^T x = b in place (x contains b on entry).
void ldl_solve(int64_t n, const int64_t* Lp, const int64_t* Li,
               const double* Lx, const double* Dinv, double* x) {
    for (int64_t j = 0; j < n; j++) {
        double xj = x[j];
        for (int64_t p = Lp[j]; p < Lp[j + 1]; p++) {
            x[Li[p]] -= Lx[p] * xj;
        }
    }
    for (int64_t j = 0; j < n; j++) x[j] *= Dinv[j];
    for (int64_t j = n - 1; j >= 0; j--) {
        double acc = x[j];
        for (int64_t p = Lp[j]; p < Lp[j + 1]; p++) {
            acc -= Lx[p] * x[Li[p]];
        }
        x[j] = acc;
    }
}

// Greedy minimum-degree ordering of a symmetric sparsity graph given in
// full CSC (both triangles, no diagonal needed).  perm[k] = vertex
// eliminated at step k.  Complexity O(n * nnz) worst case — intended
// for host-side setup on moderate graphs (chordal analysis and KKT
// ordering); replace with approximate minimum degree for huge systems.
void mindeg_order(int64_t n, const int64_t* Ap, const int64_t* Ai,
                  int64_t* perm) {
    std::vector<std::vector<int64_t>> adj(n);
    std::vector<bool> alive(n, true);
    for (int64_t j = 0; j < n; j++) {
        for (int64_t p = Ap[j]; p < Ap[j + 1]; p++) {
            if (Ai[p] != j) adj[j].push_back(Ai[p]);
        }
        std::sort(adj[j].begin(), adj[j].end());
        adj[j].erase(std::unique(adj[j].begin(), adj[j].end()), adj[j].end());
    }
    auto degree = [&](int64_t v) {
        int64_t d = 0;
        for (int64_t u : adj[v])
            if (alive[u]) d++;
        return d;
    };
    for (int64_t k = 0; k < n; k++) {
        int64_t best = -1, best_deg = n + 1;
        for (int64_t v = 0; v < n; v++) {
            if (!alive[v]) continue;
            int64_t d = degree(v);
            if (d < best_deg) {
                best = v;
                best_deg = d;
            }
        }
        perm[k] = best;
        alive[best] = false;
        // connect the alive neighborhood of `best` into a clique
        std::vector<int64_t> nb;
        for (int64_t u : adj[best])
            if (alive[u]) nb.push_back(u);
        for (int64_t u : nb) {
            for (int64_t w : nb) {
                if (w != u &&
                    !std::binary_search(adj[u].begin(), adj[u].end(), w)) {
                    adj[u].insert(
                        std::lower_bound(adj[u].begin(), adj[u].end(), w), w);
                }
            }
        }
    }
}

}  // extern "C"
