// Host-side sparse structure analysis for piqp_tpu_torch: the port's own
// copy of the JAX package's csrc/structure.cpp, built by
// piqp_tpu_torch/_native.py with g++ at first use.
//
// Native analog of the reference's multistage structure detection
// (PIQP's include/piqp/sparse/multistage_kkt.hpp:420-597,
// extract_arrow_structure): given the symmetric sparsity pattern of
// P + A'A + G'G, find (a) "arrow" columns that couple globally and
// (b) a block-tridiagonal partition of the remaining band.
//
// The algorithm here is an original design (not a port): instead of the
// reference's per-entry syrk/potrf flop comparisons we
//   1. classify columns whose forward reach exceeds a band cap as arrow
//      columns (they would otherwise force huge diagonal blocks), and
//   2. compute the *minimal* sequential block partition via suffix minima
//      of each row's leftmost column: a boundary can be placed at e iff
//      no row at or after e reaches left of the previous boundary.
//
// Everything is O(nnz + n). Exposed with a plain C ABI for ctypes.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Inputs: CSC (or CSR; pattern is symmetric) of the full symmetric pattern,
// n columns. Outputs written into caller-allocated buffers:
//   is_arrow[n]    (uint8)  1 if column is an arrow column
//   block_start[n] (int64)  block boundaries (first `*n_blocks` entries used)
//   block_size[n]  (int64)
// Returns 0 on success.
int64_t piqp_tpu_detect_structure(
    int64_t n,
    const int64_t* indptr,
    const int64_t* indices,
    int64_t band_cap,          // <=0: auto
    uint8_t* is_arrow,
    int64_t* block_start,
    int64_t* block_size,
    int64_t* n_blocks_out,
    int64_t* arrow_width_out)
{
    if (n <= 0) { *n_blocks_out = 0; *arrow_width_out = 0; return 0; }

    // collect strictly-lower coupling edges (lo, hi)
    std::vector<int64_t> elo, ehi;
    elo.reserve(indptr[n]);
    ehi.reserve(indptr[n]);
    for (int64_t j = 0; j < n; ++j) {
        for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
            int64_t i = indices[k];
            if (i == j) continue;
            elo.push_back(std::min(i, j));
            ehi.push_back(std::max(i, j));
        }
    }

    // auto band cap: 4x the median entry distance, at least 32
    if (band_cap <= 0) {
        std::vector<int64_t> ds;
        ds.reserve(elo.size());
        for (size_t k = 0; k < elo.size(); ++k) ds.push_back(ehi[k] - elo[k]);
        int64_t med = 0;
        if (!ds.empty()) {
            size_t mid = ds.size() / 2;
            std::nth_element(ds.begin(), ds.begin() + mid, ds.end());
            med = ds[mid];
        }
        band_cap = std::max<int64_t>(32, 4 * med);
    }

    // arrow columns = greedy vertex cover of the long-range edges: every
    // coupling longer than the cap must have at least one endpoint in the
    // arrow set (so that removing arrow columns leaves a narrow band)
    std::fill(is_arrow, is_arrow + n, 0);
    std::vector<int64_t> llo, lhi;
    for (size_t k = 0; k < elo.size(); ++k) {
        if (ehi[k] - elo[k] > band_cap) {
            llo.push_back(elo[k]);
            lhi.push_back(ehi[k]);
        }
    }
    std::vector<int64_t> cnt(n, 0);
    for (size_t k = 0; k < llo.size(); ++k) { ++cnt[llo[k]]; ++cnt[lhi[k]]; }
    std::vector<uint8_t> covered(llo.size(), 0);
    size_t uncovered = llo.size();
    int64_t arrow_width = 0;
    while (uncovered > 0) {
        int64_t best = -1, best_cnt = 0;
        for (int64_t j = 0; j < n; ++j) {
            if (!is_arrow[j] && cnt[j] > best_cnt) { best = j; best_cnt = cnt[j]; }
        }
        if (best < 0) break;
        is_arrow[best] = 1;
        ++arrow_width;
        for (size_t k = 0; k < llo.size(); ++k) {
            if (covered[k]) continue;
            if (llo[k] == best || lhi[k] == best) {
                covered[k] = 1;
                --uncovered;
                --cnt[llo[k]];
                --cnt[lhi[k]];
            }
        }
    }

    // map non-arrow columns to a compacted index space
    std::vector<int64_t> newidx(n, -1);
    int64_t nr = 0;
    for (int64_t j = 0; j < n; ++j) {
        if (!is_arrow[j]) newidx[j] = nr++;
    }

    // leftmost reach per compacted row, ignoring arrow columns
    std::vector<int64_t> minc_r(nr);
    for (int64_t j = 0; j < n; ++j) {
        if (is_arrow[j]) continue;
        minc_r[newidx[j]] = newidx[j];
    }
    for (int64_t j = 0; j < n; ++j) {
        for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
            int64_t i = indices[k];
            int64_t lo = std::min(i, j), hi = std::max(i, j);
            if (lo == hi || is_arrow[lo] || is_arrow[hi]) continue;
            int64_t r = newidx[hi];
            minc_r[r] = std::min(minc_r[r], newidx[lo]);
        }
    }

    // suffix minima: sufmin[i] = min_{r >= i} minc_r[r]
    std::vector<int64_t> sufmin(nr + 1);
    sufmin[nr] = nr;
    for (int64_t i = nr - 1; i >= 0; --i) {
        sufmin[i] = std::min(minc_r[i], sufmin[i + 1]);
    }

    // minimal sequential block partition: next boundary is the smallest
    // e > s with sufmin[e] >= s (no later row reaches left of s)
    int64_t nb = 0;
    int64_t s = 0;
    while (s < nr) {
        int64_t e = s + 1;
        while (e < nr && sufmin[e] < s) ++e;
        block_start[nb] = s;
        block_size[nb] = e - s;
        ++nb;
        s = e;
    }

    *n_blocks_out = nb;
    *arrow_width_out = arrow_width;
    return 0;
}

// Scatter CSC values of a symmetric matrix (upper or full pattern) into
// padded stage blocks. Layout matches piqp_tpu.multistage.StageQPData:
//   Pd   (T, D, D), Psub (T, D, D), Pa (T, Da, D), Pc (Da, Da)
// `var_stage[v]` = stage of variable v (or -1 for arrow),
// `var_off[v]`   = offset within its stage (or arrow offset).
// Entries spanning non-adjacent stages return a negative count.
int64_t piqp_tpu_scatter_P(
    int64_t n,
    const int64_t* indptr,
    const int64_t* indices,
    const double* values,
    const int64_t* var_stage,
    const int64_t* var_off,
    int64_t T, int64_t D, int64_t Da,
    double* Pd, double* Psub, double* Pa, double* Pc)
{
    for (int64_t j = 0; j < n; ++j) {
        for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
            int64_t i = indices[k];
            if (i < j) continue;  // caller passes the full symmetric matrix;
                                  // process the lower triangle once + mirror
            double v = values[k];
            int64_t r = i, c = j;
            int64_t sr = var_stage[r], sc = var_stage[c];
            int64_t orow = var_off[r], ocol = var_off[c];
            bool diag_entry = (r == c);
            if (sr < 0 && sc < 0) {            // arrow-arrow -> Pc
                Pc[orow * Da + ocol] += v;
                if (!diag_entry) Pc[ocol * Da + orow] += v;
            } else if (sr < 0) {               // arrow row, stage col -> Pa
                Pa[(sc * Da + orow) * D + ocol] += v;
            } else if (sc < 0) {               // stage row, arrow col -> Pa
                Pa[(sr * Da + ocol) * D + orow] += v;
            } else if (sr == sc) {             // diagonal block
                Pd[(sr * D + orow) * D + ocol] += v;
                if (!diag_entry) Pd[(sr * D + ocol) * D + orow] += v;
            } else if (sr == sc + 1) {         // sub-diagonal block
                Psub[(sc * D + orow) * D + ocol] += v;
            } else {
                return -(r * n + c + 1);       // non-adjacent coupling
            }
        }
    }
    return 0;
}

// Bucket constraint rows by stage and scatter a CSR constraint matrix into
// (T, rmax, D) / (T, rmax, D) / (T, rmax, Da) blocks.
// row_bucket[r] and row_slot[r] must be precomputed (see python side).
// Returns 0 or a negative code when a row spans more than stages
// (bucket, bucket+1, arrow).
int64_t piqp_tpu_scatter_constr(
    int64_t rows, int64_t n,
    const int64_t* indptr,   // CSR
    const int64_t* indices,
    const double* values,
    const int64_t* var_stage,
    const int64_t* var_off,
    const int64_t* row_bucket,
    const int64_t* row_slot,
    int64_t T, int64_t rmax, int64_t D, int64_t Da,
    double* M1, double* M2, double* Mg)
{
    for (int64_t r = 0; r < rows; ++r) {
        int64_t bk = row_bucket[r], slot = row_slot[r];
        for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
            int64_t c = indices[k];
            double v = values[k];
            int64_t sc = var_stage[c], oc = var_off[c];
            if (sc < 0) {
                Mg[(bk * rmax + slot) * Da + oc] += v;
            } else if (sc == bk) {
                M1[(bk * rmax + slot) * D + oc] += v;
            } else if (sc == bk + 1) {
                M2[(bk * rmax + slot) * D + oc] += v;
            } else {
                return -(r * n + c + 1);
            }
        }
    }
    return 0;
}

} // extern "C"
