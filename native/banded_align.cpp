// Banded semi-global alignment with traceback -> CIGAR, batch API.
//
// Role: the host-side extension stage of the aligner pipeline
// (bossruns_tpu/aligner). Seeding + chaining run on the device (minimizer
// lookup + diagonal voting); this kernel refines each read's single
// candidate window into a base-exact alignment and emits the CIGAR that the
// coverage converter needs. It replaces the alignment role that the
// reference delegates to minimap2/mappy (C) — see SURVEY.md §2.2.
//
// Alignment model: banded edit distance (match 0 / mismatch 1 / indel 1),
// query consumed end-to-end, free leading/trailing gaps on the target window
// (the window is padded around the predicted diagonal). Traceback prefers
// diagonal moves so CIGARs match the conventional M-heavy style.
//
// Build: make -C native   (produces libbossnative.so; ctypes-loaded from
// bossruns_tpu/aligner/native.py)

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>
#include <thread>
#include <atomic>

#define RESTRICT __restrict__

namespace {

constexpr int32_t INF = 1 << 28;

struct Workspace {
    std::vector<int32_t> prev, curr, vdu;
    std::vector<uint8_t> opv, trace;  // trace: 1 byte/cell (band-local)
};

// ops: 0 = diagonal (M), 1 = up (I: query consumed), 2 = left (D: target consumed)
struct AlnResult {
    int32_t cost;
    int64_t tstart, tend;
    int32_t n_cigar;
};

// Align query (m bases, 2-bit codes, 4=N) to target window (n bases).
// Band: for query row i, target columns j in [center(i)-half, center(i)+half]
// where center(i) = i + pad (expected start at offset `pad` in the window).
// Returns cost and writes cigar ops/lens into out arrays (capacity cap).
AlnResult banded_align(const int8_t* q, int32_t m, const int8_t* t, int32_t n,
                       int32_t half, int32_t pad, Workspace& ws,
                       uint32_t* cigar_out, int32_t cap) {
    const int32_t bw = 2 * half + 1;
    ws.prev.assign(bw + 1, INF);   // slot bw: sentinel for the up-move read
    ws.curr.assign(bw + 1, INF);
    ws.vdu.resize(bw);
    ws.opv.resize(bw);
    ws.trace.resize(static_cast<size_t>(m + 1) * bw);

    // row 0: free leading target gap -> cost 0 at any target offset in band
    // band coordinates: cell (i, j) stored at b = j - (i + pad - half)
    for (int32_t b = 0; b < bw; ++b) {
        int32_t j = b + (0 + pad - half);
        ws.prev[b] = (j >= 0 && j <= n) ? 0 : INF;
        ws.trace[b] = 2;
    }

    // The row update is restructured into three band-wide passes so the
    // compiler can vectorise the work: (1) v = min(diag, up) — no intra-row
    // dependency; (2) the left-gap prefix scan curr[b] = min(v[b],
    // curr[b-1]+1) — scalar but only 2 ops/cell; (3) trace op recovery by
    // comparing curr against the pass-1 candidates. Tie priority matches the
    // original single-pass code: diagonal > up > left.
    int32_t* RESTRICT vdu = ws.vdu.data();
    uint8_t* RESTRICT opv = ws.opv.data();
    for (int32_t i = 1; i <= m; ++i) {
        int32_t lo = i + pad - half;  // target index of band slot 0 for row i
        uint8_t* RESTRICT tr = ws.trace.data() + static_cast<size_t>(i) * bw;
        const int8_t qc = q[i - 1];
        const bool qc_ok = qc < 4;
        int32_t* RESTRICT prev = ws.prev.data();
        int32_t* RESTRICT curr = ws.curr.data();
        // valid slots: j = b + lo in [0, n]; rows whose band lies entirely
        // past the window end (lo > n) have NO valid slots — bhi goes
        // negative there, so every fill loop below must clamp to [0, bw)
        const int32_t blo = std::max(0, -lo);
        const int32_t bhi = std::min(bw - 1, n - lo);  // inclusive; may be < 0
        // slots with a diagonal predecessor need j >= 1
        const int32_t bdiag = std::max(blo, 1 - lo);
        for (int32_t b = blo; b < bdiag && b <= bhi; ++b) {  // j == 0: up only
            vdu[b] = prev[b + 1] + 1;
            opv[b] = 1;
        }
        const int8_t* RESTRICT trow = t + (bdiag + lo - 1);
        for (int32_t b = bdiag; b <= bhi; ++b) {  // vectorisable
            int32_t sub = (qc == trow[b - bdiag] && qc_ok) ? 0 : 1;
            int32_t diag = prev[b] + sub;
            int32_t up = prev[b + 1] + 1;
            int32_t v = diag <= up ? diag : up;
            vdu[b] = v;
            opv[b] = diag <= up ? 0 : 1;
        }
        int32_t run = INF;  // left-gap scan (scalar, 2 ops/cell)
        for (int32_t b = blo; b <= bhi; ++b) {
            int32_t v = vdu[b];
            run = run + 1 < v ? run + 1 : v;
            curr[b] = run;
        }
        for (int32_t b = blo; b <= bhi; ++b)  // vectorisable
            tr[b] = curr[b] == vdu[b] ? opv[b] : 2;
        const int32_t fill_lo = std::min(blo, bw);
        for (int32_t b = 0; b < fill_lo; ++b) { curr[b] = INF; tr[b] = 0; }
        for (int32_t b = std::max(bhi + 1, fill_lo); b < bw; ++b) { curr[b] = INF; tr[b] = 0; }
        std::swap(ws.prev, ws.curr);
    }

    // free trailing target gap: take min over last row
    int32_t best = INF, bestb = 0;
    int32_t lo_m = m + pad - half;
    for (int32_t b = 0; b < bw; ++b) {
        int32_t j = b + lo_m;
        if (j < 0 || j > n) continue;
        if (ws.prev[b] < best) { best = ws.prev[b]; bestb = b; }
    }
    AlnResult res{best, 0, 0, 0};
    if (best >= INF) return res;

    // traceback
    int32_t i = m, j = bestb + lo_m;
    res.tend = j;
    int32_t nc = 0;
    uint32_t last_op = 255, run = 0;
    auto push = [&](uint32_t op) {
        if (op == last_op) { ++run; return true; }
        if (last_op != 255) {
            if (nc >= cap) return false;
            cigar_out[nc++] = (run << 4) | last_op;  // htslib-style packing
        }
        last_op = op; run = 1; return true;
    };
    bool ok = true;
    while (i > 0) {
        int32_t b = j - (i + pad - half);
        uint8_t op = ws.trace[static_cast<size_t>(i) * bw + b];
        if (op == 0) { ok = push(0); --i; --j; }        // M
        else if (op == 1) { ok = push(1); --i; }        // I (query only)
        else { ok = push(2); --j; }                     // D (target only)
        if (!ok) break;
    }
    if (ok && last_op != 255 && nc < cap) cigar_out[nc++] = (run << 4) | last_op;
    res.tstart = j;
    res.n_cigar = ok ? nc : 0;
    // cigar is emitted in reverse (traceback order); caller reverses
    return res;
}

// ---------------------------------------------------------------------------
// Bit-parallel banded alignment (Myers 1999 block recurrence, Hyyro's
// carry-corrected formulation — both published algorithms). Each 64-row
// block of the query advances one text column in ~15 word ops, vs 64 cells
// of scalar/SIMD DP: ~3x faster than the 3-pass int32 kernel above at ONT
// band widths. Same alignment model as banded_align (unit edit costs, free
// leading/trailing target gaps, query consumed end-to-end) with one
// relaxation: the band is block-granular and its edges are permissive (a
// path may ride the frozen band top at +1/column), so costs can be <= the
// strict-band kernel's. Traceback reconstructs cell values from stored
// per-column (Pv, Mv, Score) words by popcount and walks M > I > D on
// score equality — the same tie priority as the trace-array kernel.

struct MyersWS {
    std::vector<uint64_t> peq;                 // [5][nb]
    std::vector<uint64_t> Pv, Mv;              // [nb] current column
    std::vector<int32_t> Score;                // [nb] D[(b+1)*64][j]
    std::vector<uint64_t> trPv, trMv;          // per column, active blocks
    std::vector<int32_t> trScore;
    std::vector<int32_t> colFirst, colLast, colBase;
};

static inline int myers_block(uint64_t& Pv, uint64_t& Mv, uint64_t Eq, int hin) {
    const uint64_t HIGH = 1ull << 63;
    uint64_t Xv = Eq | Mv;
    if (hin < 0) Eq |= 1ull;
    uint64_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
    uint64_t Ph = Mv | ~(Xh | Pv);
    uint64_t Mh = Pv & Xh;
    int hout = int((Ph & HIGH) >> 63) - int((Mh & HIGH) >> 63);
    Ph <<= 1;
    Mh <<= 1;
    if (hin < 0) Mh |= 1ull;
    if (hin > 0) Ph |= 1ull;
    Pv = Mh | ~(Xv | Ph);
    Mv = Ph & Xv;
    return hout;
}

AlnResult banded_myers(const int8_t* q, int32_t m, const int8_t* t, int32_t n,
                       int32_t half, int32_t pad, MyersWS& ws,
                       uint32_t* cigar_out, int32_t cap) {
    const int32_t nb = (m + 63) >> 6;
    ws.peq.assign(static_cast<size_t>(5) * nb, 0);
    for (int32_t r = 0; r < m; ++r) {
        int8_t c = q[r];
        if (c >= 0 && c < 4)
            ws.peq[static_cast<size_t>(c) * nb + (r >> 6)] |= 1ull << (r & 63);
        // q==4 (N) never matches; peq[4] stays 0 so t==N matches nothing
    }
    ws.Pv.assign(nb, ~0ull);
    ws.Mv.assign(nb, 0);
    ws.Score.resize(nb);
    for (int32_t b = 0; b < nb; ++b) ws.Score[b] = (b + 1) * 64;
    ws.colFirst.assign(n + 1, 0);
    ws.colLast.assign(n + 1, -1);
    ws.colBase.assign(n + 1, 0);
    ws.trPv.clear(); ws.trMv.clear(); ws.trScore.clear();
    const int32_t maxBlocksCol = std::min<int64_t>(nb, (2 * half) / 64 + 2);
    ws.trPv.reserve(static_cast<size_t>(n + 1) * maxBlocksCol);
    ws.trMv.reserve(static_cast<size_t>(n + 1) * maxBlocksCol);
    ws.trScore.reserve(static_cast<size_t>(n + 1) * maxBlocksCol);

    // answer row m: D[m][j] from the block containing row m
    const int32_t lb = (m - 1) >> 6;
    const int32_t shm = m - lb * 64;  // in [1, 64]
    const uint64_t maskm = shm >= 64 ? 0ull : (~0ull << shm);
    int32_t best = INF, jbest = 0;
    if (0 >= m + pad - half) { best = m; jbest = 0; }  // j=0 in row-m band

    int32_t bl_prev = -1;
    for (int32_t j = 1; j <= n; ++j) {
        // band rows for this column: [j-pad-half, j-pad+half] clamped
        int32_t rl = j - pad - half, rh = j - pad + half;
        if (rh < 1 || rl > m) { ws.colLast[j] = -1; continue; }
        int32_t bf = rl <= 1 ? 0 : (rl - 1) >> 6;
        int32_t bl = std::min(nb - 1, (std::min(rh, m) - 1) >> 6);
        if (bf > bl) { ws.colLast[j] = -1; continue; }
        // blocks entering at the bottom: column-(j-1) state continues the
        // insert run down from the block above (D[r][j-1] = r-ish)
        for (int32_t b = std::max(bl_prev + 1, bf); b <= bl; ++b) {
            ws.Pv[b] = ~0ull;
            ws.Mv[b] = 0;
            ws.Score[b] = (b > 0 ? ws.Score[b - 1] : 0) + 64;
        }
        bl_prev = std::max(bl_prev, bl);

        const int8_t c = t[j - 1];
        const uint64_t* eq = &ws.peq[static_cast<size_t>(c) * nb];
        // top boundary: block 0 gets the free leading-gap row (hin 0);
        // a trimmed band top feeds +1/column (the frozen wall)
        int hin = bf == 0 ? 0 : 1;
        for (int32_t b = bf; b <= bl; ++b) {
            hin = myers_block(ws.Pv[b], ws.Mv[b], eq[b], hin);
            ws.Score[b] += hin;
        }
        ws.colFirst[j] = bf;
        ws.colLast[j] = bl;
        ws.colBase[j] = static_cast<int32_t>(ws.trScore.size());
        for (int32_t b = bf; b <= bl; ++b) {
            ws.trPv.push_back(ws.Pv[b]);
            ws.trMv.push_back(ws.Mv[b]);
            ws.trScore.push_back(ws.Score[b]);
        }
        if (lb >= bf && lb <= bl && m >= rl && m <= rh) {
            int32_t sm = ws.Score[lb]
                - __builtin_popcountll(ws.Pv[lb] & maskm)
                + __builtin_popcountll(ws.Mv[lb] & maskm);
            if (sm < best) { best = sm; jbest = j; }
        }
    }

    AlnResult res{best, 0, 0, 0};
    if (best >= INF) return res;

    // D[r][j] from the stored column state; INF when outside the band
    auto cell = [&](int32_t r, int32_t j) -> int32_t {
        if (r == 0) return 0;          // free leading target gap row
        if (j == 0) return r;          // empty-text column
        if (ws.colLast[j] < 0) return INF;
        int32_t B = (r - 1) >> 6;
        if (B < ws.colFirst[j] || B > ws.colLast[j]) return INF;
        size_t idx = static_cast<size_t>(ws.colBase[j]) + (B - ws.colFirst[j]);
        int32_t sh = r - B * 64;       // in [1, 64]
        uint64_t mask = sh >= 64 ? 0ull : (~0ull << sh);
        return ws.trScore[idx]
            - __builtin_popcountll(ws.trPv[idx] & mask)
            + __builtin_popcountll(ws.trMv[idx] & mask);
    };

    int32_t i = m, j = jbest, s = best;
    res.tend = j;
    int32_t nc = 0;
    uint32_t last_op = 255, run = 0;
    auto push = [&](uint32_t op) {
        if (op == last_op) { ++run; return true; }
        if (last_op != 255) {
            if (nc >= cap) return false;
            cigar_out[nc++] = (run << 4) | last_op;
        }
        last_op = op; run = 1; return true;
    };
    bool ok = true;
    while (i > 0 && ok) {
        if (j >= 1) {
            int32_t d = cell(i - 1, j - 1);
            if (d < INF) {
                int32_t sub = (q[i - 1] == t[j - 1] && q[i - 1] < 4) ? 0 : 1;
                if (d + sub == s) { ok = push(0); --i; --j; s = d; continue; }
            }
            int32_t u = cell(i - 1, j);
            if (u < INF && u + 1 == s) { ok = push(1); --i; s = u; continue; }
            int32_t l = cell(i, j - 1);
            if (l < INF && l + 1 == s) { ok = push(2); --j; s = l; continue; }
            // band-edge fallback (frozen-wall scores have no exact
            // predecessor): take any stored predecessor, diagonal first
            if (d < INF) { ok = push(0); --i; --j; s = d; continue; }
            if (u < INF) { ok = push(1); --i; s = u; continue; }
        } else {
            int32_t u = cell(i - 1, 0);
            if (u + 1 == s || true) { ok = push(1); --i; s = u; continue; }
        }
        ok = push(1); --i; --s;  // last resort: consume query
    }
    if (ok && last_op != 255 && nc < cap) cigar_out[nc++] = (run << 4) | last_op;
    res.tstart = j;
    res.n_cigar = ok ? nc : 0;
    res.cost = best;
    return res;
}

}  // namespace

extern "C" {

// Batch banded alignment.
//  queries: concatenated 2-bit codes (int8, 0..3, 4=N), offsets q_off[n+1]
//  target: one global genome array (int8 codes)
//  win_start/win_end: per-read candidate windows into target
//  pad: expected query start at win_start + pad (diagonal prediction)
//  half_band: per-read band half-width
// Outputs per read: cost, tstart/tend (global coords), cigar ops packed
// (len<<4 | op; op 0=M 1=I 2=D) in reverse order into cigar_buf at
// cigar_cap*r, count in cigar_len (0 => failed/overflow).
// Production path: bit-parallel Myers blocks (see banded_myers above).
void banded_align_batch(const int8_t* queries, const int64_t* q_off, int32_t n,
                        const int8_t* target, int64_t /*t_len*/,
                        const int64_t* win_start, const int64_t* win_end,
                        const int32_t* pad, const int32_t* half_band,
                        int32_t n_threads,
                        int32_t* cost, int64_t* tstart, int64_t* tend,
                        uint32_t* cigar_buf, int32_t cigar_cap, int32_t* cigar_len) {
    std::atomic<int32_t> next{0};
    auto worker = [&]() {
        MyersWS ws;
        for (;;) {
            int32_t r = next.fetch_add(1);
            if (r >= n) break;
            int32_t m = static_cast<int32_t>(q_off[r + 1] - q_off[r]);
            int64_t ws_ = win_start[r], we_ = win_end[r];
            int32_t wn = static_cast<int32_t>(we_ - ws_);
            if (m <= 0 || wn <= 0) { cigar_len[r] = 0; cost[r] = -1; continue; }
            AlnResult res = banded_myers(queries + q_off[r], m, target + ws_, wn,
                                         half_band[r], pad[r], ws,
                                         cigar_buf + static_cast<size_t>(r) * cigar_cap,
                                         cigar_cap);
            cost[r] = res.cost >= INF ? -1 : res.cost;
            tstart[r] = ws_ + res.tstart;
            tend[r] = ws_ + res.tend;
            cigar_len[r] = res.n_cigar;
        }
    };
    int32_t nt = std::max(1, n_threads);
    std::vector<std::thread> threads;
    for (int32_t i = 1; i < nt; ++i) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
}

// Strict-band 3-pass scalar kernel, kept as the cross-check oracle for the
// Myers path (tests/test_native_host.py): same model with exact band edges.
void banded_align_batch_scalar(const int8_t* queries, const int64_t* q_off,
                               int32_t n, const int8_t* target, int64_t,
                               const int64_t* win_start, const int64_t* win_end,
                               const int32_t* pad, const int32_t* half_band,
                               int32_t n_threads,
                               int32_t* cost, int64_t* tstart, int64_t* tend,
                               uint32_t* cigar_buf, int32_t cigar_cap,
                               int32_t* cigar_len) {
    std::atomic<int32_t> next{0};
    auto worker = [&]() {
        Workspace ws;
        for (;;) {
            int32_t r = next.fetch_add(1);
            if (r >= n) break;
            int32_t m = static_cast<int32_t>(q_off[r + 1] - q_off[r]);
            int64_t ws_ = win_start[r], we_ = win_end[r];
            int32_t wn = static_cast<int32_t>(we_ - ws_);
            if (m <= 0 || wn <= 0) { cigar_len[r] = 0; cost[r] = -1; continue; }
            AlnResult res = banded_align(queries + q_off[r], m, target + ws_, wn,
                                         half_band[r], pad[r], ws,
                                         cigar_buf + static_cast<size_t>(r) * cigar_cap,
                                         cigar_cap);
            cost[r] = res.cost >= INF ? -1 : res.cost;
            tstart[r] = ws_ + res.tstart;
            tend[r] = ws_ + res.tend;
            cigar_len[r] = res.n_cigar;
        }
    };
    int32_t nt = std::max(1, n_threads);
    std::vector<std::thread> threads;
    for (int32_t i = 1; i < nt; ++i) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host data-plane kernels: batch CIGAR expansion -> coverage COO triplets.
//
// Replaces the per-read NumPy string pipeline (io/paf.py expand_cigar +
// io/coo.py concatenation) for production batch sizes: one pass over all
// reads emits the (global_pos, symbol, weight) runs the device consumes.
// Reads arrive strand-corrected as 2-bit codes with phred quals.

extern "C" {

// Batch cg:Z-string parser: concatenated cigar strings (byte offsets
// offs[n+1]) -> packed (len<<4 | op) uint32 ops, op 0=M/=/X 1=I/S 2=D/N.
// out must hold at least offs[n]/2+n entries (every op is >= 2 chars).
// Writes per-record op counts into out_counts; returns total ops or -1 on a
// malformed byte. Replaces a per-record Python regex parse (~60 us/record).
int64_t parse_cigar_batch(const char* cat, const int64_t* offs, int32_t n,
                          uint32_t* out, int64_t out_cap,
                          int32_t* out_counts) {
    static int8_t opcode[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) opcode[i] = -1;
        opcode['M'] = 0; opcode['='] = 0; opcode['X'] = 0;
        opcode['I'] = 1; opcode['S'] = 1;
        opcode['D'] = 2; opcode['N'] = 2;
        opcode['H'] = 3; opcode['P'] = 3; opcode['B'] = 3;  // dropped
        init = true;
    }
    int64_t k = 0;
    for (int32_t r = 0; r < n; ++r) {
        int64_t nops = 0;
        uint32_t len = 0;
        for (int64_t i = offs[r]; i < offs[r + 1]; ++i) {
            const unsigned char ch = cat[i];
            if (ch >= '0' && ch <= '9') {
                len = len * 10 + (ch - '0');
                continue;
            }
            const int8_t op = opcode[ch];
            if (op < 0) return -1;
            if (op < 3) {
                if (k >= out_cap) return -1;
                out[k++] = (len << 4) | (uint32_t)op;
                ++nops;
            }
            len = 0;
        }
        out_counts[r] = (int32_t)nops;
    }
    return k;
}

}  // extern "C"

extern "C" {

// Packed expansion: per covered target position emit (symbol, qual) only —
// positions are reconstructed on-device from per-read (start, span) runs
// (see bossruns_tpu/models/runs.py), cutting host->device transfer ~8x.
int64_t expand_cigars_packed(const int8_t* seqs, const int8_t* quals,
                             const int64_t* s_off,
                             const uint32_t* cigars, const int64_t* c_off,
                             int32_t n,
                             int8_t* out_sym, int8_t* out_qual, int64_t cap) {
    int64_t k = 0;
    for (int32_t r = 0; r < n; ++r) {
        const int8_t* s = seqs + s_off[r];
        const int8_t* q = quals + s_off[r];
        int64_t si = 0;
        for (int64_t c = c_off[r]; c < c_off[r + 1]; ++c) {
            uint32_t len = cigars[c] >> 4;
            uint32_t op = cigars[c] & 0xF;
            if (op == 0) {  // M
                if (k + len > cap) return -1;
                for (uint32_t i = 0; i < len; ++i) {
                    out_sym[k] = s[si + i];
                    out_qual[k] = q[si + i];
                    ++k;
                }
                si += len;
            } else if (op == 2) {  // D -> symbol 4, qual 20
                if (k + len > cap) return -1;
                for (uint32_t i = 0; i < len; ++i) { out_sym[k] = 4; out_qual[k] = 20; ++k; }
            } else {
                si += len;
            }
        }
    }
    return k;
}

}  // extern "C"

extern "C" {

// One-pass rolling k-mer scan for minimizer index construction
// (bossruns_tpu/aligner/index.py::build_index). Emits, per k-mer window
// start, the canonical 2-bit-packed code, the strand flag (reverse
// complement is canonical), the minimizer selection hash (31-bit triple32
// mix of canonical ^ canonical>>15 — MUST match index.selection_hash /
// seed._hash31), and an ok flag (all k bases valid && not palindromic).
// Replaces 30+ genome-length NumPy passes with one; at human scale the
// index build drops minutes.
void kmer_scan(const int8_t* codes, int64_t n_codes, int32_t k,
               int64_t* canonical, int8_t* strand, int32_t* hash_out,
               int8_t* ok_out) {
    const int64_t n = n_codes - k + 1;
    if (n <= 0) return;
    const int64_t mask = (k >= 32) ? ~0LL : ((1LL << (2 * k)) - 1);
    const int rc_shift = 2 * (k - 1);
    int64_t fwd = 0, rc = 0;
    int64_t since_bad = 0;  // valid bases seen since the last invalid one
    for (int64_t i = 0; i < n_codes; ++i) {
        const int64_t b = codes[i] & 3;
        fwd = ((fwd << 2) | b) & mask;
        rc = (rc >> 2) | ((3 - b) << rc_shift);
        since_bad = (codes[i] >= 4) ? 0 : since_bad + 1;
        const int64_t p = i - k + 1;  // window start this k-mer belongs to
        if (p < 0) continue;
        const bool valid = since_bad >= k && fwd != rc;
        const int64_t can = fwd < rc ? fwd : rc;
        canonical[p] = can;
        strand[p] = (int8_t)(rc < fwd);
        ok_out[p] = (int8_t)valid;
        if (valid) {
            uint32_t h = (uint32_t)can ^ (uint32_t)(can >> 15);
            h ^= h >> 16; h *= 0x45D9F3Bu;
            h ^= h >> 16; h *= 0x45D9F3Bu;
            h ^= h >> 16;
            hash_out[p] = (int32_t)(h >> 1);
        } else {
            hash_out[p] = 0x7FFFFFFF;
        }
    }
}

}  // extern "C"

namespace {

inline int64_t parse_i64(const char* p, const char* end, const char** out) {
    int64_t v = 0;
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = p;
    return neg ? -v : v;
}

}  // namespace

extern "C" {

// One-call PAF parser: the whole text blob -> columnar arrays. Replaces the
// per-line Python split/int/tag-find loop in io/paf.parse_paf (the second-
// largest host cost of a PAF-driven simulation batch) and parses cg:Z tags
// straight into packed (len<<4|op) uint32 ops, so no later string parse.
//
// nums: int64 [cap, 11] rows (qlen qstart qend tlen tstart tend nmatch
// blocklen mapq AS s1); names: int64 [cap, 4] (qname_off qname_len
// tname_off tname_len, byte offsets into text); flags: int8 [cap, 2]
// (rev, primary); cg_bound: int64 [cap+1] op-bounds into cg_ops (equal
// bounds = record had no cg tag). Records with blocklen < min_len or
// (primary_only && tp:A != P) are dropped, mirroring boss/paf.py:652-672.
// Returns the record count, or -1 if a capacity would be exceeded.
int64_t parse_paf_blob(const char* text, int64_t tlen,
                       int64_t min_len, int32_t primary_only,
                       int64_t* nums, int64_t* names, int8_t* flags,
                       uint32_t* cg_ops, int64_t cg_cap, int64_t* cg_bound,
                       int64_t cap) {
    static const int8_t opcode[256] = {
        /* zero-init; set below via switch in code instead */
    };
    (void)opcode;
    int64_t n = 0;
    int64_t cg_pos = 0;
    cg_bound[0] = 0;
    const char* p = text;
    const char* end = text + tlen;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        // split first 12 fields
        const char* f[13];
        int nf = 0;
        const char* q = p;
        f[nf++] = q;
        while (q < line_end && nf < 13) {
            if (*q == '\t') f[nf++] = q + 1;
            ++q;
        }
        if (nf >= 12 && n < cap) {
            const char* e;
            int64_t* row = nums + n * 11;
            const char* cur;
            // field ends are the next field start - 1, or line_end
            auto fend = [&](int i) {
                return i + 1 < nf ? f[i + 1] - 1 : line_end;
            };
            names[n * 4 + 0] = f[0] - text;
            names[n * 4 + 1] = fend(0) - f[0];
            row[0] = parse_i64(f[1], fend(1), &e);
            row[1] = parse_i64(f[2], fend(2), &e);
            row[2] = parse_i64(f[3], fend(3), &e);
            flags[n * 2 + 0] = (*f[4] == '+') ? 0 : 1;
            names[n * 4 + 2] = f[5] - text;
            names[n * 4 + 3] = fend(5) - f[5];
            row[3] = parse_i64(f[6], fend(6), &e);
            row[4] = parse_i64(f[7], fend(7), &e);
            row[5] = parse_i64(f[8], fend(8), &e);
            row[6] = parse_i64(f[9], fend(9), &e);
            row[7] = parse_i64(f[10], fend(10), &e);
            row[8] = parse_i64(f[11], fend(11), &e);
            row[9] = 0;   // AS:i
            row[10] = 0;  // s1:i
            int8_t prim = 0;
            bool cg_ok = true;
            // walk tag fields (field 12 onward): each is key:type:value
            cur = nf > 12 ? f[12] : line_end;
            while (cur < line_end) {
                const char* tab = (const char*)memchr(cur, '\t', line_end - cur);
                const char* vend = tab ? tab : line_end;
                if (vend - cur >= 5) {
                    if (memcmp(cur, "tp:A:", 5) == 0) {
                        prim = cur[5] == 'P';
                    } else if (memcmp(cur, "AS:i:", 5) == 0) {
                        row[9] = parse_i64(cur + 5, vend, &e);
                    } else if (memcmp(cur, "s1:i:", 5) == 0) {
                        row[10] = parse_i64(cur + 5, vend, &e);
                    } else if (memcmp(cur, "cg:Z:", 5) == 0) {
                        const char* c = cur + 5;
                        while (c < vend) {
                            const char* after;
                            int64_t l = parse_i64(c, vend, &after);
                            if (after >= vend || after == c) { cg_ok = false; break; }
                            uint32_t op;
                            switch (*after) {
                                case 'M': case '=': case 'X': op = 0; break;
                                case 'I': case 'S': op = 1; break;
                                case 'D': case 'N': op = 2; break;
                                case 'H': case 'P': case 'B': op = 1; break;
                                default: op = 1; break;
                            }
                            if (cg_pos >= cg_cap) return -1;
                            cg_ops[cg_pos++] = ((uint32_t)l << 4) | op;
                            c = after + 1;
                        }
                    }
                }
                cur = tab ? tab + 1 : line_end;
            }
            if (!cg_ok) cg_pos = cg_bound[n];  // malformed tag -> no cigar
            flags[n * 2 + 1] = prim;
            if (row[7] >= min_len && (!primary_only || prim)) {
                cg_bound[n + 1] = cg_pos;
                ++n;
            } else {
                cg_pos = cg_bound[n];  // roll back this record's ops
            }
        } else if (nf >= 12) {
            return -1;  // cap exceeded
        }
        p = line_end + 1;
    }
    return n;
}

}  // extern "C"

extern "C" {

// Strand-corrected (encode + revcomp + slice) alignment windows for a batch
// of reads, feeding expand_cigars_packed. Replaces the per-read Python loop
// in io/coo_native.build_packed_runs (~0.45 s per 4000-read batch: per-read
// np.frombuffer encode, reverse-complement copies and slicing).
//
// seq_cat / qual_cat: raw ASCII bytes of all read sequences / quality
// strings concatenated, with seq_off/qual_off [n+1] record boundaries. A
// zero-length quality record means "no quals" -> fill 40 (mappy parity).
// qs/qe are ORIGINAL query coordinates, ql the full read length, rev the
// strand flag; for rev reads the emitted window is the reverse complement
// of seq[qe-1 .. qs] (equivalent to revcomp-then-slice at [ql-qe, ql-qs)).
// Emits int8 codes (A,C,G,T->0..3, other->4) and clipped int8 quals.
// Returns total bases written, or -1 if cap would be exceeded.
int64_t prep_read_windows(const char* seq_cat, const int64_t* seq_off,
                          const char* qual_cat, const int64_t* qual_off,
                          const int64_t* qs, const int64_t* qe,
                          const uint8_t* rev, int32_t n,
                          int8_t* out_sym, int8_t* out_qual, int64_t cap) {
    int8_t enc[256];
    for (int i = 0; i < 256; ++i) enc[i] = 4;
    enc[(unsigned char)'A'] = 0; enc[(unsigned char)'a'] = 0;
    enc[(unsigned char)'C'] = 1; enc[(unsigned char)'c'] = 1;
    enc[(unsigned char)'G'] = 2; enc[(unsigned char)'g'] = 2;
    enc[(unsigned char)'T'] = 3; enc[(unsigned char)'t'] = 3;
    static const int8_t rc[5] = {3, 2, 1, 0, 4};
    int64_t k = 0;
    for (int32_t r = 0; r < n; ++r) {
        const char* s = seq_cat + seq_off[r];
        const char* q = qual_cat + qual_off[r];
        const bool has_q = qual_off[r + 1] > qual_off[r];
        const int64_t w = qe[r] - qs[r];
        if (w <= 0) continue;
        if (k + w > cap) return -1;
        if (rev[r]) {
            for (int64_t i = 0; i < w; ++i) {
                const int64_t o = qe[r] - 1 - i;
                out_sym[k + i] = rc[enc[(unsigned char)s[o]]];
                int32_t qv = has_q ? (int32_t)(unsigned char)q[o] - 33 : 40;
                out_qual[k + i] = (int8_t)(qv < 0 ? 0 : (qv > 127 ? 127 : qv));
            }
        } else {
            for (int64_t i = 0; i < w; ++i) {
                const int64_t o = qs[r] + i;
                out_sym[k + i] = enc[(unsigned char)s[o]];
                int32_t qv = has_q ? (int32_t)(unsigned char)q[o] - 33 : 40;
                out_qual[k + i] = (int8_t)(qv < 0 ? 0 : (qv > 127 ? 127 : qv));
            }
        }
        k += w;
    }
    return k;
}

}  // extern "C"

extern "C" {

// Split per-base observations into reference-match runs + explicit non-match
// COO. Matches dominate (~90-95%) and form intervals, so the device can add
// them with a +1/-1 boundary scatter and a cumulative sum instead of one
// scatter row per base (~10x fewer scatter rows). Deletions (symbol 4) and
// mismatches go to the explicit list. Bases with qual < qt are dropped, as
// are symbol-4 bases when len_b == 4 (the 4-symbol observation model ignores
// deletions, sequences.py:417-418).
// Outputs are (barcode, position) PAIRS — not flattened bc*G+g indices —
// so the format carries genomes beyond the int32 flat-index domain
// (> ~430 Mb; a human genome's 3.1e9 positions need uint32). mr: match runs
// (bc uint8, gstart uint32, len uint16); ex: explicit observations
// (bc*5+sym uint16, gpos uint32). The narrow dtypes cut the per-batch
// host->device bytes ~3x; runs longer than 65535 are emitted as chunks.
// Read starts are 64-bit (concatenated-genome offsets exceed int32).
// Returns (n_runs << 32) | n_explicit, or -1 if a cap would be exceeded.
// (_v2 suffix: the narrow-dtype ABI — a stale .so without this symbol makes
// the Python side fall back to NumPy instead of corrupting buffers.)
int64_t split_match_runs_wide_v2(const int8_t* sym, const int8_t* qual,
                                 int64_t m,
                                 const int64_t* rstart, const int32_t* rspan,
                                 const int32_t* rbc, int32_t n_reads,
                                 const int8_t* ref, int64_t G,
                                 int32_t qt, int32_t len_b,
                                 uint8_t* mr_bc, uint32_t* mr_g,
                                 uint16_t* mr_len, int64_t mr_cap,
                                 uint16_t* ex_bcsym, uint32_t* ex_g,
                                 int64_t ex_cap) {
    int64_t nr = 0, ne = 0;
    int64_t base = 0;
    (void)m;
    for (int32_t r = 0; r < n_reads; ++r) {
        int64_t g0 = rstart[r];
        int64_t span = rspan[r];
        uint8_t bc = (uint8_t)rbc[r];
        int64_t run_start = -1;
        for (int64_t i = 0; i < span; ++i) {
            int64_t g = g0 + i;
            int8_t s = sym[base + i];
            bool valid = qual[base + i] >= qt && g < G &&
                         !(len_b == 4 && s == 4);
            bool match = valid && s == ref[g];
            if (match) {
                if (run_start < 0) run_start = g;
                else if (g - run_start == 65535) {  // uint16 len cap: chunk
                    if (nr >= mr_cap) return -1;
                    mr_bc[nr] = bc;
                    mr_g[nr] = (uint32_t)run_start;
                    mr_len[nr] = 65535;
                    ++nr;
                    run_start = g;
                }
            } else {
                if (run_start >= 0) {
                    if (nr >= mr_cap) return -1;
                    mr_bc[nr] = bc;
                    mr_g[nr] = (uint32_t)run_start;
                    mr_len[nr] = (uint16_t)(g - run_start);
                    ++nr;
                    run_start = -1;
                }
                if (valid) {
                    if (ne >= ex_cap) return -1;
                    ex_bcsym[ne] = (uint16_t)(rbc[r] * 5 + s);
                    ex_g[ne] = (uint32_t)g;
                    ++ne;
                }
            }
        }
        if (run_start >= 0) {
            if (nr >= mr_cap) return -1;
            mr_bc[nr] = bc;
            mr_g[nr] = (uint32_t)run_start;
            mr_len[nr] = (uint16_t)(g0 + span - run_start);
            ++nr;
        }
        base += span;
    }
    return (nr << 32) | ne;
}

// Minimizer-mask kernel: out[i] = 1 iff h[i] equals the minimum of SOME
// w-window containing i (all ties — the selection rule of
// aligner/index.py::minimizer_mask, whose scipy two-pass form dominated
// index builds). Two monotonic-deque sliding-min passes, O(n); windows are
// clipped at the array edges (== scipy's 'nearest' replication for a min).
// Threaded variants (round 5): the per-batch AEONS index rebuild scans a
// few Mb of new sequence per batch; both passes chunk exactly.
//   kmer_scan_mt — each chunk primes the rolling k-mer state from its own
//   start (the since_bad streak truncates at the chunk start, which leaves
//   the `streak >= k` validity test unchanged), so chunk outputs equal the
//   sequential scan's bit for bit.
//   minimizer_mask_mt — mask[i] depends on h[i-w+1 .. i+w-1] only; each
//   chunk runs the two deque passes over its halo-extended range with
//   GLOBAL end clipping.

static void kmer_scan_range(const int8_t* codes, int64_t n_codes, int32_t k,
                            int64_t p0, int64_t p1,
                            int64_t* canonical, int8_t* strand,
                            int32_t* hash_out, int8_t* ok_out) {
    const int64_t mask = (k >= 32) ? ~0LL : ((1LL << (2 * k)) - 1);
    const int rc_shift = 2 * (k - 1);
    int64_t fwd = 0, rc = 0;
    int64_t since_bad = 0;
    const int64_t i_end = p1 + k - 1 < n_codes ? p1 + k - 1 : n_codes;
    for (int64_t i = p0; i < i_end; ++i) {
        const int64_t b = codes[i] & 3;
        fwd = ((fwd << 2) | b) & mask;
        rc = (rc >> 2) | ((3 - b) << rc_shift);
        since_bad = (codes[i] >= 4) ? 0 : since_bad + 1;
        const int64_t p = i - k + 1;
        if (p < p0) continue;
        const bool valid = since_bad >= k && fwd != rc;
        const int64_t can = fwd < rc ? fwd : rc;
        canonical[p] = can;
        strand[p] = (int8_t)(rc < fwd);
        ok_out[p] = (int8_t)valid;
        if (valid) {
            uint32_t h = (uint32_t)can ^ (uint32_t)(can >> 15);
            h ^= h >> 16; h *= 0x45D9F3Bu;
            h ^= h >> 16; h *= 0x45D9F3Bu;
            h ^= h >> 16;
            hash_out[p] = (int32_t)(h >> 1);
        } else {
            hash_out[p] = 0x7FFFFFFF;
        }
    }
}

static void minimizer_mask_range(const int32_t* h, int64_t n, int32_t w,
                                 int64_t a, int64_t b, int8_t* out) {
    // out[i] for i in [a, b); wmin[p] = min(h[p : min(p+w, n)]) computed for
    // p in [lo, b) with lo = max(a - w + 1, 0); m2[i] = min(wmin[max(i-w+1,
    // 0) : i+1]); out[i] = (h[i] == m2[i]).
    const int64_t lo = a - w + 1 > 0 ? a - w + 1 : 0;
    const int64_t span = b - lo;
    if (span <= 0) return;
    int32_t* wmin = (int32_t*)malloc((size_t)span * sizeof(int32_t));
    int64_t* dq = (int64_t*)malloc(((size_t)span + (size_t)w) * sizeof(int64_t));
    int64_t head = 0, tail = 0;
    const int64_t hi = b + w - 1 < n ? b + w - 1 : n;  // codes read: [lo, hi)
    for (int64_t i = lo; i < hi; ++i) {
        while (tail > head && h[dq[tail - 1]] > h[i]) --tail;
        dq[tail++] = i;
        int64_t p = i - w + 1;
        if (p >= lo && p < b) {
            while (dq[head] < p) ++head;
            wmin[p - lo] = h[dq[head]];
        }
    }
    // tail windows clipped at the GLOBAL end (p + w > n)
    for (int64_t p = (n - w + 1 > lo ? n - w + 1 : lo); p < b; ++p) {
        while (head < tail && dq[head] < p) ++head;
        wmin[p - lo] = (head < tail) ? h[dq[head]] : h[p];
    }
    head = tail = 0;
    for (int64_t i = lo; i < b; ++i) {
        while (tail > head && wmin[dq[tail - 1] - lo] > wmin[i - lo]) --tail;
        dq[tail++] = i;
        int64_t l2 = i - w + 1;
        while (dq[head] < (l2 > lo ? l2 : lo)) ++head;
        if (i >= a) out[i] = (h[i] == wmin[dq[head] - lo]) ? 1 : 0;
    }
    free(wmin);
    free(dq);
}

void kmer_scan_mt(const int8_t* codes, int64_t n_codes, int32_t k,
                  int64_t* canonical, int8_t* strand, int32_t* hash_out,
                  int8_t* ok_out, int32_t nthreads) {
    const int64_t n = n_codes - k + 1;
    if (n <= 0) return;
    int T = nthreads < 1 ? 1 : nthreads;
    if ((int64_t)T > n) T = 1;
    std::vector<std::thread> threads;
    const int64_t chunk = (n + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        const int64_t p0 = t * chunk;
        const int64_t p1 = (t + 1) * chunk < n ? (t + 1) * chunk : n;
        if (p0 >= p1) break;
        threads.emplace_back(kmer_scan_range, codes, n_codes, k, p0, p1,
                             canonical, strand, hash_out, ok_out);
    }
    for (auto& th : threads) th.join();
}

void minimizer_mask_mt(const int32_t* h, int64_t n, int32_t w, int8_t* out,
                       int32_t nthreads) {
    if (n <= 0) return;
    int T = nthreads < 1 ? 1 : nthreads;
    if ((int64_t)T > n) T = 1;
    std::vector<std::thread> threads;
    const int64_t chunk = (n + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        const int64_t a = t * chunk;
        const int64_t b = (t + 1) * chunk < n ? (t + 1) * chunk : n;
        if (a >= b) break;
        threads.emplace_back(minimizer_mask_range, h, n, w, a, b, out);
    }
    for (auto& th : threads) th.join();
}

void minimizer_mask_c(const int32_t* h, int64_t n, int32_t w, int8_t* out) {
    if (n <= 0) return;
    int32_t* wmin = (int32_t*)malloc((size_t)n * sizeof(int32_t));
    int64_t* dq = (int64_t*)malloc((size_t)n * sizeof(int64_t));
    // pass 1: wmin[p] = min(h[p : p+w]) clipped
    int64_t head = 0, tail = 0;
    for (int64_t i = 0; i < n; ++i) {
        while (tail > head && h[dq[tail - 1]] > h[i]) --tail;
        dq[tail++] = i;
        int64_t p = i - w + 1;  // window [p, i] fully pushed
        if (p >= 0) {
            while (dq[head] < p) ++head;
            wmin[p] = h[dq[head]];
        }
    }
    // tail windows [p, n) for p > n-w (clipped): deque still holds suffix
    for (int64_t p = (n - w + 1 > 0 ? n - w + 1 : 0); p < n; ++p) {
        while (head < tail && dq[head] < p) ++head;
        if (head < tail) wmin[p] = h[dq[head]];
        else wmin[p] = h[p];
    }
    // pass 2: m2[i] = min(wmin[max(0, i-w+1) : i+1]); out = (h == m2)
    head = tail = 0;
    for (int64_t i = 0; i < n; ++i) {
        while (tail > head && wmin[dq[tail - 1]] > wmin[i]) --tail;
        dq[tail++] = i;
        int64_t lo = i - w + 1;
        while (dq[head] < (lo > 0 ? lo : 0)) ++head;
        out[i] = (h[i] == wmin[dq[head]]) ? 1 : 0;
    }
    free(wmin);
    free(dq);
}

// _v3: like _v2 but additionally emits the SOURCE ROW of every output run /
// explicit entry (rrow[r] for record r — callers pass per-record read
// indices so device-side gating can switch whole reads on/off with a
// per-read bit vector; models/runs.py step_gated). Kept as a separate
// symbol so a stale .so degrades to the NumPy fallback, never corrupts.
int64_t split_match_runs_wide_v3(const int8_t* sym, const int8_t* qual,
                                 int64_t m,
                                 const int64_t* rstart, const int32_t* rspan,
                                 const int32_t* rbc, const int32_t* rrow,
                                 int32_t n_reads,
                                 const int8_t* ref, int64_t G,
                                 int32_t qt, int32_t len_b,
                                 uint8_t* mr_bc, uint32_t* mr_g,
                                 uint16_t* mr_len, uint32_t* mr_read,
                                 int64_t mr_cap,
                                 uint16_t* ex_bcsym, uint32_t* ex_g,
                                 uint32_t* ex_read, int64_t ex_cap) {
    int64_t nr = 0, ne = 0;
    int64_t base = 0;
    (void)m;
    for (int32_t r = 0; r < n_reads; ++r) {
        int64_t g0 = rstart[r];
        int64_t span = rspan[r];
        uint8_t bc = (uint8_t)rbc[r];
        uint32_t row = (uint32_t)rrow[r];
        int64_t run_start = -1;
        for (int64_t i = 0; i < span; ++i) {
            int64_t g = g0 + i;
            int8_t s = sym[base + i];
            bool valid = qual[base + i] >= qt && g < G &&
                         !(len_b == 4 && s == 4);
            bool match = valid && s == ref[g];
            if (match) {
                if (run_start < 0) run_start = g;
                else if (g - run_start == 65535) {  // uint16 len cap: chunk
                    if (nr >= mr_cap) return -1;
                    mr_bc[nr] = bc;
                    mr_g[nr] = (uint32_t)run_start;
                    mr_len[nr] = 65535;
                    mr_read[nr] = row;
                    ++nr;
                    run_start = g;
                }
            } else {
                if (run_start >= 0) {
                    if (nr >= mr_cap) return -1;
                    mr_bc[nr] = bc;
                    mr_g[nr] = (uint32_t)run_start;
                    mr_len[nr] = (uint16_t)(g - run_start);
                    mr_read[nr] = row;
                    ++nr;
                    run_start = -1;
                }
                if (valid) {
                    if (ne >= ex_cap) return -1;
                    ex_bcsym[ne] = (uint16_t)(rbc[r] * 5 + s);
                    ex_g[ne] = (uint32_t)g;
                    ex_read[ne] = row;
                    ++ne;
                }
            }
        }
        if (run_start >= 0) {
            if (nr >= mr_cap) return -1;
            mr_bc[nr] = bc;
            mr_g[nr] = (uint32_t)run_start;
            mr_len[nr] = (uint16_t)(g0 + span - run_start);
            mr_read[nr] = row;
            ++nr;
        }
        base += span;
    }
    return (nr << 32) | ne;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-seeding hot helpers (aligner/host_seed.py).
//
// seed_votes_c: votes[i] = #elements of the sorted composite-key array within
// [comp[i]-tol, comp[i]+tol] — a two-pointer sweep replacing two
// n-log-n searchsorted passes (host_seed.py::_votes is the executable spec,
// pinned equal in tests/test_native_host.py).
//
// peel_mask_c: set votes[lo_j : hi_j) = -1 for m (possibly overlapping)
// ranges via an O(n + m) difference-array pass (host_seed.py::_peel_mask
// spec).
// ---------------------------------------------------------------------------

extern "C" {

void seed_votes_c(const int64_t* comp, int64_t n, int64_t tol, int64_t* votes) {
    int64_t lo = 0, hi = 0;
    for (int64_t i = 0; i < n; ++i) {
        while (comp[i] - comp[lo] > tol) ++lo;
        if (hi < i + 1) hi = i + 1;
        while (hi < n && comp[hi] - comp[i] <= tol) ++hi;
        votes[i] = hi - lo;
    }
}

// seed_votes_bucket_c: the round-5 staggered-bucket vote. votes[i] = max
// over two grids (width 2*tol, offsets 0 and tol) of the run length of i's
// (seg, floor-divide bucket) group; inputs sorted by (seg, diag). Floor
// division matches numpy (host_seed.py::_votes is the executable spec,
// pinned equal in tests/test_native_host.py; the device kernel counts
// identically by the shared partition).
void seed_votes_bucket_c(const int64_t* seg, const int64_t* diag, int64_t n,
                         int64_t tol, int64_t* votes) {
    if (n <= 0) return;
    const int64_t width = 2 * tol > 0 ? 2 * tol : 1;
    for (int grid = 0; grid < 2; ++grid) {
        const int64_t off = grid ? tol : 0;
        int64_t run_start = 0;
        int64_t prev_b = 0;
        for (int64_t i = 0; i <= n; ++i) {
            int64_t b = 0;
            if (i < n) {
                int64_t v = diag[i] + off;
                b = v / width;
                if ((v % width) != 0 && (v < 0)) --b;  // floor like numpy
            }
            bool boundary = (i == n) || (i > 0 && (seg[i] != seg[i - 1] || b != prev_b));
            if (boundary) {
                int64_t len = i - run_start;
                for (int64_t j = run_start; j < i; ++j) {
                    if (grid == 0 || len > votes[j]) votes[j] = len;
                }
                run_start = i;
            }
            prev_b = b;
        }
    }
}

void peel_mask_c(int64_t* votes, int64_t n, const int64_t* lo,
                 const int64_t* hi, int64_t m) {
    if (n <= 0 || m <= 0) return;
    int32_t* mark = (int32_t*)calloc((size_t)n + 1, sizeof(int32_t));
    for (int64_t j = 0; j < m; ++j) {
        int64_t a = lo[j], b = hi[j];
        if (a < 0) a = 0;
        if (b > n) b = n;
        if (a < b) { mark[a] += 1; mark[b] -= 1; }
    }
    int64_t acc = 0;
    for (int64_t i = 0; i < n; ++i) {
        acc += mark[i];
        if (acc > 0) votes[i] = -1;
    }
    free(mark);
}

}  // extern "C"

extern "C" {

// interval_minmax_c: per-interval min/max of vals[lo_j : hi_j) (host_seed.py
// ::_interval_minmax spec — empty intervals yield (empty, -empty)). Work is
// the sum of interval sizes (cluster sizes), not the full array length the
// NumPy reduceat interleave pays.
void interval_minmax_c(const int64_t* vals, const int64_t* lo, const int64_t* hi,
                       int64_t m, int64_t empty, int64_t* mn, int64_t* mx) {
    for (int64_t j = 0; j < m; ++j) {
        int64_t vmn = empty, vmx = -empty;
        for (int64_t i = lo[j]; i < hi[j]; ++i) {
            int64_t v = vals[i];
            if (v < vmn) vmn = v;
            if (v > vmx) vmx = v;
        }
        mn[j] = vmn;
        mx[j] = vmx;
    }
}

}  // extern "C"
