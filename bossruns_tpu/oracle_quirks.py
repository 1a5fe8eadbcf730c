"""Bug-compatible ("reference_quirks") BOSS-RUNS mask oracle.

The default oracle (oracle.py) and engine (models/runs.py) fix three
documented reference defects (docs/PARITY.md "Deliberate deviations" 1-3).
BASELINE.md's parity clause, however, is "bit-identical strategy decisions vs
the reference" — this module is the reference-EXACT mask computer, including
its bugs, so masks can be compared bit-for-bit to what the reference stack
would write. Each quirk, with its source:

  Q1  ubar0 from benefit: update_wrapper builds ``smu_adj`` from ``benefit``
      (/root/reference/boss/runs/core.py:178-186 — `adjust_length(...,
      expanded=benefit)` twice), so find_strat_thread's
      ``ubar0 = np.sum(fhat * smu)`` actually sums fhat * benefit.
  Q3  merged-row drift: per-contig downsampled arrays carry ``len//100 + 1``
      rows (runs/reference.py:215-237); merge_benefit concatenates them, the
      global adjust_length trims the END to ``n_sites // 100`` rows, and
      _distribute_strategy slices contig j at offset Σ_{i<j} len_i//100
      (runs/core.py:125-155) — j rows EARLY, so contig j's strategy rows are
      shifted by j (row r receives the decision computed for row r - j).
  Q3b fhat drift (same family): read-start windows are ``L // 2000`` per
      contig (floor — readstartdist.py:26: tail starts fall outside
      np.histogram's range and are DROPPED), the merged fhat expands by a
      flat repeat(20) and a global end-trim to target_size
      (readstartdist.py:121-152), so contig boundaries drift here too.

(Q2, the rejected-reverse-read coverage bug, lives in the simulation data
plane — models/runs_sim.py `reference_quirks` — because it corrupts the
coverage INPUT, not this update pipeline.)

Everything else follows the reference literally: per-(site,barcode) freeze at
total coverage >= 30 (sequences.py:419-430), dropout zeroing once mean
coverage > 5 with threshold int(mean/8) (reference.py:148-178), per-contig
bucket switches of shape len//20000 + 1 via non-overlapping window sums +
adjust_length (reference.py:183-211), len_b==4 models zero the deletion
counts in place (sequences.py:415-417), the 'F'-order flatten and
try/except threshold indexing of find_strat_thread (sequences.py:565-649),
and rejected contigs ride along as 4-base dummies that still count toward
n_sites (reference.py:319-345).
"""
from __future__ import annotations

import numpy as np

from .oracle import fhat_pointmass, move_sum_fwd, move_sum_rev, site_scores
from .ops.model import ObservationModel

WINDOW = 100
BUCKET_SIZE = 20_000
FHAT_WINDOW = 2_000
MU = 400
TINY = np.finfo(np.float64).tiny


def adjust_length(original_size: int, expanded: np.ndarray) -> np.ndarray:
    """utils.py:206-226: pad with the array's own tail / trim the end."""
    lendiff = original_size - expanded.shape[0]
    if lendiff > 0:
        return np.append(expanded, expanded[-lendiff:], axis=0)
    if lendiff < 0:
        return expanded[: -abs(lendiff)]
    return expanded


def window_sum(arr: np.ndarray, w: int) -> np.ndarray:
    """utils.py:192-202: non-overlapping window sums, tail dropped."""
    return np.sum(arr[: (len(arr) // w) * w].reshape(-1, w), axis=1)


class _QContig:
    """Reference Contig state (runs/reference.py:20-118)."""

    def __init__(self, name: str, seq_int: np.ndarray, nb: int, rej: bool = False):
        self.name = name
        self.rej = rej
        self.seq_int = seq_int.astype(np.int64)
        self.length = int(seq_int.shape[0])
        self.nb = nb
        L = self.length
        self.coverage = np.zeros((L, 5, nb), np.uint16)
        self.change_mask = np.zeros(L, bool)  # per site (increment_coverage:141)
        self.bucket_switches = np.zeros((L // BUCKET_SIZE + 1, nb), bool)
        self.scores = None  # [L, nb] f64, lazily seeded from the zero-cov prior
        if rej:
            self.strat = np.zeros(1, bool)
            self.strat_df = np.zeros(1, bool)
        else:
            self.strat = np.ones((L // WINDOW, 2, nb), bool)
            # drift-free twin (see ReferenceQuirkOracle.step(also_drift_free))
            self.strat_df = np.ones((L // WINDOW, 2, nb), bool)


class ReferenceQuirkOracle:
    """Stateful reference-exact update pipeline over a set of contigs.

    contigs: {name: seq_int uint8 array} in fasta order. Contigs shorter
    than min_len are skipped; names in reject_refs become 4-base dummies
    with a shape-(1,) always-reject strategy (reference.py:319-338).
    """

    def __init__(
        self,
        contigs: dict[str, np.ndarray],
        model: ObservationModel,
        nb: int = 1,
        reject_refs: set[str] | frozenset = frozenset(),
        min_len: int = 100_000,
        bucket_threshold: float = 5.0,
        fhat_alpha: float = 1.0,
        fhat_p0: float = 0.1,
    ):
        self.model = model
        self.nb = nb
        self.bucket_threshold = bucket_threshold
        self.fhat_alpha, self.fhat_p0 = fhat_alpha, fhat_p0
        self.contigs: dict[str, _QContig] = {}
        for name, seq in contigs.items():
            if seq.shape[0] < min_len:
                continue
            if name in reject_refs:
                self.contigs[name] = _QContig(
                    name, np.array([0, 1, 2, 3], np.uint8), nb, rej=True
                )
            else:
                self.contigs[name] = _QContig(name, seq, nb)
        self.filt = {n: c for n, c in self.contigs.items() if not c.rej}
        # n_sites counts the rejected contigs' dummy 4-mers too
        # (reference.py:343-347 sums contig_lengths of ALL loaded contigs)
        self.n_sites = int(sum(c.length for c in self.contigs.values()))
        # read-start windows: floor(L / 2000) per contig (readstartdist.py:26)
        self.read_starts = {
            n: np.zeros((c.length // FHAT_WINDOW, 2))
            for n, c in self.filt.items()
        }
        self.fhat_target = int(sum(c.length for c in self.filt.values()) // WINDOW)

    # ----------------------------------------------------------- updates ----

    def _scores(self, c: _QContig) -> np.ndarray:
        """Dense per-(site,barcode) scores with freeze (sequences.py:398-455).

        The reference recomputes only changed sites from a lookup table, but
        score = f(coverage pattern, ref base) is history-free and coverage is
        monotone, so dense recomputation yields the identical array (a site
        frozen at >= 30 total stays >= 30; dropout zeros are recomputed by
        the miss path each batch anyway).
        """
        cov = c.coverage
        if self.model.len_b == 4:
            cov[:, 4, :] = 0  # in-place like sequences.py:415-417
        out = np.empty((c.length, self.nb))
        for b in range(self.nb):
            counts = cov[:, :, b].astype(np.int64)
            s, _e = site_scores(counts.astype(np.float64), c.seq_int, self.model)
            maxed = counts.sum(axis=1) >= 30
            out[:, b] = np.where(maxed, TINY, s)
        return out

    def _modify_scores(self, c: _QContig) -> None:
        """Dropout zeroing (reference.py:148-178): mean over ALL (site,
        barcode) coverage; int-cast threshold; row-wise (any barcode)."""
        covsum = c.coverage.sum(axis=1)  # [L, nb]
        if np.mean(covsum) > 5:
            threshold = int(np.mean(covsum) / 8)
            dropout = np.where(covsum <= threshold)[0]
            c.scores[dropout] = 0.0

    def _check_buckets(self, c: _QContig) -> None:
        """reference.py:183-211 literally, per barcode."""
        for b in range(self.nb):
            csum = c.coverage[:, :, b].sum(axis=1)
            cmean = window_sum(csum, BUCKET_SIZE) / BUCKET_SIZE
            cmean = adjust_length(c.bucket_switches.shape[0], cmean)
            c.bucket_switches[cmean >= self.bucket_threshold, b] = True

    def _benefits(self, c: _QContig, approx_ccl: np.ndarray):
        """Per-contig smu / additional benefit on len//100 + 1 rows
        (reference.py:215-269)."""
        rows = c.length // WINDOW + 1
        scores_ds = np.zeros((rows, self.nb))
        site_idx = np.arange(c.length) // WINDOW
        smu = np.zeros((rows, 2, self.nb))
        ben = np.zeros((rows, 2, self.nb))
        weights = np.arange(0.05, 1, 0.1)[::-1]
        ccl_ds = np.asarray(approx_ccl) // WINDOW
        for b in range(self.nb):
            np.add.at(scores_ds[:, b], site_idx, c.scores[:, b])
            smu[:, 0, b] = move_sum_fwd(scores_ds[:, b], MU // WINDOW)
            smu[:, 1, b] = move_sum_rev(scores_ds[:, b], MU // WINDOW)
            for i in range(10):
                w = int(ccl_ds[i])
                ben[:, 0, b] += weights[i] * move_sum_fwd(scores_ds[:, b], w)
                ben[:, 1, b] += weights[i] * move_sum_rev(scores_ds[:, b], w)
        ben = ben - smu
        ben[ben < 0] = 0.0
        return smu, ben

    def _fhat(self) -> np.ndarray:
        """Merged fhat posterior + flat repeat expansion + global end-trim
        (readstartdist.py:86-152): contig boundaries drift (Q3b)."""
        merged = np.concatenate(list(self.read_starts.values()))
        fh = fhat_pointmass(merged, alpha=self.fhat_alpha, p0=self.fhat_p0)
        fhat_exp = np.repeat(fh, FHAT_WINDOW // WINDOW, axis=0)
        fhat_exp = adjust_length(self.fhat_target, fhat_exp)
        s = fhat_exp.sum()
        if s != 0:
            fhat_exp = fhat_exp * (1.0 / s)  # on_target = 1
        return fhat_exp

    @staticmethod
    def _find_strat(benefit, smu, fhat, time_cost: float):
        """sequences.py:565-649 literally (F-order flatten, abs exponents,
        try/except threshold indexing). smu is ALREADY the quirked alias of
        benefit when called from step() (Q1)."""
        alpha, rho, mu = 300 // WINDOW, 300 // WINDOW, 400 // WINDOW
        tc = time_cost // WINDOW
        benefit_flat = benefit.flatten("F")
        nz = np.nonzero(benefit_flat)
        bnz = benefit_flat[nz]
        if bnz.size == 0:
            return np.ones(benefit.shape, bool), 0.0
        normaliser = np.max(bnz)
        _m, exponents = np.frexp(bnz / normaliser)
        expo = np.abs(exponents)
        bincounts = np.bincount(expo)
        used = np.nonzero(bincounts)[0]
        counts = bincounts[used]
        f_grid = np.bincount(expo, weights=fhat.flatten("F")[nz])
        f_mean = f_grid[used] / counts
        benefit_bin = np.power(2.0, -used.astype(np.float64)) * normaliser
        ubar0 = np.sum(fhat * smu)
        tbar0 = alpha + rho + mu
        cs_u = np.cumsum(benefit_bin * f_mean * counts) + ubar0
        cs_t = np.cumsum(tc * counts * f_mean) + tbar0
        strat_size = int(np.argmax(cs_u / cs_t)) + 1
        try:
            threshold = benefit_bin[strat_size]
        except IndexError:
            threshold = benefit_bin[-1]
        return benefit >= threshold, float(threshold)

    # -------------------------------------------------------------- step ----

    def increment(self, name: str, pos: np.ndarray, sym: np.ndarray,
                  bc: np.ndarray | None = None) -> None:
        """Scatter one batch's observations into a contig's coverage
        (reference.py:122-144). pos: site indices; sym: 0..4 symbol codes."""
        c = self.contigs.get(name)
        if c is None or c.rej:
            return
        tmp = np.zeros(c.coverage.shape, np.uint16)
        b = bc if bc is not None else np.zeros(pos.shape[0], np.int64)
        np.add.at(tmp, (pos, sym, b), 1)
        c.change_mask[:] = False
        c.change_mask[np.where(tmp)[0]] = True
        c.coverage += tmp

    def count_read_starts(self, starts_fwd: dict[str, list],
                          starts_rev: dict[str, list]) -> None:
        """np.histogram binning with floor-window range: tail read starts
        beyond n_windows*2000 are dropped (readstartdist.py:43-82)."""
        for cname, rs in self.read_starts.items():
            n_win = rs.shape[0]
            rng = (0, FHAT_WINDOW * n_win)
            rs[:, 0] += np.histogram(starts_fwd.get(cname, []), bins=n_win, range=rng)[0]
            rs[:, 1] += np.histogram(starts_rev.get(cname, []), bins=n_win, range=rng)[0]

    def _fhat_drift_free(self) -> np.ndarray:
        """fhat expansion WITHOUT the Q3b drift: each contig's windows expand
        to exactly len//100 rows (per-contig adjust) before the global
        normalisation — the layout the device engine uses."""
        merged = np.concatenate(list(self.read_starts.values()))
        fh = fhat_pointmass(merged, alpha=self.fhat_alpha, p0=self.fhat_p0)
        parts = []
        off = 0
        for n, c in self.filt.items():
            nw = self.read_starts[n].shape[0]
            exp = np.repeat(fh[off : off + nw], FHAT_WINDOW // WINDOW, axis=0)
            parts.append(adjust_length(c.length // WINDOW, exp))
            off += nw
        fhat_exp = np.concatenate(parts)
        s = fhat_exp.sum()
        if s != 0:
            fhat_exp = fhat_exp * (1.0 / s)
        return fhat_exp

    def step(self, approx_ccl: np.ndarray, time_cost: float,
             also_drift_free: bool = False):
        """One update_wrapper (runs/core.py:160-198) after increments +
        read-start counts. Returns the strategy dict as written to
        masks/boss.npz.

        also_drift_free=True additionally runs the SAME f64 scores/benefits
        through a drift-FREE layout (per-contig len//100 rows, true offsets,
        per-contig fhat expansion — Q3/Q3b removed, Q1 kept) into each
        contig's ``strat_df`` twin and returns (masks, masks_drift_free).
        The elementwise difference of the two mask sets is the POSITIVELY
        PREDICTED Q3/Q3b disagreement set: both pipelines share every input,
        so any cell where they differ is attributable to the layout drift
        and nothing else."""
        for c in self.filt.values():
            c.scores = self._scores(c)
            self._modify_scores(c)
        for c in self.filt.values():
            self._check_buckets(c)
        switched_on = any(c.bucket_switches.any() for c in self.contigs.values())
        if switched_on:
            fhat_exp = self._fhat()
            fhat_exp = np.repeat(fhat_exp[:, :, np.newaxis], self.nb, axis=2)
            per = {n: self._benefits(c, approx_ccl) for n, c in self.filt.items()}
            benefit = np.concatenate([per[n][1] for n in self.filt])
            target = self.n_sites // WINDOW
            benefit_adj = adjust_length(target, benefit)
            smu_adj = adjust_length(target, benefit)  # Q1: benefit, not smu
            fhat_adj = adjust_length(target, fhat_exp)
            strat, _thr = self._find_strat(benefit_adj, smu_adj, fhat_adj, time_cost)
            # Q3: distribute at Σ len//100 offsets into the (Σ len//100+1)-row
            # merged array — contig j's rows shifted j early (core.py:125-155)
            i = 0
            for n, c in self.filt.items():
                expand = BUCKET_SIZE // WINDOW
                buckets = np.repeat(c.bucket_switches, expand, axis=0)
                buckets = adjust_length(c.strat.shape[0], buckets)
                cstrat = strat[i: i + c.length // WINDOW, :]
                for b in range(self.nb):
                    c.strat[buckets[:, b], :, b] = cstrat[buckets[:, b], :, b]
                i += c.length // WINDOW
            if also_drift_free:
                # same scores/benefits, drift-free layout: per-contig trim to
                # len//100 rows, true offsets, per-contig fhat expansion
                ben_df = np.concatenate(
                    [per[n][1][: c.length // WINDOW] for n, c in self.filt.items()]
                )
                fhat_df = self._fhat_drift_free()
                fhat_df = np.repeat(fhat_df[:, :, np.newaxis], self.nb, axis=2)
                strat_d, _t = self._find_strat(ben_df, ben_df, fhat_df, time_cost)
                i = 0
                for n, c in self.filt.items():
                    expand = BUCKET_SIZE // WINDOW
                    buckets = np.repeat(c.bucket_switches, expand, axis=0)
                    buckets = adjust_length(c.strat_df.shape[0], buckets)
                    cstrat = strat_d[i : i + c.length // WINDOW, :]
                    for b in range(self.nb):
                        c.strat_df[buckets[:, b], :, b] = cstrat[buckets[:, b], :, b]
                    i += c.length // WINDOW
        masks = {n: c.strat.copy() for n, c in self.contigs.items()}
        if also_drift_free:
            return masks, {n: c.strat_df.copy() for n, c in self.contigs.items()}
        return masks
