"""Read-to-reference aligner (mappy/minimap2 replacement).

Pipeline per batch:
  host encode -> device minimizer seeding + diagonal voting (seed.py, jitted)
  -> native banded-DP extension with CIGAR traceback (native/banded_align.cpp)
  -> PafRecords compatible with the rest of the data plane.

Replaces the reference's Mapper.map_sequences (boss/mapper.py:52-65): same
facade contract ({read_id: seq} -> alignment records, optional mu-truncation
for AEONS sims, min alignment length mu/2), but batched on device instead of
per-read C calls under a thread pool.

Parity note (SURVEY.md §7.6): exact minimap2 output equality is not a goal —
decision-level parity (same locus/strand, CIGAR-accurate coverage) is. Like
the reference's Mapper (which keeps every minimap2 record per read,
boss/mapper.py:52-65), reads can yield MULTIPLE alignments: the top voted
diagonal clusters are DP-extended; split (chimeric) reads produce several
primary records over disjoint query spans, repeat copies produce secondary
records. map_sequences drops secondaries by default — matching the
reference's primary-only parse (boss/paf.py:652-672) — while the live
mapper plugin keeps them so multi_on/multi_off decisions stay reachable
(boss/dynamic_readfish.py:229-247). mapq encodes uniqueness of a record's
diagonal cluster against competing clusters over the same query span.
"""
from __future__ import annotations

import logging

import numpy as np

from ..io.paf import PafRecords
from ..models.layout import GenomeLayout
from . import native
from .index import (K, MinimizerIndex, W, build_index, build_index_layout,
                    load_or_build_index)
from .seed import NCAND, SEED_FIELDS, DeviceIndex, seed_and_vote

logger = logging.getLogger("bossruns")

_ENC = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _ENC[_b] = _i
    _ENC[_b + 32] = _i
_RC = np.array([3, 2, 1, 0, 4], dtype=np.int8)

LENGTH_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)

#: fixed read-row count per length bucket (the big tier). Seeding shapes are
#: (rows, L) and every distinct shape costs a full XLA compile —
#: pow2-of-group-size rows made the shape universe depend on each corpus's
#: read-length mix, so every new workload recompiled. The row counts were
#: sized on an earlier accelerator; they are kept until a trace on this one
#: decides them. Three tiers per bucket (64-row small tier for tiny
#: calls, big//8 mid tier for few-hundred-read batches — AEONS decisions and
#: live chunk batches — this big tier otherwise, groups chunked at the big
#: tier) bound the universe at ~19 distinct shapes (the 32768 bucket's
#: tiers collapse into the small tier), all persistent-cache-stable across
#: runs. The big tier is sized for ~2M read positions per call so one call's
#: seeding stays a few hundred ms while batches of thousands of reads need
#: only a handful of pipelined dispatches; the mid tier keeps a 500-read
#: truncated batch from paying 8x row padding.
BUCKET_ROWS = {512: 4096, 1024: 2048, 2048: 1024, 4096: 512,
               8192: 256, 16384: 128, 32768: 64}
SMALL_ROWS = 64


def tier_rows(n: int, L: int) -> int:
    """Smallest row tier that fits n reads of bucket L."""
    big = BUCKET_ROWS[L]
    mid = max(SMALL_ROWS, big // 8)
    if n <= SMALL_ROWS:
        return SMALL_ROWS
    if n <= mid:
        return mid
    return big

#: overlapping-span competitor candidates are DP-extended (and may be emitted
#: as secondary records) only at >= this vote ratio vs the best candidate
#: (minimap2's pri_ratio analogue); disjoint-span (split-read) candidates
#: bypass the ratio — each segment is its own primary.
SECONDARY_RATIO = 0.5
#: max alignment records attempted per read
MAX_ALIGNS = NCAND
#: minimum query-span overlap fraction for two candidates to count as
#: alternatives of each other (vs segments of a split read)
OVERLAP_FRAC = 0.5


def encode(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode(), dtype=np.uint8)]


def make_aligner(layout: "GenomeLayout", backend: str = "auto",
                 host_max_sites: int = 512_000_000, **kw):
    """Production aligner factory: host or device seeding by genome size.

    backend: 'auto' | 'host' | 'device' (env BOSS_ALIGNER_BACKEND overrides).
    Both backends emit byte-identical records (tests/test_host_seed.py) —
    the choice is pure performance. Vectorised host seeding serves genomes
    up to host_max_sites; the device path keeps the index off the host and
    does not compete with host work (a live deployment shares its cores
    with a basecaller), so 'auto' picks it beyond. The cutoff dates from an
    earlier accelerator and is kept until a measurement on this one
    decides it.
    """
    import os

    backend = os.environ.get("BOSS_ALIGNER_BACKEND", backend)
    if backend == "device":
        return TpuAligner(layout, **kw)
    if backend == "host" or int(layout.lengths.sum()) <= host_max_sites:
        from .cpu_baseline import CpuAligner

        # threads at the core count, capped at 16: measured throughput is
        # flat from cores-1 to cores+2 on a 4-core host while a fixed 8
        # loses ~15% to oversubscription; the GIL-bound record-assembly
        # section means very wide pools (64-128 cores) can regress, so cap
        # until measured on a many-core host (ADVICE r4)
        kw.setdefault("threads", max(2, min(os.cpu_count() or 4, 16)))
        return CpuAligner(layout, **kw)
    return TpuAligner(layout, **kw)


def _overlap_frac(a: tuple[int, int], b: tuple[int, int]) -> float:
    """Overlap of two query intervals as a fraction of the shorter one."""
    inter = min(a[1], b[1]) - max(a[0], b[0])
    if inter <= 0:
        return 0.0
    return inter / max(1, min(a[1] - a[0], b[1] - b[0]))


class TpuAligner:
    def __init__(
        self,
        layout: GenomeLayout,
        k: int = K,
        w: int = W,
        max_occ: int = 64,
        min_votes: int = 4,
        max_divergence: float = 0.35,
        mu: int = 400,
        threads: int = 8,
        source: str | None = None,
    ):
        """source: path of the fasta the layout came from — enables the
        on-disk index cache (the reference's .mmi analogue)."""
        self.layout = layout
        self.mu = mu
        self.min_votes = min_votes
        self.max_divergence = max_divergence
        self.threads = threads
        self.target = np.where(layout.site_valid(), layout.seq_int, 4).astype(np.int8)
        logger.info("building minimizer index")
        # in-memory layouts (source=None, e.g. AEONS decision contigs) build
        # from per-contig memoised scans: only changed contigs re-scan
        self.index: MinimizerIndex = (
            build_index_layout(layout, k=k, w=w, max_occ=max_occ)
            if source is None
            else load_or_build_index(
                layout.seq_int, layout.site_valid(), source, k=k, w=w, max_occ=max_occ
            )
        )
        self.dev_index = DeviceIndex(self.index)
        logger.info(f"index: {self.index.n_minimizers} minimizers, "
                    f"{self.index.keys.shape[0]} distinct k-mers")
        # host tables for coordinate translation
        self._block_starts = layout.offsets.astype(np.int64)
        self._block_ends = (layout.offsets + layout.lengths).astype(np.int64)

    def load_index(self, fasta: str) -> None:
        """Rebuild the index from a new fasta (AEONS contig hot-swap —
        the readfish side calls this when contigs/aeons.fa changes,
        dynamic_readfish.py:113-139)."""
        from ..models.layout import build_layout
        from ..models.runs_sim import load_reference_contigs

        layout = build_layout(load_reference_contigs(fasta), min_len=500)
        self.__init__(
            layout,
            k=self.index.k,
            w=self.index.w,
            min_votes=self.min_votes,
            max_divergence=self.max_divergence,
            mu=self.mu,
            threads=self.threads,
        )

    # ----------------------------------------------------------- seeding ----

    def _seed_bucket_dispatch(self, enc_reads: list[np.ndarray]):
        """Dispatch the seeding kernel for one bucket WITHOUT pulling the
        result: jit dispatch is async, so several buckets' kernels queue on
        the device while the host runs banded DP on earlier buckets
        (map_sequences pipelines pull->jobs->DP per bucket)."""
        from .seed import _seed_topn_jit, anchor_budget, pack_reads

        lens = np.array([e.shape[0] for e in enc_reads], np.int32)
        L = 0
        for b in LENGTH_BUCKETS:
            if lens.max(initial=0) <= b:
                L = b
                break
        L = L or LENGTH_BUCKETS[-1]
        # fixed row tiers per bucket (see tier_rows): the caller chunks
        # groups at BUCKET_ROWS[L], so len(enc_reads) always fits
        rows = tier_rows(len(enc_reads), L)
        assert len(enc_reads) <= rows, (len(enc_reads), rows, L)
        mat = np.full((rows, L), 4, np.int8)
        for r, e in enumerate(enc_reads):
            mat[r, : min(e.shape[0], L)] = e[:L]
        di = self.dev_index
        return _seed_topn_jit(
            pack_reads(mat), di.keys, di.pos_packed,
            di.k, di.w, anchor_budget(L, di.w), L, NCAND,
        )

    @staticmethod
    def _pull_seeds(out_dev, n: int):
        """Block on one bucket's kernel and unpack its
        [len(SEED_FIELDS) * NCAND, rows] result to field -> [n, NCAND]."""
        packed = np.asarray(out_dev)
        nf = len(SEED_FIELDS)
        return {
            f: np.stack([packed[c * nf + i][:n] for c in range(NCAND)], axis=1)
            for i, f in enumerate(SEED_FIELDS)
        }

    def _seed_bucket(self, enc_reads: list[np.ndarray]):
        return self._pull_seeds(self._seed_bucket_dispatch(enc_reads), len(enc_reads))

    # ----------------------------------------------------------- mapping ----

    def map_sequences(self, sequences: dict[str, str], trunc: bool = False,
                      min_len: int | None = None,
                      all_records: bool = False) -> PafRecords:
        """Align a batch; returns records with target-forward CIGARs.

        trunc: align only the first mu bases (AEONS sim truncation,
        mapper.py:60-62). min_len: drop alignments spanning less target than
        this (defaults to mu/2 like mapper.py:64). all_records: keep
        secondary alignments (primary flag 0) — by default they are dropped,
        matching the reference's primary-only PAF parse (boss/paf.py:652-672);
        split-read segments are primary and always kept.
        """
        min_len = int(self.mu / 2) if min_len is None else min_len
        rids = list(sequences)
        if not rids:
            return _empty_records()
        # ONE encode pass over the concatenated batch (a per-read Python
        # loop cost ~17 ms at 4000 reads); enc entries are views
        parts = [sequences[r][: self.mu] if trunc else sequences[r] for r in rids]
        codes_cat = _ENC[np.frombuffer("".join(parts).encode(), np.uint8)]
        offs = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
        enc = [codes_cat[offs[i]: offs[i + 1]] for i in range(len(parts))]
        # bucket by length to bound padded shapes. Dispatch EVERY bucket's
        # seeding kernel up front (async jit dispatch — they queue on the
        # device), then pull/extend per bucket: the host's banded DP on
        # bucket i overlaps the device seeding of buckets i+1.. .
        order = np.argsort([e.shape[0] for e in enc], kind="stable")
        pend = []
        i = 0
        while i < len(order):
            j = i
            Lmax = None
            group = []
            while j < len(order):
                ln = enc[order[j]].shape[0]
                b = next((x for x in LENGTH_BUCKETS if ln <= x), LENGTH_BUCKETS[-1])
                if Lmax is None:
                    Lmax = b
                if b != Lmax or len(group) >= BUCKET_ROWS[Lmax]:
                    break
                group.append(order[j])
                j += 1
            pend.append((group, self._seed_bucket_dispatch([enc[g] for g in group])))
            i = j

        rows = {k: [] for k in (
            "qname qlen qstart qend rev tname tlen tstart tend nmatch blocklen mapq "
            "align_score s1 primary".split()
        )}
        cigs = []
        for group, out_dev in pend:
            seeds = self._pull_seeds(out_dev, len(group))
            results = {
                g: {k: v[slot] for k, v in seeds.items()}
                for slot, g in enumerate(group)
            }
            self._extend_bucket(rids, enc, results, min_len, rows, cigs,
                                all_records)

        def cat(f, dt):
            if not rows[f]:
                return (np.array([], dtype=object) if dt is object
                        else np.zeros(0, dt))
            return np.concatenate(rows[f]).astype(dt)

        return PafRecords(
            qname=cat("qname", object), qlen=cat("qlen", np.int64),
            qstart=cat("qstart", np.int64), qend=cat("qend", np.int64),
            rev=cat("rev", np.int8), tname=cat("tname", object),
            tlen=cat("tlen", np.int64), tstart=cat("tstart", np.int64),
            tend=cat("tend", np.int64), nmatch=cat("nmatch", np.int64),
            blocklen=cat("blocklen", np.int64), mapq=cat("mapq", np.int64),
            align_score=cat("align_score", np.int64), s1=cat("s1", np.int64),
            primary=cat("primary", np.int8), cigars=cigs,
        )

    def _candidate_plan(self, seeds: dict, mlen: np.ndarray, min_len: int):
        """Vectorised candidate selection + query windows + mapq for a whole
        bucket: all [n, NCAND] numpy (the former per-read scalar loops cost
        ~40% of a 4000-read truncated batch in Python int() extraction).

        Semantics (unchanged from the scalar form):
        - candidate 0 qualifies if voted enough; later candidates qualify as
          split-read segments (disjoint query span — each its own primary) or
          as repeat alternatives at >= SECONDARY_RATIO of the best vote count
          (minimap2's pri_ratio analogue). Peel order is descending votes, so
          a candidate only competes with LOWER-indexed ones.
        - query windows: a lone candidate (or overlapping alternatives)
          extends the FULL read — seed spans undershoot the true alignment by
          hundreds of bases at ONT error rates. Only >=2 DISJOINT qualifying
          candidates partition the query, at the midpoints between adjacent
          seed spans (a full-read band cannot absorb a multi-kb soft clip).
        - mapq: uniqueness vs the best OTHER voted cluster over >=
          OVERLAP_FRAC of the same query span; split segments do not lower
          each other's mapq (minimap2's per-chain mapq).

        Returns dict of [n, NCAND] arrays: use, qs, qe, half, ts_pred, ws,
        we, mapq (mapq for ALL voted candidates, use/windows for selected).
        """
        k = self.index.k
        votes = seeds["votes"].astype(np.int64)        # [n, C]
        n, C = votes.shape
        span_lo = seeds["qmin"].astype(np.int64)
        span_hi = np.minimum(mlen[:, None], seeds["qmax"].astype(np.int64) + k)
        voted = votes >= self.min_votes
        # peel emits descending votes; a sentinel row after the first
        # below-threshold candidate never qualifies (matches the loop break)
        voted &= np.cumprod(voted, axis=1).astype(bool)

        # pairwise overlap fraction of seed spans [n, C, C]
        inter = (np.minimum(span_hi[:, :, None], span_hi[:, None, :])
                 - np.maximum(span_lo[:, :, None], span_lo[:, None, :]))
        shorter = np.maximum(
            1, np.minimum((span_hi - span_lo)[:, :, None],
                          (span_hi - span_lo)[:, None, :])
        )
        ovl = np.maximum(inter, 0) / shorter >= OVERLAP_FRAC  # [n, C, C]

        # qualification, in candidate order: c competes against SELECTED
        # lower candidates. Selection of c depends only on earlier columns,
        # so resolve the C columns sequentially (C=4 — four numpy passes).
        use = np.zeros((n, C), bool)
        use[:, 0] = voted[:, 0]
        ratio_ok = votes >= SECONDARY_RATIO * votes[:, :1]
        for c in range(1, C):
            prev_ov = (ovl[:, c, :c] & use[:, :c]).any(axis=1)
            use[:, c] = voted[:, c] & (~prev_ov | ratio_ok[:, c])
        # MAX_ALIGNS cap (= NCAND; guard stays for smaller caps)
        if MAX_ALIGNS < C:
            use &= np.cumsum(use, axis=1) <= MAX_ALIGNS

        # query windows: midpoint cuts toward DISJOINT qualifying siblings
        ctr = span_lo + span_hi
        disj = use[:, :, None] & use[:, None, :] & ~ovl
        np.einsum("ncc->nc", disj)[:] = False  # no self-pairing
        left_sib = disj & (ctr[:, None, :] < ctr[:, :, None])   # sibling c2 left of c
        right_sib = disj & ~(ctr[:, None, :] < ctr[:, :, None])
        right_sib &= disj  # keep only real siblings
        # qs = max over left siblings of min(span_lo_c, (span_hi_2+span_lo_c)//2)
        cut_l = np.minimum(span_lo[:, :, None],
                           (span_hi[:, None, :] + span_lo[:, :, None]) // 2)
        qs = np.max(np.where(left_sib, cut_l, 0), axis=2)
        cut_r = np.maximum(span_hi[:, :, None],
                           (span_hi[:, :, None] + span_lo[:, None, :]) // 2)
        qe = np.min(np.where(right_sib, cut_r, mlen[:, None, None]), axis=2)
        slen = qe - qs
        # overhang eligibility counts the pre-slen-filter selection (the
        # scalar form sized bands against every sibling in the list, even
        # one later dropped for a short window)
        multi = use.sum(axis=1) > 1
        use = use & (slen >= 50)

        # band: observed indel drift + margin (+ window overhang past the
        # seeds for split segments, so a junction flank can soft-clip)
        overhang = np.where(
            multi[:, None] & ((qs > 0) | (qe < mlen[:, None])),
            np.maximum(np.maximum(span_lo - qs, qe - span_hi), 0), 0,
        )
        dspan = seeds["dspan"].astype(np.int64)
        half = np.clip(dspan // 2 + 48 + (slen * 0.005).astype(np.int64)
                       + overhang, 64, 1024).astype(np.int64)

        # diagonal -> predicted target start; clamp to the contig block
        strand = seeds["strand"].astype(np.int64)
        bkey = seeds["bkey"].astype(np.int64)
        ts_pred = np.where(strand == 0, bkey + qs, bkey - qe + k)
        cid = np.searchsorted(self._block_starts, np.maximum(ts_pred, 0),
                              side="right") - 1
        cid = np.clip(cid, 0, len(self.layout.names) - 1)
        ws = np.maximum(self._block_starts[cid], ts_pred - half - 16)
        we = np.minimum(self._block_ends[cid], ts_pred + slen + half + 16)
        use &= (we - ws) >= min_len

        # mapq for every voted candidate: best competing vote over the span
        comp = ovl & (votes > 0)[:, None, :]
        np.einsum("ncc->nc", comp)[:] = False
        second = np.max(np.where(comp, votes[:, None, :], 0), axis=2)
        uniq = 1.0 - np.minimum(1.0, second / np.maximum(1, votes))
        mapq = np.where(votes >= 2 * self.min_votes,
                        np.minimum(60, 60 * uniq), 30 * uniq).astype(np.int64)
        return dict(use=use, qs=qs, qe=qe, half=half, ts_pred=ts_pred,
                    ws=ws, we=we, mapq=mapq)

    def _extend_bucket(self, rids, enc, results, min_len, rows, cigs,
                       all_records: bool = False) -> None:
        """Banded-DP extension + record assembly for one bucket's seeds
        (host work — runs while later buckets' seeding kernels execute on
        the device)."""
        group = list(results)
        if not group:
            return
        seeds = {
            f: np.stack([results[g][f] for g in group])
            for f in SEED_FIELDS
        }  # [n, NCAND]
        mlen = np.array([enc[g].shape[0] for g in group], np.int64)
        plan = self._candidate_plan(seeds, mlen, min_len)
        use = plan["use"] & (mlen >= 50)[:, None]
        job_r, job_c = np.nonzero(use)           # bucket-local (row, cand)
        if job_r.shape[0] == 0:
            return
        group_arr = np.asarray(group, np.int64)
        job_g = group_arr[job_r]                 # global read index
        job_qs = plan["qs"][job_r, job_c].astype(np.int64)
        job_qe = plan["qe"][job_r, job_c].astype(np.int64)
        job_strand = seeds["strand"][job_r, job_c].astype(np.int64)
        segs = []
        for g, qs_i, qe_i, st in zip(job_g, job_qs, job_qe, job_strand):
            seg = enc[g][qs_i:qe_i]
            if st:
                seg = _RC[np.minimum(seg, 4)][::-1]
            segs.append(seg)

        q_cat = np.concatenate(segs).astype(np.int8)
        slen_j = (job_qe - job_qs).astype(np.int64)
        q_off = np.concatenate([[0], np.cumsum(slen_j)]).astype(np.int64)
        win_s = plan["ws"][job_r, job_c].astype(np.int64)
        win_e = plan["we"][job_r, job_c].astype(np.int64)
        pad = np.maximum(plan["ts_pred"][job_r, job_c] - win_s, 0).astype(np.int32)
        half = plan["half"][job_r, job_c].astype(np.int32)
        cost, tstart, tend, cigars = native.align_batch(
            q_cat, q_off, self.target, win_s, win_e, pad, half, self.threads
        )

        # ---- vectorised record assembly (the former per-job scalar loop
        # cost ~50% of a 4000-read truncated pass in pure Python) ----------
        nj = job_r.shape[0]
        sizes = np.array([c.size for c in cigars], np.int64)
        coff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        if coff[-1] == 0:  # every extension failed: no record to assemble
            return
        ok = (cost >= 0) & (sizes > 0)
        ok &= cost <= self.max_divergence * np.maximum(slen_j, 1)
        # strip leading/trailing insertion runs (query-only) into soft clips;
        # traceback merges runs, so each end has at most one I run
        cig_cat = np.concatenate(cigars)
        lens_all = (cig_cat >> 4).astype(np.int64)
        ops_all = (cig_cat & 0xF).astype(np.int64)
        first_i = np.minimum(coff[:-1], coff[-1] - 1)
        last_i = np.maximum(coff[1:] - 1, 0)
        head_ins = ok & (ops_all[first_i] == 1)
        s_al = np.where(head_ins, lens_all[first_i], 0)
        lo = coff[:-1] + head_ins
        tail_ins = ok & (coff[1:] - 1 >= lo) & (ops_all[last_i] == 1)
        e_clip = np.where(tail_ins, lens_all[last_i], 0)
        hi = coff[1:] - tail_ins
        ok &= hi > lo
        ts = tstart.astype(np.int64)
        te = tend.astype(np.int64)
        ok &= (te - ts) >= min_len
        cid = np.searchsorted(self._block_starts, ts, side="right") - 1
        cid_c = np.clip(cid, 0, len(self._block_ends) - 1)
        be = self._block_ends[cid_c]
        ok &= (cid >= 0) & (ts < be) & (te <= be)  # padding cross => bogus
        # per-job op-class sums over the stripped [lo, hi) cigar ranges
        pos = np.arange(coff[-1], dtype=np.int64)
        pos_job = np.repeat(np.arange(nj, dtype=np.int64), sizes)
        inrange = (pos >= lo[pos_job]) & (pos < hi[pos_job])
        key = pos_job * 3 + np.minimum(ops_all, 2)
        sums = np.bincount(
            key[inrange], weights=lens_all[inrange], minlength=nj * 3
        ).astype(np.int64).reshape(nj, 3)
        n_m, n_i, n_d = sums[:, 0], sums[:, 1], sums[:, 2]
        mism = cost.astype(np.int64) - (n_i + n_d + s_al + e_clip)
        nmatch = np.maximum(0, n_m - np.maximum(0, mism))
        # segment-local clips -> global read coordinates (rev segments were
        # RC'd, so their head clip sits at the segment's END)
        qstart = np.where(job_strand == 1, job_qs + e_clip, job_qs + s_al)
        qend = np.where(job_strand == 1, job_qe - s_al, job_qe - e_clip)
        mapq_j = plan["mapq"][job_r, job_c].astype(np.int64)
        s1_j = seeds["votes"][job_r, job_c].astype(np.int64)
        ascore = 2 * nmatch - cost.astype(np.int64)
        off_j = self._block_starts[cid_c]

        keep = np.flatnonzero(ok)
        if keep.shape[0] == 0:
            return
        # primary flags: best record by (mapq, AS) per read is primary;
        # further records are primary (split-read/supplementary) iff their
        # query span is disjoint from every primary so far, else secondary.
        # Single-record reads (the vast majority) short-circuit to primary.
        primary = np.ones(keep.shape[0], np.int8)
        kg = job_g[keep]
        counts = np.bincount(kg, minlength=int(job_g.max()) + 1)
        multi_reads = np.flatnonzero(counts > 1)
        for g in multi_reads:
            idx = np.flatnonzero(kg == g)       # positions within keep
            j = keep[idx]
            order = sorted(range(idx.shape[0]),
                           key=lambda i: (mapq_j[j[i]], ascore[j[i]]),
                           reverse=True)
            prim_spans: list[tuple[int, int]] = []
            for i in order:
                span = (int(qstart[j[i]]), int(qend[j[i]]))
                if not prim_spans or all(
                    _overlap_frac(span, s) < OVERLAP_FRAC for s in prim_spans
                ):
                    primary[idx[i]] = 1
                    prim_spans.append(span)
                else:
                    primary[idx[i]] = 0
        if not all_records:
            keep = keep[primary == 1]
            primary = primary[primary == 1]
        if keep.shape[0] == 0:
            return

        names_arr = np.asarray(self.layout.names, dtype=object)
        lengths_arr = np.asarray(self.layout.lengths, np.int64)
        rids_arr = np.asarray(rids, dtype=object)
        rows["qname"].append(rids_arr[job_g[keep]])
        rows["qlen"].append(mlen[job_r[keep]].astype(np.int64))
        rows["qstart"].append(qstart[keep])
        rows["qend"].append(qend[keep])
        rows["rev"].append(job_strand[keep].astype(np.int8))
        rows["tname"].append(names_arr[cid_c[keep]])
        rows["tlen"].append(lengths_arr[cid_c[keep]])
        rows["tstart"].append(ts[keep] - off_j[keep])
        rows["tend"].append(te[keep] - off_j[keep])
        rows["nmatch"].append(nmatch[keep])
        rows["blocklen"].append((n_m + n_i + n_d)[keep])
        rows["mapq"].append(mapq_j[keep])
        rows["align_score"].append(ascore[keep])
        rows["s1"].append(s1_j[keep])
        rows["primary"].append(primary)
        for j in keep:
            cigs.append(cig_cat[lo[j]:hi[j]])  # packed uint32 views


def _empty_records() -> PafRecords:
    z = np.zeros(0, np.int64)
    return PafRecords(
        qname=np.array([], dtype=object), qlen=z, qstart=z, qend=z,
        rev=np.zeros(0, np.int8), tname=np.array([], dtype=object),
        tlen=z, tstart=z, tend=z, nmatch=z, blocklen=z, mapq=z,
        align_score=z, s1=z, primary=np.zeros(0, np.int8), cigars=[],
    )
