"""All-vs-all / new-vs-pool overlap discovery on device.

Replacement for the reference's minimap2 subprocess calls
(`minimap2 -x ava-ont` and `-x map-ont -w5 -e0 -m100 -r2k`,
/root/reference/boss/aeons/sequences.py:538-622): a minimizer index is built
over the target pool, query sequences are seeded on device, and the top
diagonal clusters per strand become chain-extent overlap records — the same
approximate-coordinate PAF style minimap2 emits for ava (no base-level
extension), which is all miniasm-class classification needs.
"""
from __future__ import annotations

import logging

import numpy as np

from ..aligner import encode
from ..aligner.index import build_index_cached
from ..aligner.seed import DeviceIndex, seed_candidates

logger = logging.getLogger("bossruns")

GAP = 512  # invalid-code spacer between pool sequences (> DIAG_TOL so
# clusters never span two sequences)


class PoolIndex:
    """Minimizer index over a set of pool sequences (concatenated)."""

    def __init__(self, seqs: dict[str, str], k: int = 15, w: int = 10, max_occ: int = 32):
        self.names = list(seqs)
        self.lengths = np.array([len(seqs[n]) for n in self.names], np.int64)
        starts = np.concatenate([[0], np.cumsum(self.lengths + GAP)[:-1]]).astype(np.int64)
        self.starts = starts
        # assembled from per-sequence memoised scans: AEONS rebuilds this
        # index every batch over a mostly-unchanged pool, so only NEW
        # sequences pay the k-mer/window scan (bit-identical to the concat
        # scan, tests/test_pool_index_cache.py)
        self.host = build_index_cached(
            [seqs[n] for n in self.names], starts, k=k, w=w, max_occ=max_occ
        )
        self._dev: DeviceIndex | None = None
        self.k = k

    @property
    def dev(self) -> DeviceIndex:
        """Device copy, built lazily: host-seeded batches (the common case
        for working pools, see find_overlaps) never pay the index upload.

        Pad floors sized for a few-hundred-kb working pool; the 2x pad
        hysteresis absorbs batch-to-batch wobble and bigger pools grow the
        pad once per doubling. Keys dominate both the per-call H2D upload
        and the lookup sort-join volume, so an oversized floor taxes EVERY
        seeding call."""
        if self._dev is None:
            self._dev = DeviceIndex(self.host, min_keys_pad=1 << 17, min_pos_pad=1 << 18)
        return self._dev

    def locate(self, gpos: int) -> int:
        """Global concat position -> sequence index."""
        return int(np.searchsorted(self.starts, gpos, side="right") - 1)


# shape economy: every distinct (rows, L, index-pad) triple compiles its own
# seeding executable. Two coarse length buckets + a 256-row floor keep an entire
# AEONS experiment within a handful of executables; the extra padded compute
# is noise next to the index-sized sort-join. The 131072 bucket is
# HOST-ONLY (> AVA_DEVICE_MAX): ultralong reads keep their full length and
# anchor set there instead of being silently truncated to 32 kb — the
# vectorised host path has no compiled-shape constraint.
AVA_BUCKETS = (8192, 32768, 131072)
AVA_DEVICE_MAX = 32768
ROW_FLOOR = 256
#: host anchor-slot cap for the ultralong bucket (~2.2*L/(w+1) at 131 kb)
ULTRALONG_BUDGET = 1 << 15


def _bucketize(enc: list[np.ndarray]):
    order = np.argsort([e.shape[0] for e in enc], kind="stable")
    groups = []
    i = 0
    while i < len(order):
        ln = enc[order[i]].shape[0]
        b = next((x for x in AVA_BUCKETS if ln <= x), AVA_BUCKETS[-1])
        group = []
        while i < len(order):
            ln = enc[order[i]].shape[0]
            bb = next((x for x in AVA_BUCKETS if ln <= x), AVA_BUCKETS[-1])
            if bb != b or len(group) >= 2048:
                break
            group.append(int(order[i]))
            i += 1
        groups.append((b, group))
    return groups


#: host/device seeding dispatch thresholds. Host and device seeding are
#: bit-identical (tests/test_host_seed.py); the choice is pure performance.
#: A device ava call pays the index H2D upload, the kernel launch and a
#: D2H pull per bucket; vectorised host seeding serves working pools up to
#: the thresholds (every AEONS experiment short of a large metagenome) and
#: the device's sort-join beyond. The values date from an earlier
#: accelerator. Override per call with host=True/False.
HOST_MAX_MINIMIZERS = 8_000_000
HOST_MAX_QUERY_BASES = 64_000_000


def find_overlaps(
    queries: dict[str, str],
    pool_index: PoolIndex,
    min_votes: int = 4,
    ncand: int = 4,
    exclude_self: bool = True,
    merge: bool = False,
    host: bool | None = None,
):
    """Seed queries against the pool; yield overlap candidate rows.

    Returns dict of columnar arrays (qname/qlen/qstart/qend/rev/tname/tlen/
    tstart/tend/nmatch/blocklen/s1) with approximate chain-extent coords.

    host: run the seeding on host (aligner/host_seed.py) instead of the
    device kernel; None = auto by pool/query size. Identical results either
    way — the host mirror is pinned bit-identical to the device kernel.
    """
    from ..aligner.host_seed import host_seed_candidates

    qnames = list(queries)
    enc = [encode(queries[q]) for q in qnames]
    if host is None:
        host = (
            pool_index.host.n_minimizers <= HOST_MAX_MINIMIZERS
            and sum(e.shape[0] for e in enc) <= HOST_MAX_QUERY_BASES
        )
    rows: dict[str, list] = {k: [] for k in (
        "qname qlen qstart qend rev tname tlen tstart tend nmatch blocklen s1".split()
    )}
    k = pool_index.k
    qname_arr = np.array(qnames, dtype=object)
    name_arr = np.array(pool_index.names, dtype=object)
    for L, group in _bucketize(enc):
        # the ultralong bucket is host-only: device seeding shapes are a
        # compiled-cost knob, and truncating 100 kb reads to 32 kb turned
        # their dovetails into internal matches (round-5 fix)
        use_host = host or L > AVA_DEVICE_MAX
        if use_host:
            # reuse memoised minimizer scans when available (new reads were
            # just scanned for the pool index build): same anchors, skips
            # the per-query k-mer/window re-scan. Truncated reads (> L) and
            # memo misses fall back to the batch scan.
            from ..aligner.index import _digest, _memo_get
            from ..aligner.seed import anchor_budget

            w = pool_index.host.w
            budget = (anchor_budget(L, w, cap=ULTRALONG_BUDGET)
                      if L > AVA_DEVICE_MAX else None)
            scans = [
                _memo_get((_digest(queries[qnames[g]].encode()),
                           enc[g].shape[0], k, w))
                if enc[g].shape[0] <= L else None
                for g in group
            ]
            cands = host_seed_candidates(
                [enc[g][:L] for g in group], pool_index.host, ncand=ncand, L=L,
                pre_scans=scans if all(s is not None for s in scans) else None,
                budget=budget,
            )
            cands = {f: np.asarray(v) for f, v in cands.items()}
        else:
            rows_p = max(ROW_FLOOR, 1 << int(np.ceil(np.log2(max(len(group), 1)))))
            mat = np.full((rows_p, L), 4, np.int8)
            for r, g in enumerate(group):
                mat[r, : min(enc[g].shape[0], L)] = enc[g][:L]
            cands = seed_candidates(mat, pool_index.dev, ncand=ncand)
        nc = cands["votes"].shape[1]
        ng = len(group)
        # columnar candidate -> record conversion (no per-candidate Python)
        g_idx = np.repeat(np.asarray(group, np.int64), nc)          # [ng*nc]
        votes = np.asarray(cands["votes"][:ng]).ravel()
        keep = votes >= min_votes
        if not keep.any():
            continue
        g_idx, votes = g_idx[keep], votes[keep]
        tmin = np.asarray(cands["tmin"][:ng]).ravel()[keep]
        tmax = np.asarray(cands["tmax"][:ng]).ravel()[keep] + k
        qmin = np.asarray(cands["qmin"][:ng]).ravel()[keep]
        qmax = np.asarray(cands["qmax"][:ng]).ravel()[keep] + k
        rev = np.asarray(cands["strand"][:ng]).ravel()[keep]
        tid = np.searchsorted(pool_index.starts, tmin, side="right") - 1
        tname = name_arr[tid]
        qname = qname_arr[g_idx]
        qlen = np.array([enc[g].shape[0] for g in g_idx], np.int64)
        t0 = pool_index.starts[tid]
        tl = pool_index.lengths[tid]
        ts = tmin - t0
        te = np.minimum(tmax - t0, tl)
        qs = qmin
        qe = np.minimum(qmax, qlen)
        keep2 = te > ts
        if exclude_self:
            keep2 &= tname != qname
        if not keep2.any():
            continue
        span = np.minimum(qe - qs, te - ts)
        nmatch = np.minimum(votes * k, span)
        blocklen = np.maximum(qe - qs, te - ts)
        for field, vals in (
            ("qname", qname), ("qlen", qlen), ("qstart", qs), ("qend", qe),
            ("rev", rev), ("tname", tname), ("tlen", tl), ("tstart", ts),
            ("tend", te), ("nmatch", nmatch), ("blocklen", blocklen),
            ("s1", nmatch),
        ):
            rows[field].extend(vals[keep2].tolist())
    return merge_chains(rows) if merge else rows


def merge_chains(rows: dict[str, list], slope_tol: float = 0.03,
                 max_gap: int = 5000) -> dict[str, list]:
    """Merge split diagonal clusters of the same (query, target, strand)
    into one chain — minimap2-style bounded gap/drift joining.

    Indel drift fragments chains of long overlaps (> ~30 kb of accumulated
    drift) into multiple clusters (/root/reference relies on minimap2's
    chain merging here, boss/aeons/sequences.py:538-563). Two clusters
    belong to one alignment iff ALL of:

      * collinear: diagonals within max(256, slope_tol * joined span) —
        drift grows with span;
      * query-adjacent: the q gap between them is <= max_gap and they do
        not overlap by more than half the shorter fragment;
      * target-adjacent: same bound on the t gap (orientation-aware).

    The adjacency conditions are what round 4's diagonal-only merge lacked:
    without them, co-diagonal repeat clusters of the SAME pair fused into
    inflated spans that reclassified dovetails into containments and
    stalled unitig growth. With them, only true fragments of one alignment
    join, so the merge is safe for the assembly ava (enabled there since
    round 5) and a no-op for short reads.
    """
    n = len(rows["qname"])
    if n == 0:
        return rows
    order = sorted(
        range(n), key=lambda i: (rows["qname"][i], rows["tname"][i], rows["rev"][i],
                                 rows["qstart"][i])
    )
    merged: list[dict] = []
    for i in order:
        cand = {k: rows[k][i] for k in rows}
        if merged:
            prev = merged[-1]
            same = (
                prev["qname"] == cand["qname"]
                and prev["tname"] == cand["tname"]
                and prev["rev"] == cand["rev"]
            )
            if same:
                if cand["rev"]:
                    d_prev = prev["tend"] + prev["qstart"]
                    d_cand = cand["tend"] + cand["qstart"]
                    gap_t = prev["tstart"] - cand["tend"]
                else:
                    d_prev = prev["tstart"] - prev["qstart"]
                    d_cand = cand["tstart"] - cand["qstart"]
                    gap_t = cand["tstart"] - prev["tend"]
                gap_q = cand["qstart"] - prev["qend"]
                shorter = min(prev["qend"] - prev["qstart"],
                              cand["qend"] - cand["qstart"])
                span = max(prev["qend"], cand["qend"]) - min(prev["qstart"], cand["qstart"])
                collinear = abs(d_prev - d_cand) <= max(256, slope_tol * span)
                adjacent = (
                    -shorter // 2 <= gap_q <= max_gap
                    and -shorter // 2 <= gap_t <= max_gap
                )
                if collinear and adjacent:
                    prev["qstart"] = min(prev["qstart"], cand["qstart"])
                    prev["qend"] = max(prev["qend"], cand["qend"])
                    prev["tstart"] = min(prev["tstart"], cand["tstart"])
                    prev["tend"] = max(prev["tend"], cand["tend"])
                    prev["nmatch"] += cand["nmatch"]
                    prev["s1"] += cand["s1"]
                    prev["blocklen"] = max(
                        prev["qend"] - prev["qstart"], prev["tend"] - prev["tstart"]
                    )
                    continue
        merged.append(cand)
    return {k: [m[k] for m in merged] for k in rows}


def rows_to_records(rows: dict[str, list]):
    from ..io.paf import PafRecords

    n = len(rows["qname"])
    arr = lambda key, dt: np.array(rows[key], dtype=dt)
    return PafRecords(
        qname=arr("qname", object), qlen=arr("qlen", np.int64),
        qstart=arr("qstart", np.int64), qend=arr("qend", np.int64),
        rev=arr("rev", np.int8), tname=arr("tname", object),
        tlen=arr("tlen", np.int64), tstart=arr("tstart", np.int64),
        tend=arr("tend", np.int64), nmatch=arr("nmatch", np.int64),
        blocklen=arr("blocklen", np.int64), mapq=np.zeros(n, np.int64),
        align_score=arr("s1", np.int64), s1=arr("s1", np.int64),
        primary=np.ones(n, np.int8), cigars=[None] * n,
    )
