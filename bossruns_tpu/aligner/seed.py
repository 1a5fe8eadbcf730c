"""On-device seed lookup + diagonal voting: the device half of the aligner.

Replaces minimap2's seed-and-chain stage (the reference calls mappy's C
implementation per read in a thread pool, /root/reference/boss/mapper.py:69-127).
Here the whole batch is one jitted program over a padded [R, L] read matrix:

  1. 2-bit pack k-mers (k shifted adds) + validity via rolling max,
  2. 31-bit mix hash, two rolling mins (lax.reduce_window) select canonical
     minimizers — identical (k, w, hash) scheme to the host-built index so
     read and reference select the same minimizers,
  3. a fixed per-read budget of minimizer slots is compacted by argsort,
  4. binary search (searchsorted) into the sorted index keys, gather up to C
     occurrences per minimizer -> anchors,
  5. per-strand diagonal voting: anchors vote for their diagonal within a
     tolerance T via per-read sorted searchsorted counts; the best anchor
     yields (strand, predicted target start, votes); the runner-up on a
     distinct diagonal yields a mapq-style uniqueness signal.

Everything is int32 (no x64 mode needed); genomes up to 2^31 sites. The
winning candidate window goes to the native banded-DP extension
(native/banded_align.cpp) for a base-exact CIGAR.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .index import K, MinimizerIndex, W

ANCHOR_BUDGET = 1024   # minimizer slots kept per read (A)
OCC_CAP = 4            # index occurrences used per minimizer (C)
DIAG_TOL = 256         # diagonal clustering tolerance (bases)
SENTINEL = np.int32(2**31 - 2**24)  # beyond any real diagonal


def _pow2(n: int, floor: int = 1 << 10) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


# process-wide pad hysteresis: an AEONS experiment rebuilds the pool/contig
# index every batch with a wobbling minimizer count; each distinct padded
# shape costs a full XLA compile of the seeding kernels. Reuse the previous
# pad when it is within 2x of the need (so
# wobble across a pow2 boundary keeps one shape) but never inflate beyond
# 2x — the sort-join lookup cost scales with the padded index size, so a
# small index must not inherit a huge previous pad.
_PAD_PREV = {"keys": 1 << 10, "pos": 1 << 10}


def _pad_hysteresis(n: int, which: str) -> int:
    pad = _pow2(max(n, 1))
    prev = _PAD_PREV[which]
    if pad < prev <= 2 * pad:
        return prev
    _PAD_PREV[which] = pad
    return pad


PACK_PAD = np.uint32(0xFFFFFFFF)  # pos_packed slot with no occurrence


class DeviceIndex:
    """Device-resident copy of the minimizer index (int32).

    Arrays pad to power-of-two lengths (with 2x-bounded hysteresis, see
    _pad_hysteresis) so rebuilt indexes (AEONS rebuilds the pool index every
    batch) hit the jit cache instead of recompiling the seeding kernels: pad
    keys are INT32_MAX sentinels (> any 30-bit k-mer code, so lookups never
    match).

    Occurrences live in ``pos_packed`` [U_pad, OCC_CAP] uint32 =
    (position << 1) | strand, PACK_PAD where a key has fewer occurrences:
    a fixed stride per key turns the anchor fetch into ONE gather with a
    contiguous 16-byte inner slice indexed by the key's rank from the
    sort-join, instead of a CSR layout's per-element base+occ gathers."""

    def __init__(self, idx: MinimizerIndex, min_keys_pad: int = 1,
                 min_pos_pad: int = 1):
        """min_*_pad: caller-supplied pad floors — callers that rebuild the
        index repeatedly around a known working size (the AEONS pool) pin the
        pad so growth through that size never changes shapes."""
        assert idx.positions.max(initial=0) < 2**31
        self.k, self.w = idx.k, idx.w
        nk = idx.keys.shape[0]
        nkp = _pad_hysteresis(max(nk, min_keys_pad), "keys")
        keys = np.full(nkp, np.iinfo(np.int32).max, np.int32)
        keys[:nk] = idx.keys
        packed = np.full((nkp, OCC_CAP), PACK_PAD, np.uint32)
        off = idx.offsets
        pos_u = idx.positions.astype(np.uint32)
        str_u = idx.strands.astype(np.uint32)
        cnt = np.minimum(off[1:] - off[:-1], OCC_CAP).astype(np.int64)
        for c in range(OCC_CAP):
            rows = np.flatnonzero(cnt > c)
            src = off[rows] + c
            packed[rows, c] = (pos_u[src] << np.uint32(1)) | str_u[src]
        # _pos_pad kept so AEONS' per-batch index rebuilds stay shape-stable
        self._pos_pad = _pad_hysteresis(
            max(idx.positions.shape[0], min_pos_pad), "pos"
        )
        self.pos_packed = jnp.asarray(packed)
        self.keys = jnp.asarray(keys, jnp.int32)        # 30-bit codes
        self.n_keys = nk


def pack_reads(mat: np.ndarray) -> np.ndarray:
    """[R, L] int8 base codes (0..4) -> [R, L//8] uint32, 4 bits per base.

    The padded read matrix is the seeding stage's host->device payload;
    4 bits per base quarter its bytes and keep the N/pad code (4) exact.
    L must be a multiple of 8 (LENGTH_BUCKETS are)."""
    r, L = mat.shape
    assert L % 8 == 0, L
    u = mat.astype(np.uint8).reshape(r, L // 8, 8).astype(np.uint32)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, None, :]
    return np.bitwise_or.reduce(u << shifts, axis=2)


def unpack_reads(packed, L: int):
    """Device-side inverse of pack_reads: [R, L//8] uint32 -> [R, L] int8.
    Elementwise shifts/masks — XLA fuses the decode into the k-mer scan."""
    shifts = (jnp.arange(8, dtype=jnp.uint32) * 4)[None, None, :]
    x = (packed[:, :, None] >> shifts) & jnp.uint32(0xF)
    return x.reshape(packed.shape[0], L).astype(jnp.int8)


def _rolling_min(x, w):
    init = np.asarray(np.iinfo(np.int32).max, dtype=x.dtype)
    return jax.lax.reduce_window(x, init, jax.lax.min, (1, w), (1, 1), "valid")


def _rolling_max(x, w):
    init = np.asarray(np.iinfo(np.int32).min, dtype=x.dtype)
    return jax.lax.reduce_window(x, init, jax.lax.max, (1, w), (1, 1), "valid")


def _hash31(x):
    """31-bit selection hash; MUST match aligner.index.selection_hash."""
    h = x.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x45D9F3B)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x45D9F3B)
    h = h ^ (h >> 16)
    return (h >> 1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "w"))
def read_minimizers(reads, k: int = K, w: int = W):
    """Canonical minimizers of a padded read matrix.

    reads: [R, L] int8 codes (0..3, >=4 pad/N).
    Returns (canonical [R, Lk] int32, strand [R, Lk] int32, is_min bool).
    """
    r, L = reads.shape
    n = L - k + 1
    c = reads.astype(jnp.int32)
    fwd = jnp.zeros((r, n), jnp.int32)
    rc = jnp.zeros((r, n), jnp.int32)
    for j in range(k):
        fwd = (fwd << 2) | (c[:, j : j + n] & 3)
        rc = (rc << 2) | (3 - (c[:, k - 1 - j : k - 1 - j + n] & 3))
    valid = _rolling_max(c, k) < 4
    canonical = jnp.minimum(fwd, rc)
    strand = (rc < fwd).astype(jnp.int32)
    valid = valid & (fwd != rc)
    hmax = jnp.iinfo(jnp.int32).max
    h = jnp.where(valid, _hash31((canonical ^ (canonical >> 15)).astype(jnp.uint32)), hmax)
    pad_hi = jnp.full((r, w - 1), hmax, jnp.int32)
    wmin = _rolling_min(jnp.concatenate([h, pad_hi], axis=1), w)
    m2 = _rolling_min(jnp.concatenate([pad_hi, wmin], axis=1), w)
    is_min = valid & (h == m2)
    return canonical, strand, is_min


@partial(jax.jit, static_argnames=("budget",))
def compact_minimizers(canonical, strand, is_min, budget: int = ANCHOR_BUDGET):
    """Keep up to `budget` minimizer slots per read (position-stable)."""
    r, n = canonical.shape
    posidx = jax.lax.broadcasted_iota(jnp.int32, (r, n), 1)
    sort_key = jnp.where(is_min, posidx, n + posidx)
    order = jnp.argsort(sort_key, axis=1)[:, :budget]
    take = lambda arr: jnp.take_along_axis(arr, order, axis=1)
    return take(canonical), take(strand), take(posidx), take(is_min)


def _lookup_join(keys, ck, valid):
    """Gather-free index lookup via sort-join.

    Joins the sorted index keys with the query k-mers through one
    multi-operand sort + cumulative maxima instead of per-query
    binary-search gathers. Carried payloads:
    the key's RANK (its row in the sorted key table — monotone, so cummax
    propagates the last key <= query) and the key value itself for the
    exact-match test. The rank then indexes pos_packed's fixed-stride rows.

    keys [U] sorted int32 (pad INT32_MAX); ck [N] int32 queries;
    valid [N] bool.
    Returns (hit [N] bool, rank [N] int32 in [0, U)).
    """
    U = keys.shape[0]
    n = ck.shape[0]
    big = jnp.iinfo(jnp.int32).max
    v = jnp.concatenate([keys, ck])
    tag = jnp.concatenate([jnp.zeros(U, jnp.int32), jnp.ones(n, jnp.int32)])
    kv = jnp.concatenate([keys, jnp.full(n, -1, jnp.int32)])
    rank = jnp.concatenate(
        [jnp.arange(U, dtype=jnp.int32), jnp.full(n, -1, jnp.int32)]
    )
    slot = jnp.concatenate([jnp.full(U, big, jnp.int32), jnp.arange(n, dtype=jnp.int32)])
    # no stability needed: tied queries carry identical (kv, rank) payloads
    # and their slots only route the result back
    sv, _st, skv, srk, sslot = jax.lax.sort(
        (v, tag, kv, rank, slot), num_keys=2
    )
    ckv = jax.lax.cummax(skv)
    crk = jax.lax.cummax(srk)
    out_val = jnp.zeros(n, jnp.int32).at[sslot].set(ckv, mode="drop")
    out_rank = jnp.zeros(n, jnp.int32).at[sslot].set(crk, mode="drop")
    hit = valid & (out_val == ck)
    return hit, jnp.maximum(out_rank, 0)


def _vote(keys_sorted, tol=DIAG_TOL):
    """votes[i] = anchors sharing i's best staggered diagonal bucket;
    -1 for sentinels. keys_sorted MUST be ascending per row (it is: voting
    runs on the output of the compaction sort).

    Replaces the exact +-tol sort-join (a 3n-wide 3-operand sort per call,
    the seeding kernel's dominant cost) with run-length counts over two
    staggered power-of-two grids of
    width 2*tol (offsets 0 and tol): any cluster of diameter <= tol is fully
    contained in a bucket of at least one grid, so compact clusters keep
    their full count, while the op mix drops to scans + elementwise (no
    extra sort, no gathers). Cluster extents stay exact (|key - best| <=
    tol downstream). Counts are elementwise identical to the host mirror
    (host_seed._votes) by the shared floor-divide partition — pinned in
    tests/test_host_seed.py.
    """
    r, n = keys_sorted.shape
    width = 2 * tol
    idx = jax.lax.broadcasted_iota(jnp.int32, (r, n), 1)
    big = jnp.int32(n)

    def run_counts(bucket):
        newrun = jnp.concatenate(
            [jnp.ones((r, 1), bool), bucket[:, 1:] != bucket[:, :-1]], axis=1
        )
        start = jax.lax.cummax(jnp.where(newrun, idx, -1), axis=1)
        nxt_src = jnp.where(newrun, idx, big)
        suf_min = jnp.flip(jax.lax.cummin(jnp.flip(nxt_src, 1), axis=1), 1)
        nxt = jnp.concatenate([suf_min[:, 1:], jnp.full((r, 1), big, jnp.int32)], 1)
        return nxt - start

    b0 = jnp.floor_divide(keys_sorted, width)
    b1 = jnp.floor_divide(keys_sorted + tol, width)
    votes = jnp.maximum(run_counts(b0), run_counts(b1))
    return jnp.where(keys_sorted < SENTINEL, votes, -1)


NCAND = 4  # diagonal clusters peeled per read (multi-mapping candidates)

SEED_FIELDS = ("strand", "bkey", "votes", "dspan", "qmin", "qmax")


@partial(jax.jit, static_argnames=("k", "w", "budget", "L", "ncand"))
def _seed_topn_jit(reads_packed, keys, pos_packed,
                   k: int, w: int = W, budget: int = ANCHOR_BUDGET,
                   L: int = 0, ncand: int = NCAND):
    """Top-``ncand`` diagonal clusters per read (multi-mapping seeding).

    The reference's Mapper returns ALL of minimap2's alignments per read
    (boss/mapper.py:52-65) — split reads yield several primary records and
    repeats yield secondaries, feeding choose_best_mapper (boss/paf.py:709-722)
    and the live multi_on/multi_off decisions (boss/dynamic_readfish.py:229-247).
    Here the vote table is peeled ncand times: each round takes the best
    remaining cluster jointly across both strand spaces, records
    (strand, diagonal, votes, diagonal spread, query-span of the cluster's
    anchors) and masks votes within 2*tol of it on its strand. Output is ONE
    packed int32 [len(SEED_FIELDS) * ncand, R], pulled in one transfer.
    """
    reads = unpack_reads(reads_packed, L)
    canonical, strand, is_min = read_minimizers(reads, k, w)
    ck, cs, cpos, cvalid = compact_minimizers(canonical, strand, is_min, budget)
    r, a = ck.shape

    hit_f, rank_f = _lookup_join(keys, ck.reshape(-1), cvalid.reshape(-1))
    hit = hit_f.reshape(r, a)
    # one gather with a contiguous [OCC_CAP] inner slice per anchor (see
    # DeviceIndex.pos_packed)
    packed = pos_packed[rank_f.reshape(r, a)]     # [r, a, OCC_CAP] uint32
    occ_ok = hit[:, :, None] & (packed != PACK_PAD)
    gpos = (packed >> 1).astype(jnp.int32)
    gstrand = (packed & 1).astype(jnp.int32)

    same = gstrand == cs[:, :, None]
    diag_f = gpos - cpos[:, :, None]
    diag_r = gpos + cpos[:, :, None]
    key_f0 = jnp.where(occ_ok & same, diag_f, SENTINEL).reshape(r, a * OCC_CAP)
    key_r0 = jnp.where(occ_ok & ~same, diag_r, SENTINEL).reshape(r, a * OCC_CAP)
    rp0 = jnp.broadcast_to(cpos[:, :, None], (r, a, OCC_CAP)).reshape(r, a * OCC_CAP)

    # compact before voting: most anchors have ~1.3 occurrences, so about
    # 2/3 of the a*OCC_CAP slots are SENTINEL padding. An ascending sort
    # pushes sentinels to the end (SENTINEL > any diagonal); voting on
    # the front half costs ~40% less sort volume than voting padded. The
    # anchor's read position rides the sort as payload (query spans of each
    # cluster come from it). Reads with > a*OCC_CAP/2 real anchor
    # occurrences (heavy repeats) lose their largest diagonals, matching
    # minimap2's high-occurrence seed drop in spirit. fwd/rev stack into ONE
    # sort + ONE vote launch: row i is read i's fwd space, row r+i its rev.
    # The sort is stable: equal diagonals keep their payloads in input order
    # through the [:, :cw] cut, as in the host mirror's stable argsort.
    cw = (a * OCC_CAP) // 2
    key_fr, rp_fr = (
        x[:, :cw] for x in jax.lax.sort(
            (jnp.concatenate([key_f0, key_r0], axis=0),
             jnp.concatenate([rp0, rp0], axis=0)),
            num_keys=1, dimension=1, is_stable=True,
        )
    )
    votes_fr = _vote(key_fr)

    big = jnp.int32(1 << 30)
    v = votes_fr
    per_cand = []
    for _ in range(ncand):
        b = jnp.argmax(v, axis=1)                                  # [2r]
        bv = jnp.take_along_axis(v, b[:, None], axis=1)[:, 0]
        bk = jnp.take_along_axis(key_fr, b[:, None], axis=1)[:, 0]
        rev = bv[r:] > bv[:r]
        votes_i = jnp.maximum(bv[:r], bv[r:])
        key_i = jnp.where(rev, bk[r:], bk[:r])
        # winner-row mask over the stacked [2r] space
        chosen = jnp.concatenate([~rev, rev])
        key_full = jnp.concatenate([key_i, key_i])
        in_cl = chosen[:, None] & (jnp.abs(key_fr - key_full[:, None]) <= DIAG_TOL) \
            & (key_fr < SENTINEL)
        dmax = jnp.max(jnp.where(in_cl, key_fr, -big), axis=1)
        dmin = jnp.min(jnp.where(in_cl, key_fr, big), axis=1)
        qmax = jnp.max(jnp.where(in_cl, rp_fr, -big), axis=1)
        qmin = jnp.min(jnp.where(in_cl, rp_fr, big), axis=1)
        # non-chosen rows contributed +-big sentinels; the stacked halves
        # therefore combine with max/min
        comb_max = lambda x: jnp.maximum(x[:r], x[r:])
        comb_min = lambda x: jnp.minimum(x[:r], x[r:])
        # dspan: diagonal spread of the cluster = observed indel drift, used
        # by the extension stage to size the DP band (far tighter than a
        # worst-case length-proportional band)
        dspan = jnp.maximum(comb_max(dmax) - comb_min(dmin), 0)
        per_cand.append((
            rev.astype(jnp.int32),
            key_i,
            votes_i,
            dspan,
            jnp.maximum(comb_min(qmin), 0),
            jnp.maximum(comb_max(qmax), 0),
        ))
        # peel: kill this cluster (and its fringe) on its strand only
        v = jnp.where(
            chosen[:, None] & (jnp.abs(key_fr - key_full[:, None]) <= 2 * DIAG_TOL),
            -1, v,
        )
    return jnp.stack([f for cand in per_cand for f in cand])


def anchor_budget(L: int, w: int, cap: int = ANCHOR_BUDGET) -> int:
    """Minimizer-slot budget for reads of padded length L: expected density
    is 2/(w+1) positions, so a pow2 just above that (plus slack) loses no
    anchors while keeping the vote sorts ~L/w wide instead of a fixed 1024
    (the vote sort is the seeding kernel's dominant cost).

    cap: device kernels keep the default (budget is a compiled-shape knob);
    the HOST ava path raises it for ultralong reads (aeons/ava.py) — a
    100 kb read carries ~20k minimizers, and capping at 1024 silently
    discarded all but the read's first ~6 kb of anchors."""
    need = int(2.2 * L / (w + 1)) + 16
    return min(_pow2(need, floor=64), cap)


def seed_and_vote(reads, dev_idx: DeviceIndex, ncand: int = NCAND):
    """[R, L] padded HOST read matrix (int8 codes) -> per-read top-ncand
    candidate dict of [R, ncand] arrays (fields: SEED_FIELDS). Candidate 0
    is the best-voted cluster; a read is unmapped when votes[:, 0] <= 0.
    Ships the reads 4-bit packed (pack_reads)."""
    L = int(reads.shape[1])
    packed = np.asarray(_seed_topn_jit(
        pack_reads(np.asarray(reads)),
        dev_idx.keys,
        dev_idx.pos_packed,
        dev_idx.k,
        dev_idx.w,
        anchor_budget(L, dev_idx.w),
        L,
        ncand,
    ))  # single D2H transfer
    nf = len(SEED_FIELDS)
    return {
        f: np.stack([packed[c * nf + i] for c in range(ncand)], axis=1)
        for i, f in enumerate(SEED_FIELDS)
    }


@partial(jax.jit, static_argnames=("k", "ncand", "tol", "w", "budget", "L"))
def _seed_candidates_jit(reads_packed, keys, pos_packed, k: int, ncand: int,
                         tol: int = DIAG_TOL, w: int = W, budget: int = ANCHOR_BUDGET,
                         L: int = 0):
    """Multi-candidate seeding for all-vs-all overlap discovery (AEONS).

    Returns per read, per candidate [R, 2*ncand] arrays: votes, strand,
    qmin/qmax (read k-mer span), tmin/tmax (target span). Candidates are the
    top-voted diagonal clusters per strand space (minimap2-ava style chain
    extents without base-level extension).
    """
    reads = unpack_reads(reads_packed, L)
    canonical, strand, is_min = read_minimizers(reads, k, w)
    ck, cs, cpos, cvalid = compact_minimizers(canonical, strand, is_min, budget)
    r, a = ck.shape

    hit_f, rank_f = _lookup_join(keys, ck.reshape(-1), cvalid.reshape(-1))
    hit = hit_f.reshape(r, a)
    packed = pos_packed[rank_f.reshape(r, a)]     # [r, a, OCC_CAP] uint32
    occ_ok = hit[:, :, None] & (packed != PACK_PAD)
    gpos = (packed >> 1).astype(jnp.int32)
    gstrand = (packed & 1).astype(jnp.int32)

    same = gstrand == cs[:, :, None]
    diag_f = gpos - cpos[:, :, None]
    diag_r = gpos + cpos[:, :, None]
    rp0 = jnp.broadcast_to(cpos[:, :, None], (r, a, OCC_CAP)).reshape(r, a * OCC_CAP)
    gp0 = gpos.reshape(r, a * OCC_CAP)

    big = jnp.int32(1 << 30)
    cw = (a * OCC_CAP) // 2
    results = []
    for strand_space, key0 in ((0, jnp.where(occ_ok & same, diag_f, SENTINEL)),
                               (1, jnp.where(occ_ok & ~same, diag_r, SENTINEL))):
        # compact before voting (see _seed_and_vote_jit): ~2/3 of the slots
        # are SENTINEL padding; the peel rounds below then run on half the
        # width too. rp/gp ride the sort as payload operands.
        keys_flat, rp, gp = (
            arr[:, :cw] for arr in jax.lax.sort(
                (key0.reshape(r, a * OCC_CAP), rp0, gp0), num_keys=1, dimension=1,
                is_stable=True,
            )
        )
        votes = _vote(keys_flat, tol)
        v = votes
        for _ in range(ncand):
            best = jnp.argmax(v, axis=1)
            bkey = jnp.take_along_axis(keys_flat, best[:, None], axis=1)[:, 0]
            bvote = jnp.take_along_axis(v, best[:, None], axis=1)[:, 0]
            cluster = (jnp.abs(keys_flat - bkey[:, None]) <= tol) & (keys_flat < SENTINEL)
            qmin = jnp.min(jnp.where(cluster, rp, big), axis=1)
            qmax = jnp.max(jnp.where(cluster, rp, -big), axis=1)
            tmin = jnp.min(jnp.where(cluster, gp, big), axis=1)
            tmax = jnp.max(jnp.where(cluster, gp, -big), axis=1)
            results.append((bvote, jnp.full_like(bvote, strand_space), qmin, qmax, tmin, tmax))
            v = jnp.where(jnp.abs(keys_flat - bkey[:, None]) <= 2 * tol, -1, v)
    # ONE packed int32 output [R, 6, 2*ncand]: one device->host pull
    # instead of six
    stack = lambda i: jnp.stack([res[i] for res in results], axis=1)
    return jnp.stack([stack(i) for i in range(6)], axis=1)


def seed_candidates(reads, dev_idx: DeviceIndex, ncand: int = 4, tol: int | None = None):
    """[R, L] padded HOST read matrix -> top diagonal clusters per strand
    space. Ships the reads 4-bit packed (pack_reads).

    tol: diagonal clustering tolerance; long sequences accumulate indel
    drift ~1% of their length, so callers scale it with read length.
    """
    L = int(reads.shape[1])
    if tol is None:
        tol = max(DIAG_TOL, L // 32)
    out = _seed_candidates_jit(
        pack_reads(np.asarray(reads)), dev_idx.keys, dev_idx.pos_packed,
        dev_idx.k, ncand, int(tol), dev_idx.w,
        anchor_budget(L, dev_idx.w),
        L,
    )
    packed = np.asarray(out)  # single D2H transfer
    names = ("votes", "strand", "qmin", "qmax", "tmin", "tmax")
    return {n: packed[:, i] for i, n in enumerate(names)}
