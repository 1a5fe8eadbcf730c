"""Contig scoring / expected benefit / strategy threshold for BOSS-AEONS.

Device pipeline over the current contig set (rebuilt per batch — AEONS state
lives in per-contig coverage arrays, so scoring is a pure function of
coverage). Semantics mirror /root/reference/boss/aeons/sequences.py:

  * sigmoid low-coverage score 1/(exp(cov_mean - lowcov) + 1), cov capped at
    100 (Benefit.init_scoring_vec/score_array :1522-1551) — computed directly
    instead of via the 101-entry lookup,
  * uncapped low-coverage contig ends get score 1 ("nodes of interest",
    Sequence.set_contig_ends :371-395),
  * S_mu and the CCL-weighted benefit as clamped-segment window sums with
    virtual unit-score mass beyond uncapped ends (replacing the reference's
    physical array expansion by ccl_max, Benefit._expand_scores :1589-1604),
  * unweighted exponent-bin threshold scan: cs_u = cumsum(bin*count)+ubar0,
    cs_t = cumsum(tc*count)+tbar0 with alpha=200 (ContigPool.find_threshold
    :1059-1094 — note the reference uses alpha=200 here vs 300 in RUNS).

Contig layout: all contigs concatenate on a 100-site-chunk axis padded to a
power-of-two total so jit sees few distinct shapes.

Two backends behind contig_strategies (size-cutoff dispatch, see
HOST_MAX_CHUNKS): a vectorised per-contig HOST path (cache-resident f64
cumsum windows) and the fused DEVICE kernel below, which also serves
loaded-host deployments (a live run shares its cores with a basecaller).

Device transfer economy: the host uploads one uint8 per 100-site chunk (the
capped floor(cov_sum/100) the sigmoid needs — exact, the kernel floored
anyway) plus per-contig descriptors padded to a small fixed table; the
kernel expands segment bounds on device and returns ONE uint8 array =
bit-packed strategy mask ++ threshold bytes: one round trip, and far fewer
bytes each way than an f32-everything form. Whether that still pays on a
locally attached card is an open measurement.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.genome_ops import (_csum, frexp_abs_exponent, windowed_sums_fwd,
                              windowed_sums_rev)

NODE = 100
NBINS = 192
CONTIG_PAD = 64  # per-contig descriptor table rows (pow2-padded above this)


@partial(jax.jit, static_argnames=())
def _strategy_jit(cov_mean_u8, ndc, noi_l, noi_r, e_lc, e_rc, total,
                  lowcov, ccl_ds, mu_ds, tc, tbar0):
    """cov_mean_u8 [N] uint8 = min(floor(chunk_cov_sum / 100), 100) per
    100-site chunk; ndc [C] int32 chunk count per contig (0 = pad row);
    noi_l/noi_r [C] bool (end node of interest); e_lc/e_rc [C] bool (left/
    right end uncapped); total int32 = real rows.

    One fused kernel: segment expansion, benefit windows AND the threshold
    scan — smu_sum stays a device scalar instead of forcing a host round
    trip between two jits. Returns ONE uint8 array [N*2/8 + 8]:
    little-endian bit-packed (benefit >= threshold | all-true-when-empty)
    mask ++ threshold f32 bytes ++ any_nonzero byte ++ 3 pad bytes."""
    n = cov_mean_u8.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    row_valid = rows < total

    # per-row contig id from the descriptor table: ends[c] = cumsum(ndc);
    # searchsorted side='right' maps row -> its contig (pad contigs have
    # ndc=0 and can never win). Rows beyond `total` clamp to the last table
    # row and are masked by row_valid everywhere below.
    ends = jnp.cumsum(ndc)
    starts = ends - ndc
    cid = jnp.searchsorted(ends, rows, side="right")
    cid = jnp.minimum(cid, ndc.shape[0] - 1)
    seg_start = jnp.where(row_valid, starts[cid], rows)
    seg_end = jnp.where(row_valid, ends[cid], rows + 1)
    e_l = e_lc[cid] & row_valid
    e_r = e_rc[cid] & row_valid
    noi = ((rows == seg_start) & noi_l[cid]) | ((rows == seg_end - 1) & noi_r[cid])

    cov_mean = cov_mean_u8.astype(jnp.float32)
    scores = 1.0 / (jnp.exp(cov_mean - lowcov) + 1.0)
    scores = jnp.where(noi & row_valid, 1.0, scores)
    scores = jnp.where(row_valid, scores, 0.0)

    cs = _csum(scores)

    # the 22 window sums share the one cumsum via dynamic-slice shifts; the
    # segment-boundary corrections gather cs[seg_end]/cs[seg_start] ONCE and
    # are reused by every window instead of 22 full-axis gathers
    cs_end = jnp.take(cs, seg_end, axis=-1)
    cs_start = jnp.take(cs, seg_start, axis=-1)

    def fwd(w):
        base = windowed_sums_fwd(cs, w, seg_end, rows, cs_at_seg_end=cs_end)
        # virtual unit scores beyond an uncapped right end
        over = jnp.maximum(rows + w - seg_end, 0)
        return base + jnp.where(e_r, jnp.minimum(over, w).astype(cs.dtype), 0.0)

    def rev(w):
        base = windowed_sums_rev(cs, w, seg_start, rows, cs_at_seg_start=cs_start)
        over = jnp.maximum(seg_start - (rows + 1 - w), 0)
        return base + jnp.where(e_l, jnp.minimum(over, w).astype(cs.dtype), 0.0)

    smu = jnp.stack([fwd(mu_ds), rev(mu_ds)], axis=-1)
    weights = jnp.arange(0.1, 1.1, 0.1, dtype=cs.dtype)[::-1]
    ebf = jnp.zeros_like(scores)
    ebr = jnp.zeros_like(scores)
    for i in range(10):
        w = jnp.maximum(ccl_ds[i], 1)
        ebf = ebf + weights[i] * fwd(w)
        ebr = ebr + weights[i] * rev(w)
    benefit = jnp.maximum(jnp.stack([ebf, ebr], axis=-1) - smu, 0.0)
    benefit = jnp.where(row_valid[:, None], benefit, 0.0)

    # threshold scan (ContigPool.find_threshold :1059-1094), fused in
    smu_sum = jnp.sum(smu)
    b = benefit.ravel()
    nz = b > 0
    any_nz = jnp.any(nz)
    norm = jnp.max(b)
    norm_safe = jnp.where(norm > 0, norm, 1.0)
    idx = frexp_abs_exponent(jnp.where(nz, b / norm_safe, 1.0), NBINS)
    counts = jnp.zeros(NBINS, b.dtype).at[idx].add(nz.astype(b.dtype))
    used = counts > 0
    bin_ids = jnp.arange(NBINS, dtype=jnp.int32)
    bbin = jnp.exp2(-bin_ids.astype(b.dtype)) * norm_safe
    cs_u = jnp.cumsum(bbin * counts) + smu_sum
    cs_t = jnp.cumsum(tc * counts) + tbar0
    peak = jnp.where(used, cs_u / cs_t, -jnp.inf)
    kmax = jnp.argmax(peak)
    after = used & (bin_ids > kmax)
    nxt = jnp.min(jnp.where(after, bin_ids, NBINS))
    last_used = jnp.max(jnp.where(used, bin_ids, -1))
    thr_idx = jnp.where(nxt < NBINS, nxt, last_used).astype(jnp.int32)
    thr = bbin[jnp.maximum(thr_idx, 0)]

    # no-nonzero-benefit batches keep the accept-all strategy
    mask = jnp.where(any_nz, b >= thr, True)
    packed = jnp.sum(
        mask.reshape(-1, 8).astype(jnp.uint8)
        << jnp.arange(8, dtype=jnp.uint8)[None, :],
        axis=1, dtype=jnp.uint8,
    )
    thr_bytes = jax.lax.bitcast_convert_type(
        thr.astype(jnp.float32), jnp.uint8
    ).reshape(4)
    tail = jnp.concatenate([
        thr_bytes,
        jnp.array([0, 0, 0], jnp.uint8),
        any_nz.astype(jnp.uint8)[None],
    ])
    return jnp.concatenate([packed, tail])


def _pad_pow2(n: int, floor: int = 1 << 10) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _strategy_host(cov_mean_u8, nd, noi_l, noi_r, e_lc, e_rc,
                   lowcov, ccl_ds, mu_ds, tc, tbar0):
    """Vectorised NumPy mirror of _strategy_jit over the REAL (unpadded)
    chunk axis: same sigmoid scores / virtual end mass / stacked window
    gather / exponent-bin scan, f64 cumsum. Returns (mask [n,2] bool, thr).

    Exists for size-cutoff dispatch (see contig_strategies). Host and
    device agree to the same >=99.9% mask tolerance as the sequential spec
    mirror (tests/test_aeons.py::test_contig_strategies_matches_numpy_mirror).
    """
    n = cov_mean_u8.shape[0]
    nd = np.asarray(nd, np.int64)
    ends = np.cumsum(nd)
    starts = ends - nd
    wins = np.concatenate([[mu_ds], np.maximum(ccl_ds, 1)]).astype(np.int64)  # [11]
    wmax = int(wins.max())
    weights = np.arange(0.1, 1.1, 0.1)[::-1]
    smu = np.empty((n, 2))
    eb = np.zeros((n, 2))
    # per-contig blocks: each contig's cumsum + 22 shifted-slice windows stay
    # cache-resident (a flat whole-pool pass was measured ~40% slower at
    # metagenome scale — 22 full-length f64 temporaries stream through DRAM).
    # The clamped boundary windows come free from padding the per-contig
    # cumsum: no gathers at all.
    for ci in range(nd.shape[0]):
        s0, s1 = int(starts[ci]), int(ends[ci])
        nc = s1 - s0
        if nc <= 0:
            continue
        sc = (1.0 / (np.exp(cov_mean_u8[s0:s1].astype(np.float32)
                            - np.float32(lowcov)) + 1.0)).astype(np.float32)
        if noi_l[ci]:
            sc[0] = 1.0
        if noi_r[ci]:
            sc[-1] = 1.0
        cs = np.empty(nc + 1 + wmax, np.float64)
        cs[0] = 0.0
        np.cumsum(sc, dtype=np.float64, out=cs[1 : nc + 1])
        cs[nc + 1 :] = cs[nc]                      # right clamp
        cs_lo = np.concatenate([np.zeros(wmax), cs[: nc + 1]])  # left clamp
        r = np.arange(nc, dtype=np.int64)
        for j, w in enumerate(wins):
            f = cs[w : w + nc] - cs[:nc]
            rv = cs[1 : nc + 1] - cs_lo[wmax + 1 - w : wmax + 1 - w + nc]
            if e_rc[ci]:
                f = f + np.clip(r + w - nc, 0, w)
            if e_lc[ci]:
                rv = rv + np.clip(w - 1 - r, 0, w)
            if j == 0:
                smu[s0:s1, 0], smu[s0:s1, 1] = f, rv
            else:
                eb[s0:s1, 0] += weights[j - 1] * f
                eb[s0:s1, 1] += weights[j - 1] * rv
    benefit = np.maximum(eb - smu, 0.0)

    b = benefit.ravel()
    nzv = b[b > 0]
    if nzv.size == 0:
        return np.ones((n, 2), bool), 0.0
    norm = float(b.max())
    _m, e = np.frexp(nzv / norm)
    idx = np.minimum(np.abs(e), NBINS - 1)
    counts = np.bincount(idx, minlength=NBINS).astype(np.float64)
    used = counts > 0
    bin_ids = np.arange(NBINS)
    bbin = np.exp2(-bin_ids.astype(np.float64)) * norm
    cs_u = np.cumsum(bbin * counts) + float(smu.sum())
    cs_t = np.cumsum(tc * counts) + tbar0
    peak = np.where(used, cs_u / cs_t, -np.inf)
    kmax = int(np.argmax(peak))
    after = np.flatnonzero(used & (bin_ids > kmax))
    thr_idx = int(after[0]) if after.size else int(np.max(bin_ids[used]))
    thr = float(bbin[thr_idx])
    return benefit >= thr, thr


#: dispatch cutoff (total 100-site chunks, ~210 Mb of contigs): the host
#: path runs below it, the device kernel above (and for loaded-host
#: deployments via the override). The value dates from an earlier
#: accelerator and is kept until scripts/profile_aeons_strategy.py decides
#: it on this one. Env override: BOSS_AEONS_STRATEGY_BACKEND = host |
#: device | auto.
HOST_MAX_CHUNKS = 1 << 21


def contig_strategies(
    contigs,  # dict[str, Sequence]
    ccl: np.ndarray,
    lam: float,
    lowcov: float = 10.0,
    mu: int = 400,
    end_lim: int = 50,
    backend: str = "auto",
) -> tuple[dict[str, np.ndarray], float]:
    """Per-contig strategy masks [(ceil(len/100), 2) bool] + threshold.

    backend: 'auto' (host below HOST_MAX_CHUNKS total chunks,
    device above) | 'host' | 'device'; env BOSS_AEONS_STRATEGY_BACKEND
    overrides."""
    import os

    backend = os.environ.get("BOSS_AEONS_STRATEGY_BACKEND", backend)
    names = list(contigs)
    if not names:
        return {}, 0.0
    nd = [int(-(-len(contigs[h].seq) // NODE)) for h in names]
    total = sum(nd)
    n_pad = _pad_pow2(total)
    c_pad = _pad_pow2(len(names), floor=CONTIG_PAD)
    cov_mean = np.zeros(n_pad, np.uint8)
    ndc = np.zeros(c_pad, np.int32)
    noi_l = np.zeros(c_pad, bool)
    noi_r = np.zeros(c_pad, bool)
    e_lc = np.zeros(c_pad, bool)
    e_rc = np.zeros(c_pad, bool)
    off = 0
    offsets = {}
    for ci, (h, ndch) in enumerate(zip(names, nd)):
        s = contigs[h]
        cc = np.add.reduceat(s.cov, np.arange(0, len(s.cov), NODE))
        cov_mean[off : off + ndch] = np.minimum(cc // NODE, 100).astype(np.uint8)
        ndc[ci] = ndch
        # contig-end nodes of interest (set_contig_ends :371-395): the end
        # test uses the EXACT chunk sum, so it stays host-side
        end_l = not s.cap_l and cc[0] <= end_lim * NODE
        end_r = not s.cap_r and cc[-1] <= end_lim * NODE
        noi_l[ci] = end_l
        noi_r[ci] = end_r
        e_lc[ci] = end_l
        e_rc[ci] = end_r
        offsets[h] = (off, ndch)
        off += ndch

    ccl_ds = np.maximum(np.asarray(ccl) // NODE, 1).astype(np.int32)
    alpha, rho = 200 // NODE, 300 // NODE
    tc = max((lam - mu - 300) // NODE, 1.0)
    tbar0 = alpha + rho + mu // NODE

    if backend == "host" or (backend == "auto" and total <= HOST_MAX_CHUNKS):
        nc = len(names)
        mask_r, thr_f = _strategy_host(
            cov_mean[:total], ndc[:nc], noi_l[:nc], noi_r[:nc],
            e_lc[:nc], e_rc[:nc], lowcov, ccl_ds, mu // NODE, tc, tbar0,
        )
        return ({h: mask_r[offsets[h][0] : offsets[h][0] + offsets[h][1]]
                 for h in names}, thr_f)

    flat = np.asarray(_strategy_jit(
        jnp.asarray(cov_mean), jnp.asarray(ndc), jnp.asarray(noi_l),
        jnp.asarray(noi_r), jnp.asarray(e_lc), jnp.asarray(e_rc),
        jnp.int32(total), jnp.float32(lowcov), jnp.asarray(ccl_ds),
        jnp.int32(mu // NODE), jnp.float32(tc), jnp.float32(tbar0),
    ))  # exactly ONE D2H pull: packed mask ++ [thr f32, pad, any_nz]
    nbytes = (n_pad * 2) // 8
    mask = np.unpackbits(flat[:nbytes], bitorder="little").astype(bool)
    mask = mask.reshape(n_pad, 2)
    thr_v = float(flat[nbytes : nbytes + 4].view(np.float32)[0])
    any_nz = bool(flat[-1])
    thr_f = thr_v if any_nz else 0.0
    strats = {}
    for h in names:
        off, ndch = offsets[h]
        strats[h] = mask[off : off + ndch]
    return strats, thr_f
