"""Float64 NumPy oracle implementing the reference BOSS-RUNS math.

This module is the conformance baseline for the device kernels: a compact,
vectorised re-implementation of the *mathematics* of the reference pipeline
(posterior/entropy score, S_mu / expected-benefit window sums, read-start
posterior, exponent-binned threshold scan) in float64 on CPU.

It serves two purposes:
  * unit tests compare every device kernel against it (value closeness for f32,
    decision-level identity for the strategy masks), and
  * bench.py times it as the "CPU BOSS-RUNS" stand-in baseline, since the
    actual reference cannot run here (its mappy/bottleneck C deps are absent).

Reference semantics sources (file:line cited per function):
  /root/reference/boss/runs/sequences.py   (posterior, score, threshold scan)
  /root/reference/boss/runs/reference.py   (S_mu, expected benefit windows)
  /root/reference/boss/runs/readstartdist.py (fhat point-mass posterior)

NOTE on a reference quirk: runs/core.py:182-183 passes ``benefit`` where it
means ``smu`` when adjusting lengths, so the reference's ubar0 term is computed
from benefit rather than S_mu. We implement the *intended* semantics (ubar0
from S_mu); the term only shifts both cumulative sums by a constant.
"""
from __future__ import annotations

import numpy as np
from scipy.special import betaln

from .ops.model import ObservationModel

COUNT_CLIP = 990


# ---------------------------------------------------------------- posterior --

def site_posterior(counts: np.ndarray, ref_base: np.ndarray, model: ObservationModel) -> np.ndarray:
    """Posterior over genotypes per site. counts [N,>=len_b], ref [N] -> [N,G].

    Multiplicative form like sequences.py:485-516: post ∝ prior[r] * Π phi^c.
    """
    c = np.minimum(counts[:, : model.len_b], COUNT_CLIP).astype(np.float64)
    lik = np.prod(model.phi[None, :, :] ** c[:, :, None], axis=1)  # [N, G]
    post = model.prior[ref_base] * lik
    z = post.sum(axis=1)
    z[z < 1e-300] = 1e-300
    return post / z[:, None]


def site_scores_fast(counts: np.ndarray, ref_base: np.ndarray, model: ObservationModel):
    """Closed-form f64 scores (same math as ops/scores.py, NumPy).

    Used as the CPU baseline in bench.py: the strongest plausible optimized
    CPU implementation — log-space matmul over DEDUPLICATED
    (count-pattern, ref-base) rows, i.e. the reference's lookup-table
    insight applied at full strength. Agrees with site_scores to ~1e-13.
    """
    packed = _pack_rows(counts, ref_base, model.len_b)
    if packed is not None:
        uniq_c, uniq_r, inv, n_uniq = packed
        if n_uniq < counts.shape[0] // 2:
            s_u, e_u = _site_scores_fast_dense(uniq_c, uniq_r, model)
            return s_u[inv], e_u[inv]
    return _site_scores_fast_dense(counts, ref_base, model)


def _pack_rows(counts, ref_base, len_b: int):
    """Deduplicate (count-pattern, ref-base) rows via ONE packed int64 key
    (np.unique over a 1-D key sorts ~20x faster than the axis=0 void-row
    form, which dominated the whole scoring pass at genome scale).

    Returns (unique_counts f64, unique_ref, inverse, n_unique) or None when
    counts are fractional (unkeyable)."""
    c = np.minimum(counts[:, :len_b], COUNT_CLIP)
    if not np.all(c == np.floor(c)):
        return None
    ci = c.astype(np.int64)
    key = np.asarray(ref_base, np.int64).copy()
    base = np.int64(COUNT_CLIP + 1)
    mult = np.int64(8)  # ref_base < 8
    for j in range(len_b):
        key += ci[:, j] * mult
        mult *= base
    uniq, inv = np.unique(key, return_inverse=True)
    # decode the unique keys back into count rows
    ref_u = uniq % 8
    rest = uniq // 8
    cols = []
    for _j in range(len_b):
        cols.append(rest % base)
        rest = rest // base
    return (np.stack(cols, axis=1).astype(np.float64), ref_u, inv,
            int(uniq.shape[0]))


def _site_scores_fast_dense(counts: np.ndarray, ref_base: np.ndarray, model: ObservationModel):
    c = np.minimum(counts[:, : model.len_b], COUNT_CLIP).astype(np.float64)
    lphi = model.log_phi
    ll = c @ lphi + model.log_prior[ref_base]
    ll -= ll.max(axis=1, keepdims=True)
    post = np.exp(ll)
    post /= post.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        lp = np.where(post > 0, np.log(np.where(post > 0, post, 1.0)), 0.0)
    entropy = -(post * lp).sum(axis=1)
    q = post @ model.phi.T
    with np.errstate(divide="ignore", invalid="ignore"):
        qlogq = np.where(q > 0, q * np.log(np.where(q > 0, q, 1.0)), 0.0)
    with np.errstate(invalid="ignore"):
        k = np.where(model.phi > 0, model.phi * model.log_phi, 0.0).sum(axis=0)
    return post @ k - qlogq.sum(axis=1), entropy


def site_scores(counts: np.ndarray, ref_base: np.ndarray, model: ObservationModel):
    """(score, entropy) per site; sequences.py:520-549 vectorised.

    Deduplicates (count-pattern, ref-base) rows before computing — the same
    insight as the reference's 6-D lookup table (most sites share a handful
    of coverage patterns). Bit-identical to the dense computation: every
    arithmetic step is row-independent, so computing a unique row once gives
    the same float result as computing each occurrence. ~20x faster at
    realistic coverage (the dense pass cost ~110 s at 12.6 Mb)."""
    packed = _pack_rows(counts, ref_base, model.len_b)
    if packed is not None:
        uniq_c, uniq_r, inv, n_uniq = packed
        if n_uniq < counts.shape[0] // 2:
            s_u, e_u = _site_scores_dense(uniq_c, uniq_r, model)
            return s_u[inv], e_u[inv]
    return _site_scores_dense(counts, ref_base, model)


def _site_scores_dense(counts: np.ndarray, ref_base: np.ndarray, model: ObservationModel):
    post = site_posterior(counts, ref_base, model)
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.where(post > 0, np.log(np.where(post > 0, post, 1.0)), 0.0)
    entropy = -(post * logs).sum(axis=1)

    p2 = post[:, None, :] * model.phi[None, :, :]  # [N, B, G]
    q = p2.sum(axis=2)  # [N, B]
    q = np.where(q == 0, 1e-300, q)
    new_post = p2 / q[:, :, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        lnp = np.where(new_post > 0, np.log(np.where(new_post > 0, new_post, 1.0)), 0.0)
    new_entropy = -(q[:, :, None] * new_post * lnp).sum(axis=(1, 2))
    return entropy - new_entropy, entropy


# ------------------------------------------------------------- window sums --

def move_sum_fwd(x: np.ndarray, w: int) -> np.ndarray:
    """out[i] = sum(x[i : i+w]) clamped at the array end.

    Equals bn.move_sum(x[::-1], window=w, min_count=1)[::-1]
    (runs/reference.py:233).
    """
    cs = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    n = x.shape[0]
    hi = np.minimum(np.arange(n) + w, n)
    return cs[hi] - cs[:n]


def move_sum_rev(x: np.ndarray, w: int) -> np.ndarray:
    """out[i] = sum(x[max(0, i-w+1) : i+1]).

    Equals bn.move_sum(x, window=w, min_count=1) (runs/reference.py:234).
    """
    cs = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    n = x.shape[0]
    lo = np.maximum(np.arange(n) + 1 - w, 0)
    return cs[1 : n + 1] - cs[lo]


def downsample_sum(x: np.ndarray, out_len: int, window: int = 100) -> np.ndarray:
    """Sum x into out_len bins of `window` sites (runs/reference.py:229-231)."""
    out = np.zeros(out_len, dtype=np.float64)
    idx = np.arange(x.shape[0]) // window
    np.add.at(out, idx, x)
    return out


def expected_benefit(scores_ds: np.ndarray, approx_ccl: np.ndarray, mu: int = 400, window: int = 100):
    """(smu [L,2], benefit [L,2]) for one contig's downsampled scores.

    S_mu and the CCL-weighted 10-window expected benefit; the per-window
    weights are 0.95, 0.85, ..., 0.05 (runs/reference.py:215-269).
    """
    n = scores_ds.shape[0]
    smu = np.stack([move_sum_fwd(scores_ds, mu // window), move_sum_rev(scores_ds, mu // window)], axis=1)
    weights = np.arange(0.05, 1, 0.1)[::-1]
    eb = np.zeros((n, 2))
    ccl_ds = approx_ccl // window
    for i in range(10):
        w = max(int(ccl_ds[i]), 1)
        eb[:, 0] += move_sum_fwd(scores_ds, w) * weights[i]
        eb[:, 1] += move_sum_rev(scores_ds, w) * weights[i]
    benefit = eb - smu
    benefit[benefit < 0] = 0.0
    return smu, benefit


# ------------------------------------------------------------- threshold ----

def find_strategy(benefit: np.ndarray, smu: np.ndarray, fhat: np.ndarray, time_cost: float):
    """Global accept threshold via binary-exponent binning.

    Mirrors Scoring.find_strat_thread (sequences.py:565-649) without the
    thread pools: frexp-bin the non-zero benefits, per-bin counts and mean
    fhat, then maximise cumulative benefit rate / time rate.

    Returns (strat bool same shape as benefit, threshold).
    """
    window = 100
    alpha, rho, mu = 300 // window, 300 // window, 400 // window
    tc = time_cost // window

    bflat = benefit.ravel()
    nz = np.flatnonzero(bflat)
    if nz.size == 0:
        return np.ones_like(benefit, dtype=bool), 0.0
    bnz = bflat[nz]
    normaliser = bnz.max()
    _, exponents = np.frexp(bnz / normaliser)
    expo = np.abs(exponents)
    counts_all = np.bincount(expo)
    f_all = np.bincount(expo, weights=fhat.ravel()[nz])
    used = np.flatnonzero(counts_all)
    counts = counts_all[used]
    f_mean = f_all[used] / counts
    benefit_bin = np.power(2.0, -used.astype(np.float64)) * normaliser

    # f32-rounded products: order-invariant f64 sum (see genome_ops.find_strategy)
    ubar0 = float(np.sum((fhat * smu).astype(np.float32).astype(np.float64)))
    tbar0 = alpha + rho + mu
    cs_u = np.cumsum(benefit_bin * f_mean * counts) + ubar0
    cs_t = np.cumsum(tc * counts * f_mean) + tbar0
    peak = cs_u / cs_t
    strat_size = int(np.argmax(peak)) + 1
    threshold = benefit_bin[strat_size] if strat_size < benefit_bin.shape[0] else benefit_bin[-1]
    return benefit >= threshold, float(threshold)


# ------------------------------------------------------------------- fhat ---

def fhat_pointmass(read_starts: np.ndarray, alpha: float = 1.0, p0: float = 0.1) -> np.ndarray:
    """Posterior mean read-start probability per (window, strand).

    read_starts: [W, 2] counts. Point mass at zero for unobserved windows
    (readstartdist.py:86-117).
    """
    n_windows = read_starts.shape[0]
    csum = read_starts.sum()
    denom = 2.0 * n_windows * alpha + csum
    fhat = (alpha + read_starts) / denom
    if alpha == 1.0:
        # B(1, z) = 1/z exactly — matches ops/genome_ops.fhat_pointmass's
        # closed form bit-for-bit (exp(betaln) would round differently)
        beta_num = 1.0 / ((2.0 * n_windows - 1.0) + csum)
        beta_denom = 1.0 / (2.0 * n_windows - 1.0)
    else:
        beta_num = np.exp(betaln(alpha, (2 * n_windows - 1) * alpha + csum))
        beta_denom = np.exp(betaln(alpha, (2 * n_windows - 1) * alpha)) or 1e-20
    p0_bit = p0 / (p0 + (1 - p0))
    expected_post = (1 - p0_bit * (beta_num / beta_denom)) * (alpha / denom)
    out = np.where(read_starts > 0, fhat, expected_post)
    return out


# ----------------------------------------------------- full pipeline oracle --

def full_update(engine, state_np: dict, batch_np: dict, approx_ccl, time_cost,
                bucket_threshold: float = 5.0, fast_scores: bool = False,
                scores_override: np.ndarray | None = None,
                reference_quirks: bool = False):
    """Float64 numpy reference of one full RunsEngine step.

    reference_quirks: reproduce quirk Q1 (ubar0 from benefit — the
    reference's runs/core.py:178-186 variable swap), pairing with
    RunsConfig(reference_quirks=True) on the engine. The complete
    bug-compatible pipeline (incl. the Q3 row drift) is
    oracle_quirks.ReferenceQuirkOracle.

    scores_override: [NB, G] post-mask per-site scores to use INSTEAD of the
    oracle's own f64 scores — pass the engine's f32 scores (StepAux.scores
    under debug_aux) to test the benefit/fhat/threshold pipeline for exact
    f64 agreement in isolation from score precision.

    engine: a models.runs.RunsEngine (used only for its layout/model/config).
    state_np: dict of numpy arrays mirroring GenomeState fields.
    batch_np: dict with cov_pos/cov_sym/cov_bc/cov_w/rs_row/rs_strand/rs_w.
    Returns (new_state_np, aux dict). Semantics identical to RunsEngine._step
    but computed in float64 like the reference implementation.
    """
    from .models.layout import BUCKET, DS

    lay = engine.layout
    model = engine.model
    cfg = engine.config
    nb = lay.n_barcodes
    G, Gd = lay.G_pad, lay.Gd_pad
    tiny = np.finfo(np.float64).tiny

    cov0 = state_np["coverage"]  # [NB, 5, G] genome axis last, uint16
    # expand match runs + explicit observations like the device step does
    # (quality masking already happened host-side when the batch was built)
    inc = np.zeros(cov0.size, np.int64)
    mr_flat = (
        np.asarray(batch_np["mr_bc"], np.int64) * G
        + np.asarray(batch_np["mr_g"], np.int64)
    )
    mr_len = np.asarray(batch_np["mr_len"], np.int64)
    seq_i = lay.seq_int.astype(np.int64)
    sel = mr_len > 0
    flat0, ln = mr_flat[sel], mr_len[sel]
    if flat0.size:
        total = int(ln.sum())
        off = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(ln)[:-1]]), ln)
        idx = np.repeat(flat0, ln) + off
        b, g = np.divmod(idx, G)
        np.add.at(inc, (b * 5 + seq_i[g]) * G + g, 1)
    ex_g = np.asarray(batch_np["ex_g"], np.int64)
    ex_real = ex_g != 0xFFFFFFFF  # EX_PAD sentinel marks padding rows
    ex_flat = (
        np.asarray(batch_np["ex_bcsym"], np.int64)[ex_real] * G
        + ex_g[ex_real]
    )
    np.add.at(inc, ex_flat, 1)
    inc = inc.reshape(cov0.shape)
    # saturating uint16 add, matching the device step (runs.py step 1)
    cov = np.minimum(cov0.astype(np.int64) + inc, 65535).astype(np.uint16)
    changed_site = (inc != 0).any(axis=(0, 1))

    covsum = cov.sum(axis=1).astype(np.float64)  # [NB, G]
    seq = lay.seq_int.astype(np.int32)
    site_valid = lay.site_valid()
    maxed = covsum >= cfg.freeze_cov
    if scores_override is None:
        # scores are replaced wholesale below when an override is given —
        # skip the dominant site_scores pass entirely in that case (it cost
        # ~170 s/batch at zymo scale in the conformance drive)
        score_fn = site_scores_fast if fast_scores else site_scores
        fresh = np.stack([score_fn(cov[b].T, seq, model)[0] for b in range(nb)])
        scores = np.where(site_valid[None], fresh, 0.0)
        scores = np.where(maxed, tiny, scores)
    else:
        scores = np.zeros((nb, G))

    covsum_ds = covsum.reshape(nb, Gd, DS).sum(axis=2)
    cid = np.where(lay.contig_id_ds < 0, lay.n_contigs, lay.contig_id_ds)
    per_contig = np.zeros(lay.n_contigs + 1)
    np.add.at(per_contig, cid, covsum_ds.sum(axis=0))
    denom = np.append(lay.lengths * nb, 1).astype(np.float64)
    mean_c = per_contig / denom
    thr = np.floor(mean_c / cfg.dropout_mod)
    active = mean_c > cfg.dropout_min_mean
    site_cid = cid[np.arange(G) // DS]
    drop_now = active[site_cid] & site_valid & (covsum <= thr[site_cid][None]).any(axis=0)
    drop_now = np.broadcast_to(drop_now[None], (nb, G))

    recomputed = changed_site[None] & ~maxed
    hold_zero = state_np["zeroed"] & ~recomputed
    scores = np.where(hold_zero | drop_now, 0.0, scores)
    zeroed = drop_now | hold_zero
    if scores_override is not None:
        scores = np.asarray(scores_override, np.float64)

    # buckets
    cc = np.concatenate([np.zeros((nb, 1)), np.cumsum(covsum_ds, axis=1)], axis=1)
    lo = lay.bucket_lo_ds
    lo_safe = np.maximum(lo, 0)
    wsum = cc[:, lo_safe + BUCKET // DS] - cc[:, lo_safe]
    bucket_valid = np.arange(lay.NBk_pad) < lay.n_buckets
    bucket_mean = np.where(lo >= 0, wsum / BUCKET, 0.0)
    bucket_on = state_np["bucket_on"] | ((bucket_mean >= bucket_threshold) & bucket_valid)
    any_on = bool(bucket_on.any())

    # fhat
    read_starts = state_np["read_starts"].copy()
    np.add.at(read_starts, (batch_np["rs_row"], batch_np["rs_strand"]), batch_np["rs_w"])
    fh = np.zeros((lay.Wf_pad, 2))
    fh[: lay.n_fhat] = fhat_pointmass(
        read_starts[: lay.n_fhat], alpha=cfg.fhat_alpha, p0=cfg.fhat_p0
    )
    fidx = lay.fhat_idx
    fhat_exp = np.where((fidx >= 0)[:, None], fh[np.maximum(fidx, 0)], 0.0)
    # closed-form normaliser over the window axis + f32 rounding of the
    # per-row weights — the engine's reduction-order-invariance contract
    # (models/runs.py step 4): f32 summands make every downstream f64 sum
    # exact in any order
    fhat_rows = np.bincount(fidx[fidx >= 0], minlength=lay.Wf_pad).astype(np.float64)
    tot = float(np.sum(fh * fhat_rows[:, None]))
    if tot > 0:
        fhat_exp = fhat_exp * (cfg.on_target / tot)
    fhat_exp = fhat_exp.astype(np.float32).astype(np.float64)

    # benefit
    scores_ds = scores.reshape(nb, Gd, DS).sum(axis=2)
    ccl_ds = np.clip(
        np.asarray(approx_ccl) // DS, 1, getattr(cfg, "ccl_clamp_ds", 4096)
    )
    smu = np.zeros((nb, Gd, 2))
    ben = np.zeros((nb, Gd, 2))
    rows = np.arange(Gd)
    seg_s, seg_e = lay.ds_seg_start, lay.ds_seg_end
    weights = np.arange(0.05, 1, 0.1)[::-1]
    for b in range(nb):
        cs = np.concatenate([[0.0], np.cumsum(scores_ds[b])])
        mu_ds = cfg.mu // DS
        smu[b, :, 0] = cs[np.minimum(rows + mu_ds, seg_e)] - cs[rows]
        smu[b, :, 1] = cs[rows + 1] - cs[np.maximum(rows + 1 - mu_ds, seg_s)]
        for i in range(10):
            wd = int(ccl_ds[i])
            ben[b, :, 0] += weights[i] * (cs[np.minimum(rows + wd, seg_e)] - cs[rows])
            ben[b, :, 1] += weights[i] * (cs[rows + 1] - cs[np.maximum(rows + 1 - wd, seg_s)])
    ben = np.maximum(ben - smu, 0.0)

    fhat_b = np.broadcast_to(fhat_exp[None], ben.shape)
    strat_cand, threshold = find_strategy(
        ben, ben if reference_quirks else smu, fhat_b, time_cost
    )
    any_nz = bool((ben > 0).any())

    bidx = lay.bucket_idx
    gate = bucket_on[:, np.maximum(bidx, 0)] & (bidx >= 0)[None]
    do_update = any_on and any_nz
    write = do_update & gate & lay.strat_row_valid[None]
    strat = np.where(write[:, :, None], strat_cand, state_np["strat"])

    new_state = dict(coverage=cov, zeroed=zeroed, bucket_on=bucket_on,
                     read_starts=read_starts, strat=strat)
    aux = dict(any_on=any_on, updated=do_update, threshold=threshold,
               benefit=ben, smu=smu, scores=scores, fhat=fhat_exp)
    return new_state, aux
