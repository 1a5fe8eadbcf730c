"""Dense genome-axis device kernels: scatter, window sums, fhat, threshold.

These replace the reference's per-contig numpy/bottleneck hot loops:

  * coverage scatter-add        <- np.add.at loops (runs/reference.py:122-144)
  * clamped-segment window sums <- bn.move_sum per contig per window
                                   (runs/reference.py:215-269); here a single
                                   cumulative sum + two clamped gathers per
                                   window, exact for min_count=1 semantics and
                                   respecting contig-block boundaries.
  * read-start posterior        <- readstartdist.py:86-117
  * exponent-binned threshold   <- find_strat_thread (runs/sequences.py:565-649)
                                   including its frexp |exponent| aliasing
                                   (exponent +1 of the max element and -1 share
                                   a bin) which we reproduce bit-for-bit at the
                                   decision level.

All functions are shape-polymorphic jnp code, jitted by the caller; window
sizes arrive as traced scalars so a changing read-length distribution never
triggers recompilation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------- scatter --

def scatter_add_3d(target, idx0, idx1, idx2, w):
    """target[idx0, idx1, idx2] += w with out-of-range entries dropped."""
    return target.at[idx0, idx1, idx2].add(w.astype(target.dtype), mode="drop")


def scatter_add_2d(target, idx0, idx1, w):
    return target.at[idx0, idx1].add(w.astype(target.dtype), mode="drop")


# ------------------------------------------------------------- window sums --

def _csum(x):
    """[..., N] -> [..., N+1] exclusive-prefix cumulative sum in f32."""
    cs = jnp.cumsum(x, axis=-1, dtype=jnp.promote_types(x.dtype, jnp.float32))
    zero = jnp.zeros(cs.shape[:-1] + (1,), cs.dtype)
    return jnp.concatenate([zero, cs], axis=-1)


def windowed_sums_fwd(cs, w, seg_end, rows, cs_at_seg_end=None):
    """out[..., r] = sum(x[r : min(r+w, seg_end[r])]).

    cs: exclusive cumsum of x ([..., N+1]); w: traced scalar window;
    seg_end: [N] exclusive segment bound; rows: [N] iota.
    Equals bn.move_sum(x[::-1], w, min_count=1)[::-1] per segment.

    Implemented as a dynamic shift (cs[r+w], a dynamic_slice copy)
    corrected at segment boundaries with a static gather (cs[seg_end]),
    instead of a traced-index gather over the whole axis.
    """
    n = rows.shape[0]
    pad = jnp.broadcast_to(cs[..., -1:], cs.shape[:-1] + (n,))
    cs2 = jnp.concatenate([cs, pad], axis=-1)
    shifted = jax.lax.dynamic_slice_in_dim(cs2, w, n, axis=-1)  # cs[r+w]
    if cs_at_seg_end is None:
        cs_at_seg_end = jnp.take(cs, seg_end, axis=-1)
    hi = jnp.where(rows + w <= seg_end, shifted, cs_at_seg_end)
    return hi - cs[..., :n]


def windowed_sums_rev(cs, w, seg_start, rows, cs_at_seg_start=None):
    """out[..., r] = sum(x[max(r+1-w, seg_start[r]) : r+1]).

    Equals bn.move_sum(x, w, min_count=1) per segment.
    """
    n = rows.shape[0]
    pad = jnp.zeros(cs.shape[:-1] + (n,), cs.dtype)
    cs2 = jnp.concatenate([pad, cs], axis=-1)
    # cs[r+1-w] = cs2[n + r + 1 - w]
    shifted = jax.lax.dynamic_slice_in_dim(cs2, n + 1 - w, n, axis=-1)
    if cs_at_seg_start is None:
        cs_at_seg_start = jnp.take(cs, seg_start, axis=-1)
    lo = jnp.where(rows + 1 - w >= seg_start, shifted, cs_at_seg_start)
    return cs[..., 1 : n + 1] - lo


def expected_benefit(scores_ds, approx_ccl_ds, seg_start, seg_end, mu_ds: int = 4):
    """(smu, benefit), both [..., N, 2], from downsampled scores [..., N].

    benefit = sum_i weight_i * window_sum(ccl_i) - smu, clipped >= 0, with the
    10 CCL piece weights 0.95..0.05 (runs/reference.py:241-269).

    Decision-precision contract: pass scores_ds in float64 (of f32 per-site
    scores). f64 sums of f32 values are exact for any reduction order until
    the running magnitude spends the 29 spare mantissa bits, so the window
    sums here match a sequential numpy f64 implementation to ~1 ulp; the
    weighted accumulation below is an UNROLLED sequential chain in the same
    order as the reference loop (reference.py:253-264) so no reassociation
    is introduced where full-mantissa f64 products are summed.
    """
    n = scores_ds.shape[-1]
    rows = jnp.arange(n, dtype=jnp.int32)
    cs = _csum(scores_ds)  # [..., n+1]
    # the 22 window sums share the one cumsum via dynamic-slice shifts; the
    # segment-boundary corrections gather cs[seg_end]/cs[seg_start] ONCE and
    # are reused by every window (instead of a stacked [11, n] traced-index
    # gather).
    cs_end = jnp.take(cs, seg_end, axis=-1)
    cs_start = jnp.take(cs, seg_start, axis=-1)

    fwd = lambda w: windowed_sums_fwd(cs, w, seg_end, rows, cs_at_seg_end=cs_end)
    rev = lambda w: windowed_sums_rev(cs, w, seg_start, rows, cs_at_seg_start=cs_start)
    mu_w = jnp.asarray(mu_ds, jnp.int32)
    smu = jnp.stack([fwd(mu_w), rev(mu_w)], axis=-1)  # [..., n, 2]
    # host-side f64 weight constants (bit-identical to the numpy oracle's);
    # python floats are weak-typed so the array dtype is preserved. The
    # accumulation is an UNROLLED sequential chain in the reference loop's
    # order (reference.py:253-264) so no reassociation is introduced.
    weights = [float(w) for w in np.arange(0.05, 1.0, 0.1)[::-1]]  # [10]
    wins = jnp.maximum(approx_ccl_ds, 1)
    ebf = weights[0] * fwd(wins[0])
    ebr = weights[0] * rev(wins[0])
    for k in range(1, 10):
        ebf = ebf + weights[k] * fwd(wins[k])
        ebr = ebr + weights[k] * rev(wins[k])
    eb = jnp.stack([ebf, ebr], axis=-1)
    return smu, jnp.maximum(eb - smu, 0.0)


# ------------------------------------------------------------------- fhat ---

def fhat_pointmass(read_starts, row_valid, n_windows: int, alpha: float = 1.0, p0: float = 0.1):
    """Posterior-mean read-start probability per (window, strand).

    read_starts: [W, 2] accumulated counts (padding rows all-zero);
    row_valid: [W] bool; n_windows: static count of real windows.
    Point mass at zero for unobserved windows (readstartdist.py:86-117).
    """
    dtype = read_starts.dtype
    csum = jnp.sum(read_starts)
    denom = 2.0 * n_windows * alpha + csum
    if alpha == 1.0:
        # B(1, z) = 1/z: closed form, no lgamma
        beta_num = 1.0 / ((2.0 * n_windows - 1.0) + csum)
        beta_denom = jnp.asarray(1.0 / (2.0 * n_windows - 1.0), dtype)
    else:
        beta_num = jnp.exp(
            jax.scipy.special.betaln(alpha, (2.0 * n_windows - 1.0) * alpha + csum)
        )
        beta_denom = jnp.exp(
            jax.scipy.special.betaln(jnp.asarray(alpha, dtype), (2.0 * n_windows - 1.0) * alpha)
        )
    beta_denom = jnp.where(beta_denom == 0, 1e-20, beta_denom)
    p0_bit = p0 / (p0 + (1.0 - p0))
    expected_post = (1.0 - p0_bit * (beta_num / beta_denom)) * (alpha / denom)
    fh = jnp.where(read_starts > 0, (alpha + read_starts) / denom, expected_post)
    return jnp.where(row_valid[:, None], fh, 0.0)


# -------------------------------------------------------- threshold scan ----

def frexp_abs_exponent(x, nbins: int):
    """|numpy.frexp exponent| of positive floats, clamped to [0, nbins-1].

    Exact IEEE semantics (no log2 rounding at bin edges): the biased
    exponent field is read straight from the bits. Subnormals go to the top
    bin — their benefit is ~0 and never near the threshold.
    """
    if x.dtype == jnp.float32:
        itype, shift, mask, bias = jnp.int32, 23, 0xFF, 126
    elif x.dtype == jnp.float64:
        itype, shift, mask, bias = jnp.int64, 52, 0x7FF, 1022
    else:
        raise TypeError(x.dtype)
    biased = (jax.lax.bitcast_convert_type(x, itype) >> shift) & mask
    a = jnp.abs(biased - bias).astype(jnp.int32)
    a = jnp.where(biased == 0, nbins - 1, a)  # subnormal
    return jnp.minimum(a, nbins - 1)


class ThresholdResult(NamedTuple):
    strat: jax.Array       # bool, same shape as benefit
    threshold: jax.Array   # scalar
    any_nonzero: jax.Array  # bool scalar


def bin_benefit(benefit, fhat, norm, nbins: int):
    """Exponent-bin the (local block of the) benefit array.

    Returns (counts [nbins], fsum [nbins], ubar0_partial_input) building
    blocks whose sums are reduction-order invariant: counts are integers and
    fsum sums f32-rounded fhat weights, so psum-ing per-shard partials gives
    bit-identical results to one global pass (see find_strategy).
    """
    dtype = benefit.dtype
    b = benefit.ravel()
    f = fhat.ravel().astype(dtype)
    nz = b > 0
    norm_safe = jnp.where(norm > 0, norm, 1.0)
    idx = frexp_abs_exponent(jnp.where(nz, b / norm_safe, 1.0), nbins)
    nzf = nz.astype(dtype)
    # counts are integers: scatter in int32 and cast — exact and
    # order-invariant either way
    counts = jnp.zeros(nbins, jnp.int32).at[idx].add(
        nz.astype(jnp.int32)).astype(dtype)
    fsum = jnp.zeros(nbins, dtype).at[idx].add(f * nzf)
    return counts, fsum


def ubar0_partial(fhat, smu, dtype):
    """Sum of f32-rounded fhat*smu products: f32 summands make the f64
    accumulation exact in any reduction order, so sharded and single-chip
    engines produce the identical ubar0 (the numpy oracle applies the same
    rounding — see oracle.full_update)."""
    return jnp.sum(
        (fhat.astype(dtype) * smu.astype(dtype)).astype(jnp.float32).astype(dtype)
    )


def threshold_from_bins(counts, fsum, norm, ubar0, time_cost, nbins: int,
                        window: int = 100):
    """Threshold scan over (already globally reduced) exponent bins."""
    dtype = counts.dtype
    alpha_t, rho_t, mu_t = 300 // window, 300 // window, 400 // window
    tc = (time_cost // window).astype(dtype)
    norm_safe = jnp.where(norm > 0, norm, 1.0)
    used = counts > 0
    f_mean = jnp.where(used, fsum / jnp.maximum(counts, 1.0), 0.0)
    bin_ids = jnp.arange(nbins, dtype=jnp.int32)
    benefit_bin = jnp.exp2(-bin_ids.astype(dtype)) * norm_safe
    tbar0 = jnp.asarray(alpha_t + rho_t + mu_t, dtype)
    cs_u = jnp.cumsum(benefit_bin * f_mean * counts) + ubar0
    cs_t = jnp.cumsum(tc * counts * f_mean) + tbar0
    peak = jnp.where(used, cs_u / cs_t, -jnp.inf)
    kmax = jnp.argmax(peak)
    # threshold bin: next used bin after kmax, else the last used bin
    after = used & (bin_ids > kmax)
    nxt = jnp.min(jnp.where(after, bin_ids, nbins))
    last_used = jnp.max(jnp.where(used, bin_ids, -1))
    thr_idx = jnp.where(nxt < nbins, nxt, last_used).astype(jnp.int32)
    return benefit_bin[jnp.maximum(thr_idx, 0)]


def find_strategy(benefit, smu, fhat, time_cost, nbins: int = 192, window: int = 100) -> ThresholdResult:
    """Global accept/reject threshold via binary-exponent binning.

    benefit/smu/fhat: same shape (any); time_cost: traced scalar.
    Mirrors sequences.py:565-649. The reference's runs/core.py:182-183 passes
    benefit where it means smu into the ubar0 term; we use the intended smu.
    The sharded engine (parallel/mesh.py) runs bin_benefit/ubar0_partial per
    genome shard, psums the bins, and feeds the same threshold_from_bins.
    """
    dtype = benefit.dtype
    any_nz = jnp.any(benefit > 0)
    norm = jnp.max(benefit)
    counts, fsum = bin_benefit(benefit, fhat, norm, nbins)
    ubar0 = ubar0_partial(fhat, smu, dtype)
    threshold = threshold_from_bins(counts, fsum, norm, ubar0, time_cost, nbins, window)
    strat = benefit >= threshold
    return ThresholdResult(strat=strat, threshold=threshold, any_nonzero=any_nz)


def estimate_fhat_priors(read_starts: np.ndarray) -> tuple[float, float]:
    """Method-of-moments estimate of the Dirichlet concentration alpha and
    the zero-window point mass p0 from accumulated read-start counts.

    Host-side helper (numpy) over the [W, 2] count matrix; equates the
    empirical variance of Fhat with the variance of a symmetric Dirichlet.
    Reference: boss/runs/readstartdist.py:156-178 (estimate_priors — defined
    but never called in the reference loop either; exposed here for parity
    and for offline prior tuning).
    """
    merged = np.asarray(read_starts, np.float64)
    n_windows = merged.shape[0]
    p0 = np.count_nonzero(merged == 0) / (n_windows * 2)
    csum = np.sum(merged) or 1e-30
    fhat = merged / csum
    vhat = np.var(fhat, ddof=0) or 1e-30
    lhs = (2 * n_windows - 1) / (vhat * 8 * (n_windows**3))
    alpha = float(lhs - 1 / (2 * n_windows))
    return alpha, float(p0)
