"""Per-site posterior / entropy / expected-benefit-score kernels (JAX).

The score of a genome site is the expected decrease in Shannon entropy of the
genotype posterior after observing one more read symbol at that site (the
mutual information between the next observation and the genotype).

Reference semantics: /root/reference/boss/runs/sequences.py:460-549
(calc_posterior + calc_score). The reference precomputes a ~3.3 GB 6-D lookup
table (sequences.py:347-393) because per-site Python math is slow; on the
device we recompute every site densely each update. Moreover the score
admits a closed form that removes the reference's [sites, symbols,
genotypes] intermediate entirely: with p the posterior, phi[b,g] = P(obs b | genotype g) and
sum_b phi[b,g] = 1,

    score = sum_g p[g] * k[g]  -  sum_b q[b] * log q[b]
    k[g]  = sum_b phi[b,g] * log phi[b,g]        (a [G] constant)
    q     = p @ phi.T                            (next-observation probability)

so the whole genome scores reduce to two small matmuls ([N,B]x[B,G] for the
log-likelihood, [N,G]x[G,B] for q) plus elementwise ops — fused by XLA, and
trivially shardable along the site axis N.

Counts are clipped at 990 like the reference's phi_stored indexing guard
(sequences.py:493).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .model import ObservationModel

COUNT_CLIP = 990


class ScoreTables:
    """Device-resident constants derived from an ObservationModel."""

    def __init__(self, model: ObservationModel, dtype=jnp.float32):
        self.model = model
        self.dtype = dtype
        self.len_b = model.len_b
        phi = model.phi
        self.phi = jnp.asarray(phi, dtype)
        self.log_phi = jnp.asarray(model.log_phi, dtype)
        self.log_prior = jnp.asarray(model.log_prior, dtype)
        # k[g] = sum_b phi log phi (negative per-genotype observation entropy)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(phi > 0, phi * np.log(np.where(phi > 0, phi, 1.0)), 0.0).sum(0)
        self.k = jnp.asarray(k, dtype)


def site_log_posterior(counts, ref_base, tables: ScoreTables):
    """log posterior over genotypes per site.

    counts: [..., B>=len_b] observation counts, ref_base: [...] int in 0..3.
    Returns log_post [..., G].
    """
    c = jnp.clip(counts[..., : tables.len_b], 0, COUNT_CLIP).astype(tables.dtype)
    # Precision.HIGHEST: a default-precision f32 matmul may run in TF32 on
    # the GPU (10-bit mantissa inputs, ~3 decimal digits): the clipped
    # counts stay exact, but log_phi loses most of its digits — fatal for a
    # score that is a small difference of O(1) entropy terms (the strategy
    # feedback loop amplifies the error into divergent accept/reject
    # trajectories).
    ll = jnp.dot(
        c,
        tables.log_phi,
        preferred_element_type=tables.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    lp = ll + tables.log_prior[ref_base]
    lse = jax.scipy.special.logsumexp(lp, axis=-1, keepdims=True)
    return lp - lse


def site_scores(counts, ref_base, tables: ScoreTables):
    """(score, entropy) per site; closed form, see module docstring."""
    log_post = site_log_posterior(counts, ref_base, tables)
    post = jnp.exp(log_post)
    entropy = -jnp.sum(post * log_post, axis=-1)
    q = jnp.dot(
        post,
        tables.phi.T,
        preferred_element_type=tables.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )  # [..., B]
    qlogq = jnp.where(q > 0, q * jnp.log(jnp.where(q > 0, q, 1.0)), 0.0)
    score = jnp.sum(post * tables.k, axis=-1) - jnp.sum(qlogq, axis=-1)
    return score, entropy


def prior_score(model: ObservationModel, dtype=jnp.float64) -> tuple[float, float]:
    """(score0, entropy0) of a zero-coverage site (matches Scoring.score0/ent0,
    sequences.py:342)."""
    t = ScoreTables(model, dtype)
    c = jnp.zeros((1, model.len_b), dtype)
    r = jnp.zeros((1,), jnp.int32)
    s, e = site_scores(c, r, t)
    return float(s[0]), float(e[0])


def site_scores_t(counts_t, ref_base, tables: ScoreTables):
    """(score, entropy) with the genome axis last: counts_t [..., B, N].

    The long site axis is last (contiguous), so elementwise and reduction
    work runs along it instead of along a 5-wide minor axis. Same math as
    site_scores.
    """
    dtype = tables.dtype
    c = jnp.clip(counts_t[..., : tables.len_b, :], 0, COUNT_CLIP).astype(dtype)
    # ll[..., g, n] = sum_b log_phi[b, g] * c[..., b, n]
    # HIGHEST precision: see site_log_posterior — TF32-truncated inputs
    # corrupt the tiny score differences this pipeline thresholds on.
    ll = jnp.einsum(
        "bg,...bn->...gn",
        tables.log_phi,
        c,
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    # prior selection via one-hot matmul, NOT a gather: a gather makes an
    # [N, G_t] temp with a tiny trailing axis, while the matmul keeps the
    # genome axis last; with HIGHEST precision the 0/1 products select
    # exactly, so results are bit-identical to the gather.
    onehot = (
        ref_base[..., None, :] == jnp.arange(4, dtype=ref_base.dtype)[:, None]
    ).astype(dtype)  # [..., 4, N]
    prior_n = jnp.einsum(
        "bg,...bn->...gn",
        tables.log_prior,
        onehot,
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    lp = ll + prior_n  # [..., G, N]
    lse = jax.scipy.special.logsumexp(lp, axis=-2, keepdims=True)
    log_post = lp - lse
    post = jnp.exp(log_post)
    entropy = -jnp.sum(post * log_post, axis=-2)
    q = jnp.einsum(
        "bg,...gn->...bn",
        tables.phi,
        post,
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    qlogq = jnp.where(q > 0, q * jnp.log(jnp.where(q > 0, q, 1.0)), 0.0)
    score = jnp.sum(post * tables.k[:, None], axis=-2) - jnp.sum(qlogq, axis=-2)
    return score, entropy


def site_scores_t_scan(counts_t, ref_base, tables: ScoreTables, block: int):
    """Scores only, computed in genome-axis blocks of ``block`` sites.

    site_scores_t keeps ~3 live [genotypes, N] float temporaries through the
    posterior/logsumexp chain — at a 3.1 Gb diploid genome (15 genotypes)
    that is ~12 GB per 16-way shard, the dominant transient in the whole
    step. Scoring has no cross-site dependency, so a lax.scan over
    dynamic-sliced blocks caps the temporaries at [genotypes, block] while
    producing bit-identical results (same per-site dot products, HIGHEST
    precision). The scanned output buffer is updated in place.

    ``block`` must divide the site-axis length (engines pass a chunk-aligned
    divisor); block <= 0 or block >= N falls back to the one-shot form.
    """
    N = counts_t.shape[-1]
    if block <= 0 or block >= N or N % block:
        return site_scores_t(counts_t, ref_base, tables)[0]
    lead = counts_t.shape[:-2]
    out0 = jnp.zeros((*lead, N), tables.dtype)

    def body(buf, i):
        c = jax.lax.dynamic_slice_in_dim(counts_t, i * block, block, axis=-1)
        r = jax.lax.dynamic_slice_in_dim(ref_base, i * block, block, axis=-1)
        s, _ = site_scores_t(c, r, tables)  # entropy is dead code (DCE'd)
        return jax.lax.dynamic_update_slice_in_dim(buf, s, i * block, axis=-1), None

    buf, _ = jax.lax.scan(
        body, out0, jnp.arange(N // block, dtype=jnp.int32)
    )
    return buf
