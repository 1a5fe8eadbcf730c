"""Observation model + score kernel conformance vs the f64 oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from bossruns_tpu import oracle
from bossruns_tpu.ops.model import make_model
from bossruns_tpu.ops.scores import ScoreTables, prior_score, site_scores


@pytest.mark.parametrize("ploidy", [1, 2])
@pytest.mark.parametrize("deletion_error", [0.03, 0.0])
def test_phi_columns_are_distributions(ploidy, deletion_error):
    m = make_model(ploidy=ploidy, deletion_error=deletion_error)
    np.testing.assert_allclose(m.phi.sum(axis=0), 1.0, atol=1e-12)
    assert (m.phi > 0).all()
    assert m.prior.shape[0] == 4


def test_phi_haploid_default_values():
    # haploid with deletions, defaults: diag 0.93, off-diag 0.04/3,
    # deletion row 0.03, missed-deletion col 0.1/4 (sequences.py:70-91)
    m = make_model(ploidy=1)
    assert m.len_b == 5 and m.len_g == 5
    np.testing.assert_allclose(np.diag(m.phi)[:4], 1 - 0.04 - 0.03)
    np.testing.assert_allclose(m.phi[4, :4], 0.03)
    np.testing.assert_allclose(m.phi[:4, 4], 0.1 / 4)
    np.testing.assert_allclose(m.phi[4, 4], 0.9)
    np.testing.assert_allclose(m.phi[0, 1], 0.04 / 3)


def test_prior_haploid_default_values():
    m = make_model(ploidy=1)
    np.testing.assert_allclose(np.diag(m.prior)[:4], 1 - 0.01 * 1.4)
    np.testing.assert_allclose(m.prior[:, 4], 0.01 * 0.4)


def test_diploid_genotype_count():
    assert make_model(ploidy=2).len_g == 15
    assert make_model(ploidy=2, deletion_error=0).len_g == 10


@pytest.mark.parametrize("ploidy", [1, 2])
@pytest.mark.parametrize("deletion_error", [0.03, 0.0])
def test_scores_match_oracle_f64(rng, ploidy, deletion_error):
    m = make_model(ploidy=ploidy, deletion_error=deletion_error)
    counts = rng.integers(0, 40, size=(800, 5)).astype(np.int32)
    if m.len_b == 4:
        counts[:, 4] = 0
    ref = rng.integers(0, 4, size=800).astype(np.int32)
    so, eo = oracle.site_scores(counts, ref, m)
    sj, ej = site_scores(jnp.asarray(counts), jnp.asarray(ref), ScoreTables(m, jnp.float64))
    # atol floor: below ~1e-11 the closed form and the reference's
    # entropy-difference form diverge relatively (both are numerically zero)
    np.testing.assert_allclose(np.asarray(sj), so, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ej), eo, rtol=1e-8, atol=1e-11)


def test_scores_f32_accuracy_on_decision_relevant_sites(rng):
    m = make_model(ploidy=1)
    counts = rng.integers(0, 25, size=(5000, 5)).astype(np.int32)
    ref = rng.integers(0, 4, size=5000).astype(np.int32)
    so, _ = oracle.site_scores(counts, ref, m)
    s32, _ = site_scores(jnp.asarray(counts), jnp.asarray(ref), ScoreTables(m, jnp.float32))
    s32 = np.asarray(s32, np.float64)
    mask = so > 1e-3  # sites that can influence the strategy threshold
    assert mask.sum() > 100
    np.testing.assert_allclose(s32[mask], so[mask], rtol=2e-2)
    big = so > 1e-1
    np.testing.assert_allclose(s32[big], so[big], rtol=5e-4)


def test_prior_score_matches_oracle():
    m = make_model(ploidy=1)
    s0, e0 = prior_score(m)
    so, eo = oracle.site_scores(np.zeros((1, 5), np.int32), np.zeros(1, np.int32), m)
    assert abs(s0 - so[0]) < 1e-12
    assert abs(e0 - eo[0]) < 1e-12


def test_clip_at_990(rng):
    m = make_model(ploidy=1)
    counts = np.array([[2000, 0, 1, 0, 0]], np.int32)
    clipped = np.array([[990, 0, 1, 0, 0]], np.int32)
    ref = np.zeros(1, np.int32)
    t = ScoreTables(m, jnp.float64)
    s1, _ = site_scores(jnp.asarray(counts), jnp.asarray(ref), t)
    s2, _ = site_scores(jnp.asarray(clipped), jnp.asarray(ref), t)
    assert float(s1[0]) == float(s2[0])


def test_score_matmuls_pin_highest_precision():
    """Every dot_general in the scoring closed form must carry HIGHEST
    precision. A default-precision f32 matmul may run in TF32 on the GPU
    (~3 decimal digits of log_phi), and reduced-precision scores were seen
    to drive the strategy feedback loop into a divergent accept-all
    trajectory in a 42-batch soak run. CPU computes true f32 either way, so
    only this jaxpr check catches a regression off-hardware."""
    import jax
    import jax.numpy as jnp

    from bossruns_tpu.ops.scores import ScoreTables, site_scores_t

    m = make_model(ploidy=1)
    t = ScoreTables(m, jnp.float32)
    counts = jnp.zeros((1, 5, 256), jnp.int32)
    ref = jnp.zeros(256, jnp.int32)
    jaxpr = jax.make_jaxpr(lambda c, r: site_scores_t(c, r, t))(counts, ref)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) >= 2, "expected the ll and q contractions to be matmuls"
    for e in dots:
        prec = e.params.get("precision")
        flat = prec if isinstance(prec, (tuple, list)) else (prec,)
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in flat
        ), f"dot_general without HIGHEST precision: {e.params}"


def test_blocked_scores_bit_identical(rng):
    """site_scores_t_scan (genome-axis blocked; caps [genotypes, N] temps)
    must reproduce the one-shot kernel bit for bit under jit — the engine's
    context. (Eager vs jit can differ ~1 ulp from different XLA fusion of the
    same chain, so both sides are compared as jitted functions.)"""
    import jax
    import jax.numpy as jnp

    from bossruns_tpu.ops.scores import (
        ScoreTables,
        site_scores_t,
        site_scores_t_scan,
    )

    N = 12 * 1024
    counts = jnp.asarray(rng.integers(0, 40, (2, 5, N)).astype(np.uint16))
    seq = jnp.asarray(rng.integers(0, 4, N).astype(np.int8))
    for ploidy in (1, 2):
        t = ScoreTables(make_model(ploidy=ploidy), jnp.float32)
        full = jax.jit(lambda c, r: site_scores_t(c, r, t)[0])(counts, seq)
        for block in (1024, 999, 10 * N):  # non-dividing/oversized fall back
            blocked = jax.jit(
                lambda c, r, b=block: site_scores_t_scan(c, r, t, b)
            )(counts, seq)
            np.testing.assert_array_equal(
                np.asarray(full), np.asarray(blocked), err_msg=f"block={block}"
            )
