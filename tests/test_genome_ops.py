"""Window sums, threshold scan and fhat kernels vs the f64 oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from bossruns_tpu import oracle
from bossruns_tpu.ops import genome_ops as gops


def test_windowed_sums_match_bn_move_sum_semantics(rng):
    # single segment: clamped cumsum gathers == the oracle's move_sum fwd/rev
    x = rng.random(513)
    n = x.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    cs = gops._csum(jnp.asarray(x))
    for w in (1, 4, 37, 512, 1000):
        f = gops.windowed_sums_fwd(cs, jnp.asarray(w), jnp.full(n, n, jnp.int32), rows)
        r = gops.windowed_sums_rev(cs, jnp.asarray(w), jnp.zeros(n, jnp.int32), rows)
        np.testing.assert_allclose(np.asarray(f), oracle.move_sum_fwd(x, w), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(r), oracle.move_sum_rev(x, w), rtol=1e-9)


def test_windowed_sums_respect_segments(rng):
    # two segments: windows must not cross the boundary
    x = rng.random(200)
    seg_start = np.array([0] * 120 + [120] * 80, np.int32)
    seg_end = np.array([120] * 120 + [200] * 80, np.int32)
    rows = jnp.arange(200, dtype=jnp.int32)
    cs = gops._csum(jnp.asarray(x))
    f = np.asarray(gops.windowed_sums_fwd(cs, jnp.asarray(50), jnp.asarray(seg_end), rows))
    r = np.asarray(gops.windowed_sums_rev(cs, jnp.asarray(50), jnp.asarray(seg_start), rows))
    ef = np.concatenate([oracle.move_sum_fwd(x[:120], 50), oracle.move_sum_fwd(x[120:], 50)])
    er = np.concatenate([oracle.move_sum_rev(x[:120], 50), oracle.move_sum_rev(x[120:], 50)])
    np.testing.assert_allclose(f, ef, rtol=1e-9)
    np.testing.assert_allclose(r, er, rtol=1e-9)


def test_expected_benefit_matches_oracle(rng):
    n = 1024
    x = rng.random(n) * np.exp(rng.normal(0, 3, n))  # wide dynamic range
    ccl = np.array([460, 300, 200, 150, 110, 80, 60, 40, 20, 8]) * 100
    seg_s = np.zeros(n, np.int32)
    seg_e = np.full(n, n, np.int32)
    smu_j, ben_j = gops.expected_benefit(
        jnp.asarray(x)[None], jnp.asarray(ccl // 100), jnp.asarray(seg_s), jnp.asarray(seg_e)
    )
    smu_o, ben_o = oracle.expected_benefit(x, ccl)
    # rtol 1e-8: both sides are f64 cumsum differences over inputs spanning
    # ~8 decades; eps * running-total can reach ~1e-9 relative on small windows
    np.testing.assert_allclose(np.asarray(smu_j)[0], smu_o, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ben_j)[0], ben_o, rtol=1e-8, atol=1e-12)


def _pow2_ulps(dtype, ks):
    p = np.asarray([2.0**k for k in ks], dtype)
    return np.concatenate([p, np.nextafter(p, dtype(0)), np.nextafter(p, dtype(np.inf))])


_FREXP_CASES = {
    "random": lambda rng: np.concatenate([
        rng.random(1000),
        2.0 ** rng.integers(-40, 1, 200).astype(np.float64),  # exact powers of 2
        np.array([1.0, 0.5, 0.25, 2.0**-30]),
    ]),
    # bin edges: a log2-based exponent rounds these into the wrong bin
    "pow2_ulps": lambda rng: _pow2_ulps(np.float64, [0, -1, -2, -30, -126, -127, -189, -190, -191]),
    # below f32's normal range: f32 subnormals, held as f64 values
    "f32_subnormal_range": lambda rng: np.array(
        [2.0**-127, 2.0**-140, 2.0**-149, 1e-40, 1.17e-38], np.float64),
    # f64 subnormals go to the top bin, as numpy's |exponent| clamps them
    "f64_subnormal": lambda rng: np.array(
        [5e-324, 2.0**-1074, 2.0**-1030, np.nextafter(2.0**-1022, 0.0), 2.0**-1022]),
    "tiny": lambda rng: np.array([2.0**-190, 2.0**-190 * 1.5, 2.0**-191, 1e-300]),
}


@pytest.mark.parametrize("case", sorted(_FREXP_CASES))
def test_frexp_abs_exponent_matches_numpy(rng, case):
    vals = _FREXP_CASES[case](rng)
    _, e_np = np.frexp(vals)
    expect = np.minimum(np.abs(e_np), 191)
    got = np.asarray(gops.frexp_abs_exponent(jnp.asarray(vals, jnp.float64), 192))
    np.testing.assert_array_equal(got, expect)
    # f32 path over the values that are f32 normals (f32 subnormals go to
    # the top bin by contract)
    v32 = vals.astype(np.float32)
    v32 = v32[v32 >= np.finfo(np.float32).tiny]
    _, e32 = np.frexp(v32)
    got32 = np.asarray(gops.frexp_abs_exponent(jnp.asarray(v32), 192))
    np.testing.assert_array_equal(got32, np.minimum(np.abs(e32), 191))


def test_frexp_abs_exponent_f32_subnormal_top_bin():
    v = np.array([1e-40, 2.0**-149, np.nextafter(np.finfo(np.float32).tiny, 0)], np.float32)
    got = np.asarray(gops.frexp_abs_exponent(jnp.asarray(v), 192))
    np.testing.assert_array_equal(got, 191)


def test_find_strategy_matches_oracle(rng):
    shape = (1, 700, 2)
    benefit = rng.random(shape) * np.exp(rng.normal(0, 4, shape))
    benefit[rng.random(shape) < 0.3] = 0.0
    smu = rng.random(shape)
    fhat = rng.random(shape) * 1e-3
    tc = 5300.0
    strat_o, thr_o = oracle.find_strategy(benefit, smu, fhat, tc)
    res = gops.find_strategy(
        jnp.asarray(benefit), jnp.asarray(smu), jnp.asarray(fhat), jnp.asarray(tc)
    )
    assert np.isclose(float(res.threshold), thr_o, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(res.strat), strat_o)


def test_find_strategy_f32_decision_parity(rng):
    shape = (2, 500, 2)
    benefit = (rng.random(shape) * np.exp(rng.normal(0, 4, shape))).astype(np.float64)
    benefit[rng.random(shape) < 0.4] = 0.0
    smu = rng.random(shape)
    fhat = rng.random(shape) * 1e-3
    strat_o, thr_o = oracle.find_strategy(benefit, smu, fhat, 5300.0)
    res = gops.find_strategy(
        jnp.asarray(benefit, jnp.float32), jnp.asarray(smu, jnp.float32),
        jnp.asarray(fhat, jnp.float32), jnp.asarray(5300.0, jnp.float32)
    )
    # decisions may differ only at exact bin edges; demand > 99.9% agreement
    agree = (np.asarray(res.strat) == strat_o).mean()
    assert agree > 0.999, agree


def test_fhat_pointmass_matches_oracle(rng):
    w = 50
    counts = rng.poisson(0.7, size=(w, 2)).astype(np.float64)
    fo = oracle.fhat_pointmass(counts)
    fj = gops.fhat_pointmass(jnp.asarray(counts), jnp.ones(w, bool), w)
    np.testing.assert_allclose(np.asarray(fj), fo, rtol=1e-9)


def test_estimate_fhat_priors():
    """Method-of-moments alpha/p0 (readstartdist.py:156-178 parity)."""
    from bossruns_tpu.ops.genome_ops import estimate_fhat_priors

    rng = np.random.default_rng(0)
    # near-uniform counts -> tiny variance -> huge alpha (strong prior)
    uniform = np.full((500, 2), 20.0)
    a_u, p0_u = estimate_fhat_priors(uniform)
    assert p0_u == 0.0
    # concentrated counts -> large variance -> small alpha
    spiky = np.zeros((500, 2))
    spiky[rng.integers(0, 500, 25), 0] = 400.0
    a_s, p0_s = estimate_fhat_priors(spiky)
    assert a_s < a_u
    assert 0.9 < p0_s <= 1.0  # almost all windows unobserved
    assert a_s > 0
