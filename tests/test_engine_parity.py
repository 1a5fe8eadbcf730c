"""Full update-step parity: device engine vs f64 numpy oracle pipeline.

Decision-precision contract (BASELINE.md "bit-identical decisions"): per-site
scores are f32 (score correctness is covered by test_model_scores and
test_reference_goldens); everything downstream — benefit window sums, fhat,
the frexp threshold scan, the accept/reject comparison — runs in f64 on
device and must agree EXACTLY with the sequential numpy f64 oracle given the
same scores, over a 20-batch soak. No tolerance.
"""
import jax.numpy as jnp
import numpy as np

from bossruns_tpu import oracle
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.models.runs import ReadBatch, RunsConfig, RunsEngine


def _random_batch(rng, lay, n_obs, nb=1, n_rs=300, run_len=40, len_b=5):
    # coverage as short runs concentrated into contig prefixes so buckets
    # switch on; match-run + explicit format (models/runs.py ReadBatch)
    from bossruns_tpu.io.coo_native import split_runs

    n_runs = n_obs // run_len
    starts = []
    for c in range(lay.n_contigs):
        span = min(25_000, int(lay.lengths[c])) - run_len
        starts.append(lay.offsets[c] + rng.integers(0, span, n_runs // lay.n_contigs))
    rstart = np.concatenate(starts).astype(np.int32)
    rspan = np.full(rstart.shape[0], run_len, np.int32)
    rbc = rng.integers(0, nb, rstart.shape[0]).astype(np.int32)
    pos = np.concatenate([np.arange(s0, s0 + run_len) for s0 in rstart])
    sym = lay.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    qual = np.full(pos.shape[0], 40, np.int8)
    from bossruns_tpu.io.coo_native import pad_split

    split = split_runs(lay, sym, qual, rstart.astype(np.int64), rspan, rbc, 0, len_b)
    return dict(
        pad_split(split),
        rs_row=rng.integers(0, lay.n_fhat, n_rs).astype(np.int32),
        rs_strand=rng.integers(0, 2, n_rs).astype(np.int32),
        rs_w=np.ones(n_rs, np.float32),
    )


def _soak(rng, lay, eng, n_steps, n_obs, ccl, tc, reference_quirks=False):
    """Run engine + oracle side by side; demand exact decision agreement."""
    state = eng.init_state()
    state_np = {k: np.asarray(v) for k, v in state._asdict().items()}
    state_np["read_starts"] = state_np["read_starts"].astype(np.float64)
    params = eng.make_params(ccl, tc)
    updated_steps = 0
    for step in range(n_steps):
        b = _random_batch(rng, lay, n_obs=n_obs)
        jb = ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})
        state, aux = eng.step(state, jb, params)
        # same f32 scores into the oracle: isolates the f64 decision pipeline
        scores = np.asarray(aux.scores)
        state_np, aux_o = oracle.full_update(
            eng, state_np, b, ccl, tc, scores_override=scores,
            reference_quirks=reference_quirks,
        )
        assert bool(aux.any_on) == aux_o["any_on"], step
        assert bool(aux.updated) == aux_o["updated"], step
        np.testing.assert_array_equal(
            np.asarray(state.coverage), state_np["coverage"], err_msg=f"step {step}"
        )
        np.testing.assert_array_equal(
            np.asarray(state.bucket_on), state_np["bucket_on"], err_msg=f"step {step}"
        )
        np.testing.assert_array_equal(
            np.asarray(state.read_starts, np.float64), state_np["read_starts"]
        )
        # EXACT strategy agreement — the whole point of the f64 decision path
        np.testing.assert_array_equal(
            np.asarray(state.strat), state_np["strat"], err_msg=f"step {step}"
        )
        if aux_o["updated"]:
            updated_steps += 1
            # norm/max can differ by ~1 ulp where XLA's scan rounds; decisions
            # above are still demanded exact
            np.testing.assert_allclose(
                float(aux.threshold), aux_o["threshold"], rtol=1e-12
            )
    return state, updated_steps


def test_engine_matches_oracle_decisions_exactly(rng):
    seqA = rng.integers(0, 4, 150_000).astype(np.uint8)
    seqB = rng.integers(0, 4, 120_000).astype(np.uint8)
    lay = build_layout({"a": seqA, "b": seqB})
    eng = RunsEngine(lay, config=RunsConfig(debug_aux=True))
    assert eng.benefit_dtype == jnp.float64  # x64 on in tests
    ccl = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
    state, updated = _soak(rng, lay, eng, n_steps=20, n_obs=120_000, ccl=ccl, tc=5300.0)
    assert updated >= 15  # strategy actually exercised through the soak
    frac = np.asarray(state.strat)[:, lay.strat_row_valid, :].mean()
    assert 0.0 < frac < 1.0  # some sites rejected, some accepted


def test_engine_matches_oracle_decisions_diploid(rng):
    from bossruns_tpu.ops.model import make_model

    seq = rng.integers(0, 4, 140_000).astype(np.uint8)
    lay = build_layout({"a": seq})
    eng = RunsEngine(lay, make_model(ploidy=2), RunsConfig(debug_aux=True))
    ccl = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
    state, updated = _soak(rng, lay, eng, n_steps=5, n_obs=100_000, ccl=ccl, tc=5300.0)
    assert updated >= 2


def test_step_hlo_embeds_no_genome_constants(rng):
    """Genome-sized constants must travel as ARGUMENTS of the jitted step:
    closure-captured arrays get embedded as O(G) literals in the HLO, which
    bloats executables and their compiles. Lower the step and check no
    genome-shaped constant appears."""
    import re

    seq = rng.integers(0, 4, 210_000).astype(np.uint8)
    lay = build_layout({"a": seq})
    eng = RunsEngine(lay)
    state = eng.init_state()
    b = _random_batch(rng, lay, n_obs=20_000)
    jb = ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    params = eng.make_params(
        np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400]),
        5300.0,
    )
    hlo = eng._jit_step.lower(state, jb, params, eng._consts).as_text()
    g = lay.G_pad
    bad = [
        ln for ln in hlo.splitlines()
        if "constant" in ln and re.search(rf"\[(5,)?{g}\]", ln)
    ]
    assert not bad, bad[:3]
