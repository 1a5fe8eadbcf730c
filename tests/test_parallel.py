"""Sharded (8 virtual devices) update step: runs and matches single-chip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.models.runs import ReadBatch, RunsEngine
from bossruns_tpu.parallel.mesh import ShardedRunsEngine, demo_sharded_step, make_mesh


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dryrun_multichip_2d_mesh():
    eng, state, aux = demo_sharded_step(n_devices=8, barcode_shards=2)
    assert dict(eng.mesh.shape) == {"b": 2, "g": 4}
    assert np.asarray(state.coverage).sum() > 0
    assert np.isfinite(float(aux.threshold))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_matches_single_chip(rng):
    contigs = {
        "a": rng.integers(0, 4, 130_000).astype(np.uint8),
        "b": rng.integers(0, 4, 110_000).astype(np.uint8),
    }
    mesh = make_mesh(jax.devices()[:8], barcode_shards=1)
    lay_s = build_layout(contigs, align_chunks=8)
    lay_1 = build_layout(contigs, align_chunks=8)  # same padding for comparison
    eng_s = ShardedRunsEngine(lay_s, mesh)
    eng_1 = RunsEngine(lay_1)

    from bossruns_tpu.io.coo_native import split_runs

    n_runs, run_len = 512, 64
    rstart = rng.integers(0, 100_000 - run_len, n_runs).astype(np.int32)
    pos = np.concatenate([np.arange(s0, s0 + run_len) for s0 in rstart])
    sym = lay_1.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.08
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    from bossruns_tpu.io.coo_native import pad_split

    split = split_runs(
        lay_1, sym, np.full(pos.shape[0], 40, np.int8), rstart.astype(np.int64),
        np.full(n_runs, run_len, np.int32), np.zeros(n_runs, np.int32),
    )
    kw = dict(
        pad_split(split),
        rs_row=rng.integers(0, lay_1.n_fhat, 512).astype(np.int32),
        rs_strand=rng.integers(0, 2, 512).astype(np.int32),
        rs_w=np.ones(512, np.float32),
    )
    batch = ReadBatch(**{k: jnp.asarray(v) for k, v in kw.items()})
    ccl = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
    p1 = eng_1.make_params(ccl, 5300.0)
    st_s = eng_s.init_state()
    st_1 = eng_1.init_state()
    for _ in range(3):
        st_s, aux_s = eng_s.step(st_s, eng_s.put_batch(batch), p1)
        st_1, aux_1 = eng_1.step(st_1, batch, p1)

    np.testing.assert_array_equal(np.asarray(st_s.coverage), np.asarray(st_1.coverage))
    np.testing.assert_array_equal(np.asarray(st_s.bucket_on), np.asarray(st_1.bucket_on))
    # f64 benefit sums of f32 scores are reassociation-exact, so sharding must
    # not change a single decision
    np.testing.assert_array_equal(np.asarray(st_s.strat), np.asarray(st_1.strat))
    assert bool(aux_s.any_on) == bool(aux_1.any_on)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sim_driver_with_mesh(corpus, tmp_path):
    """The [tpu] mesh config drives a sharded simulation end to end."""
    from bossruns_tpu.models.runs_sim import BossRunsSim

    sim = BossRunsSim(
        ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
        paf_trunc=corpus["paf_trunc"], name="mesh", batchsize=120, maxb=3,
        out_base=tmp_path, mesh_shards=(1, 4),
    )
    from bossruns_tpu.parallel.mesh import ShardedRunsEngine

    assert isinstance(sim.engine, ShardedRunsEngine)
    for _ in range(3):
        sim.process_batch()
    assert np.asarray(sim.state.coverage).sum() > 0
