"""Genome-scale proof: multi-10-Mb to >=100 Mb diploid layouts through the
sharded engine.

BASELINE config 3 targets diploid chromosome
scale, and the scale evidence must be driver-visible. Two tiers:

* test_30mb_sharded_two_batches — IN THE DEFAULT SUITE: a 30 Mb diploid
  layout over the (1, 8) virtual CPU mesh, two full update steps with a
  real scattered read batch (minutes, well under 10 GB RAM).
* test_120mb_diploid_sharded_two_batches — gated behind BOSS_SCALE_TEST=1
  (needs ~30 GB host RAM); BOSS_SCALE_MB=1000 BOSS_SCALE_DEV=16 is the
  gigabase proof (measured 12 min 24 s / ~60 GB peak on the 4-CPU 125 GB
  host, round 3; captured log: docs/logs/scale_1gb.log).
"""
import os

import jax
import numpy as np
import pytest

from bossruns_tpu.io.coo_native import pad_split, split_runs
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.models.runs import ReadBatch
from bossruns_tpu.ops.model import make_model
from bossruns_tpu.parallel.mesh import ShardedRunsEngine, make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])


def _run_sharded(total: int, ndev: int, n_reads: int = 4000, rl: int = 400):
    """Build a diploid two-contig layout of `total` sites, shard it over
    ndev devices, run two full update steps, and check the invariants."""
    rng = np.random.default_rng(9)
    contigs = {
        "chrA": rng.integers(0, 4, int(total * 0.58)).astype(np.uint8),
        "chrB": rng.integers(0, 4, total - int(total * 0.58)).astype(np.uint8),
    }
    mesh = make_mesh(jax.devices()[:ndev], barcode_shards=1)
    layout = build_layout(contigs, align_chunks=ndev)
    assert layout.G_pad >= total
    eng = ShardedRunsEngine(layout, mesh, make_model(ploidy=2))
    state = eng.init_state()

    # scattered reads over both contigs, 2% mismatches
    rstart = rng.integers(0, layout.G_pad - rl, n_reads).astype(np.int64)
    pos = (rstart[:, None] + np.arange(rl)[None, :]).ravel()
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(sym.shape[0]) < 0.02
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    split = split_runs(
        layout, sym, np.full(sym.shape[0], 40, np.int8), rstart,
        np.full(n_reads, rl, np.int32), np.zeros(n_reads, np.int32),
    )
    padded = pad_split(split)
    batch = eng.put_batch(ReadBatch(
        rs_row=rng.integers(0, layout.n_fhat, n_reads).astype(np.int32),
        rs_strand=rng.integers(0, 2, n_reads).astype(np.int32),
        rs_w=np.ones(n_reads, np.float32),
        **padded,
    ))
    params = eng.make_params(CCL, 5300.0)

    for _ in range(2):
        state, aux = eng.step(state, batch, params)
    ah = eng.pull_aux(aux)

    # all observed bases landed (valid sites only; reads were drawn on-genome)
    cov = state.coverage
    assert cov.shape == (1, 5, layout.G_pad)
    total_cov = int(np.asarray(jax.jit(lambda c: c.sum(dtype=np.int64))(cov)))
    assert total_cov == 2 * (
        int(padded["mr_len"].sum(dtype=np.int64))
        + int((padded["ex_g"] != 0xFFFFFFFF).sum())
    )
    assert np.isfinite(ah.threshold)
    # strategy grid exists at full downsampled size and is boolean
    assert state.strat.shape == (1, layout.Gd_pad, 2)
    # the per-shard split is even: ndev equal genome blocks
    shard_sizes = {s.data.shape[-1] for s in cov.addressable_shards}
    assert shard_sizes == {layout.G_pad // ndev}


def test_30mb_sharded_two_batches():
    """Default-suite scale point: 30 Mb diploid over 8 shards."""
    _run_sharded(30_000_000, ndev=8, n_reads=2000)


@pytest.mark.skipif(
    not os.environ.get("BOSS_SCALE_TEST"),
    reason="genome-scale: set BOSS_SCALE_TEST=1 (slow, ~30 GB RAM)",
)
def test_120mb_diploid_sharded_two_batches():
    # BOSS_SCALE_MB=250 runs it at human-chr1 scale (BASELINE config 3);
    # BOSS_SCALE_MB=1000 BOSS_SCALE_DEV=16 is the gigabase proof of the
    # wide (barcode, uint32 position) batch format + uint16 coverage +
    # blocked scoring (XLA_FLAGS=--xla_force_host_platform_device_count=16
    # too, conftest only forces 8). The full 3.1 Gb human genome needs a
    # real 16-chip slice (see docs/DESIGN.md memory plan) because the
    # virtual CPU shards share one host's RAM.
    # Default 120 Mb / 8 shards stays under ~12 min.
    total = int(float(os.environ.get("BOSS_SCALE_MB", "120")) * 1e6)
    ndev = int(os.environ.get("BOSS_SCALE_DEV", "8"))
    _run_sharded(total, ndev=ndev)
