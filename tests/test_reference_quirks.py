"""Reference-quirk (bug-compatible) mode: engine Q1 parity, the full
bug-compatible oracle vs committed golden masks, and the Q2 data-plane quirk.

BASELINE's parity clause is "bit-identical strategy
decisions vs the reference"; the default pipeline deliberately fixes three
reference defects (docs/PARITY.md deviations 1-3), so this suite pins a mode
that reproduces them: RunsConfig(reference_quirks=True) (Q1 on device),
BossRunsSim(reference_quirks=True) (Q2 in the sim data plane), and
oracle_quirks.ReferenceQuirkOracle (the complete bug-compatible mask
computer, Q1+Q3+Q3b). Golden fixtures freeze the quirk-oracle's masks so the
reference-exact behaviour cannot silently drift.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.models.runs import ReadBatch, RunsConfig, RunsEngine
from bossruns_tpu.oracle_quirks import ReferenceQuirkOracle
from bossruns_tpu.ops.model import make_model
from tests.test_engine_parity import _random_batch, _soak

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
GOLDEN = Path(__file__).parent / "golden" / "quirk_masks.npz"


def test_engine_quirk1_matches_quirk_oracle(rng):
    """Engine with reference_quirks=True must agree EXACTLY with the f64
    oracle in quirk mode over a soak (the Q1 ubar0 swap on both sides)."""
    seqA = rng.integers(0, 4, 150_000).astype(np.uint8)
    seqB = rng.integers(0, 4, 120_000).astype(np.uint8)
    lay = build_layout({"a": seqA, "b": seqB})
    eng = RunsEngine(lay, config=RunsConfig(debug_aux=True, reference_quirks=True))
    state, updated = _soak(rng, lay, eng, n_steps=8, n_obs=120_000,
                           ccl=CCL, tc=5300.0, reference_quirks=True)
    assert updated >= 5


def test_quirk1_changes_decisions(rng):
    """The quirk flag must actually matter: same inputs, default vs quirk
    engines, masks eventually differ (ubar0 shifts the threshold peak)."""
    seq = rng.integers(0, 4, 150_000).astype(np.uint8)
    lay = build_layout({"a": seq})
    eng_d = RunsEngine(lay, config=RunsConfig())
    eng_q = RunsEngine(lay, config=RunsConfig(reference_quirks=True))
    st_d, st_q = eng_d.init_state(), eng_q.init_state()
    params = eng_d.make_params(CCL, 5300.0)
    differed = False
    for _ in range(6):
        b = _random_batch(rng, lay, n_obs=100_000)
        jb = ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})
        st_d, _ = eng_d.step(st_d, jb, params)
        st_q, _ = eng_q.step(st_q, jb, eng_q.make_params(CCL, 5300.0))
        if not np.array_equal(np.asarray(st_d.strat), np.asarray(st_q.strat)):
            differed = True
    assert differed, "quirk mode produced identical masks over the whole soak"


# ------------------------------------------------------ quirk oracle --------

def drive_quirk_oracle():
    """Deterministic drive of the bug-compatible oracle: accumulate three
    rounds of coverage + read starts, then one update step. Returns
    (quirk masks, fixed-pipeline masks on the SAME state) — the fixed side
    differs only in Q1 (ubar0 from real S_mu) and Q3 (exact per-contig rows,
    no merge drift), so the agreement fraction isolates those two quirks."""
    rng = np.random.default_rng(42)
    contigs = {
        "a": rng.integers(0, 4, 150_000).astype(np.uint8),
        "b": rng.integers(0, 4, 120_000).astype(np.uint8),
    }
    qo = ReferenceQuirkOracle(contigs, make_model(ploidy=1))
    for _round in range(4):
        for name, seq in contigs.items():
            n_runs, run_len = 1500, 40
            starts = rng.integers(0, 25_000 - run_len, n_runs)
            pos = (starts[:, None] + np.arange(run_len)[None, :]).ravel()
            sym = seq[pos].astype(np.int64)
            flip = rng.random(pos.shape[0]) < 0.05
            sym[flip] = rng.integers(0, 5, int(flip.sum()))
            qo.increment(name, pos, sym)
        qo.count_read_starts(
            {n: rng.integers(0, len(s), 50) for n, s in contigs.items()},
            {n: rng.integers(0, len(s), 50) for n, s in contigs.items()},
        )
    masks_q = qo.step(CCL, 5300.0)
    masks_d = _fixed_masks(qo)
    return masks_q, masks_d


def _fixed_masks(qo: ReferenceQuirkOracle) -> dict:
    """The repaired pipeline on the quirk oracle's own state: exact
    len//100 rows per contig (no Q3 drift), ubar0 from the real S_mu (no
    Q1). Shares scores/fhat/buckets with the quirk side so the mask delta
    isolates Q1+Q3."""
    from bossruns_tpu.oracle_quirks import WINDOW, adjust_length

    fhat_exp = qo._fhat()
    fhat_exp = np.repeat(fhat_exp[:, :, np.newaxis], qo.nb, axis=2)
    bens, smus = [], []
    for c in qo.filt.values():
        smu, ben = qo._benefits(c, CCL)
        bens.append(ben[: c.length // WINDOW])
        smus.append(smu[: c.length // WINDOW])
    benefit = np.concatenate(bens)
    smu = np.concatenate(smus)
    fhat_adj = adjust_length(benefit.shape[0], fhat_exp)
    strat, _thr = qo._find_strat(benefit, smu, fhat_adj, 5300.0)
    masks, i = {}, 0
    for n, c in qo.filt.items():
        nr = c.length // WINDOW
        expand = 20_000 // WINDOW
        buckets = adjust_length(nr, np.repeat(c.bucket_switches, expand, axis=0))
        out = np.ones((nr, 2, qo.nb), bool)
        for b in range(qo.nb):
            out[buckets[:, b], :, b] = strat[i: i + nr][buckets[:, b], :, b]
        masks[n] = out
        i += nr
    return masks


def test_quirk_oracle_matches_golden_fixture():
    """The bug-compatible masks are frozen: recompute and compare to the
    committed fixture bit-for-bit."""
    masks_q, masks_d = drive_quirk_oracle()
    assert GOLDEN.exists(), (
        "golden fixture missing — regenerate with "
        "python tests/make_quirk_golden.py"
    )
    with np.load(GOLDEN) as z:
        for name, arr in masks_q.items():
            np.testing.assert_array_equal(arr, z[name], err_msg=name)

    # quantify the quirk impact for docs/PARITY.md: masks agree on most rows
    # but NOT all (Q1+Q3 shift decisions)
    agree = np.concatenate([
        (masks_q[n] == masks_d[n]).ravel() for n in masks_d
    ])
    frac = float(agree.mean())
    print(f"quirk-vs-default mask agreement: {frac:.6f}")
    assert 0.5 < frac < 1.0, frac


def test_quirk_oracle_row_drift_shape():
    """Structural pin of Q3: the quirk oracle's merged benefit carries
    len//100 + 1 rows per contig while strategies carry len//100 — contig
    j's strategy slice starts j rows early in the merged array."""
    rng = np.random.default_rng(1)
    contigs = {
        "a": rng.integers(0, 4, 110_000).astype(np.uint8),
        "b": rng.integers(0, 4, 105_000).astype(np.uint8),
    }
    qo = ReferenceQuirkOracle(contigs, make_model(ploidy=1))
    masks = qo.step(CCL, 5300.0)  # no coverage: buckets off, strat = initial
    assert masks["a"].shape == (1100, 2, 1)
    assert masks["b"].shape == (1050, 2, 1)
    assert masks["a"].all() and masks["b"].all()  # init strat = ones
    # n_sites target: merged rows Σ(len//100+1) = 2152 trim to 2150
    assert qo.n_sites // 100 == 2150


def test_quirk2_rejected_rev_coverage(tmp_path):
    """BossRunsSim(reference_quirks=True): rejected reverse-strand reads
    contribute the read's LAST mu bases — same target positions, different
    SYMBOLS than the default (correct) pipeline. Engine Q1 is pinned off on
    both sides so the first coverage divergence can only come from Q2; after
    that batch the differing symbols feed different masks, so only the first
    divergence is checked."""
    from bossruns_tpu.models.runs_sim import BossRunsSim
    from bossruns_tpu.utils.datagen import write_corpus

    paths = write_corpus(tmp_path / "data", rng=np.random.default_rng(3),
                         contig_lengths={"c1": 150_000}, n_reads=2200)

    def make(quirks):
        return BossRunsSim(
            ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
            paf_trunc=paths["paf_trunc"], name=f"q{int(quirks)}",
            batchsize=300, maxb=6, out_base=tmp_path / f"q{int(quirks)}",
            reference_quirks=quirks, config=RunsConfig(),  # engine Q1 off
        )

    sim_d, sim_q = make(False), make(True)
    for step in range(6):
        sim_d.process_batch()
        sim_q.process_batch()
        cd = np.asarray(sim_d.state.coverage)
        cq = np.asarray(sim_q.state.coverage)
        if not np.array_equal(cd, cq):
            # first divergence is symbol-only: positional mass identical
            np.testing.assert_array_equal(
                cd.sum(axis=1, dtype=np.int64), cq.sum(axis=1, dtype=np.int64),
                err_msg=f"step {step}: Q2 must not move coverage positions",
            )
            return
    pytest.fail("no rejected reverse-strand read diverged coverage in 6 batches")
