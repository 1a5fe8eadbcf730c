"""Host seeding mirrors the device seeding kernels candidate-for-candidate.

The CPU baseline aligner (aligner/cpu_baseline.py) and the small-batch host
fast paths are only honest stand-ins if they select the SAME minimizers,
anchors and diagonal clusters as the device kernels (aligner/seed.py). These
tests pin voted candidates equal field-by-field on a synthetic corpus with
mismatches, indels, reverse strands and a repeat."""
import numpy as np
import pytest

from bossruns_tpu.aligner import LENGTH_BUCKETS, encode
from bossruns_tpu.aligner.host_seed import host_seed_candidates, host_seed_topn
from bossruns_tpu.aligner.index import build_index
from bossruns_tpu.aligner.seed import (NCAND, DeviceIndex, seed_and_vote,
                                       seed_candidates)
from bossruns_tpu.utils.datagen import simulate_reads


@pytest.fixture(scope="module")
def corpus_small(rng=None):
    rng = np.random.default_rng(77)
    G = 120_000
    base = rng.integers(0, 4, G).astype(np.uint8)
    # plant a repeat: copy a 3 kb block to a second locus
    base[80_000:83_000] = base[20_000:23_000]
    B = np.array(list("ACGT"))
    genome = {"g": "".join(B[base])}
    valid = np.ones(G, bool)
    idx = build_index(base, valid, k=15, w=10, max_occ=64)
    sim = simulate_reads(rng, genome, 300, mean_len=1500.0, sd_len=800.0)
    return idx, [encode(r.seq) for r in sim]


def _pad_matrix(enc, L):
    mat = np.full((len(enc), L), 4, np.int8)
    for r, e in enumerate(enc):
        mat[r, : min(e.shape[0], L)] = e[:L]
    return mat


def test_topn_matches_device(corpus_small):
    idx, enc = corpus_small
    L = next(b for b in LENGTH_BUCKETS if max(e.shape[0] for e in enc) <= b)
    dev = seed_and_vote(_pad_matrix(enc, L), DeviceIndex(idx), ncand=NCAND)
    host = host_seed_topn([e[:L] for e in enc], idx, L, ncand=NCAND)
    voted = dev["votes"] > 0
    assert voted[:, 0].mean() > 0.9  # the corpus actually maps
    for f in ("strand", "bkey", "votes", "dspan", "qmin", "qmax"):
        np.testing.assert_array_equal(
            host[f][voted], dev[f].astype(np.int64)[voted], err_msg=f
        )
    # unmapped placeholders agree on votedness
    np.testing.assert_array_equal(host["votes"] > 0, voted)


def test_candidates_match_device(corpus_small):
    idx, enc = corpus_small
    L = next(b for b in LENGTH_BUCKETS if max(e.shape[0] for e in enc) <= b)
    dev = seed_candidates(_pad_matrix(enc, L), DeviceIndex(idx), ncand=4)
    host = host_seed_candidates([e[:L] for e in enc], idx, ncand=4, L=L)
    voted = dev["votes"] > 0
    assert voted.any(axis=1).mean() > 0.9  # each read maps in SOME space
    for f in ("votes", "strand", "qmin", "qmax", "tmin", "tmax"):
        np.testing.assert_array_equal(
            host[f][voted], dev[f].astype(np.int64)[voted], err_msg=f
        )
    np.testing.assert_array_equal(host["votes"] > 0, voted)


def test_empty_inputs():
    rng = np.random.default_rng(1)
    tiny = rng.integers(0, 4, 64).astype(np.uint8)
    idx = build_index(tiny, np.ones(64, bool))
    out = host_seed_topn([], idx, 512)
    assert out["votes"].shape == (0, NCAND)
    base = rng.integers(0, 4, 5000).astype(np.uint8)
    idx2 = build_index(base, np.ones(5000, bool))
    out2 = host_seed_topn([encode("ACGT" * 100)], idx2, 512)
    assert out2["votes"].shape == (1, NCAND)


def test_cpu_aligner_matches_tpu_records(corpus_small):
    """CpuAligner (host seeding + native DP) emits byte-identical records to
    TpuAligner (device seeding) — they share candidate planning and extension, and seeding is
    pinned identical above."""
    from bossruns_tpu.aligner import TpuAligner
    from bossruns_tpu.aligner.cpu_baseline import CpuAligner
    from bossruns_tpu.models.layout import build_layout

    rng = np.random.default_rng(99)
    G = 120_000
    base = rng.integers(0, 4, G).astype(np.uint8)
    B = np.array(list("ACGT"))
    genome = {"g": "".join(B[base])}
    lay = build_layout({"g": base})
    sim = simulate_reads(rng, genome, 120, mean_len=1200.0, sd_len=500.0)
    seqs = {r.rid: r.seq for r in sim}
    dev = TpuAligner(lay, k=15, w=10, min_votes=4)
    cpu = CpuAligner(lay, k=15, w=10, min_votes=4)
    for kw in (dict(trunc=True), dict()):
        rt = dev.map_sequences(seqs, **kw)
        rc = cpu.map_sequences(seqs, **kw)
        assert list(rt.qname) == list(rc.qname)
        for f in ("qstart", "qend", "rev", "tstart", "tend", "nmatch",
                  "blocklen", "mapq", "align_score", "s1", "primary"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rc, f), err_msg=f)
        for a, b in zip(rt.cigars, rc.cigars):
            np.testing.assert_array_equal(a, b)
