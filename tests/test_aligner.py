"""Aligner: index/seeding/extension accuracy on ground-truth reads."""
import numpy as np
import pytest

from bossruns_tpu.aligner import TpuAligner
from bossruns_tpu.aligner.index import build_index, kmer_codes, selection_hash
from bossruns_tpu.io.paf import alignment_coverage, best_per_query
from bossruns_tpu.models.layout import build_layout, seq_to_int
from bossruns_tpu.utils.datagen import random_genome, simulate_reads


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    genome = random_genome(rng, {"gA": 180_000, "gB": 120_000})
    reads = simulate_reads(rng, genome, 250, mean_len=5000.0)
    lay = build_layout(genome)
    return genome, reads, lay, TpuAligner(lay)


def test_kmer_codes_roundtrip():
    seq = seq_to_int("ACGTACGTACGTACGTACGT")
    fwd, rc = kmer_codes(seq, k=15)
    # first k-mer ACGTACGTACGTACG packs deterministically
    expect = 0
    for b in seq[:15]:
        expect = (expect << 2) | int(b)
    assert fwd[0] == expect
    # reverse complement of position 0 equals packing the revcomp sequence
    rc_seq = (3 - seq[:15])[::-1]
    expect_rc = 0
    for b in rc_seq:
        expect_rc = (expect_rc << 2) | int(b)
    assert rc[0] == expect_rc


def test_index_excludes_padding(world):
    genome, _reads, lay, al = world
    idx = al.index
    valid = lay.site_valid()
    # no minimizer may start within k of padding/contig ends
    assert valid[idx.positions].all()
    spans_ok = idx.positions + idx.k <= lay.G_pad
    assert spans_ok.all()
    assert (np.diff(idx.keys) > 0).all()  # sorted unique
    assert idx.offsets[-1] == idx.positions.shape[0]


def test_host_device_minimizers_agree(world):
    import jax.numpy as jnp

    from bossruns_tpu.aligner.index import minimizer_mask
    from bossruns_tpu.aligner.seed import read_minimizers

    genome, _r, _l, _a = world
    seq = seq_to_int(genome["gA"][:4000])
    fwd, rc = kmer_codes(seq, 15)
    canonical = np.minimum(fwd, rc)
    ok = fwd != rc
    h = np.where(
        ok,
        selection_hash(canonical.astype(np.uint32) ^ (canonical >> 15).astype(np.uint32)),
        np.int32(2**31 - 1),
    )
    host_min = minimizer_mask(h, 10) & ok
    ck, cs, is_min = read_minimizers(jnp.asarray(seq[None, :].astype(np.int8)))
    dev_min = np.asarray(is_min)[0]
    # interior must agree exactly (edges differ: host 'nearest' vs device pad)
    w = 10
    sl = slice(w, len(h) - w)
    assert (host_min[sl] == dev_min[sl]).mean() == 1.0


def test_alignment_accuracy(world):
    genome, reads, lay, al = world
    seqs = {r.rid: r.seq for r in reads}
    rec = al.map_sequences(seqs)
    best = best_per_query(rec)
    truth = {r.rid: r for r in reads}
    long_reads = [r.rid for r in reads if len(r.seq) >= 500]
    mapped = [rid for rid in long_reads if rid in best]
    assert len(mapped) / len(long_reads) > 0.9
    good = 0
    for rid in mapped:
        i = best[rid]
        t = truth[rid]
        if (
            rec.tname[i] == t.tname
            and int(rec.rev[i]) == t.rev
            and abs(int(rec.tstart[i]) - t.tstart) <= 40
            and abs(int(rec.tend[i]) - t.tend) <= 40
        ):
            good += 1
    assert good / len(mapped) > 0.98, (good, len(mapped))


def test_cigar_expands_to_genome(world):
    genome, reads, lay, al = world
    seqs = {r.rid: r.seq for r in reads}
    rec = al.map_sequences(seqs)
    best = best_per_query(rec)
    lut = np.full(256, 4, np.uint8)
    for k, b in enumerate(b"ACGT"):
        lut[b] = k
    agree = []
    for rid in list(best)[:40]:
        i = best[rid]
        ts, te, sym, _q = alignment_coverage(rec, i, seqs[rid], "")
        gint = lut[np.frombuffer(genome[rec.tname[i]].encode(), np.uint8)[ts:te]]
        agree.append((sym == gint).mean())
    # ~3% substitutions + ~2% deletions simulated => ~95% agreement
    assert np.mean(agree) > 0.9


def test_truncated_mapping_five_prime_locus(world):
    genome, reads, lay, al = world
    seqs = {r.rid: r.seq for r in reads if len(r.seq) > 600}
    rec = al.map_sequences(seqs, trunc=True)
    best = best_per_query(rec)
    truth = {r.rid: r for r in reads}
    assert len(best) / len(seqs) > 0.85
    ok = 0
    for rid, i in best.items():
        t = truth[rid]
        if rec.tname[i] != t.tname or int(rec.rev[i]) != t.rev:
            continue
        if t.rev:
            ok += abs(int(rec.tend[i]) - t.tend) <= 40
        else:
            ok += abs(int(rec.tstart[i]) - t.tstart) <= 40
    assert ok / len(best) > 0.97


def test_sim_with_live_alignment(corpus, tmp_path):
    from bossruns_tpu.models.runs_sim import BossRunsSim

    sim = BossRunsSim(
        ref=corpus["ref"],
        fq=corpus["fq"],
        name="liveal",
        batchsize=120,
        maxb=3,
        out_base=tmp_path,
    )
    assert sim.aligner is not None
    for _ in range(3):
        sim.process_batch()
    assert np.asarray(sim.state.coverage).sum() > 0


def test_vote_matches_bucket_spec(rng):
    """The device run-length vote must equal the staggered-bucket numpy
    spec exactly, and keep the containment property that any cluster of
    diameter <= tol is counted in full by at least one grid. A broken scan
    here silently degrades overlap detection while mapping accuracy tests
    still pass."""
    import jax.numpy as jnp

    from bossruns_tpu.aligner import seed as seed_mod

    def vote_ref(keys_sorted, tol=seed_mod.DIAG_TOL):
        width = 2 * tol
        out = np.empty_like(keys_sorted)
        for r in range(keys_sorted.shape[0]):
            row = keys_sorted[r].astype(np.int64)
            for grid, off in ((0, 0), (1, tol)):
                b = (row + off) // width
                _u, inv, cnt = np.unique(b, return_inverse=True, return_counts=True)
                c = cnt[inv]
                out[r] = c if grid == 0 else np.maximum(out[r], c)
        return np.where(keys_sorted < seed_mod.SENTINEL, out, -1)

    kf = rng.integers(-5000, 5000, (6, 512)).astype(np.int32)
    kf[1, :] = 1234  # one giant cluster
    kf = np.sort(kf, axis=1)
    kf[0, -80:] = seed_mod.SENTINEL  # sorted rows end in sentinel padding
    v_new = np.asarray(seed_mod._vote(jnp.asarray(kf)))
    np.testing.assert_array_equal(v_new, vote_ref(kf))

    # containment: a compact cluster (diameter <= tol) at an arbitrary
    # offset always gets its full count on at least one grid
    tol = seed_mod.DIAG_TOL
    for start in (0, 100, tol - 1, tol, 2 * tol - 1, 3 * tol + 7):
        row = np.sort(rng.integers(start, start + tol + 1, 64)).astype(np.int32)
        pad = np.full(64, seed_mod.SENTINEL, np.int32)
        v = np.asarray(seed_mod._vote(jnp.asarray(
            np.concatenate([row, pad])[None, :])))[0]
        assert v[:64].max() == 64, f"start={start}: {v[:64].max()}"


def test_lookup_join_matches_searchsorted(rng):
    import jax.numpy as jnp

    from bossruns_tpu.aligner import seed as seed_mod

    # sorted unique keys with pow2 INT32_MAX padding + offsets
    nk = 1000
    keys_real = np.sort(rng.choice(2**20, nk, replace=False)).astype(np.int32)
    counts = rng.integers(1, 6, nk)
    offsets_real = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nkp = 2048
    keys = np.full(nkp, np.iinfo(np.int32).max, np.int32)
    keys[:nk] = keys_real
    offsets = np.full(nkp + 1, offsets_real[-1], np.int32)
    offsets[: nk + 1] = offsets_real

    q = np.concatenate([
        rng.choice(keys_real, 500),                # guaranteed hits
        rng.integers(0, 2**20, 500).astype(np.int32),  # mostly misses
    ]).astype(np.int32)
    valid = np.ones(q.shape[0], bool)
    valid[::17] = False
    hit, rank = seed_mod._lookup_join(
        jnp.asarray(keys), jnp.asarray(q), jnp.asarray(valid)
    )
    hit, rank = map(np.asarray, (hit, rank))
    loc = np.searchsorted(keys_real, q)
    loc_c = np.minimum(loc, nk - 1)
    exp_hit = valid & (keys_real[loc_c] == q)
    np.testing.assert_array_equal(hit, exp_hit)
    # the rank indexes the sorted key table (= pos_packed row)
    np.testing.assert_array_equal(rank[exp_hit], loc_c[exp_hit])
    assert (rank >= 0).all() and (rank < nkp).all()
    del offsets  # offsets no longer ride the device join (pos_packed does)


def test_overhanging_reads_near_contig_ends(rng):
    """Reads overhanging a short contig's end clip the DP window so some band
    rows have NO valid target columns (bhi < 0 in native/banded_align.cpp).
    A fill-loop bound regression here corrupted the heap silently; this pins
    the case end-to-end through map_sequences."""
    genome = random_genome(rng, {"tiny": 30_000})
    lay = build_layout(genome, min_len=10_000)
    al = TpuAligner(lay, k=13, w=5, min_votes=3)
    seq = genome["tiny"]
    extra = "".join(np.random.default_rng(3).choice(list("ACGT"), 4000))
    reads = {
        # starts 2 kb before the end, runs 4 kb past it
        "overhang_end": seq[28_000:] + extra,
        # ends exactly at the contig end
        "flush_end": seq[25_000:30_000],
        # fully internal control
        "internal": seq[10_000:16_000],
    }
    rec = al.map_sequences(reads)
    got = {rec.qname[i]: i for i in range(len(rec.qname))}
    assert "internal" in got
    for rid, i in got.items():
        assert 0 <= rec.tstart[i] < rec.tend[i] <= 30_000
    if "overhang_end" in got:
        i = got["overhang_end"]
        assert rec.tend[i] <= 30_000  # never walks past the contig


def test_index_disk_cache_roundtrip(tmp_path, rng):
    """load_or_build_index persists next to the fasta (the reference's .mmi
    analogue, reference.py:295-299) and invalidates on param change."""
    from bossruns_tpu.aligner.index import load_or_build_index

    fasta = tmp_path / "ref.fa"
    genome = random_genome(rng, {"c1": 30_000})["c1"]
    fasta.write_text(f">c1\n{genome}\n")
    lay = build_layout({"c1": genome}, min_len=1_000)
    a = load_or_build_index(lay.seq_int, lay.site_valid(), str(fasta))
    cache = tmp_path / "ref.fa.minidx.npz"
    assert cache.exists()
    b = load_or_build_index(lay.seq_int, lay.site_valid(), str(fasta))
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.positions, b.positions)
    # different params must not reuse the cached index
    c = load_or_build_index(lay.seq_int, lay.site_valid(), str(fasta), k=13, w=5)
    assert c.k == 13 and (len(c.keys) != len(a.keys) or not np.array_equal(c.keys, a.keys))
    # source change invalidates
    fasta.write_text(f">c1\n{random_genome(rng, {'c1': 30_000})['c1']}\n")
    lay2 = build_layout({"c1": fasta.read_text().splitlines()[1]}, min_len=1_000)
    d = load_or_build_index(lay2.seq_int, lay2.site_valid(), str(fasta))
    assert not np.array_equal(d.keys, a.keys) or not np.array_equal(d.positions, a.positions)


@pytest.mark.parametrize("seeding", ["device", "host"])
def test_all_extensions_failed_yields_no_records(world, monkeypatch, seeding):
    """A bucket in which every banded-DP job fails (empty CIGARs) maps to no
    records; record assembly must not index the empty CIGAR array."""
    from bossruns_tpu.aligner import native
    from bossruns_tpu.aligner.cpu_baseline import CpuAligner

    _genome, reads, lay, al = world
    if seeding == "host":
        al = CpuAligner(lay)

    def all_failed(queries_cat, q_off, *args, **kwargs):
        n = q_off.shape[0] - 1
        return (np.full(n, -1, np.int32), np.zeros(n, np.int64),
                np.zeros(n, np.int64), [np.zeros(0, np.uint32)] * n)

    monkeypatch.setattr(native, "align_batch", all_failed)
    seqs = {r.rid: r.seq for r in reads[:40]}
    for kw in (dict(trunc=True), dict()):
        rec = al.map_sequences(seqs, **kw)
        assert len(rec.qname) == 0 and rec.cigars == []
