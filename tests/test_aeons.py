"""BOSS-AEONS: kmer stats, classification, assembly, benefit, end-to-end sim."""
import numpy as np
import pytest

from bossruns_tpu.aeons import kmer
from bossruns_tpu.aeons.assembly import initial_assembly
from bossruns_tpu.aeons.ava import PoolIndex, find_overlaps, rows_to_records
from bossruns_tpu.aeons.benefit import contig_strategies
from bossruns_tpu.aeons.classify import classify
from bossruns_tpu.aeons.pool import LinkStore, Sequence, SequencePool
from bossruns_tpu.config import BossConfig
from bossruns_tpu.utils.datagen import random_genome, simulate_reads


# ---------------------------------------------------------------- kmer ------

def test_kmer_counts_include_revcomp():
    # AAAA counted together with TTTT (seq + revcomp, kmer.py:54-68)
    counts = kmer.kmer_counts("AAAAA", 4)
    idx_aaaa = 0
    idx_tttt = 0b11111111
    assert counts[idx_aaaa] == 2
    assert counts[idx_tttt] == 2


def test_tetramer_distance_separates_composition(rng):
    a1 = "".join(rng.choice(list("AACGT"), 5000))  # A-rich
    a2 = "".join(rng.choice(list("AACGT"), 5000))
    b = "".join(rng.choice(list("GGGCT"), 5000))   # G-rich
    fa1, fa2, fb = map(kmer.tetramer_freqs, (a1, a2, b))
    assert kmer.euclidean_dist(fa1, fa2) < kmer.euclidean_dist(fa1, fb)
    assert kmer.is_intra(fa1, fa2)
    assert not kmer.is_intra(fa1, fb)


def test_tetramer_zscores_shape():
    z = kmer.tetramer_zscores("ACGT" * 2000)
    assert z.shape == (256,)
    assert np.isfinite(z).all()


# ------------------------------------------------------------- classify -----

def _mk_records(rows):
    from bossruns_tpu.io.paf import PafRecords

    keys = "qname qlen qstart qend rev tname tlen tstart tend".split()
    cols = {k: [r[j] for r in rows] for j, k in enumerate(keys)}
    n = len(rows)
    big = [20_000] * n
    return PafRecords(
        qname=np.array(cols["qname"], object), qlen=np.array(cols["qlen"]),
        qstart=np.array(cols["qstart"]), qend=np.array(cols["qend"]),
        rev=np.array(cols["rev"], np.int8), tname=np.array(cols["tname"], object),
        tlen=np.array(cols["tlen"]), tstart=np.array(cols["tstart"]),
        tend=np.array(cols["tend"]), nmatch=np.array(big), blocklen=np.array(big),
        mapq=np.zeros(n, np.int64), align_score=np.array(big), s1=np.array(big),
        primary=np.ones(n, np.int8), cigars=[None] * n,
    )


def test_classification_cases():
    rows = [
        # q contained in t (fwd): small overhangs into a bigger target
        ("a", 5000, 10, 4990, 0, "b", 20000, 8000, 13000, 0),
        # t contained in q
        ("c", 20000, 8000, 13000, 0, "d", 5000, 10, 4990, 0),
        # dovetail fwd: q suffix ~ t prefix => 4, R, L
        ("e", 10000, 4000, 9990, 0, "f", 10000, 5, 6000, 0),
        # internal match: big overhangs both sides
        ("g", 20000, 8000, 11000, 0, "h", 20000, 9000, 12000, 0),
        # self alignment filtered
        ("i", 9000, 0, 9000, 0, "i", 9000, 0, 9000, 0),
    ]
    cls = classify(_mk_records(rows))
    assert cls.c[0] == 2
    assert cls.c[1] == 3
    assert cls.c[2] == 4 and cls.qside[2] == "R" and cls.tside[2] == "L"
    assert cls.c[3] in (1, 6)
    assert cls.c[4] == 0


# -------------------------------------------------------------- assembly ----

@pytest.fixture(scope="module")
def asm_world():
    rng = np.random.default_rng(9)
    genome = random_genome(rng, {"g": 80_000})
    reads = simulate_reads(rng, genome, 220, mean_len=6000.0, min_len=1000)
    seqs = {r.rid: r.seq for r in reads}
    pool = initial_assembly(seqs, min_seq_len=2500)
    return genome, reads, pool


def test_assembly_produces_long_contigs(asm_world):
    genome, reads, pool = asm_world
    lens = sorted((len(s.seq) for s in pool.sequences.values()), reverse=True)
    assert lens[0] > 15_000  # merges happened
    assert sum(lens) < 2.0 * len(genome["g"])  # no runaway duplication


def test_assembly_contigs_map_back_contiguously(asm_world):
    genome, reads, pool = asm_world
    pidx = PoolIndex({"g": genome["g"]})
    longest = {
        h: s.seq
        for h, s in sorted(pool.sequences.items(), key=lambda kv: -len(kv[1].seq))[:3]
    }
    rows = find_overlaps(longest, pidx, min_votes=4, exclude_self=False)
    best = {}
    for i in range(len(rows["qname"])):
        q = rows["qname"][i]
        cov = (rows["qend"][i] - rows["qstart"][i]) / len(longest[q])
        best[q] = max(best.get(q, 0.0), cov)
    # every long unitig aligns to the genome as (mostly) one chain
    assert all(v > 0.6 for v in best.values()), best


def test_containment_increment_dag():
    pool = SequencePool(min_len=10)
    pool.sequences["big"] = Sequence("big", "A" * 1000)
    pool.sequences["mid"] = Sequence("mid", "A" * 500)
    pool.sequences["small"] = Sequence("small", "A" * 200)
    rows = [
        # small contained in mid (q cont), mid contained in big
        ("small", 200, 0, 200, 0, "mid", 500, 100, 300, 0),
        ("mid", 500, 0, 500, 0, "big", 1000, 200, 700, 0),
    ]
    rec = _mk_records(rows)
    containments = {
        ("small", "mid"): (rec, 0, True),
        ("mid", "big"): (rec, 1, True),
    }
    contained = pool.increment(containments)
    assert contained == {"small", "mid"}
    big = pool.sequences["big"].cov
    # chain: small's coverage flowed into mid (processed first), then mid+small
    # into big
    # big[200+x] corresponds to mid[x]; small covered mid[100:300]
    assert big[450] == 3.0  # big(1) + mid(1) + small(1)
    assert big[600] == 2.0  # big(1) + mid(1)
    assert big[100] == 1.0


def test_contig_strategies_shapes_and_threshold():
    rng = np.random.default_rng(0)
    contigs = {}
    for name, L in (("c1", 30_000), ("c2", 12_345)):
        s = Sequence(name, "A" * L)
        s.cov = rng.uniform(0, 30, L).astype(np.float32)
        contigs[name] = s
    ccl = np.array([20000, 14000, 10000, 7000, 5000, 3500, 2500, 1700, 900, 300])
    strats, thr = contig_strategies(contigs, ccl=ccl, lam=6000.0, lowcov=10)
    assert strats["c1"].shape == (300, 2)
    assert strats["c2"].shape == (124, 2)
    assert thr > 0
    frac = np.mean([s.mean() for s in strats.values()])
    assert 0.0 < frac <= 1.0


def _numpy_contig_strategies(contigs, ccl, lam, lowcov=10.0, mu=400,
                             end_lim=50):
    """Sequential numpy mirror of the device strategy kernel's spec
    (aeons/benefit.py): sigmoid chunk scores, end nodes of interest,
    segment-clamped window sums with virtual unit mass beyond uncapped
    ends, exponent-bin threshold scan with ubar0 = sum(smu)."""
    NODE = 100
    names = list(contigs)
    ccl_ds = np.maximum(np.asarray(ccl) // NODE, 1).astype(int)
    weights = np.arange(0.1, 1.1, 0.1)[::-1]
    mu_ds = mu // NODE
    tc = max((lam - mu - 300) // NODE, 1.0)
    tbar0 = 200 // NODE + 300 // NODE + mu_ds
    bens, smus, meta = [], [], []
    for h in names:
        s = contigs[h]
        cc = np.add.reduceat(s.cov, np.arange(0, len(s.cov), NODE))
        cm = np.minimum(cc // NODE, 100).astype(np.float32)
        sc = (1.0 / (np.exp(cm - np.float32(lowcov)) + 1.0)).astype(np.float32)
        end_l = not s.cap_l and cc[0] <= end_lim * NODE
        end_r = not s.cap_r and cc[-1] <= end_lim * NODE
        if end_l:
            sc[0] = 1.0
        if end_r:
            sc[-1] = 1.0
        n = sc.shape[0]

        def win_fwd(w):
            out = np.zeros(n, np.float64)
            for i in range(n):
                hi = min(i + w, n)
                out[i] = sc[i:hi].sum(dtype=np.float64)
                if end_r:
                    out[i] += min(max(i + w - n, 0), w)
            return out

        def win_rev(w):
            out = np.zeros(n, np.float64)
            for i in range(n):
                lo = max(i + 1 - w, 0)
                out[i] = sc[lo : i + 1].sum(dtype=np.float64)
                if end_l:
                    out[i] += min(max(0 - (i + 1 - w), 0), w)
            return out

        smu = np.stack([win_fwd(mu_ds), win_rev(mu_ds)], axis=-1)
        eb = np.zeros((n, 2))
        for i in range(10):
            w = int(ccl_ds[i])
            eb[:, 0] += weights[i] * win_fwd(w)
            eb[:, 1] += weights[i] * win_rev(w)
        bens.append(np.maximum(eb - smu, 0.0))
        smus.append(smu)
        meta.append((h, n))
    b = np.concatenate([x.ravel() for x in bens])
    smu_sum = float(np.concatenate([x.ravel() for x in smus]).sum())
    nz = b[b > 0]
    if nz.size == 0:
        return {h: np.ones((n, 2), bool) for h, n in meta}, 0.0
    norm = b.max()
    _m, e = np.frexp(nz / norm)
    idx = np.abs(e)
    counts = np.bincount(idx, minlength=192).astype(float)
    used = counts > 0
    bin_ids = np.arange(192)
    bbin = np.exp2(-bin_ids.astype(float)) * norm
    cs_u = np.cumsum(bbin * counts) + smu_sum
    cs_t = np.cumsum(tc * counts) + tbar0
    peak = np.where(used, cs_u / cs_t, -np.inf)
    kmax = int(np.argmax(peak))
    after = np.flatnonzero(used & (bin_ids > kmax))
    thr_idx = int(after[0]) if after.size else int(np.max(bin_ids[used]))
    thr = float(bbin[thr_idx])
    strats, off = {}, 0
    for h, n in meta:
        strats[h] = bens[names.index(h)] >= thr
        off += n
    return strats, thr


@pytest.mark.parametrize("backend", ["device", "host"])
def test_contig_strategies_matches_numpy_mirror(rng, backend):
    """Both production backends (device kernel: uint8 upload, on-device
    segment expansion, bit-packed mask pull; host: vectorised f64 mirror)
    vs a sequential numpy mirror of the spec: same threshold and >= 99.9%
    identical mask bits (the frexp-bin scan is ulp-robust; window sums may
    differ in the last float32 bit)."""
    contigs = {}
    for name, L, base in (("cA", 25_000, 3.0), ("cB", 9_000, 20.0),
                          ("cC", 14_000, 8.0)):
        s = Sequence(name, "A" * L)
        s.cov = (rng.uniform(0, 2 * base, L)).astype(np.float32)
        contigs[name] = s
    contigs["cB"].cap_l = True  # one capped end: no virtual mass there
    ccl = np.array([20000, 14000, 10000, 7000, 5000, 3500, 2500, 1700, 900, 300])
    dev, thr_dev = contig_strategies(contigs, ccl=ccl, lam=6000.0, lowcov=10,
                                     backend=backend)
    ref, thr_ref = _numpy_contig_strategies(contigs, ccl, lam=6000.0, lowcov=10)
    assert thr_ref > 0  # the drive must exercise a real threshold
    assert thr_dev == pytest.approx(thr_ref, rel=1e-5)
    total = agree = 0
    for h in contigs:
        assert dev[h].shape == ref[h].shape
        total += dev[h].size
        agree += int((dev[h] == ref[h]).sum())
    assert agree / total >= 0.999, f"mask agreement {agree}/{total}"


def test_uncapped_low_coverage_ends_are_kept(rng):
    # high coverage everywhere except the uncapped ends -> ends accepted
    s = Sequence("c", "A" * 40_000)
    s.cov = np.full(40_000, 60.0, np.float32)
    s.cov[:600] = 1.0
    s.cov[-600:] = 1.0
    ccl = np.array([20000, 14000, 10000, 7000, 5000, 3500, 2500, 1700, 900, 300])
    strats, thr = contig_strategies({"c": s}, ccl=ccl, lam=6000.0, lowcov=10)
    st = strats["c"]
    assert st[0, 0] or st[0, 1]      # left end interesting
    assert st[-1, 0] or st[-1, 1]    # right end interesting
    assert st.mean() < 0.9           # bulk rejected


# ------------------------------------------------------------ end-to-end ----

def test_aeons_sim_end_to_end(tmp_path, monkeypatch):
    from bossruns_tpu.aeons.simulation import BossAeonsSim
    from bossruns_tpu.utils.datagen import write_corpus

    monkeypatch.chdir(tmp_path)
    paths = write_corpus(
        tmp_path / "data",
        rng=np.random.default_rng(21),
        contig_lengths={"gA": 100_000},
        n_reads=1300,
        mean_len=5000.0,
    )
    args = BossConfig()
    args.general.name = "aeons_t"
    args.simulation.fq = paths["fq"]
    args.simulation.batchsize = 140
    args.simulation.maxb = 3
    args.simulation.binit = 4
    args.optional.min_seq_len = 2500
    args.optional.min_contig_len = 10_000
    sim = BossAeonsSim(args, out_base=tmp_path)
    init_longest = max(len(s.seq) for s in sim.pool.sequences.values())
    assert init_longest > 10_000
    for _ in range(3):
        sim.process_batch()
    assert (tmp_path / "out_aeons_t" / "masks" / "boss.npz").exists()
    assert (tmp_path / "out_aeons_t" / "contigs" / "aeons.fa").exists()
    assert sim.strat  # strategies exist
    assert sim.accept_count + sim.reject_count > 0  # decisions engaged
    assert sim.read_cache.time_boss <= sim.read_cache.time_control


def test_repeat_filter_drops_repeat_ended_reads(rng):
    from bossruns_tpu.aeons.repeats import RepeatFilter
    from bossruns_tpu.utils.datagen import random_genome, simulate_reads

    base = random_genome(rng, {"u": 60_000})["u"]
    repeat = random_genome(rng, {"r": 1_500})["r"]
    # genome with a high-copy (6x) repeat
    parts = [base[i * 10_000 : (i + 1) * 10_000] + repeat for i in range(6)]
    genome = {"g": "".join(parts)}
    reads = simulate_reads(rng, genome, 200, mean_len=5000.0, min_len=3000)
    seqs = {r.rid: r.seq for r in reads}
    rf = RepeatFilter(seqs)
    assert rf.repeats, "repeat blocks should be detected"
    # reads whose window starts inside the repeat get flagged when the repeat
    # sits near an end
    filtered = rf.filter_batch(seqs)
    assert len(filtered) <= len(seqs)
    # a clean read far from repeats survives
    clean = {"clean": base[32_000:37_000]}
    kept = rf.filter_batch(clean)
    assert "clean" in kept


def test_multiline_containment_recovery():
    """A 12 kb read contained in a 40 kb read, fragmented into 3 internal-match
    records by indel drift, must be recovered as one merged containment
    (sequences.py:1373-1515). Sparse fragments must NOT fire."""
    from bossruns_tpu.aeons.classify import multiline_containments

    rows = [
        # q=small (12 kb) inside t=big (40 kb): three co-linear pieces
        ("small", 12000, 100, 4100, 0, "big", 40000, 10100, 14100, 0),
        ("small", 12000, 4200, 8300, 0, "big", 40000, 14250, 18300, 0),
        ("small", 12000, 8400, 11900, 0, "big", 40000, 18400, 21900, 0),
        # a pair with only sparse occupancy: two tiny distant pieces
        ("x", 30000, 100, 2100, 0, "y", 35000, 100, 2100, 0),
        ("x", 30000, 27000, 29000, 0, "y", 35000, 31000, 33000, 0),
    ]
    rec = _mk_records(rows)
    cls = classify(rec)
    assert (cls.c[:3] == 1).all(), cls.c  # all fragments are internal matches
    merged, roles = multiline_containments(rec, cls)
    assert len(roles) == 1
    row, q_cont = roles[0]
    assert q_cont and merged.qname[row] == "small" and merged.tname[row] == "big"
    assert merged.qstart[row] == 100 and merged.qend[row] == 11900
    assert merged.tstart[row] == 10100 and merged.tend[row] == 21900
    assert merged.s1[row] == 60000  # summed weights


def test_multiline_containment_feeds_increment():
    """Through LinkStore.load_records the merged record must become a
    containment edge and propagate coverage onto the container."""
    pool = SequencePool(min_len=100)
    rng = np.random.default_rng(3)
    big = "".join(rng.choice(list("ACGT"), 40000))
    pool.ingest({"big": big, "small": big[10100:21900]})
    rows = [
        ("small", 11800, 0, 4000, 0, "big", 40000, 10100, 14100, 0),
        ("small", 11800, 4100, 8200, 0, "big", 40000, 14200, 18300, 0),
        ("small", 11800, 8300, 11800, 0, "big", 40000, 18400, 21900, 0),
    ]
    store = LinkStore(tetra=False)
    containments, _ovl = store.load_records(_mk_records(rows), pool)
    assert ("small", "big") in containments
    before = pool.sequences["big"].cov[10100:21900].sum()
    contained = pool.increment(containments)
    assert contained == {"small"}
    after = pool.sequences["big"].cov[10100:21900].sum()
    assert after > before  # contained read's coverage landed on the container


def test_aeons_sim_crash_resume(tmp_path, monkeypatch):
    """Kill the sim mid-run, resume from the checkpoint, and converge to the
    same contigs/strategy as an uninterrupted run."""
    from bossruns_tpu.aeons.simulation import BossAeonsSim
    from bossruns_tpu.utils.datagen import write_corpus

    monkeypatch.chdir(tmp_path)
    paths = write_corpus(
        tmp_path / "data",
        rng=np.random.default_rng(33),
        contig_lengths={"gA": 100_000},
        n_reads=1300,
        mean_len=5000.0,
    )

    def mk_args():
        args = BossConfig()
        args.general.name = "aeons_r"
        args.simulation.fq = paths["fq"]
        args.simulation.batchsize = 140
        args.simulation.maxb = 4
        args.simulation.binit = 4
        args.optional.min_seq_len = 2500
        args.optional.min_contig_len = 10_000
        return args

    # uninterrupted reference run in its own dir
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    full = BossAeonsSim(mk_args(), out_base=ref_dir)
    full.checkpoint_every = 0
    for _ in range(4):
        full.process_batch()

    # interrupted run: 2 batches, checkpoint every batch, then "crash"
    sim1 = BossAeonsSim(mk_args(), out_base=tmp_path)
    sim1.checkpoint_every = 1
    for _ in range(2):
        sim1.process_batch()
    batch_at_crash = sim1.batch
    del sim1

    args2 = mk_args()
    args2.optional.resume = True
    sim2 = BossAeonsSim(args2, out_base=tmp_path)
    assert sim2.batch == batch_at_crash  # restored, initial asm skipped
    for _ in range(2):
        sim2.process_batch()

    def contig_sig(sim):
        # unitig names are random ids (utils.misc.random_id); compare content
        pool = sim.pool.declare_contigs(10_000).sequences
        return {s.seq: sid for sid, s in pool.items()}

    sig_full, sig_res = contig_sig(full), contig_sig(sim2)
    assert set(sig_res) == set(sig_full)  # identical contig sequences
    for seq, sid_full in sig_full.items():
        np.testing.assert_array_equal(
            sim2.strat[sig_res[seq]], full.strat[sid_full]
        )


def test_ultralong_overlap_single_unfragmented_dovetail():
    """100 kb ultralong reads at ~10% error incl. drift-heavy asymmetric
    indels: ONE overlap record per true overlap, covering
    (nearly) the whole shared region, classifying as a proper dovetail —
    what the reference gets from minimap2's chaining
    (/root/reference/boss/aeons/sequences.py:538-563). Root-caused in round
    5: the ava path truncated reads to the 32 kb device bucket and capped
    anchors at 1024 slots (~the first 6 kb), so ultralong dovetails
    surfaced as short internal matches; the host-only 131 kb bucket +
    raised anchor budget fix that, and gap-bounded chain merging
    (merge_chains) covers residual cluster splits."""
    from bossruns_tpu.utils.datagen import _simulate_alignment

    g = random_genome(np.random.default_rng(3), {"g": 160_000})["g"]
    a, _ = _simulate_alignment(np.random.default_rng(4), g[:120_000],
                               sub=0.02, ins=0.07, dele=0.01)
    b, _ = _simulate_alignment(np.random.default_rng(5), g[20_000:140_000],
                               sub=0.02, ins=0.07, dele=0.01)
    pidx = PoolIndex({"A": a})
    merged = find_overlaps({"B": b}, pidx, merge=True)
    assert len(merged["qname"]) == 1, merged["qname"]
    span = merged["qend"][0] - merged["qstart"][0]
    assert span >= 0.9 * 100_000, span  # ~100 kb true overlap, ~full cover
    rec = rows_to_records(merged)
    cls = classify(rec)
    assert int(cls.c[0]) in (4, 5), int(cls.c[0])


def _rows(entries):
    keys = "qname qlen qstart qend rev tname tlen tstart tend nmatch blocklen s1".split()
    return {k: [e[j] for e in entries] for j, k in enumerate(keys)}


def test_merge_chains_joins_only_collinear_adjacent_fragments():
    """merge_chains (minimap2-style bounded gap/drift joining): fragments
    of ONE alignment (collinear diagonals, small gap) join; co-diagonal
    repeat clusters separated by a large gap and overlapping alternates do
    NOT (round 4's diagonal-only merge fused those and stalled unitigs)."""
    from bossruns_tpu.aeons.ava import merge_chains

    # (qname qlen qstart qend rev tname tlen tstart tend nmatch blocklen s1)
    frag = _rows([
        ("q", 100_000, 1_000, 40_000, 0, "t", 120_000, 11_000, 50_500, 700, 39_500, 700),
        ("q", 100_000, 41_000, 80_000, 0, "t", 120_000, 51_800, 91_000, 700, 39_200, 700),
    ])
    m = merge_chains(frag)
    assert len(m["qname"]) == 1
    assert m["qstart"][0] == 1_000 and m["qend"][0] == 80_000
    assert m["tstart"][0] == 11_000 and m["tend"][0] == 91_000
    assert m["nmatch"][0] == 1400

    # same diagonal, 30 kb apart on both axes (a two-copy repeat): keep both
    rep = _rows([
        ("q", 100_000, 1_000, 10_000, 0, "t", 120_000, 11_000, 20_000, 300, 9_000, 300),
        ("q", 100_000, 40_000, 50_000, 0, "t", 120_000, 50_000, 60_000, 300, 10_000, 300),
    ])
    assert len(merge_chains(rep)["qname"]) == 2

    # heavily overlapping q spans (alternate placements): keep both
    alt = _rows([
        ("q", 100_000, 1_000, 40_000, 0, "t", 120_000, 11_000, 50_000, 700, 39_000, 700),
        ("q", 100_000, 2_000, 39_000, 0, "t", 120_000, 12_500, 49_000, 650, 37_000, 650),
    ])
    assert len(merge_chains(alt)["qname"]) == 2

    # reverse-strand fragments join with orientation-aware target gap
    rev = _rows([
        ("q", 100_000, 1_000, 40_000, 1, "t", 120_000, 51_500, 91_000, 700, 39_500, 700),
        ("q", 100_000, 41_000, 80_000, 1, "t", 120_000, 11_000, 50_200, 700, 39_200, 700),
    ])
    m = merge_chains(rev)
    assert len(m["qname"]) == 1
    assert m["tstart"][0] == 11_000 and m["tend"][0] == 91_000
