"""Live-mode loop against on-disk fastq with the fake sequencer backend,
plus the readfish-side decision bits (mask hot-reload, fail-open lookups)."""
import time
from pathlib import Path

import numpy as np
import pytest

from bossruns_tpu.config import BossConfig
from bossruns_tpu.live.decision import Decision, StrategyStore, make_decision
from bossruns_tpu.live.sequencer import LiveRun, Sequencer
from bossruns_tpu.models.experiment import BossRuns
from bossruns_tpu.utils.misc import write_strategy_npz


class _Aln:
    def __init__(self, ctg, r_st, r_en, strand):
        self.ctg, self.r_st, self.r_en, self.strand = ctg, r_st, r_en, strand


@pytest.fixture()
def mask_store(tmp_path):
    strat = np.zeros((100, 2), bool)
    strat[10:20, 0] = True  # accept fwd reads starting in [1000, 2000)
    write_strategy_npz(tmp_path, {"c1": strat, "rej": np.zeros(1, bool)})
    return StrategyStore(tmp_path / "masks" / "boss.npz")


def test_mask_lookup_and_decisions(mask_store):
    st = mask_store
    assert st.check_coord("c1", 1500, 0)
    assert not st.check_coord("c1", 2500, 0)
    assert not st.check_coord("c1", 1500, 1)  # rev strand off
    assert not st.check_coord("rej", 50, 0)   # shape-1 => always reject
    assert st.check_coord("nope", 10, 0)      # unknown contig fails open

    on = make_decision(st, [_Aln("c1", 1500, 1900, 1)], seq_len=400)
    assert on == Decision.single_on
    off = make_decision(st, [_Aln("c1", 2500, 2900, 1)], seq_len=400)
    assert off == Decision.single_off
    # beyond the mask's rows: fails OPEN like the reference
    # (dynamic_readfish.py:209-210)
    oob = make_decision(st, [_Aln("c1", 50000, 50400, 1)], seq_len=400)
    assert oob == Decision.single_on
    assert make_decision(st, [], 400) == Decision.no_map
    assert make_decision(st, [], 0) == Decision.no_seq
    multi = make_decision(st, [_Aln("c1", 1500, 1900, 1), _Aln("c1", 9000, 9400, 1)], 400)
    assert multi == Decision.multi_on
    # readfish strand -1 maps to boss rev: start uses r_en (reference-exact,
    # dynamic_readfish.py:233)
    rev = make_decision(st, [_Aln("c1", 1500, 1900, -1)], 400)
    assert rev == Decision.single_off  # rev strand not accepted at 1900
    # alignments win over an empty seq (reference checks results first)
    assert make_decision(st, [_Aln("c1", 1500, 1900, 1)], 0) == Decision.single_on


def test_mask_hot_reload(mask_store, tmp_path):
    st = mask_store
    assert not st.check_coord("c1", 2500, 0)
    time.sleep(0.02)
    new = np.ones((100, 2), bool)
    write_strategy_npz(tmp_path, {"c1": new})
    assert st.reload()
    assert st.check_coord("c1", 2500, 0)
    assert not st.reload()  # unchanged mtime => no reload


def test_live_runs_loop_with_fake_sequencer(corpus, tmp_path, monkeypatch):
    """The reference tests live mode by pointing the fake Sequencer at a dir
    of fastq files (boss/live.py:32-37, tests/base/test_core.py)."""
    monkeypatch.chdir(tmp_path)
    fqdir = tmp_path / "run" / "fastq_pass"
    fqdir.mkdir(parents=True)
    # split the corpus fastq into two "live" files
    lines = Path(corpus["fq"]).read_text().splitlines(keepends=True)
    half = len(lines) // 8 // 4 * 4
    (fqdir / "batch1.fq").write_text("".join(lines[:half]))

    args = BossConfig()
    args.general.name = "livetest"
    args.general.ref = corpus["ref"]
    args.general.wait = 1

    exp = BossRuns(args, out_base=tmp_path)
    seq = Sequencer(out_path=str(tmp_path / "run"))
    exp.fq_dir = str(fqdir)
    exp.channels = seq.channels
    wait = exp.process_batch()
    assert exp.batch == 1
    assert np.asarray(exp.state.coverage).sum() > 0
    # no new files -> deferred update
    assert exp.process_batch() == args.general.wait
    # second file arrives
    (fqdir / "batch2.fq").write_text("".join(lines[half : 2 * half]))
    exp.process_batch()
    assert exp.batch == 2
    assert (tmp_path / "out_livetest" / "masks" / "boss.npz").exists()


def test_scan_dir_patterns(tmp_path):
    # all six reference glob variants incl. the nonstandard .gzip spellings
    # (boss/live.py:226), plus a non-match
    root = tmp_path / "fq"
    (root / "sub").mkdir(parents=True)
    for name in ("a.fq", "b.fastq", "sub/c.fq.gz", "e.fastq.gz",
                 "f.fastq.gzip", "g.fq.gzip", "d.txt"):
        (root / name).write_text("")
    found = LiveRun.scan_dir(str(root), set())
    assert len(found) == 6
    found2 = LiveRun.scan_dir(str(root), set(found))
    assert found2 == []


def test_gzip_spelling_readable(tmp_path):
    """A .fastq.gzip file (gzip data, nonstandard suffix) must parse."""
    import gzip

    from bossruns_tpu.io.fastq import read_fastx

    p = tmp_path / "r.fastq.gzip"
    with gzip.open(p, "wt") as fh:
        fh.write("@r1 ch=1\nACGT\n+\nIIII\n")
    recs = list(read_fastx(str(p)))
    assert recs[0][0] == "r1" and recs[0][2] == "ACGT"


def test_live_checkpoint_resume(corpus, tmp_path, monkeypatch):
    """Live mode persists device state + processed-files set and resumes
    without re-processing old fastq files (addition over the reference,
    which loses all posteriors on a crash — SURVEY.md §5)."""
    monkeypatch.chdir(tmp_path)
    fqdir = tmp_path / "run" / "fastq_pass"
    fqdir.mkdir(parents=True)
    lines = Path(corpus["fq"]).read_text().splitlines(keepends=True)
    half = len(lines) // 8 // 4 * 4
    (fqdir / "batch1.fq").write_text("".join(lines[:half]))

    args = BossConfig()
    args.general.name = "ckpt"
    args.general.ref = corpus["ref"]
    args.general.wait = 1

    exp = BossRuns(args, out_base=tmp_path)
    exp.checkpoint_every = 1
    exp.fq_dir = str(fqdir)
    exp.channels = set()
    exp.process_batch()
    cov_before = np.asarray(exp.state.coverage).sum()
    assert (tmp_path / "out_ckpt" / "checkpoint" / "state.npz").exists()

    # "crash" and restart with resume: same coverage, file not re-processed
    args.optional.resume = True
    exp2 = BossRuns(args, out_base=tmp_path)
    exp2.fq_dir = str(fqdir)
    exp2.channels = set()
    assert exp2.batch == 1
    assert np.asarray(exp2.state.coverage).sum() == cov_before
    assert exp2.processed_files == {str(fqdir / "batch1.fq")}
    # no new files: deferred, coverage unchanged
    assert exp2.process_batch() == args.general.wait
    assert np.asarray(exp2.state.coverage).sum() == cov_before


def test_readfish_child_runs_on_cpu(monkeypatch):
    """The readfish_boss child never opens the accelerator the engine
    process holds: its environment pins JAX to the CPU backend."""
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    cmd, env = LiveRun.readfish_command("rf.toml", "MS00001", "boss")
    assert cmd[1].endswith("readfish_boss.py") and cmd[2:] == ["rf.toml", "MS00001", "boss"]
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["PATH"] == __import__("os").environ["PATH"]  # rest inherited


def test_launch_readfish_dry_run_starts_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(LiveRun, "search_running_process", staticmethod(lambda kw: None))
    assert LiveRun.launch_readfish("rf.toml", "MS00001", "boss", dry=True) is None
    assert LiveRun.launch_readfish("rf.toml", "TEST", "boss") is None
