"""N >= 2 hosts: the sharded step across two OS processes (BASELINE.md
scaling points). Two workers with 4 virtual CPU devices each join one
8-device mesh via the JAX distributed runtime; the genome-sharded state is
split across the processes and the resulting strategies must be
bit-identical to a single-process run over the same 8-way mesh (which
tests/test_parallel.py in turn pins against the single-chip engine and the
sequential f64 oracle)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mp_worker

NPROC = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def multiproc_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    port = _free_port()
    env_base = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        BOSS_COORDINATOR=f"127.0.0.1:{port}",
        BOSS_NUM_PROCESSES=str(NPROC),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).parent / "mp_worker.py"), str(out)],
            env=dict(env_base, BOSS_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(NPROC)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout = "TIMEOUT"
        outputs.append((p.returncode, stdout))
    for rc, stdout in outputs:
        assert rc == 0, f"worker failed (rc={rc}):\n{stdout[-3000:]}"
    return out


def test_two_process_run_matches_single_process(multiproc_out):
    mp_strat = dict(np.load(multiproc_out / "strat.npz"))
    sp_strat, sp_aux = mp_worker.run_case()
    assert set(mp_strat) == set(sp_strat)
    for name in sp_strat:
        np.testing.assert_array_equal(mp_strat[name], sp_strat[name], err_msg=name)

    mp_aux = json.loads((multiproc_out / "aux.json").read_text())
    for got, want in zip(mp_aux, sp_aux):
        assert got[0] == want.any_on and got[1] == want.updated
        assert got[2] == want.threshold  # f64 decision path: exactly equal
        np.testing.assert_allclose(got[3], want.mean_coverage, rtol=1e-6)


def test_strategies_nontrivial(multiproc_out):
    mp_strat = dict(np.load(multiproc_out / "strat.npz"))
    total = sum(int(a.sum()) for a in mp_strat.values())
    size = sum(a.size for a in mp_strat.values())
    assert 0 < total < size  # the update actually rejected something


def test_two_process_sim_driver_matches_single_process(tmp_path):
    """The full simulation driver across two processes: identical masks to a
    single-process sharded run, and only the primary writes artifacts."""
    from bossruns_tpu.utils import datagen

    corpus = tmp_path / "corpus"
    datagen.write_corpus(
        corpus,
        rng=np.random.default_rng(5),
        contig_lengths={"cA": 200_000, "cB": 120_000},
        n_reads=1400,
        mean_len=4000.0,
    )
    port = _free_port()
    mp_out = tmp_path / "mp"
    mp_out.mkdir()
    env_base = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        BOSS_COORDINATOR=f"127.0.0.1:{port}",
        BOSS_NUM_PROCESSES=str(NPROC),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).parent / "mp_worker.py"),
             "--sim", str(corpus), str(mp_out)],
            env=dict(env_base, BOSS_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(NPROC)
    ]
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout = "TIMEOUT"
        assert p.returncode == 0, f"sim worker failed:\n{stdout[-3000:]}"

    sp_out = tmp_path / "sp"
    mp_worker.run_sim(corpus, sp_out)

    mp_masks = dict(np.load(mp_out / "out_mp" / "masks" / "boss.npz"))
    sp_masks = dict(np.load(sp_out / "out_mp" / "masks" / "boss.npz"))
    assert set(mp_masks) == set(sp_masks)
    for name in sp_masks:
        np.testing.assert_array_equal(mp_masks[name], sp_masks[name], err_msg=name)
    # no stray tmp files from a second writer
    assert not list((mp_out / "out_mp" / "masks").glob("*_tmp*"))
