"""scripts/prepare_simulation_data.py: own-aligner PAFs drive the simulation."""
import subprocess
import sys
from pathlib import Path

import numpy as np

from bossruns_tpu.models.runs_sim import BossRunsSim
from bossruns_tpu.utils.datagen import write_corpus

REPO = Path(__file__).resolve().parents[1]


def test_prepare_then_simulate(tmp_path):
    paths = write_corpus(
        tmp_path / "data",
        rng=np.random.default_rng(3),
        contig_lengths={"gA": 150_000},
        n_reads=700,
        mean_len=4000.0,
    )
    out = tmp_path / "prep"
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "prepare_simulation_data.py"),
         "--ref", paths["ref"], "--fq", paths["fq"], "--out", str(out),
         "--batch", "400"],
        capture_output=True, text=True, timeout=500,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert (out / "full.paf").exists() and (out / "trunc.paf").exists()
    assert Path(f"{paths['fq']}.offsets.npy").exists()
    n_full = sum(1 for _ in open(out / "full.paf"))
    assert n_full > 500  # most reads aligned

    # the generated PAFs drive a simulation end to end
    sim = BossRunsSim(
        ref=paths["ref"], fq=paths["fq"], paf_full=str(out / "full.paf"),
        paf_trunc=str(out / "trunc.paf"), name="prep", batchsize=100, maxb=3,
        out_base=tmp_path,
    )
    for _ in range(3):
        sim.process_batch()
    assert np.asarray(sim.state.coverage).sum() > 0
