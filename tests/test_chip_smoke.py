"""chip_smoke.py outside a GPU: it refuses to run, and its helpers."""
import json
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from bossruns_tpu.config import BossConfig  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout  # no result line


def test_run_config_is_a_valid_boss_toml():
    paths = {"ref": "/d/ref.fa", "fq": "/d/r.fq", "paf_full": "/d/f.paf", "paf_trunc": "/d/t.paf"}
    sections = chip_smoke.sim_sections(paths, 7, tpu={"mesh_genome": 4})
    sections["general"]["name"] = "smoke"
    args = BossConfig.from_dict(tomllib.loads(chip_smoke.to_toml(sections)))
    assert args.simulation.batchsize == chip_smoke.BATCHSIZE == 4000
    assert args.simulation.maxb == 7 and args.simulation.paf_trunc == "/d/t.paf"
    assert args.tpu.mesh_genome == 4 and args.general.ref == "/d/ref.fa"
    live = chip_smoke.sim_sections(paths, 3, pafs=False)
    assert "paf_full" not in live["simulation"]


def test_masks_equal_is_exact():
    a = [{"c": np.array([[True, False]])}]
    assert chip_smoke.masks_equal(a, [{"c": np.array([[True, False]])}])
    assert not chip_smoke.masks_equal(a, [{"c": np.array([[True, True]])}])
    assert not chip_smoke.masks_equal(a, a + a)
    assert json.dumps(chip_smoke.to_toml({"s": {"b": True}})) == json.dumps("[s]\nb = true\n")
