"""Test configuration: force CPU JAX with an 8-device virtual mesh.

Must run before any jax import: forces the CPU platform so the suite runs
fast and can exercise multi-device sharding without an accelerator. Set
BOSS_TEST_PLATFORM to override.
"""
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = os.environ.get("BOSS_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# pin the platform through jax.config as well, in case jax was imported
# before this conftest ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bossruns_tpu.utils import datagen  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def corpus(tmp_path_factory):
    """Small synthetic corpus: 2 contigs, 1200 reads, full+trunc PAFs."""
    out = tmp_path_factory.mktemp("corpus")
    return datagen.write_corpus(
        out,
        rng=np.random.default_rng(7),
        contig_lengths={"contigA": 220_000, "contigB": 130_000},
        n_reads=1200,
        mean_len=5000.0,
    )
