"""Measure contig_strategies backends: device (fused kernel) vs host
(vectorised f64) vs the reference-equivalent f64 sequential-loop numpy
baseline, at mock-community (8 Mb), metagenome (40 Mb) and 128 Mb pool
scales — the measurement behind aeons/benefit.py HOST_MAX_CHUNKS."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import jax

from bossruns_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()
jax.config.update("jax_enable_x64", True)

from bossruns_tpu.aeons.benefit import contig_strategies

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import _aeons_strategy_numpy  # noqa: E402


class _C:
    def __init__(self, n, rng):
        self.seq = "A" * n
        self.cov = rng.integers(0, 30, n).astype(np.float32)
        self.cap_l = self.cap_r = False


def measure(n_contigs, label):
    rng = np.random.default_rng(5)
    pool = {f"u{j}": _C(200_000, rng) for j in range(n_contigs)}
    ccl = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
    lam = 6000.0
    out = {}
    for backend in ("device", "host"):
        contig_strategies(pool, ccl=ccl, lam=lam, backend=backend)  # warm
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            contig_strategies(pool, ccl=ccl, lam=lam, backend=backend)
            ts.append(time.perf_counter() - t0)
        out[backend] = float(np.median(ts)) * 1e3
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        _aeons_strategy_numpy(pool, ccl, lam)
        ts.append(time.perf_counter() - t0)
    out["cpu_f64_baseline"] = float(np.median(ts)) * 1e3
    print(f"{label}: " + "  ".join(f"{k}={v:.1f}ms" for k, v in out.items()),
          flush=True)
    return out


if __name__ == "__main__":
    measure(40, " 8 Mb (40 contigs)")
    measure(200, "40 Mb (200 contigs)")
    measure(640, "128 Mb (640 contigs)")
