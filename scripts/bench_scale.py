"""Largest-single-chip-genome probe: step latency vs genome size.

Builds successively larger random layouts (haploid, one barcode), runs the
full jitted update step with a 4000-read batch, and reports warm p50 per
size until device memory runs out. The biggest passing size is the
single-chip capacity anchor for BASELINE config 3 (chromosome scale); the
sharded engine (parallel/mesh.py) carries anything larger.

Usage: python scripts/bench_scale.py [sizes_mb ...]   (default 8 33 67 134)
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
N_READS = 4000


def scale_inputs(total_mb: float, align_chunks: int = 1, hotspots: int = 0,
                 hot_len: int = 250_000):
    """Random haploid two-contig layout of total_mb Mb plus one 4000-read
    batch of 3 kb reads with 5% errors, as (layout, ReadBatch of numpy).

    hotspots > 0 starts the reads inside that many evenly spaced windows of
    hot_len sites (instead of uniformly), so a few repeated steps switch
    buckets on and run the threshold scan; windows that start on a shard
    boundary put benefit windows across it."""
    from bossruns_tpu.io.coo_native import pad_split, split_runs
    from bossruns_tpu.models.layout import build_layout
    from bossruns_tpu.models.runs import ReadBatch

    rng = np.random.default_rng(13)
    total = int(total_mb * 1e6)
    contigs = {
        "cA": rng.integers(0, 4, total // 2).astype(np.uint8),
        "cB": rng.integers(0, 4, total - total // 2).astype(np.uint8),
    }
    layout = build_layout(contigs, align_chunks=align_chunks)

    rl = 3000
    if hotspots:
        stride = layout.G_pad // hotspots
        rstart = (rng.integers(0, hotspots, N_READS) * stride
                  + rng.integers(0, hot_len - rl, N_READS)).astype(np.int64)
    else:
        rstart = rng.integers(0, layout.G_pad - rl, N_READS).astype(np.int64)
    pos = (rstart[:, None] + np.arange(rl)[None, :]).ravel()
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(sym.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    padded = pad_split(split_runs(
        layout, sym, np.full(sym.shape[0], 40, np.int8), rstart,
        np.full(N_READS, rl, np.int32), np.zeros(N_READS, np.int32),
    ))
    batch = ReadBatch(
        rs_row=rng.integers(0, layout.n_fhat, N_READS).astype(np.int32),
        rs_strand=rng.integers(0, 2, N_READS).astype(np.int32),
        rs_w=np.ones(N_READS, np.float32),
        **padded,
    )
    return layout, batch


def one_size(total_mb: float) -> dict:
    import jax

    from bossruns_tpu.models.runs import RunsEngine

    layout, batch = scale_inputs(total_mb)
    eng = RunsEngine(layout)
    state = eng.init_state()
    batch = jax.device_put(batch)
    params = eng.make_params(CCL, 5300.0)
    state, aux = eng.step(state, batch, params)  # compile
    eng.pull_aux(aux)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
        times.append(time.perf_counter() - t0)
    return {
        "metric": "strategy_update_p50_latency_scaled",
        "value": round(float(np.median(times)) * 1000.0, 1),
        "unit": "ms",
        "vs_baseline": None,
        "detail": {"genome_sites": int(layout.lengths.sum()), "reads_per_batch": N_READS},
    }


def main(sizes_mb):
    import jax

    from bossruns_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)
    for mb in sizes_mb:
        try:
            print(json.dumps(one_size(mb)), flush=True)
        except Exception as e:
            print(json.dumps({"metric": "scale_probe_failed",
                              "value": mb, "unit": "Mb", "vs_baseline": None,
                              "detail": {"error": repr(e)[:200]}}), flush=True)
            break


if __name__ == "__main__":
    main([float(a) for a in sys.argv[1:]] or [8, 33, 67, 134])
