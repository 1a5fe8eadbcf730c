"""Aligner benchmark: device-seeding reads/s vs the CPU-baseline aligner.

Builds the bench-scale genome (8 Mb, 3 contigs), simulates noisy reads
(3% sub / 2% ins / 2% del — ONT-like), and times the two passes the
live-alignment simulation makes per batch: full-length mapping and mu=400
truncated-prefix mapping (the decision path), with the k13/w5 profile
runs_sim uses.

vs_baseline on each line = device_reads_per_s / cpu_reads_per_s, where the CPU
baseline (aligner/cpu_baseline.CpuAligner) is the honest mappy stand-in:
host seeding over the SAME minimizer index + the SAME native banded DP,
4 worker threads like the reference's mapper pool (boss/mapper.py:83-84).
Both paths emit byte-identical records (tests/test_host_seed.py), so the
ratio isolates where the seeding compute runs.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def _time_pair(base, subj, seqs, kw, trials):
    """Median seconds for (baseline, subject), trials INTERLEAVED so host
    load hits both sides of the ratio equally — sequential blocks made
    vs_baseline swing with whatever else shared the machine."""
    base.map_sequences(seqs, **kw)  # warm (loads/caches kernels)
    rec = subj.map_sequences(seqs, **kw)
    tb, ts = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        base.map_sequences(seqs, **kw)
        tb.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec = subj.map_sequences(seqs, **kw)
        ts.append(time.perf_counter() - t0)
    return float(np.median(tb)), float(np.median(ts)), rec


def main(n_reads: int = 2000, trials: int = 3, deadline_s: float | None = None):
    """deadline_s: soft wall-clock bound (seconds from now) — the DEVICE
    seeding pass measurements are skipped once past it so the
    production/host lines always emit within budget."""
    t_start = time.monotonic()
    from bossruns_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from bossruns_tpu.aligner import TpuAligner
    from bossruns_tpu.aligner.cpu_baseline import CpuAligner
    from bossruns_tpu.models.layout import build_layout
    from bossruns_tpu.utils.datagen import simulate_reads

    rng = np.random.default_rng(5)
    contigs_i = {f"c{i}": rng.integers(0, 4, L).astype(np.uint8)
                 for i, L in enumerate([4_050_000, 2_000_000, 2_000_000])}
    B = np.array(list("ACGT"))
    genome = {n: "".join(B[v]) for n, v in contigs_i.items()}
    lay = build_layout(contigs_i)
    sim = simulate_reads(rng, genome, n_reads, mean_len=3500.0, sd_len=2000.0)
    seqs = {r.rid: r.seq for r in sim}
    truth = {r.rid: (r.tname, r.tstart, r.rev) for r in sim}

    from bossruns_tpu.aligner import make_aligner

    cpu = CpuAligner(lay, k=13, w=5, min_votes=3, threads=4)
    dev = TpuAligner(lay, k=13, w=5, min_votes=3)
    # what production call sites actually run (make_aligner auto dispatch:
    # host seeding, 8 workers, at this scale) — measured against the
    # 4-thread reference-parity baseline
    prod = make_aligner(lay, k=13, w=5, min_votes=3)
    cpu_sec_trunc, prod_sec, prec = _time_pair(cpu, prod, seqs, dict(trunc=True), trials)
    print(json.dumps({
        "metric": "aligner_production_trunc_reads_per_s",
        "value": round(n_reads / prod_sec, 1),
        "unit": "reads/s",
        "vs_baseline": round(cpu_sec_trunc / prod_sec, 2),
        "detail": {
            "seconds": round(prod_sec, 2),
            "backend": type(prod).__name__,
            "cpu_baseline_reads_per_s": round(n_reads / cpu_sec_trunc, 1),
            "records": len(prec.qname),
        },
    }), flush=True)
    for label, kw in (("trunc", dict(trunc=True)), ("full", dict())):
        if deadline_s is not None and time.monotonic() - t_start > deadline_s:
            print(json.dumps({
                "metric": f"aligner_{label}_device_skipped", "value": None,
                "unit": None, "vs_baseline": None,
                "detail": {"reason": "section budget spent;"
                                     " production line already emitted"},
            }), flush=True)
            continue
        # isolate device-path failures: report and keep going so the
        # production/host lines already emitted (and the other pass's
        # attempt) survive
        try:
            cpu_sec, dev_sec, rec = _time_pair(cpu, dev, seqs, kw, trials)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({
                "metric": f"aligner_{label}_device_error", "value": None,
                "unit": None, "vs_baseline": None,
                "detail": {"error": repr(e)[:200]},
            }), flush=True)
            continue
        mapped = len(set(rec.qname))
        correct = sum(
            1 for i in range(len(rec.qname))
            if rec.tname[i] == truth[rec.qname[i]][0]
        )
        print(json.dumps({
            "metric": f"aligner_{label}_reads_per_s",
            "value": round(n_reads / dev_sec, 1),
            "unit": "reads/s",
            "vs_baseline": round(cpu_sec / dev_sec, 2),
            "detail": {
                "seconds": round(dev_sec, 2),
                "cpu_baseline_reads_per_s": round(n_reads / cpu_sec, 1),
                "cpu_baseline_threads": 4,
                "mapped_frac": round(mapped / n_reads, 4),
                "right_contig": correct,
                "records": len(rec.qname),
                # this line measures the DEVICE seeding path; production
                # call sites dispatch via aligner.make_aligner, which picks
                # the host path at this scale (byte-identical records)
                "production_backend": "host (make_aligner auto)",
            },
        }), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2000)
