"""Benchmark suite: the hot paths on the accelerator, one process.

Sections (one JSON line each), in order:
  1. strategy_update_p50_latency — THE HEADLINE: the jitted BOSS-RUNS update
     step on a zymo-scale genome (~8 Mb, 3 contigs) with a 4000-read batch,
     f64 decision path (+ f32 comparison), vs the float64 NumPy oracle of
     the same pipeline on CPU (the stand-in for CPU BOSS-RUNS;
     bossruns_tpu/oracle.py). Printed FIRST, and RE-PRINTED last so a
     reader of the last line gets it.
  2. aligner_{trunc,full}_reads_per_s — live-alignment path vs the CPU
     baseline aligner (host seeding + native DP, 4 threads — the mappy
     stand-in; scripts/bench_aligner.py)
  3. sim_batch_p50_latency — end-to-end PAF-driven simulation batch
  4. conformance_mask_agreement / conformance_dataplane — engine (quirk
     mode) vs the bug-compatible reference oracle on the zymo-like corpus,
     injected-observation AND full-data-plane drives
     (bossruns_tpu/conformance.py)
  5. aeons_batch_p50_latency — AEONS update (ava/assembly/strategy) batch
  6. chromosome-scale single-device point (134 Mb)

Every section runs in this one process (a second process would open the
card again). A section that raises emits a ``<section>_error`` record and
the suite goes on; a cumulative bench_summary after every section carries
every record, errors included. Sections sample fewer repetitions once the
BENCH_BUDGET_S budget (default 1250 s) runs low. The compile cache is
placed by bossruns_tpu.utils.compile_cache. The process always exits 0.

vs_baseline = CPU-baseline latency / device latency (higher is better).
BENCH_ONLY=step runs only the headline.
"""
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

N_READS = 4000
MEAN_LEN = 3500
GENOME = {"chr1": 4_050_000, "chr2": 2_000_000, "chr3": 2_000_000}
CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
TIME_COST = 5300.0

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 1250))
T0 = time.monotonic()
#: persistent scratch next to the repo: the sim/aeons corpora are
#: deterministic (fixed rng), so later runs (and driver rounds) reuse them
CACHE = Path(__file__).resolve().parent / ".bench_cache"


def remaining() -> float:
    return BUDGET_S - (time.monotonic() - T0)


_EMITTED: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    if isinstance(obj, dict) and obj.get("metric") not in (None, "bench_summary"):
        _EMITTED.append(obj)




def build_inputs(rng):
    from bossruns_tpu.models.layout import build_layout

    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in GENOME.items()}
    layout = build_layout(contigs)

    lens = np.array(list(GENOME.values()))
    p = lens / lens.sum()
    cid = rng.choice(len(lens), N_READS, p=p)
    rlen = np.clip(rng.normal(MEAN_LEN, 2000, N_READS), 400, 20000).astype(np.int64)
    starts = (rng.random(N_READS) * (lens[cid] - rlen)).astype(np.int64)
    goff = np.array([layout.offsets[i] for i in range(len(lens))])
    rstart = (goff[cid] + starts).astype(np.int32)
    pos = np.concatenate(
        [s0 + np.arange(l) for s0, l in zip(rstart, rlen)]
    ).astype(np.int64)
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    from bossruns_tpu.io.coo_native import pad_split, split_runs

    qual = np.full(sym.shape[0], 40, np.int8)
    split = split_runs(
        layout, sym, qual, rstart.astype(np.int64), rlen.astype(np.int32),
        np.zeros(N_READS, np.int32),
    )
    batch_np = dict(
        pad_split(split),
        rs_row=(rng.integers(0, layout.n_fhat, N_READS)).astype(np.int32),
        rs_strand=rng.integers(0, 2, N_READS).astype(np.int32),
        rs_w=np.ones(N_READS, np.float32),
    )
    print(f"# match runs {split[0].shape[0]}, explicit {split[4].shape[0]}, "
          f"bases {pos.shape[0]}", flush=True)
    return layout, batch_np


def section_headline():
    """The strategy-update step: device f64 (+f32) vs the CPU f64 oracle.

    The f64 record is emitted the MOMENT it exists; the f32 comparison runs
    afterwards, budget permitting, and enriches the final re-printed
    record, which carries the first step's wall time (compile included) as
    set-up time."""
    import jax

    from bossruns_tpu import oracle
    from bossruns_tpu.models.runs import (ReadBatch, RunsConfig, RunsEngine)

    rng = np.random.default_rng(11)
    layout, batch_np = build_inputs(rng)
    eng = RunsEngine(layout)
    state = eng.init_state()
    batch = ReadBatch(**{k: jax.device_put(v) for k, v in batch_np.items()})
    params = eng.make_params(CCL, TIME_COST)

    # -- device timing ------------------------------------------------------
    t0 = time.perf_counter()
    state, aux = eng.step(state, batch, params)  # compile + step 0
    eng.pull_aux(aux)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(7):
        # budget-aware: a median of fewer samples beats losing the suite
        # (>=3 samples preferred, 1 accepted when the budget is nearly gone)
        if ((len(times) >= 3 and remaining() < 0.55 * BUDGET_S)
                or (times and remaining() < 0.3 * BUDGET_S)):
            break
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        # production sync: one packed D2H pull of the step scalars
        eng.pull_aux(aux)
        times.append(time.perf_counter() - t0)
    dev_p50 = float(np.median(times)) * 1000.0

    # -- CPU f64 baseline (one step, same pipeline) -------------------------
    st_np = {
        "coverage": np.zeros((1, 5, layout.G_pad), np.int32),
        "zeroed": np.zeros((1, layout.G_pad), bool),
        "bucket_on": np.zeros((1, layout.NBk_pad), bool),
        "read_starts": np.zeros((layout.Wf_pad, 2)),
        "strat": np.ones((1, layout.Gd_pad, 2), bool),
    }
    cpu_ms = float("inf")
    for rep in range(2):  # min of 2: robust to transient host load
        if rep and remaining() < 0.4 * BUDGET_S:
            break
        t0 = time.perf_counter()
        oracle.full_update(eng, st_np, batch_np, CCL, TIME_COST, fast_scores=True)
        cpu_ms = min(cpu_ms, (time.perf_counter() - t0) * 1000.0)

    total_bases = int(batch_np["mr_len"].sum(dtype=np.int64)) + int(
        (batch_np["ex_g"] != 0xFFFFFFFF).sum()
    )
    record = {
        "metric": "strategy_update_p50_latency",
        "value": round(dev_p50, 3),
        "unit": "ms",
        "vs_baseline": round(cpu_ms / dev_p50, 2),
        "detail": {
            "genome_sites": int(sum(GENOME.values())),
            "reads_per_batch": N_READS,
            "bases_per_batch": total_bases,
            "reads_per_s": round(N_READS / (dev_p50 / 1000.0), 1),
            "cpu_baseline_ms": round(cpu_ms, 1),
            "f64_ms": round(dev_p50, 3),
            "n_samples": len(times),
            "f32_ms": None,
            "first_step_s": round(compile_s, 2),
        },
    }
    emit(record)  # the headline is now on the record, whatever happens next

    # -- f32 decision path (what the f64 exactness contract costs;
    #    identical math apart from benefit/threshold dtype) ------------------
    if remaining() > 90:
        try:
            eng32 = RunsEngine(layout, config=RunsConfig(benefit_dtype="float32"))
            params32 = eng32.make_params(CCL, TIME_COST)
            st32 = eng32.init_state()
            st32, aux32 = eng32.step(st32, batch, params32)
            eng32.pull_aux(aux32)
            t32 = []
            for _ in range(5):
                t0 = time.perf_counter()
                st32, aux32 = eng32.step(st32, batch, params32)
                eng32.pull_aux(aux32)
                t32.append(time.perf_counter() - t0)
            record["detail"]["f32_ms"] = round(float(np.median(t32)) * 1000.0, 3)
        except Exception as e:  # noqa: BLE001
            emit({"metric": "f32_headline_error", "value": None, "unit": None,
                  "vs_baseline": None, "detail": {"error": repr(e)[:200]}})
    return record


def section_aligner():
    """Live-alignment path: device-seeding reads/s vs the 4-thread CPU baseline
    (scripts/bench_aligner.py).

    N_READS (= the simulation's production batchsize): the seeding kernel's
    dominant cost is the index-sized lookup sort-join, which amortizes over
    the rows of one dispatch, so measure at the size the sim actually
    uses."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    from bench_aligner import main as run_aligner_bench

    # self-bound: the device-seeding passes are the first thing to give up
    run_aligner_bench(N_READS, trials=3,
                      deadline_s=max(60.0, min(300.0, remaining() - 60.0)))


def _cached_corpus(dirname: str, **kw) -> dict:
    """write_corpus with a reuse marker: the corpora are deterministic
    (fixed rng), so later runs and driver rounds skip regeneration."""
    from bossruns_tpu.utils.datagen import write_corpus

    out = CACHE / dirname
    done = out / ".complete"
    paths = {
        "ref": str(out / "ref.fa"), "fq": str(out / "reads.fq"),
        "paf_full": str(out / "full.paf"), "paf_trunc": str(out / "trunc.paf"),
    }
    if done.exists() and all(Path(p).exists() for p in paths.values()):
        return paths
    paths = write_corpus(out, **kw)
    done.write_text("ok")
    return paths


def section_sim():
    """End-to-end PAF-driven simulation batch: sample -> decide -> pack ->
    step. The corpus is deterministic and cached in .bench_cache."""
    import shutil

    from bossruns_tpu.models.runs_sim import BossRunsSim

    paths = _cached_corpus(
        "sim_corpus", rng=np.random.default_rng(3),
        contig_lengths=GENOME, n_reads=N_READS * 10, mean_len=float(MEAN_LEN),
    )
    out = CACHE / "sim_out"
    shutil.rmtree(out, ignore_errors=True)
    sim = BossRunsSim(
        ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
        paf_trunc=paths["paf_trunc"], name="bench", batchsize=N_READS,
        maxb=9, out_base=out,
    )
    # two warm batches: the gated flow's wire spec grows once as the pad
    # floors stabilize, so batch 2 loads a second executable
    sim.process_batch()
    sim.process_batch()
    times = []
    for _ in range(7):
        # budget-aware: a degraded-but-present record beats none (the
        # detail carries the sample count)
        if times and remaining() < 90:
            break
        t0 = time.perf_counter()
        sim.process_batch()
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    floor = float(np.min(times))
    emit({
        "metric": "sim_batch_p50_latency",
        "value": round(p50 * 1000.0, 1),
        "unit": "ms",
        "vs_baseline": None,
        # the floor (best batch) beside the p50 shows the batch-to-batch spread
        "detail": {"reads_per_batch": N_READS,
                   "reads_per_s": round(N_READS / p50, 1),
                   "floor_ms": round(floor * 1000.0, 1),
                   "n_samples": len(times),
                   "phase_p50_ms": sim.phase_p50_ms(last=len(times))},
    })


def _aeons_strategy_numpy(contigs, ccl, lam, lowcov=10.0, mu=400):
    """CPU stand-in for the AEONS strategy stage: the reference's per-contig
    bn.move_sum pipeline (22 window sums/contig) in f64 numpy
    (boss/aeons/sequences.py:1554-1678). Baseline for the device kernel."""
    from bossruns_tpu.oracle import move_sum_fwd, move_sum_rev

    weights = np.arange(0.1, 1.1, 0.1)[::-1]
    ccl_ds = np.maximum(np.asarray(ccl) // 100, 1)
    bens = []
    for s in contigs.values():
        cc = np.add.reduceat(s.cov, np.arange(0, len(s.cov), 100))
        scores = 1.0 / (np.exp(np.minimum(np.floor(cc / 100), 100.0) - lowcov) + 1.0)
        smu = np.stack([move_sum_fwd(scores, mu // 100), move_sum_rev(scores, mu // 100)], 1)
        eb = np.zeros_like(smu)
        for i in range(10):
            w = int(ccl_ds[i])
            eb[:, 0] += weights[i] * move_sum_fwd(scores, w)
            eb[:, 1] += weights[i] * move_sum_rev(scores, w)
        bens.append(np.maximum(eb - smu, 0.0))
    b = np.concatenate(bens).ravel()
    nz = b[b > 0]
    if nz.size == 0:
        return 0.0
    _m, e = np.frexp(nz / nz.max())
    counts = np.bincount(np.abs(e))
    used = np.flatnonzero(counts)
    bbin = np.power(2.0, -used.astype(np.float64)) * nz.max()
    tc = max((lam - mu - 300) // 100, 1.0)
    cs_u = np.cumsum(bbin * counts[used])
    cs_t = np.cumsum(tc * counts[used]) + 9
    return float(bbin[min(int(np.argmax(cs_u / cs_t)) + 1, used.size - 1)])


def section_aeons():
    """AEONS update batch: ava + assembly + contig strategies, warm.
    Reports per-stage medians and a CPU-numpy baseline ratio for the
    strategy stage."""
    import shutil

    from bossruns_tpu.aeons.simulation import BossAeonsSim
    from bossruns_tpu.config import BossConfig

    paths = _cached_corpus(
        "aeons_corpus", rng=np.random.default_rng(21),
        contig_lengths={"gA": 300_000}, n_reads=4000, mean_len=5000.0,
    )

    def make_args(name):
        args = BossConfig()
        args.general.name = name
        args.simulation.fq = paths["fq"]
        args.simulation.batchsize = 500
        args.simulation.maxb = 4
        args.simulation.binit = 2
        args.optional.min_seq_len = 2500
        args.optional.min_contig_len = 10_000
        return args

    # shape warm-up: the pool's padded kernel shapes evolve across batches,
    # and each new shape compiles (or loads from the persistent cache). The
    # sampler is deterministic, so a twin sim run through the SAME batches
    # compiles every shape the timed run will hit — the timed run then
    # measures steady-state work. Skipped (with a detail note) when the
    # budget is tight: the timed numbers then include compile noise.
    warmed = remaining() > 240
    if warmed:
        shutil.rmtree(CACHE / "aeons_warm", ignore_errors=True)
        warm = BossAeonsSim(make_args("aeons_warm"), out_base=CACHE / "aeons_warm")
        for _ in range(4):
            warm.process_batch()
    # the twin consumed the SAME deterministic reads: drop the minimizer-scan
    # memo so the timed run pays realistic new-read scan costs (cross-batch
    # pool hits within the timed run remain — that is the production win)
    from bossruns_tpu.aligner.index import _SEQ_SCAN_CACHE

    _SEQ_SCAN_CACHE.clear()
    shutil.rmtree(CACHE / "aeons_out", ignore_errors=True)
    sim = BossAeonsSim(make_args("aeons_bench"), out_base=CACHE / "aeons_out")
    sim.process_batch()  # in-run warm batch (mirrors the twin's first)
    times, stages = [], []
    for _ in range(3):
        if times and remaining() < 120:  # degraded record beats a timeout
            break
        t0 = time.perf_counter()
        sim.process_batch()
        times.append(time.perf_counter() - t0)
        stages.append(dict(sim.stage_times))
    p50 = float(np.median(times))
    stage_p50 = {
        k: round(float(np.median([s.get(k, 0.0) for s in stages])) * 1000.0, 1)
        for k in stages[-1]
    }
    # strategy-stage baseline, device vs CPU numpy, at metagenome scale
    from bossruns_tpu.aeons.benefit import contig_strategies

    class _C:
        def __init__(self, n, rng):
            self.seq = "A" * n
            self.cov = rng.integers(0, 30, n).astype(np.float32)
            self.cap_l = self.cap_r = False

    rng = np.random.default_rng(5)
    ccl, lam = sim.rl_dist.approx_ccl, sim.rl_dist.lam

    def strat_triple(n_contigs):
        pool = {f"u{j}": _C(200_000, rng) for j in range(n_contigs)}
        out = {}
        for backend in ("auto", "device"):
            contig_strategies(pool, ccl=ccl, lam=lam, backend=backend)  # warm
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                contig_strategies(pool, ccl=ccl, lam=lam, backend=backend)
                ts.append(time.perf_counter() - t0)
            out[backend] = float(np.median(ts)) * 1000.0
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _aeons_strategy_numpy(pool, ccl, lam)
            ts.append(time.perf_counter() - t0)
        out["cpu"] = float(np.median(ts)) * 1000.0
        return out

    # two scales: 8 Mb (a small mock community) and 40 Mb (a real metagenome
    # pool). `auto` is the PRODUCTION path (size-cutoff dispatch,
    # aeons/benefit.py HOST_MAX_CHUNKS — the per-contig host kernel at
    # both scales); cpu is the reference-equivalent f64 numpy
    # move_sum pipeline; device is the fused device kernel kept for
    # loaded-host deployments.
    s8 = strat_triple(40)
    s40 = strat_triple(200)
    emit({
        "metric": "aeons_batch_p50_latency",
        "value": round(p50 * 1000.0, 1),
        "unit": "ms",
        "vs_baseline": round(s40["cpu"] / s40["auto"], 2),
        "detail": {"reads_per_batch": 500,
                   "n_contigs": len(sim.strat),
                   "shape_warmed": warmed,
                   "stage_p50_ms": stage_p50,
                   "strategy_8mb_production_ms": round(s8["auto"], 1),
                   "strategy_8mb_cpu_ms": round(s8["cpu"], 1),
                   "strategy_8mb_device_ms": round(s8["device"], 1),
                   "strategy_40mb_production_ms": round(s40["auto"], 1),
                   "strategy_40mb_cpu_ms": round(s40["cpu"], 1),
                   "strategy_40mb_device_ms": round(s40["device"], 1),
                   "dispatch": "host below aeons/benefit.py HOST_MAX_CHUNKS",
                   # end-to-end baseline boundary: the reference's AEONS
                   # batch shells out to minimap2/miniasm/gfatools (C
                   # subprocesses, not installable here), so no honest
                   # end-to-end CPU ratio exists; vs_baseline covers the
                   # strategy stage (the only stage with a same-machine
                   # reference-equivalent implementation). The e2e p50
                   # above IS the full batch incl. ava/assembly on the
                   # bit-identical host seeding mirror.
                   "e2e_baseline": "none runnable (reference uses external"
                                   " C subprocesses); vs_baseline ="
                                   " strategy stage only"},
    })


def section_scale():
    """Chromosome-scale single-device point: the full jitted step on a
    134 Mb genome (scripts/bench_scale.py)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    from bench_scale import one_size

    emit(one_size(134.0))


def section_conformance():
    """Engine (quirk mode) vs the bug-compatible reference oracle on the
    zymo-like corpus (9 contigs / 12.6 Mb): decision-level parity at
    realistic scale, reported as a mask-agreement fraction — PLUS the
    full-data-plane drive (production BossRunsSim: sample -> decide ->
    CIGAR -> device coverage -> mask vs the oracle fed from the same PAF
    records), whose coverage comparison is bit-exact."""
    from bossruns_tpu.conformance import (drive_dataplane_conformance,
                                          drive_zymo_conformance)

    out = drive_zymo_conformance(n_batches=2, reads_per_batch=12_000)
    emit({
        "metric": "conformance_mask_agreement",
        "value": round(out["min_agreement"], 6),
        "unit": "fraction",
        "vs_baseline": None,
        "detail": {"per_batch": [round(a, 6) for a in out["per_batch"]],
                   "exact_vs_drift_free_oracle": out["exact_vs_drift_free"],
                   "n_contigs": out["n_contigs"],
                   "n_sites": out["n_sites"],
                   "any_on": out["any_on"],
                   "residual_unexplained": out["residual_unexplained"],
                   "residual_precision": out["residual_precision"],
                   "residual_observed": out["residual_observed"]},
    })
    if remaining() > 240:
        dp = drive_dataplane_conformance(
            n_batches=2, reads_per_batch=8000, work_dir=CACHE / "dpc")
        emit({
            "metric": "conformance_dataplane",
            "value": round(dp["min_agreement"], 6),
            "unit": "fraction",
            "vs_baseline": None,
            "detail": {"coverage_exact": dp["coverage_exact"],
                       "per_batch": [round(a, 6) for a in dp["per_batch"]],
                       "n_sites": dp["n_sites"],
                       "any_on": dp["any_on"],
                       "residual_unexplained": dp["residual_unexplained"],
                       "residual_precision": dp["residual_precision"],
                       "residual_observed": dp["residual_observed"]},
        })


SECTIONS = {
    "aligner": section_aligner,
    "sim_batch": section_sim,
    "aeons_batch": section_aeons,
    "scale": section_scale,
    "conformance": section_conformance,
}

def _init_jax():
    import jax

    from bossruns_tpu.utils.compile_cache import configure_compile_cache

    CACHE.mkdir(exist_ok=True)
    configure_compile_cache()
    # production decision precision: f64 benefit/threshold scan
    jax.config.update("jax_enable_x64", True)


def _run_section(name: str, fn) -> list:
    """Run one section in this process; its records, or its error record."""
    before = len(_EMITTED)
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - report the section, keep going
        emit({"metric": f"{name}_error", "value": None, "unit": None,
              "vs_baseline": None, "detail": {"error": repr(e)[:300]}})
    return _EMITTED[before:]


def main():
    _init_jax()
    all_records = []
    headline = None
    try:
        headline = section_headline()
    except Exception as e:  # noqa: BLE001
        emit({"metric": "strategy_update_error", "value": None, "unit": None,
              "vs_baseline": None, "detail": {"error": repr(e)[:300]}})
        all_records += _EMITTED[-1:]

    def emit_summary():
        summary = [
            {"metric": r["metric"], "value": r.get("value"),
             "unit": r.get("unit"), "vs_baseline": r.get("vs_baseline")}
            for r in ([headline] if headline else []) + all_records
        ]
        emit({"metric": "bench_summary", "value": len(summary),
              "unit": "records", "vs_baseline": None,
              "detail": {"records": summary}})

    if os.environ.get("BENCH_ONLY", "") != "step":
        # conformance before aeons/scale: if the budget runs dry, the
        # decision-parity evidence outranks the remaining perf points
        for name in ("aligner", "sim_batch", "conformance", "aeons_batch", "scale"):
            all_records += _run_section(name, SECTIONS[name])
            # cumulative summary after EVERY section: an external kill of
            # the whole bench still leaves a complete scoreboard in the tail
            emit_summary()
    emit_summary()
    # last line re-prints the headline
    if headline is not None:
        emit(headline)


if __name__ == "__main__":
    main()
