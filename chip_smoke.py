"""Smoke test of BOSS-RUNS on NVIDIA GPUs: the main path, end to end.

    python chip_smoke.py             # one GPU: every default phase
    python chip_smoke.py --chips 4   # four GPUs: the genome-sharded phases only

Runs only where JAX's default backend is a GPU, and exits non-zero before
any phase otherwise: it never falls back to the CPU. Everything runs in
this one process, so each card is opened once. Each phase checks what comes
out against the repository's own reference (the f64 NumPy oracle, the host
seeding mirror, the host AEONS strategy kernel, numpy.frexp) and raises on a
mismatch; nothing catches it, so a failed phase ends the script non-zero
before the result line.

Default phases (zymo-like deployment: 9 contigs / 12.6 Mb haploid,
4,000 reads per update, ONT-like reads from utils/datagen):
  runs_sim_paf    simulation with precomputed PAFs through __main__.main
  runs_sim_align  the same simulation aligning live (host seeding + native DP)
  parity          (a) masks bit-identical to the f64 oracle fed the GPU's own
                  scores, (b) conformance floors, (c) determinism of the sim,
                  (d) frexp bin edges against numpy
  device_aligner  device seeding records byte-identical to the host mirror
  aeons           AEONS simulation, then device vs host strategies at 40 Mb
Four-card phases (--chips 4): the zymo simulation with mesh_genome = 4 vs
one card, the sharded step at 134 Mb vs one card, and the b2 x g2 dry run.

Corpora are generated from fixed seeds into .smoke/ (gitignored) and reused
when present. The compile cache is placed by bossruns_tpu.utils.compile_cache.
The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": n}}
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

PLATFORM = "gpu"
ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"

BATCHSIZE = 4000       # the reference's reads per update (boss/config.py:56-57)
SIM_MEAN_LEN = 6000.0  # datagen's ONT-like default read length
SIM_BATCHES = 7        # buckets switch on by batch ~3; rejections follow
ALIGN_BATCHES = 3
PARITY_BATCHES = 5
PARITY_READS = 12_000  # ~3.3x coverage per batch: the threshold scan runs each batch
AGREEMENT_FLOOR = 0.996  # tests/test_conformance_zymo.py


def require_gpu():
    import jax

    backend = jax.default_backend()
    if backend != PLATFORM:
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX's default backend is {backend!r} "
            f"(devices: {jax.devices()})"
        )
    return jax


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ------------------------------------------------------------------ helpers --

def corpus(name: str, seed: int, **kw) -> dict[str, str]:
    """write_corpus into .smoke/<name>, reused while its stamp matches."""
    from bossruns_tpu.utils.datagen import write_corpus

    out = WORK / name
    stamp = json.dumps({"seed": seed, **kw}, sort_keys=True)
    done = out / ".complete"
    paths = {"ref": out / "ref.fa", "fq": out / "reads.fq",
             "paf_full": out / "full.paf", "paf_trunc": out / "trunc.paf"}
    if not (done.exists() and done.read_text() == stamp
            and all(p.exists() for p in paths.values())):
        shutil.rmtree(out, ignore_errors=True)
        write_corpus(out, rng=np.random.default_rng(seed), **kw)
        done.write_text(stamp)
    return {k: str(p) for k, p in paths.items()}


def zymo_corpus() -> dict[str, str]:
    from bossruns_tpu.conformance import ZYMO_LIKE_LENGTHS

    return corpus("zymo_corpus", 3, contig_lengths=ZYMO_LIKE_LENGTHS,
                  n_reads=BATCHSIZE * (SIM_BATCHES + 1),  # the sampler's need
                  mean_len=SIM_MEAN_LEN)


def to_toml(sections: dict) -> str:
    lines = []
    for sec, kv in sections.items():
        lines.append(f"[{sec}]")
        for k, v in kv.items():
            lines.append(f"{k} = {json.dumps(v)}")  # JSON scalars are TOML scalars
    return "\n".join(lines) + "\n"


@contextmanager
def recorded_masks():
    """Every strategy mask the RUNS simulation writes, in order (the initial
    accept-all mask, then one per updated batch)."""
    from bossruns_tpu.models import runs_sim

    seen: list[dict[str, np.ndarray]] = []
    write = runs_sim.write_strategy_npz

    def record(out_dir, strat, *args, **kwargs):
        seen.append({c: np.array(m) for c, m in strat.items()})
        return write(out_dir, strat, *args, **kwargs)

    runs_sim.write_strategy_npz = record
    try:
        yield seen
    finally:
        runs_sim.write_strategy_npz = write


def run_main(name: str, sections: dict):
    """`python -m bossruns_tpu --toml <name>.toml` in-process, from a fresh
    run directory (outputs land in the working directory)."""
    from bossruns_tpu.__main__ import main

    run_dir = WORK / "runs" / name
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    sections = dict(sections)
    sections["general"] = {"name": name, **sections.get("general", {})}
    toml = run_dir / f"{name}.toml"
    toml.write_text(to_toml(sections))
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        with recorded_masks() as masks:
            rc = main(["--toml", str(toml)])
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"{name}: main returned {rc}")
    return run_dir / f"out_{name}", masks


def metrics(out_dir: Path) -> list[dict]:
    path = out_dir / "metrics" / "batches.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def masks_equal(a: list[dict], b: list[dict]) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[c], y[c]) for c in x)
        for x, y in zip(a, b)
    )


def sim_sections(paths: dict, batches: int, pafs: bool = True, **extra) -> dict:
    sim = {"fq": paths["fq"], "batchsize": BATCHSIZE, "maxb": batches}
    if pafs:
        sim.update(paf_full=paths["paf_full"], paf_trunc=paths["paf_trunc"])
    return {"general": {"ref": paths["ref"]}, "simulation": sim, **extra}


def check_runs_sim(out: Path, lengths: dict[str, int], batches: int) -> dict:
    """The verify recipe's checks on a finished RUNS simulation."""
    from bossruns_tpu.utils.misc import read_strategy_npz

    final = read_strategy_npz(out / "masks" / "boss.npz")
    for c, L in lengths.items():
        if final[c].shape != (L // 100, 2, 1):
            raise AssertionError(f"mask {c}: shape {final[c].shape}, want {(L // 100, 2, 1)}")
    rows = metrics(out)
    if len(rows) != batches:
        raise AssertionError(f"{len(rows)} metric rows for {batches} batches")
    # a strategy update needs a bucket switched on (StepAux.updated)
    updated = [r["batch"] for r in rows if r["updated"]]
    if not updated:
        raise AssertionError("bucket_on never flipped: no strategy update")
    acc = sum(r["n_accepted"] for r in rows)
    rej = sum(r["n_rejected"] for r in rows)
    frac = acc / max(acc + rej, 1)
    if not 0.0 < frac < 1.0:
        raise AssertionError(f"accepted fraction {frac}: rejections never engaged")
    last = rows[-1]
    if not last["time_boss"] < last["time_control"]:
        raise AssertionError(f"pseudotime boss {last['time_boss']} >= control {last['time_control']}")
    return {"updated_batches": updated, "accepted_frac": round(frac, 4),
            "rejected_reads": rej, "time_boss": last["time_boss"],
            "time_control": last["time_control"],
            "batch_phases_s": rows[-1]["phases"]}


# ------------------------------------------------------------------ phases ---

def phase_runs_sim_paf(paths, lengths, name="smoke", batches=SIM_BATCHES):
    out, masks = run_main(name, sim_sections(paths, batches))
    res = check_runs_sim(out, lengths, batches)
    res["masks_written"] = len(masks)
    return res, masks


def phase_runs_sim_align(paths, batches=ALIGN_BATCHES):
    from bossruns_tpu.aligner import native

    # _load caches its outcome: once loaded, the NumPy fallback never runs
    if not native._load():
        raise RuntimeError("native banded-DP library did not build or load")
    out, _ = run_main("smoke_align", sim_sections(paths, batches, pafs=False))
    rows = metrics(out)
    if len(rows) != batches:
        raise AssertionError(f"{len(rows)} metric rows for {batches} batches")
    mapped = sum(r["n_mapped"] for r in rows) / (batches * BATCHSIZE)
    if mapped < 0.9:
        raise AssertionError(f"live alignment mapped only {mapped:.3f} of reads")
    return {"mapped_frac": round(mapped, 4), "native_dp": True,
            "batch_phases_s": rows[-1]["phases"]}


def decision_parity(n_batches=PARITY_BATCHES, reads_per_batch=PARITY_READS,
                    lengths=None, seed=7):
    """(a): the production engine's masks vs the sequential f64 NumPy
    oracle given the engine's own f32 scores — bit-identical, no tolerance."""
    from bossruns_tpu import oracle
    from bossruns_tpu.conformance import (CCL, TIME_COST, ZYMO_LIKE_LENGTHS,
                                          observation_step_batch,
                                          ont_observation_batch)
    from bossruns_tpu.models.layout import build_layout
    from bossruns_tpu.models.runs import ReadBatch, RunsConfig, RunsEngine
    from bossruns_tpu.ops.model import make_model

    rng = np.random.default_rng(seed)
    lengths = lengths or ZYMO_LIKE_LENGTHS
    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in lengths.items()}
    layout = build_layout(contigs)
    eng = RunsEngine(layout, make_model(ploidy=1), RunsConfig(debug_aux=True))
    state = eng.init_state()
    state_np = {k: np.array(v) for k, v in state._asdict().items()}
    state_np["read_starts"] = state_np["read_starts"].astype(np.float64)
    params = eng.make_params(CCL, TIME_COST)
    floors, rs_floor = (0, 0), 512
    updated = 0
    for b in range(n_batches):
        obs = ont_observation_batch(rng, layout, reads_per_batch)
        batch, floors, rs_floor = observation_step_batch(layout, obs, floors, rs_floor)
        state, aux = eng.step(state, ReadBatch(**batch), params)
        ah = eng.pull_aux(aux)
        state_np, aux_o = oracle.full_update(
            eng, state_np, batch, CCL, TIME_COST, scores_override=np.asarray(aux.scores))
        for field in ("coverage", "bucket_on", "strat"):
            got = np.asarray(getattr(state, field))
            if not np.array_equal(got, state_np[field]):
                n = int((got != state_np[field]).sum())
                raise AssertionError(f"batch {b}: {field} differs from the oracle in {n} cells")
        if ah.updated != aux_o["updated"]:
            raise AssertionError(f"batch {b}: updated {ah.updated} vs oracle {aux_o['updated']}")
        updated += int(ah.updated)
    strat = np.asarray(state.strat)[:, layout.strat_row_valid, :]
    if updated < min(3, n_batches) or not 0.0 < strat.mean() < 1.0:
        raise AssertionError(f"decision path not exercised: {updated} updates, "
                             f"accepted {strat.mean():.4f}")
    return {"batches": n_batches, "updated_batches": updated,
            "accepted_frac": round(float(strat.mean()), 4), "mask_cells": int(strat.size)}


def conformance(zymo_reads=PARITY_READS, dp_reads=8000, lengths=None):
    """(b): the CPU suite's conformance floors (tests/test_conformance_zymo.py)."""
    from bossruns_tpu.conformance import (drive_dataplane_conformance,
                                          drive_zymo_conformance)

    kw = {"lengths": lengths} if lengths else {}
    z = drive_zymo_conformance(n_batches=3, reads_per_batch=zymo_reads, **kw)
    if not (z["any_on"] and z["exact_vs_drift_free"]
            and z["min_agreement"] >= AGREEMENT_FLOOR and z["residual_unexplained"] == 0):
        raise AssertionError(f"zymo conformance: {z}")
    dp = drive_dataplane_conformance(n_batches=2, reads_per_batch=dp_reads,
                                     work_dir=WORK / "dataplane", **kw)
    if not (dp["any_on"] and dp["coverage_exact"]
            and dp["min_agreement"] >= AGREEMENT_FLOOR and dp["residual_unexplained"] == 0):
        raise AssertionError(f"data-plane conformance: {dp}")
    return {"zymo_min_agreement": z["min_agreement"],
            "zymo_exact_vs_drift_free": z["exact_vs_drift_free"],
            "zymo_residual": [z["residual_observed"], z["residual_unexplained"],
                              z["residual_precision"]],
            "dataplane_min_agreement": dp["min_agreement"],
            "dataplane_coverage_exact": dp["coverage_exact"],
            "dataplane_residual_unexplained": dp["residual_unexplained"]}


def frexp_edges():
    """(d): the threshold scan's exponent bins on the card vs numpy.frexp."""
    import jax.numpy as jnp

    from bossruns_tpu.ops.genome_ops import frexp_abs_exponent

    ks = [0, -1, -2, -30, -126, -127, -149, -189, -190, -191, -500, -1022]
    p2 = np.array([2.0**k for k in ks])
    f64 = np.concatenate([
        p2, np.nextafter(p2, 0.0), np.nextafter(p2, np.inf),
        [1e-40, 2.0**-140, 1.17e-38],                   # f32 subnormal range
        [5e-324, 2.0**-1030, np.nextafter(2.0**-1022, 0.0)],  # f64 subnormals
        [2.0**-190 * 1.5, 1e-300, 0.75, 0.999999],
    ])
    want = np.minimum(np.abs(np.frexp(f64)[1]), 191)
    got = np.asarray(frexp_abs_exponent(jnp.asarray(f64, jnp.float64), 192))
    bad = np.flatnonzero(got != want)
    if bad.size:
        raise AssertionError(f"f64 bins differ at {f64[bad]}: {got[bad]} vs {want[bad]}")
    p32 = np.array([2.0**k for k in (0, -1, -30, -125)], np.float32)
    f32 = np.concatenate([p32, np.nextafter(p32, np.float32(0)), np.nextafter(p32, np.float32(np.inf)),
                          [np.finfo(np.float32).tiny]])  # smallest f32 normal
    want32 = np.minimum(np.abs(np.frexp(f32)[1]), 191)
    got32 = np.asarray(frexp_abs_exponent(jnp.asarray(f32), 192))
    sub32 = np.asarray(frexp_abs_exponent(jnp.asarray(np.array([1e-40, 2.0**-149], np.float32)), 192))
    if not (np.array_equal(got32, want32) and (sub32 == 191).all()):
        raise AssertionError(f"f32 bins: {got32} vs {want32}; subnormals {sub32}")
    return {"f64_values": int(f64.size), "f32_values": int(f32.size) + 2}


def phase_parity(paths, lengths, first_run_masks):
    from bossruns_tpu.utils.misc import read_strategy_npz

    out = {"precision": "per-site scores f32 with matmuls at Precision.HIGHEST "
                        "(no TF32); benefit, fhat and threshold scan f64"}
    out["decisions_vs_oracle"] = decision_parity()
    out["conformance"] = conformance()
    rerun, masks = phase_runs_sim_paf(paths, lengths, name="smoke_rerun")
    final_a = read_strategy_npz(WORK / "runs" / "smoke" / "out_smoke" / "masks" / "boss.npz")
    final_b = read_strategy_npz(WORK / "runs" / "smoke_rerun" / "out_smoke_rerun" / "masks" / "boss.npz")
    if not (masks_equal(first_run_masks, masks) and masks_equal([final_a], [final_b])):
        raise AssertionError("two runs from the same seed wrote different masks")
    out["determinism"] = {"identical_masks": len(masks), "updated_batches": rerun["updated_batches"]}
    out["frexp"] = frexp_edges()
    return out


def phase_device_aligner(paths, n_reads=BATCHSIZE):
    """The live driver's aligner (TpuAligner: device seeding) on a mu=400
    truncated batch vs the host seeding mirror: byte-identical records."""
    from bossruns_tpu.aligner import TpuAligner
    from bossruns_tpu.aligner.cpu_baseline import CpuAligner
    from bossruns_tpu.io.fastq import read_fastx
    from bossruns_tpu.models.layout import build_layout
    from bossruns_tpu.models.runs_sim import load_reference_contigs

    layout = build_layout(load_reference_contigs(paths["ref"]))
    seqs = {}
    for name, _c, seq, _q in read_fastx(paths["fq"]):
        seqs[name] = seq
        if len(seqs) == n_reads:
            break
    dev = TpuAligner(layout, source=paths["ref"])
    platform = next(iter(dev.dev_index.keys.devices())).platform
    if platform != PLATFORM:
        raise AssertionError(f"device index lives on {platform}")
    host = CpuAligner(layout, source=paths["ref"])
    t0 = time.perf_counter()
    rd = dev.map_sequences(seqs, trunc=True)
    t_dev = time.perf_counter() - t0
    rh = host.map_sequences(seqs, trunc=True)
    if list(rd.qname) != list(rh.qname):
        raise AssertionError("device and host records name different reads")
    for f in ("qlen", "qstart", "qend", "rev", "tname", "tlen", "tstart", "tend",
              "nmatch", "blocklen", "mapq", "align_score", "s1", "primary"):
        a, b = getattr(rd, f), getattr(rh, f)
        if not np.array_equal(a, b):
            raise AssertionError(f"field {f} differs in {int((a != b).sum())} records")
    for i, (a, b) in enumerate(zip(rd.cigars, rh.cigars)):
        if not np.array_equal(a, b):
            raise AssertionError(f"CIGAR of record {i} ({rd.qname[i]}) differs")
    mapped = len(set(rd.qname)) / len(seqs)
    if mapped < 0.5:  # noisy 400 bp prefixes at the live defaults (k15/w10)
        raise AssertionError(f"only {mapped:.3f} of the reads mapped")
    return {"reads": len(seqs), "records": len(rd.qname), "mapped_frac": round(mapped, 4),
            "device_first_call_s": round(t_dev, 2)}


class _PoolContig:
    """A contig of the AEONS pool as contig_strategies reads it."""

    def __init__(self, n: int, rng):
        self.seq = "A" * n
        self.cov = rng.integers(0, 30, n).astype(np.float32)
        self.cap_l = self.cap_r = False


def phase_aeons(n_pool_contigs=200, contig_len=200_000):
    from bossruns_tpu.aeons.benefit import contig_strategies
    from bossruns_tpu.conformance import CCL

    # the bench's AEONS cell (bench.py section_aeons)
    paths = corpus("aeons_corpus", 21, contig_lengths={"gA": 300_000},
                   n_reads=4000, mean_len=5000.0)
    out, _ = run_main("smoke_aeons", {
        "simulation": {"fq": paths["fq"], "batchsize": 500, "maxb": 4, "binit": 2},
        "optional": {"min_seq_len": 2500, "min_contig_len": 10_000},
    })
    rows = metrics(out)
    if not rows or not (out / "masks" / "boss.npz").exists():
        raise AssertionError("AEONS simulation wrote no strategy")
    # strategies at the bench's 40 Mb metagenome pool; tolerance as in
    # tests/test_aeons.py (device windows run in f32, the host's in f64)
    rng = np.random.default_rng(5)
    pool = {f"u{j}": _PoolContig(contig_len, rng) for j in range(n_pool_contigs)}
    dev, thr_d = contig_strategies(pool, ccl=CCL, lam=6000.0, backend="device")
    host, thr_h = contig_strategies(pool, ccl=CCL, lam=6000.0, backend="host")
    total = sum(m.size for m in host.values())
    diff = sum(int((dev[h] != host[h]).sum()) for h in host)
    if not (thr_h > 0 and abs(thr_d - thr_h) <= 1e-5 * thr_h and diff <= 1e-3 * total):
        raise AssertionError(f"device vs host strategy: thr {thr_d} vs {thr_h}, {diff}/{total} cells")
    return {"aeons_batches": len(rows), "contigs": rows[-1]["n_contigs"],
            "pool_mb": n_pool_contigs * contig_len / 1e6, "threshold_device": thr_d,
            "threshold_host": thr_h, "mask_cells_differing": diff, "mask_cells": total}


# -------------------------------------------------------------- four cards ---

def phase_sharded_sim(paths, lengths, batches=5, shards=4):
    """(a) the zymo simulation with the genome sharded over `shards` cards:
    every mask it writes equals the one-card run's, batch by batch."""
    one, m1 = run_main("smoke_g1", sim_sections(paths, batches))
    many, m4 = run_main(f"smoke_g{shards}", sim_sections(
        paths, batches, tpu={"mesh_genome": shards}))
    res = check_runs_sim(many, lengths, batches)
    if not masks_equal(m1, m4):
        raise AssertionError("sharded simulation masks differ from one card")
    return {"masks_compared": len(m1), **res}


def phase_sharded_scale(total_mb=134.0, steps=4, shards=4):
    """(b) the sharded step at chromosome scale against one card."""
    import jax

    sys.path.insert(0, str(ROOT / "scripts"))
    from bench_scale import CCL, scale_inputs

    from bossruns_tpu.models.runs import RunsEngine
    from bossruns_tpu.parallel.mesh import ShardedRunsEngine, make_mesh

    layout, batch = scale_inputs(total_mb, align_chunks=shards, hotspots=16)
    one = RunsEngine(layout)
    many = ShardedRunsEngine(layout, make_mesh(jax.devices()[:shards]))
    s1, s4 = one.init_state(), many.init_state()
    p1, p4 = one.make_params(CCL, 5300.0), many.make_params(CCL, 5300.0)
    b1, b4 = jax.device_put(batch), many.put_batch(batch)
    updated = 0
    for i in range(steps):
        s1, a1 = one.step(s1, b1, p1)
        s4, a4 = many.step(s4, b4, p4)
        h1, h4 = one.pull_aux(a1), many.pull_aux(a4)
        st1, st4 = np.asarray(s1.strat), np.asarray(s4.strat)
        if h1.updated != h4.updated or not np.array_equal(st1, st4):
            raise AssertionError(f"step {i}: sharded masks differ in {int((st1 != st4).sum())} cells")
        updated += int(h1.updated)
    frac = float(st1[:, layout.strat_row_valid, :].mean())
    if not updated or not 0.0 < frac < 1.0:
        raise AssertionError(f"decision path not exercised: {updated} updates, accepted {frac}")
    return {"genome_sites": int(layout.lengths.sum()), "steps": steps,
            "updated_steps": updated, "accepted_frac": round(frac, 4)}


def phase_dryrun(n: int):
    """(c) the b2 x g2 mesh dry run."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(n)
    return {"devices": n}


# -------------------------------------------------------------------- main ---

def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    res = out[0] if isinstance(out, tuple) else out
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s {json.dumps(res, default=str)}",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the genome-sharded phases on four cards")
    args = ap.parse_args(argv)

    jax = require_gpu()
    jax.config.update("jax_enable_x64", True)  # the f64 decision path
    from bossruns_tpu.conformance import ZYMO_LIKE_LENGTHS
    from bossruns_tpu.utils.compile_cache import configure_compile_cache

    devices = jax.devices()
    print(f"devices: {devices}", flush=True)
    print(card_info(), flush=True)
    print(f"jax {jax.__version__}, compile cache {configure_compile_cache()}", flush=True)
    if len(devices) < args.chips:
        raise SystemExit(f"--chips {args.chips} needs {args.chips} GPUs, found {len(devices)}")
    WORK.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    paths = run_phase("zymo_corpus", zymo_corpus)
    lengths = ZYMO_LIKE_LENGTHS
    if args.chips == 4:
        run_phase("sharded_sim", phase_sharded_sim, paths, lengths)
        run_phase("sharded_scale_134mb", phase_sharded_scale)
        run_phase("dryrun_multichip", phase_dryrun, 4)
    else:
        _res, masks = run_phase("runs_sim_paf", phase_runs_sim_paf, paths, lengths)
        run_phase("runs_sim_align", phase_runs_sim_align, paths)
        run_phase("parity", phase_parity, paths, lengths, masks)
        run_phase("device_aligner", phase_device_aligner, paths)
        run_phase("aeons", phase_aeons)
    print(f"all phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
