"""Realistic-scale conformance drive: engine (quirk mode) vs the
bug-compatible reference oracle on a zymo-like corpus.

The reference's de-facto conformance suite is a Zymo mock community —
zymo.fa, 9 contigs, largest 4,045,619 bp — plus 10k ONT reads
(/root/reference/tests/constants.py:8-23; the data submodule is empty in
this snapshot, so the corpus is regenerated here with a frozen seed:
reference-realistic contig count/length spread and an ONT-like error
profile). Each batch's observations feed BOTH

  * the device engine in reference-quirk mode (RunsConfig(reference_quirks)
    — quirk Q1, the ubar0 variable swap), and
  * ``oracle_quirks.ReferenceQuirkOracle`` — the complete bug-compatible
    NumPy pipeline (Q1 + the Q3/Q3b merged-row layout drifts, which are
    host-layout properties deliberately NOT reproduced on device;
    docs/PARITY.md).

so the per-batch mask agreement isolates exactly the documented Q3/Q3b
deviations. Consumed by tests/test_conformance_zymo.py (default suite,
asserts the agreement floor) and bench.py (reports it as a BENCH line).
"""
from __future__ import annotations

import numpy as np

from .models.layout import build_layout
from .models.runs import ReadBatch, RunsConfig, RunsEngine
from .ops.model import make_model
from .oracle_quirks import ReferenceQuirkOracle

#: 9 contigs, largest ~4.05 Mb — the zymo.fa shape
#: (tests/base/test_runs_core.py:37-40: NZ_CP041015.1 is 4,045,619 bp)
ZYMO_LIKE_LENGTHS = {
    "z01": 4_045_000, "z02": 2_800_000, "z03": 2_200_000,
    "z04": 1_500_000, "z05": 1_000_000, "z06": 500_000,
    "z07": 300_000, "z08": 150_000, "z09": 105_000,
}

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
TIME_COST = 5300.0
FHAT_WINDOW = 2000


def ont_observation_batch(rng, layout, n_reads: int, mean_len: float = 3500.0,
                          sub: float = 0.03, dele: float = 0.02):
    """One batch of ONT-profile per-base observations + read starts.

    Substitutions draw a uniform base (like the test corpora); deletions
    observe the deletion symbol (4) at the target site; insertions consume
    no target sites so they need no representation at the observation level.

    Returns (sym, rstart_global, rlen, starts_fwd, starts_rev) where
    starts_* are per-contig local read-start positions (the fwd tstart /
    rev tend convention, readstartdist.py:43-82).
    """
    lens = layout.lengths.astype(np.int64)
    p = lens / lens.sum()
    cid = rng.choice(len(lens), n_reads, p=p)
    rlen = np.clip(rng.normal(mean_len, mean_len * 0.6, n_reads),
                   400, 6 * mean_len).astype(np.int64)
    rlen = np.minimum(rlen, lens[cid] - 1)
    start_local = (rng.random(n_reads) * (lens[cid] - rlen)).astype(np.int64)
    rev = rng.integers(0, 2, n_reads)
    rstart = layout.offsets[cid] + start_local
    pos = np.concatenate([np.arange(s, s + l) for s, l in zip(rstart, rlen)])
    sym = layout.seq_int[pos].astype(np.int8)
    m = sym.shape[0]
    r = rng.random(m)
    subm = r < sub
    delm = (r >= sub) & (r < sub + dele)
    sym[subm] = rng.integers(0, 4, int(subm.sum()))
    sym[delm] = 4
    # read starts: fwd -> tstart, rev -> tend (the read's last covered site
    # + 1, i.e. start + len — PAF tend is exclusive)
    starts_fwd: dict[str, list] = {}
    starts_rev: dict[str, list] = {}
    for i, name in enumerate(layout.names):
        sel = cid == i
        fwd = sel & (rev == 0)
        rv = sel & (rev == 1)
        starts_fwd[name] = start_local[fwd]
        starts_rev[name] = (start_local + rlen)[rv]
    return sym, rstart, rlen, cid, rev, start_local, starts_fwd, starts_rev


def observation_step_batch(layout, obs, floors=(0, 0), rs_floor: int = 512):
    """Engine batch (dict of numpy ReadBatch fields) for one
    ``ont_observation_batch`` draw: match runs + explicit observations, and
    read-start rows mirroring io/coo.build_read_start_rows (incl. the
    histogram right-edge inclusion and beyond-range drop). Pad floors only
    grow, so a run of batches reuses few shapes. Returns (batch, floors,
    rs_floor)."""
    from .io.coo_native import pad_split, split_runs

    sym, rstart, rlen, cid, rev, start_local, _sf, _sr = obs
    n_reads = rlen.shape[0]
    qual = np.full(sym.shape[0], 40, np.int8)
    split = split_runs(layout, sym, qual, rstart.astype(np.int64),
                       rlen.astype(np.int32), np.zeros(n_reads, np.int32))
    padded = pad_split(split, floors)
    floors = (padded["mr_g"].shape[0], padded["ex_g"].shape[0])
    out_row, out_strand = [], []
    for i in range(n_reads):
        wf = int(layout.lengths[cid[i]]) // FHAT_WINDOW
        if wf == 0:
            continue
        start = int(start_local[i] + rlen[i]) if rev[i] else int(start_local[i])
        if start > FHAT_WINDOW * wf:
            continue
        out_row.append(int(layout.fhat_offsets[cid[i]]) + min(start // FHAT_WINDOW, wf - 1))
        out_strand.append(int(rev[i]))
    n_rs = len(out_row)
    rs_floor = max(rs_floor, 1 << int(np.ceil(np.log2(max(n_rs, 1)))))
    rs_row = np.zeros(rs_floor, np.int32)
    rs_strand = np.zeros(rs_floor, np.int32)
    rs_w = np.zeros(rs_floor, np.float32)
    rs_row[:n_rs] = out_row
    rs_strand[:n_rs] = out_strand
    rs_w[:n_rs] = 1.0
    batch = dict(padded, rs_row=rs_row, rs_strand=rs_strand, rs_w=rs_w)
    return batch, floors, rs_floor


def drive_zymo_conformance(
    n_batches: int = 3,
    reads_per_batch: int = 12_000,
    mean_len: float = 3500.0,
    seed: int = 7,
    lengths: dict[str, int] | None = None,
    exact_check: bool = True,
) -> dict:
    """Run the engine (quirk mode) and the quirk oracle over the same
    batches; return per-batch and final mask agreement.

    The defaults put ~3.3x mean coverage per batch on a 12.6 Mb community so
    bucket switches flip and the threshold scan runs on every batch.

    Two parity levels per batch:
      * ``exact_vs_drift_free`` (exact_check=True): the engine's masks must
        be BIT-IDENTICAL to the sequential f64 oracle of the same quirk-Q1
        pipeline (oracle.full_update(reference_quirks=True) with the
        engine's own scores) — the strongest claim, now at realistic scale.
      * ``agreement`` vs the COMPLETE bug-compatible oracle
        (ReferenceQuirkOracle, Q1+Q3+Q3b): quantifies what the reference's
        own merged-row layout drifts (docs/PARITY.md deviations, deliberately
        not reproduced on device) cost in decision agreement.
    """
    from . import oracle as oracle_mod

    lengths = lengths or ZYMO_LIKE_LENGTHS
    rng = np.random.default_rng(seed)
    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in lengths.items()}
    layout = build_layout(contigs)
    eng = RunsEngine(layout, make_model(ploidy=1),
                     RunsConfig(reference_quirks=True, debug_aux=exact_check))
    qo = ReferenceQuirkOracle(contigs, make_model(ploidy=1))
    attributed: list[dict] = []
    state = eng.init_state()
    state_np = None
    if exact_check:
        state_np = {k: np.asarray(v) for k, v in state._asdict().items()}
        state_np["read_starts"] = state_np["read_starts"].astype(np.float64)
    params = eng.make_params(CCL, TIME_COST)
    floors = (0, 0)
    rs_floor = 512
    agreements = []
    exact_batches: list[bool] = []
    any_on = False
    for _b in range(n_batches):
        obs = ont_observation_batch(rng, layout, reads_per_batch, mean_len)
        (sym, rstart, rlen, cid, rev, start_local, starts_fwd, starts_rev) = obs
        # --- engine side -------------------------------------------------
        batch_dict, floors, rs_floor = observation_step_batch(layout, obs, floors, rs_floor)
        state, aux = eng.step(state, ReadBatch(**batch_dict), params)
        ah = eng.pull_aux(aux)
        any_on = any_on or ah.any_on
        if exact_check:
            state_np, _aux_o = oracle_mod.full_update(
                eng, state_np, batch_dict, CCL, TIME_COST,
                scores_override=np.asarray(aux.scores),
                reference_quirks=True,
            )
            exact_ok = bool(
                np.array_equal(np.asarray(state.strat), state_np["strat"])
                and np.array_equal(np.asarray(state.coverage), state_np["coverage"])
            )
            exact_batches.append(exact_ok)
        # --- oracle side -------------------------------------------------
        for i, name in enumerate(layout.names):
            sel_reads = np.flatnonzero(cid == i)
            if sel_reads.size == 0:
                continue
            ppos = np.concatenate([
                np.arange(start_local[j], start_local[j] + rlen[j]) for j in sel_reads
            ])
            base_off = np.concatenate([[0], np.cumsum(rlen)[:-1]])
            psym = np.concatenate([
                sym[base_off[j]: base_off[j] + rlen[j]] for j in sel_reads
            ])
            qo.increment(name, ppos, psym.astype(np.int64))
        qo.count_read_starts(starts_fwd, starts_rev)
        masks_o, masks_df = qo.step(CCL, TIME_COST, also_drift_free=True)
        masks_e = eng.strat_dict(state)
        agree = np.concatenate([
            (masks_e[n] == masks_o[n][: masks_e[n].shape[0]]).ravel()
            for n in masks_e
        ])
        agreements.append(float(agree.mean()))
        # POSITIVE residual attribution, two named causes:
        #   drift      — cells where the quirk oracle disagrees with its own
        #                drift-free twin (identical f64 scores, layout
        #                removed): the predicted Q3/Q3b set;
        #   precision  — cells where the engine disagrees with the twin
        #                (engine scores are f32, the oracle's f64 — cells
        #                within a score ulp of the threshold bin edge flip).
        # Every observed disagreement must fall in one of the two
        # (set logic: engine != quirk implies quirk != twin OR engine !=
        # twin); `unexplained` counts cells outside BOTH — always 0 unless
        # the attribution machinery itself is broken.
        attributed.append(_attribute_residual(masks_e, masks_o, masks_df))
    total_obs = sum(a["observed"] for a in attributed)
    total_unexpl = sum(a["unexplained"] for a in attributed)
    total_prec = sum(a["precision"] for a in attributed)
    return {
        "agreement": agreements[-1],
        "per_batch": agreements,
        "min_agreement": float(min(agreements)),
        "exact_vs_drift_free": bool(exact_batches and all(exact_batches)),
        "exact_batches": exact_batches,
        "any_on": bool(any_on),
        "n_sites": int(layout.lengths.sum()),
        "n_contigs": len(layout.names),
        "reads_per_batch": reads_per_batch,
        # residual attribution: fraction of engine-vs-quirk disagreements NOT
        # inside the positively predicted Q3/Q3b drift set
        "residual_observed": total_obs,
        "residual_unexplained": total_unexpl,
        "residual_unexplained_frac": (
            total_unexpl / total_obs if total_obs else 0.0
        ),
        "residual_per_batch": attributed,
        "residual_precision": total_prec,
    }


def _attribute_residual(masks_e: dict, masks_o: dict, masks_df: dict) -> dict:
    """Decompose engine-vs-quirk mask disagreements into the predicted
    Q3/Q3b layout-drift set and the f32-vs-f64 score-precision set (see the
    call-site comment). Returns per-batch counts."""
    obs = unexpl = prec = 0
    for n in masks_e:
        rows = masks_e[n].shape[0]
        d_obs = masks_e[n] != masks_o[n][:rows]
        d_pred = masks_df[n][:rows] != masks_o[n][:rows]
        d_prec = masks_e[n] != masks_df[n][:rows]
        obs += int(d_obs.sum())
        prec += int((d_obs & ~d_pred & d_prec).sum())
        unexpl += int((d_obs & ~d_pred & ~d_prec).sum())
    return {"observed": obs, "unexplained": unexpl, "precision": prec}


def drive_dataplane_conformance(
    n_batches: int = 2,
    reads_per_batch: int = 6000,
    mean_len: float = 3500.0,
    seed: int = 11,
    lengths: dict[str, int] | None = None,
    ploidy: int = 1,
    barcoded: bool = False,
    work_dir=None,
) -> dict:
    """Conformance through the REAL data plane at scale.

    Unlike drive_zymo_conformance (which injects synthetic per-base
    observations), this drives the production ``BossRunsSim`` end to end —
    sample -> in-silico ReadUntil decide -> CIGAR expansion (native C) ->
    device coverage scatter -> scores -> mask — over a ground-truthed corpus
    (utils/datagen), and feeds the ReferenceQuirkOracle from the SAME
    decided PAF records through the independent NumPy expansion
    (io.paf.alignment_coverage). Matches the reference's own conformance
    tier (/root/reference/tests/base/test_runs_simulation.py:47-74 on
    zymo.fa + ERR3152366), parametrised over ploidy and barcodes like
    test_runs_core.py:12 / test_runs_sequences.py:9-23.

    Asserts two levels:
      * coverage_exact — the engine's device coverage equals the oracle's
        np.add.at coverage BIT-FOR-BIT per contig (the data plane has no
        tolerance: offsets, strands, barcodes, trunc records, quirk-Q2
        slices must all agree),
      * mask agreement vs the bug-compatible oracle (the Q3/Q3b layout
        drift is the only expected residual).
    """
    import shutil
    import tempfile
    from pathlib import Path

    from .io.paf import alignment_coverage
    from .models.runs_sim import BossRunsSim
    from .ops.model import make_model as _mk
    from .utils.datagen import write_corpus

    lengths = lengths or ZYMO_LIKE_LENGTHS
    tmp = Path(work_dir) if work_dir else Path(tempfile.mkdtemp(prefix="boss_dpc_"))
    own_tmp = work_dir is None
    try:
        bcs = [1, 2] if barcoded else None
        corpus = tmp / "corpus"
        done = corpus / ".complete"
        stamp = f"{sorted(lengths.items())}|{reads_per_batch * (n_batches + 1)}|{mean_len}|{seed}|{bcs}"
        paths = {"ref": str(corpus / "ref.fa"), "fq": str(corpus / "reads.fq"),
                 "paf_full": str(corpus / "full.paf"),
                 "paf_trunc": str(corpus / "trunc.paf")}
        # deterministic corpus (frozen rng): persistent work_dirs (bench
        # cache) skip the ~100 MB regeneration on later runs
        if not (done.exists() and done.read_text() == stamp
                and all(Path(p).exists() for p in paths.values())):
            paths = write_corpus(
                corpus, rng=np.random.default_rng(seed),
                contig_lengths=lengths,
                n_reads=reads_per_batch * (n_batches + 1),
                mean_len=mean_len, barcodes=bcs,
            )
            done.write_text(stamp)
        sim = BossRunsSim(
            ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
            paf_trunc=paths["paf_trunc"], name="dpc",
            batchsize=reads_per_batch, maxb=n_batches, out_base=tmp,
            barcodes=["barcode01", "barcode02"] if barcoded else None,
            ploidy=ploidy, reference_quirks=True, gated=False,
        )
        model = _mk(ploidy=ploidy)
        contigs_int = {
            n: np.frombuffer(s.encode(), np.uint8) for n, s in
            ((nm, sq) for nm, sq in _load_contig_strings(paths["ref"]).items())
        }
        enc = np.zeros(256, np.uint8)
        for i, b in enumerate(b"ACGT"):
            enc[b] = i
        contigs_int = {n: enc[v] for n, v in contigs_int.items()}
        nb = 2 if barcoded else 1
        qo = ReferenceQuirkOracle(contigs_int, model, nb=nb)

        # capture each batch's decided record set as the sim makes it
        captured: dict = {}
        orig_make = sim.make_decisions

        def capturing_make(seqs, full, trunc, read_bc):
            full2, trunc2, outc = orig_make(seqs, full, trunc, read_bc)
            captured.update(seqs=seqs, full=full2, trunc=trunc2, outc=outc,
                            read_bc=read_bc)
            return full2, trunc2, outc

        sim.make_decisions = capturing_make

        agreements, cov_exact, attributed = [], [], []
        for _b in range(n_batches):
            sim.process_batch()
            seqs, full, trunc = captured["seqs"], captured["full"], captured["trunc"]
            outc, read_bc = captured["outc"], captured["read_bc"]
            # quirk-Q2 trunc slices exactly as the sim applies them
            trunc_seqs = dict(outc.reads_decision)
            for kind, i in outc.cov_rows:
                if kind == "trunc" and trunc.rev[i]:
                    rid = trunc.qname[i]
                    trunc_seqs[rid] = seqs[rid][-sim.mu:]
            # oracle coverage from the same records, independent expansion
            per_contig: dict[str, list] = {}
            for kind, i in outc.cov_rows:
                rec = full if kind == "full" else trunc
                rid = rec.qname[i]
                seq = seqs[rid] if kind == "full" else trunc_seqs[rid]
                ts, te, symv, _q = alignment_coverage(rec, i, seq, "")
                per_contig.setdefault(rec.tname[i], []).append(
                    (ts, te, symv, read_bc.get(rid, 0)))
            for name, chunks in per_contig.items():
                pos = np.concatenate([np.arange(ts, te) for ts, te, _s, _b2 in chunks])
                sym = np.concatenate([s for _t, _e, s, _b2 in chunks]).astype(np.int64)
                bc = np.concatenate([
                    np.full(te - ts, b2, np.int64) for ts, te, _s, b2 in chunks
                ])
                qo.increment(name, pos, sym, bc)
            # read starts from accepted full records (fwd tstart / rev tend)
            starts_fwd: dict[str, list] = {}
            starts_rev: dict[str, list] = {}
            for i in outc.acc_rows:
                t = full.tname[i]
                if full.rev[i]:
                    starts_rev.setdefault(t, []).append(int(full.tend[i]))
                else:
                    starts_fwd.setdefault(t, []).append(int(full.tstart[i]))
            qo.count_read_starts(starts_fwd, starts_rev)
            masks_o, masks_df = qo.step(
                sim.rl_dist.approx_ccl, sim.rl_dist.time_cost,
                also_drift_free=True)
            masks_e = sim.engine.strat_dict(sim.state)
            agree_parts = [
                (masks_e[n] == masks_o[n][: masks_e[n].shape[0]]).ravel()
                for n in masks_e
            ]
            agreements.append(float(np.concatenate(agree_parts).mean()))
            attributed.append(_attribute_residual(masks_e, masks_o, masks_df))
            # coverage: engine device state vs oracle np.add.at, bit-for-bit
            cov_e = np.asarray(sim.state.coverage)  # [NB, 5, G_pad]
            ok = True
            for ci, n in enumerate(sim.layout.names):
                off = int(sim.layout.offsets[ci])
                L = int(sim.layout.lengths[ci])
                e = cov_e[:, :, off : off + L]            # [NB, 5, L]
                o = qo.contigs[n].coverage.transpose(2, 1, 0)  # [nb, 5, L]
                ok = ok and bool(np.array_equal(e, o.astype(e.dtype)))
            cov_exact.append(ok)
        total_obs = sum(a["observed"] for a in attributed)
        total_unexpl = sum(a["unexplained"] for a in attributed)
        total_prec = sum(a["precision"] for a in attributed)
        return {
            "per_batch": agreements,
            "min_agreement": float(min(agreements)),
            "coverage_exact": bool(all(cov_exact)),
            "coverage_exact_batches": cov_exact,
            "any_on": bool(np.asarray(sim.state.bucket_on).any()),
            "n_sites": int(sim.layout.lengths.sum()),
            "n_contigs": len(sim.layout.names),
            "ploidy": ploidy,
            "barcoded": barcoded,
            "reads_per_batch": reads_per_batch,
            "residual_observed": total_obs,
            "residual_unexplained": total_unexpl,
            "residual_unexplained_frac": (
                total_unexpl / total_obs if total_obs else 0.0),
            "residual_precision": total_prec,
        }
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def _load_contig_strings(ref_path: str) -> dict[str, str]:
    from .io.fastq import read_fastx

    return {name: seq for name, _c, seq, _q in read_fastx(ref_path)}
