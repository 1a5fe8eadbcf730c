"""Stage-level timing of the headline RUNS step on the accelerator.

Times jitted sub-pipelines (each ending in a tiny reduction so the stage's
work cannot be dead-code eliminated) to locate where the per-step ms go.
    python scripts/profile_step.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import jax

from bossruns_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import bench
from bossruns_tpu.models.runs import ReadBatch, RunsEngine
from bossruns_tpu.models.layout import DS
from bossruns_tpu.ops import genome_ops as gops
from bossruns_tpu.ops.scores import site_scores_t_scan


def timeit(fn, *args, n=7, name=""):
    r = fn(*args)
    jax.block_until_ready(r)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        r = fn(*args)
        jax.block_until_ready(r)
        ts.append(time.perf_counter() - t0)
    p50 = float(np.median(ts)) * 1e3
    print(f"{name:28s} {p50:8.2f} ms  (min {min(ts)*1e3:7.2f})", flush=True)
    return p50


def main():
    rng = np.random.default_rng(11)
    layout, batch_np = bench.build_inputs(rng)
    eng = RunsEngine(layout)
    state = eng.init_state()
    batch = ReadBatch(**{k: jax.device_put(v) for k, v in batch_np.items()})
    params = eng.make_params(bench.CCL, bench.TIME_COST)
    C = eng._consts
    cfg = eng.config
    nb, G = 1, layout.G_pad
    Gd = G // DS
    bdt = eng.benefit_dtype

    # full step (state is donated: thread it through)
    st = eng.init_state()
    st, aux = eng.step(st, batch, params)
    jax.block_until_ready(aux.vec)
    ts = []
    for _ in range(7):
        t0 = time.perf_counter()
        st, aux = eng.step(st, batch, params)
        jax.block_until_ready(aux.vec)
        ts.append(time.perf_counter() - t0)
    print(f"{'full step (f64)':28s} {float(np.median(ts))*1e3:8.2f} ms  "
          f"(min {min(ts)*1e3:7.2f})", flush=True)
    state = eng.init_state()

    # stage 1: coverage
    @jax.jit
    def s_cov(cov, batch):
        nbG = nb * G
        mr_len = batch.mr_len.astype(jnp.int32)
        sign = (mr_len > 0).astype(jnp.int32)
        mr_flat = batch.mr_bc.astype(jnp.int32) * G + batch.mr_g.astype(jnp.int32)
        ex_flat = batch.ex_bcsym.astype(jnp.uint32) * jnp.uint32(G) + batch.ex_g
        bounds = (jnp.zeros(nbG + 1, jnp.int32)
                  .at[mr_flat].add(sign, mode="drop")
                  .at[mr_flat + mr_len].add(-sign, mode="drop"))
        match_inc = jnp.cumsum(bounds[:nbG]).reshape(nb, G)
        exp_inc = (jnp.zeros(nb * 5 * G, jnp.int32).at[ex_flat].add(1, mode="drop")
                   .reshape(nb, 5, G))
        onehot_ref = (C.seq[None, :] == jnp.arange(5, dtype=C.seq.dtype)[:, None]).astype(jnp.int32)
        coverage = jnp.minimum(
            cov.astype(jnp.int32) + exp_inc + onehot_ref[None] * match_inc[:, None, :],
            65535).astype(jnp.uint16)
        changed = jnp.any(exp_inc != 0, axis=(0, 1)) | jnp.any(match_inc != 0, axis=0)
        return coverage, changed

    cov, changed = s_cov(state.coverage, batch)
    jax.block_until_ready(cov)
    timeit(lambda: s_cov(state.coverage, batch)[0].sum(), name="1 coverage scatter+cumsum")

    # stage 2: scores
    @jax.jit
    def s_scores(coverage):
        fresh = site_scores_t_scan(coverage, C.seq, eng.tables, eng._score_block(G))
        return fresh
    scores = s_scores(cov)
    jax.block_until_ready(scores)
    timeit(lambda: s_scores(cov).sum(), name="2 scores closed form")

    # stage 3: ds reductions (f64)
    @jax.jit
    def s_ds(coverage, scores):
        covsum = jnp.sum(coverage, axis=1, dtype=jnp.int32)
        covsum_f = covsum.astype(jnp.float32)
        covsum_ds = jnp.sum(covsum_f.reshape(nb, Gd, DS), axis=2, dtype=bdt)
        scores_ds = jnp.sum(scores.reshape(nb, Gd, DS), axis=2, dtype=bdt)
        return covsum_ds.sum(), scores_ds.sum()
    timeit(lambda: s_ds(cov, scores), name="3 ds reductions (f64)")

    @jax.jit
    def s_ds_int(coverage, scores):
        covsum = jnp.sum(coverage, axis=1, dtype=jnp.int32)
        covsum_ds = jnp.sum(covsum.reshape(nb, Gd, DS), axis=2).astype(bdt)
        scores_ds = jnp.sum(scores.reshape(nb, Gd, DS), axis=2, dtype=bdt)
        return covsum_ds.sum(), scores_ds.sum()
    timeit(lambda: s_ds_int(cov, scores), name="3b ds: int32 covsum variant")

    # stage 4: dropout + buckets (on f64 covsum_ds)
    @jax.jit
    def make_ds(coverage, scores):
        covsum = jnp.sum(coverage, axis=1, dtype=jnp.int32)
        covsum_f = covsum.astype(jnp.float32)
        covsum_ds = jnp.sum(covsum_f.reshape(nb, Gd, DS), axis=2, dtype=bdt)
        scores_ds = jnp.sum(scores.reshape(nb, Gd, DS), axis=2, dtype=bdt)
        return covsum, covsum_ds, scores_ds
    covsum, covsum_ds, scores_ds = jax.block_until_ready(make_ds(cov, scores))

    @jax.jit
    def s_dropout(covsum, covsum_ds, scores):
        covsum_f = covsum.astype(jnp.float32)
        per_contig = jnp.zeros(layout.n_contigs + 1, bdt).at[C.contig_id_ds].add(
            jnp.sum(covsum_ds, axis=0))
        contig_mean = (per_contig / C.contig_denom.astype(bdt)).astype(jnp.float32)
        thr_ds = jnp.floor(contig_mean / cfg.dropout_mod)[C.contig_id_ds]
        active_ds = (contig_mean > cfg.dropout_min_mean)[C.contig_id_ds]
        low = jnp.any(covsum_f.reshape(nb, Gd, DS) <= thr_ds[None, :, None], axis=0)
        drop_site = (low & active_ds[:, None]).reshape(G) & C.site_valid
        sc = jnp.where(drop_site[None, :], 0.0, scores)
        return sc.sum()
    timeit(lambda: s_dropout(covsum, covsum_ds, scores), name="4 dropout masking")

    # stage 5: benefit windows
    @jax.jit
    def s_benefit(scores_ds):
        smu, benefit = gops.expected_benefit(
            scores_ds, jnp.clip(params.approx_ccl // DS, 1, cfg.ccl_clamp_ds),
            C.seg_start, C.seg_end, mu_ds=cfg.mu // DS)
        return smu.sum(), benefit.sum()
    timeit(lambda: s_benefit(scores_ds), name="5 benefit windows (f64)")

    @jax.jit
    def s_benefit32(scores_ds):
        sd = scores_ds.astype(jnp.float32)
        smu, benefit = gops.expected_benefit(
            sd, jnp.clip(params.approx_ccl // DS, 1, cfg.ccl_clamp_ds),
            C.seg_start, C.seg_end, mu_ds=cfg.mu // DS)
        return smu.sum(), benefit.sum()
    timeit(lambda: s_benefit32(scores_ds), name="5b benefit windows (f32)")

    # stage 6: threshold scan
    @jax.jit
    def make_ben(scores_ds):
        return gops.expected_benefit(
            scores_ds, jnp.clip(params.approx_ccl // DS, 1, cfg.ccl_clamp_ds),
            C.seg_start, C.seg_end, mu_ds=cfg.mu // DS)
    smu, benefit = jax.block_until_ready(make_ben(scores_ds))
    fhat_b = jnp.zeros_like(benefit) + 1e-5

    @jax.jit
    def s_thr(benefit, smu, fhat_b):
        res = gops.find_strategy(benefit, smu, fhat_b, params.time_cost.astype(bdt))
        return res.threshold, res.strat.sum()
    timeit(lambda: s_thr(benefit, smu, fhat_b), name="6 threshold scan (f64)")

    # stage 7: fhat
    @jax.jit
    def s_fhat(rs):
        fhat_w = gops.fhat_pointmass(rs.astype(bdt), C.fhat_valid, layout.n_fhat,
                                     cfg.fhat_alpha, cfg.fhat_p0)
        tot = jnp.sum(fhat_w * C.fhat_rows[:, None])
        fidx = C.fhat_idx
        fhat_exp = jnp.where((fidx >= 0)[:, None],
                             jnp.take(fhat_w, jnp.maximum(fidx, 0), axis=0), 0.0)
        return (fhat_exp * tot).sum()
    timeit(lambda: s_fhat(state.read_starts), name="7 fhat expand")

    # D2H pull cost
    vec = jnp.arange(4.0)
    timeit(lambda: np.asarray(vec), name="D2H pull (4 floats)")


if __name__ == "__main__":
    main()
