"""Multi-chip sharding of the RUNS update step: explicit SPMD via shard_map.

Scaling design (SURVEY.md §2.3/§5): the genome is the long axis.
All per-site and per-ds-row state shards as contiguous chunk blocks over the
mesh axis ``g`` (the adaptive-sampling analogue of context/sequence
parallelism); the barcode axis optionally shards over ``b`` (multi-sample
data parallelism). Read COO batches are replicated — each shard keeps the
scatter rows that land in its block.

Earlier rounds expressed this with GSPMD sharding constraints on the
single-chip step and let the partitioner insert collectives. Inspecting the
partitioned HLO showed the partitioner falling back to FULL-GENOME
all-gathers (s32[G] for the flat coverage scatter, f64[Gd] for the benefit
cumsum): every device materialised the whole genome, so memory did not scale
and each step paid G-sized collectives. This module instead writes the SPMD
program explicitly with jax.shard_map; every array the body touches is the
local block, and the only communication is:

  * all_gather of per-shard [nb] run/score totals  (prefix for the two
    genome-axis cumulative sums: match-run coverage + benefit cs)
  * two ppermute halo exchanges of [nb, HALO] f64 cumsum boundary values
    (HALO = clamped max CCL window, default 4096 ds rows = 409.6 kb reads)
  * psums of tiny replicated tables: per-contig sums [C+1], bucket window
    sums [NW], threshold bins [192], and the aux scalars

Bit-exactness contract (matches models/runs.py + oracle.py): every cross-
site reduction either sums integers in f64 (coverage, buckets, contig means,
bin counts) or sums f32-rounded values in f64 (scores, fhat weights, ubar0
products) — both are exact under ANY reduction order, so the sharded step
produces bit-identical strategies to the single-chip engine and the
sequential f64 oracle.

Scatter domains are per-shard: the replicated batch carries (barcode,
uint32 position) pairs (good to 2^32 global sites — a 3.1 Gb human genome
fits), and each shard flattens only its LOCAL block, so the int32 scatter
limit applies per shard (nb_local * 5 * G_local < 2^31), not globally.

Layouts must be built with ``align_chunks = mesh g-size`` so every shard
gets whole chunks (layout.py guarantees equal blocks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.layout import BUCKET, DS, GenomeLayout, build_layout
from ..models.runs import (
    GenomeState,
    ReadBatch,
    RunsConfig,
    RunsEngine,
    StepAux,
    StepParams,
)
from ..ops import genome_ops as gops
from ..ops.scores import site_scores_t_scan
from . import distributed as dist

# benefit CCL piece weights 0.95..0.05 (reference.py:241-269); keep the
# accumulation order identical to ops/genome_ops.expected_benefit
_WEIGHTS = [float(w) for w in np.arange(0.05, 1.0, 0.1)[::-1]]


def local_run_indices(mr_bc, mr_g, mr_len, b0, g0u, nb_l, Gl):
    """Shard-local flat scatter indices for match-run boundary markers.

    All position arithmetic is uint32 (global positions exceed int32 beyond
    ~2.1 Gb); wraparound doubles as the out-of-shard test — a position left
    of the shard wraps to a huge value and fails the ``< Gl`` check. Returns
    (idx_start, idx_end) int32 in [0, nb_l*Gl], where nb_l*Gl marks
    out-of-shard rows (dropped by the scatter).
    """
    OOB = nb_l * Gl
    bc_l = mr_bc.astype(jnp.int32) - b0
    on_row = (bc_l >= 0) & (bc_l < nb_l) & (mr_len > 0)
    st_u = mr_g - g0u                                   # uint32, wraps
    idx_s = jnp.where(
        on_row & (st_u < Gl), bc_l * Gl + st_u.astype(jnp.int32), OOB
    )
    en_u = mr_g + mr_len.astype(jnp.uint32) - g0u
    idx_e = jnp.where(
        on_row & (en_u < Gl), bc_l * Gl + en_u.astype(jnp.int32), OOB
    )
    return idx_s, idx_e


def local_ex_indices(ex_bcsym, ex_g, b0, g0u, nb_l, Gl):
    """Shard-local flat scatter indices for explicit observations
    ((bc_l*5+sym)*Gl + g_l), with nb_l*5*Gl marking out-of-shard rows.
    EX_PAD-padded rows wrap to a huge g_ue and fail the < Gl check."""
    OOB = nb_l * 5 * Gl
    bsym = ex_bcsym.astype(jnp.int32)
    bc_e = bsym // 5 - b0
    sym_e = bsym % 5
    g_ue = ex_g - g0u                                   # uint32, wraps
    ok = (bc_e >= 0) & (bc_e < nb_l) & (g_ue < Gl)
    return jnp.where(ok, (bc_e * 5 + sym_e) * Gl + g_ue.astype(jnp.int32), OOB)


def make_mesh(devices=None, barcode_shards: int = 1, name_g: str = "g", name_b: str = "b") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    assert n % barcode_shards == 0, (n, barcode_shards)
    arr = np.array(devices).reshape(barcode_shards, n // barcode_shards)
    return Mesh(arr, (name_b, name_g))


class ShardedRunsEngine(RunsEngine):
    """RunsEngine whose step is an explicit shard_map SPMD program."""

    #: the single-transfer wire upload (RunsEngine.step_from_numpy) targets
    #: the single-chip step; sharded batches go through put_batch/step
    wire_capable = False

    def __init__(
        self,
        layout: GenomeLayout,
        mesh: Mesh,
        model=None,
        config: RunsConfig = RunsConfig(),
    ):
        self.mesh = mesh
        axes = mesh.axis_names
        self._axb, self._axg = axes[0], axes[-1]
        self.Sb = mesh.shape[self._axb]
        self.Sg = mesh.shape[self._axg]
        # relax the base class's single-chip scatter-range assert to per-shard
        self._shard_div = (self.Sb, self.Sg)
        assert layout.G_pad % self.Sg == 0
        assert (layout.G_pad // self.Sg) % DS == 0
        assert layout.n_barcodes % self.Sb == 0, (layout.n_barcodes, self.Sb)
        super().__init__(layout, model, config)
        self.Gl = layout.G_pad // self.Sg
        self.Gdl = self.Gl // DS
        self.nb_l = self.nb // self.Sb
        self.halo = int(min(self.Gdl, config.ccl_clamp_ds))

        def ns(*spec):
            return NamedSharding(mesh, P(*spec))

        b, g = self._axb, self._axg
        self._state_specs = GenomeState(
            coverage=P(b, None, g), zeroed=P(b, g), bucket_on=P(b, None),
            read_starts=P(None, None), strat=P(b, g, None),
        )
        self._state_shardings = GenomeState(
            coverage=ns(b, None, g), zeroed=ns(b, g), bucket_on=ns(b, None),
            read_starts=ns(None, None), strat=ns(b, g, None),
        )
        batch_specs = ReadBatch(*([P()] * len(ReadBatch._fields)))
        params_specs = StepParams(P(), P(), P())
        # genome-axis constants move to their shards once at init
        const_specs = (
            P(g),        # seq [G]
            P(g),        # site_valid [G]
            P(g),        # contig_id_ds [Gd]
            P(g),        # seg_start [Gd]
            P(g),        # seg_end [Gd]
            P(g),        # strat_valid [Gd]
            P(g),        # fhat_idx [Gd]
            P(g),        # bucket_idx [Gd]
            P(g),        # win_id_ds [Gd]
            P(None),     # bucket_src [NBk]
            P(None),     # bucket_valid [NBk]
            P(None),     # fhat_valid [Wf]
            P(None),     # fhat_rows [Wf]
            P(None),     # contig_denom [C+1]
        )
        # shard_put (not device_put): works when the mesh spans processes —
        # each process materialises only its addressable blocks of the
        # genome-axis constants
        self._consts = tuple(
            dist.shard_put(np.asarray(c), ns(*spec))
            for c, spec in zip(
                (
                    self.c_seq, self.c_site_valid,
                    self.c_contig_id_ds, self.c_seg_start, self.c_seg_end,
                    self.c_strat_valid, self.c_fhat_idx, self.c_bucket_idx,
                    self.c_win_id_ds, self.c_bucket_src, self.c_bucket_valid,
                    self.c_fhat_valid, self.c_fhat_rows, self.c_contig_denom,
                ),
                const_specs,
            )
        )
        aux_specs = StepAux(
            any_on=P(), updated=P(), threshold=P(), mean_coverage=P(), vec=P(),
            scores=(P(b, g) if config.debug_aux else None),
        )
        mapped = jax.shard_map(
            self._step_local,
            mesh=mesh,
            in_specs=(self._state_specs, batch_specs, params_specs, const_specs),
            out_specs=(self._state_specs, aux_specs),
            check_vma=False,
        )
        # consts are explicit jit ARGUMENTS: closing over arrays that span
        # non-addressable devices is rejected in multi-process runs (and
        # closure-captured genome-sized arrays would embed as HLO literals)
        self._jit_step = jax.jit(mapped, donate_argnums=(0,))
        self.step = lambda state, batch, params: self._jit_step(
            state, batch, params, self._consts
        )

    # ---------------------------------------------------------------- body ---

    def _step_local(self, state: GenomeState, batch: ReadBatch, params: StepParams, consts):
        """Per-shard step body. Mirrors RunsEngine._step stage by stage; each
        comment cites the single-chip line it reproduces."""
        (seq_l, valid_l, cid_l, seg_s_l, seg_e_l, strat_v_l,
         fidx_l, bidx_l, win_l, bucket_src, bucket_valid, fhat_valid,
         fhat_rows, contig_denom) = consts
        cfg = self.config
        dtype = self.dtype
        bdt = self.benefit_dtype
        axg, axb = self._axg, self._axb
        both = (axb, axg)
        Sg = self.Sg
        s = lax.axis_index(axg)
        b_sh = lax.axis_index(axb)
        nb_l, _, Gl = state.coverage.shape
        Gdl = Gl // DS
        halo = self.halo
        # global site offset in uint32: s * Gl exceeds int32 beyond ~2.1 Gb
        # (human genome 3.1e9 sites); all position arithmetic below is uint32
        # where wraparound doubles as the out-of-shard test (a position left
        # of the shard wraps to a huge value and fails the `< Gl` check)
        g0u = s.astype(jnp.uint32) * jnp.uint32(Gl)
        row0 = s * Gdl                              # global ds-row offset
        b0 = b_sh * nb_l                            # global barcode offset

        # -- 1. coverage increments (runs.py step 1) --------------------------
        # match-run +1/-1 boundaries: keep the markers that land in this
        # shard; the cross-shard carry is the net number of runs still open
        # at the shard boundary, all_gathered as one integer per barcode row
        OOB = nb_l * Gl
        idx_s, idx_e = local_run_indices(
            batch.mr_bc, batch.mr_g, batch.mr_len, b0, g0u, nb_l, Gl
        )
        bounds = (
            jnp.zeros(OOB + 1, jnp.int32)
            .at[idx_s].add(1, mode="drop")
            .at[idx_e].add(-1, mode="drop")
        )[:OOB].reshape(nb_l, Gl)
        net = jnp.sum(bounds, axis=1)                       # [nb_l] int32
        nets = lax.all_gather(net, axg)                     # [Sg, nb_l]
        before = (jnp.arange(Sg, dtype=jnp.int32) < s)[:, None]
        carry = jnp.sum(jnp.where(before, nets, 0), axis=0)  # [nb_l]
        match_inc = jnp.cumsum(bounds, axis=1) + carry[:, None]

        OOB2 = nb_l * 5 * Gl
        idx = local_ex_indices(batch.ex_bcsym, batch.ex_g, b0, g0u, nb_l, Gl)
        exp_inc = (
            jnp.zeros(OOB2 + 1, jnp.int32)
            .at[idx].add(1, mode="drop")
        )[:OOB2].reshape(nb_l, 5, Gl)
        onehot_l = (
            seq_l[None, :] == jnp.arange(5, dtype=seq_l.dtype)[:, None]
        ).astype(jnp.int32)
        # saturating uint16 add; `inc` stays fused, and changed decomposes
        # exactly (increments >= 0) — see the single-chip step's comments
        coverage = jnp.minimum(
            state.coverage.astype(jnp.int32)
            + exp_inc
            + onehot_l[None] * match_inc[:, None, :],
            65535,
        ).astype(jnp.uint16)
        changed_l = jnp.any(exp_inc != 0, axis=(0, 1)) | jnp.any(
            match_inc != 0, axis=0
        )  # [Gl]
        changed_site = lax.psum(changed_l.astype(jnp.int32), axb) > 0

        covsum = jnp.sum(coverage, axis=1, dtype=jnp.int32)
        covsum_f = covsum.astype(dtype)

        # -- 2. scores (runs.py step 2) ---------------------------------------
        fresh = site_scores_t_scan(
            coverage, seq_l, self.tables, self._score_block(Gl)
        )
        maxed = covsum >= cfg.freeze_cov
        fresh = jnp.maximum(fresh, 0.0)
        scores = jnp.where(valid_l[None, :], fresh, 0.0)
        scores = jnp.where(maxed, self.tiny, scores)

        covsum_ds = jnp.sum(covsum_f.reshape(nb_l, Gdl, DS), axis=2, dtype=bdt)
        pc_local = jnp.zeros(self.layout.n_contigs + 1, bdt).at[cid_l].add(
            jnp.sum(covsum_ds, axis=0)
        )
        per_contig = lax.psum(pc_local, both)               # exact: integers
        contig_mean = (per_contig / contig_denom.astype(bdt)).astype(dtype)
        thr_ds = jnp.floor(contig_mean / cfg.dropout_mod)[cid_l]
        active_ds = (contig_mean > cfg.dropout_min_mean)[cid_l]
        # "any barcode is low at this site" — OR across barcode shards
        low = jnp.any(covsum_f.reshape(nb_l, Gdl, DS) <= thr_ds[None, :, None], axis=0)
        low = lax.psum(low.astype(jnp.int32), axb) > 0
        drop_site = (low & active_ds[:, None]).reshape(Gl) & valid_l
        drop_now = jnp.broadcast_to(drop_site[None, :], (nb_l, Gl))

        recomputed = changed_site[None, :] & ~maxed
        hold_zero = state.zeroed & ~recomputed
        scores = jnp.where(hold_zero | drop_now, 0.0, scores)
        zeroed = drop_now | hold_zero

        # -- 3. bucket switches (runs.py step 3) -------------------------------
        NWp = self.NW_pad
        row_off = jnp.arange(nb_l, dtype=jnp.int32)[:, None] * NWp
        win_idx = jnp.where((win_l >= 0)[None, :], win_l[None, :] + row_off, nb_l * NWp)
        winsums = (
            jnp.zeros(nb_l * NWp, bdt)
            .at[win_idx.ravel()].add(covsum_ds.ravel(), mode="drop")
            .reshape(nb_l, NWp)
        )
        winsums = lax.psum(winsums, axg)                    # exact: integers
        wsum = jnp.take(winsums, jnp.maximum(bucket_src, 0), axis=1)
        bucket_mean = jnp.where((bucket_src >= 0)[None, :], wsum / BUCKET, 0.0).astype(dtype)
        bucket_on = state.bucket_on | (
            (bucket_mean >= params.bucket_threshold) & bucket_valid[None, :]
        )
        any_on = lax.psum(jnp.any(bucket_on).astype(jnp.int32), axb) > 0

        # -- 4. fhat (runs.py step 4): replicated compute ----------------------
        read_starts = gops.scatter_add_2d(
            state.read_starts, batch.rs_row, batch.rs_strand, batch.rs_w
        )
        fhat_w = gops.fhat_pointmass(
            read_starts.astype(bdt), fhat_valid, self.layout.n_fhat,
            cfg.fhat_alpha, cfg.fhat_p0,
        )
        tot = jnp.sum(fhat_w * fhat_rows.astype(bdt)[:, None])
        fhat_exp = jnp.where(
            (fidx_l >= 0)[:, None], jnp.take(fhat_w, jnp.maximum(fidx_l, 0), axis=0), 0.0
        )  # [Gdl, 2]
        fhat_exp = fhat_exp * jnp.where(tot > 0, cfg.on_target / tot, 0.0)
        fhat_exp = fhat_exp.astype(jnp.float32).astype(bdt)

        # -- 5. benefit (runs.py step 5) ---------------------------------------
        # genome-axis cumulative sum: local cumsum + all_gathered prefix, then
        # halo exchange of the boundary values each neighbour's windows read
        scores_ds = jnp.sum(scores.reshape(nb_l, Gdl, DS), axis=2, dtype=bdt)
        cs_l = jnp.cumsum(scores_ds, axis=-1, dtype=bdt)     # [nb_l, Gdl]
        totals = lax.all_gather(cs_l[:, -1], axg)            # [Sg, nb_l]
        prefix = jnp.sum(jnp.where(before, totals, 0.0), axis=0)  # exact: f32 summands
        cs_glob = jnp.concatenate([prefix[:, None], cs_l + prefix[:, None]], axis=1)
        # left halo: previous shard's last `halo` cumsum values; right halo:
        # next shard's first `halo` (post-zero) values. Edge shards receive
        # zeros — never read, because hi <= seg_end and lo >= seg_start keep
        # indices inside the genome
        fwd_perm = [(i, i + 1) for i in range(Sg - 1)]
        rev_perm = [(i + 1, i) for i in range(Sg - 1)]
        left = lax.ppermute(cs_glob[:, Gdl - halo : Gdl], axg, fwd_perm) if Sg > 1 else jnp.zeros((nb_l, halo), bdt)
        right = lax.ppermute(cs_glob[:, 1 : halo + 1], axg, rev_perm) if Sg > 1 else jnp.zeros((nb_l, halo), bdt)
        ext = jnp.concatenate([left, cs_glob, right], axis=1)  # rows row0-halo .. row0+Gdl+halo

        rows_g = row0 + jnp.arange(Gdl, dtype=jnp.int32)
        mu_ds = cfg.mu // DS
        wins = jnp.concatenate([
            jnp.asarray([mu_ds], jnp.int32).reshape(1),
            jnp.clip(params.approx_ccl // DS, 1, halo),
        ])  # [11]
        off = halo - row0
        # per-window dynamic-slice shifts of the halo-extended cumsum + TWO
        # boundary gathers shared by all windows (same reasoning as
        # ops/genome_ops.expected_benefit: instead of a stacked [11*Gdl]
        # traced-index gather). cs[r + d] for
        # the local rows is ext[:, halo + d : halo + d + Gdl] — w <= halo
        # keeps every slice inside the exchanged halos.
        cs_end = jnp.take(ext, seg_e_l + off, axis=-1)       # cs[seg_end[r]]
        cs_start = jnp.take(ext, seg_s_l + off, axis=-1)     # cs[seg_start[r]]
        base = ext[:, halo : halo + Gdl]                     # cs[r]
        base1 = ext[:, halo + 1 : halo + 1 + Gdl]            # cs[r+1]

        def win_fwd(w):
            shifted = lax.dynamic_slice_in_dim(ext, halo + w, Gdl, axis=-1)
            return jnp.where(rows_g + w <= seg_e_l, shifted, cs_end) - base

        def win_rev(w):
            shifted = lax.dynamic_slice_in_dim(ext, halo + 1 - w, Gdl, axis=-1)
            return base1 - jnp.where(rows_g + 1 - w >= seg_s_l, shifted, cs_start)

        smu = jnp.stack([win_fwd(wins[0]), win_rev(wins[0])], axis=-1)
        ebf = _WEIGHTS[0] * win_fwd(wins[1])
        ebr = _WEIGHTS[0] * win_rev(wins[1])
        for k in range(1, 10):
            ebf = ebf + _WEIGHTS[k] * win_fwd(wins[1 + k])
            ebr = ebr + _WEIGHTS[k] * win_rev(wins[1 + k])
        benefit = jnp.maximum(jnp.stack([ebf, ebr], axis=-1) - smu, 0.0)

        # -- 6. threshold + gated strategy (runs.py step 6) --------------------
        fhat_b = jnp.broadcast_to(fhat_exp[None], benefit.shape)
        norm = lax.pmax(jnp.max(benefit), both)
        any_nz = lax.psum(jnp.any(benefit > 0).astype(jnp.int32), both) > 0
        counts_l, fsum_l = gops.bin_benefit(benefit, fhat_b, norm, 192)
        counts = lax.psum(counts_l, both)                   # exact: integers
        fsum = lax.psum(fsum_l, both)                       # exact: f32 summands
        ubar0 = lax.psum(gops.ubar0_partial(
            fhat_b, benefit if cfg.reference_quirks else smu, bdt  # Q1 swap
        ), both)
        threshold = gops.threshold_from_bins(
            counts, fsum, norm, ubar0, params.time_cost.astype(bdt), 192
        )
        strat_cand = benefit >= threshold
        gate = jnp.take(bucket_on, jnp.maximum(bidx_l, 0), axis=1) & (bidx_l >= 0)[None, :]
        do_update = any_on & any_nz
        write = do_update & gate & strat_v_l[None, :]
        strat = jnp.where(write[:, :, None], strat_cand, state.strat)

        new_state = GenomeState(
            coverage=coverage, zeroed=zeroed, bucket_on=bucket_on,
            read_starts=read_starts, strat=strat,
        )
        mean_cov = (
            lax.psum(jnp.sum(covsum_ds), both) / self.n_real_sites
        ).astype(dtype)
        aux = StepAux(
            any_on=any_on,
            updated=do_update,
            threshold=threshold,
            mean_coverage=mean_cov,
            vec=jnp.stack([
                any_on.astype(dtype), do_update.astype(dtype),
                threshold.astype(dtype), mean_cov.astype(dtype),
            ]),
            scores=scores if cfg.debug_aux else None,
        )
        return new_state, aux

    # ---------------------------------------------------------------- util ---

    def init_state(self) -> GenomeState:
        """Build every state array shard-by-shard: materialising the
        unsharded [NB, 5, G] coverage first would allocate the whole genome
        on one device (5 GB at 250 Mb; impossible at 3 Gb)."""
        lay = self.layout
        strat_valid = np.asarray(lay.strat_row_valid)

        sh = self._state_shardings
        nb, Gp, Gdp, NBkp, Wfp = self.nb, lay.G_pad, lay.Gd_pad, lay.NBk_pad, lay.Wf_pad

        def norm(idx, shape):
            """index tuple of (possibly open) slices -> resolved slices."""
            return tuple(slice(*s.indices(d)[:2]) for s, d in zip(idx, shape))

        def zeros(shape, dtype, sharding):
            def cb(idx):
                ix = norm(idx, shape)
                return np.zeros([s.stop - s.start for s in ix], dtype)
            return jax.make_array_from_callback(shape, sharding, cb)

        def strat0_cb(idx):
            ix = norm(idx, (nb, Gdp, 2))
            blk = strat_valid[ix[1]][None, :, None]
            return np.broadcast_to(
                blk, (ix[0].stop - ix[0].start, blk.shape[1], ix[2].stop - ix[2].start)
            ).copy()

        return GenomeState(
            coverage=zeros((nb, 5, Gp), np.uint16, sh.coverage),
            zeroed=zeros((nb, Gp), bool, sh.zeroed),
            bucket_on=zeros((nb, NBkp), bool, sh.bucket_on),
            read_starts=zeros((Wfp, 2), np.dtype(self.dtype), sh.read_starts),
            strat=jax.make_array_from_callback((nb, Gdp, 2), sh.strat, strat0_cb),
        )

    def put_batch(self, batch: ReadBatch) -> ReadBatch:
        if self.mesh.devices.size > jax.local_device_count():
            return dist.replicate(batch, self.mesh)  # multi-host: callback form
        rep = NamedSharding(self.mesh, P())
        return jax.device_put(batch, rep)

    def make_params(self, approx_ccl: np.ndarray, time_cost: float) -> StepParams:
        params = super().make_params(approx_ccl, time_cost)
        if self.mesh.devices.size > jax.local_device_count():
            return dist.replicate(params, self.mesh)
        return params

    def strat_dict(self, state: GenomeState) -> dict[str, np.ndarray]:
        if not state.strat.is_fully_addressable:
            state = state._replace(strat=dist.fetch(state.strat))
        return super().strat_dict(state)


def demo_sharded_step(n_devices: int | None = None, barcode_shards: int = 1, seed: int = 0,
                      n_steps: int = 3):
    """Build a small multi-contig genome, shard it over all devices, run the
    full update step ``n_steps`` times. Used by the multichip dry-run and as
    a living example.

    The simulated batch carries enough coverage (~6x mean per step over c1,
    with 5% mismatches) that by the last step bucket switches flip on and the
    threshold scan produces a REAL mask: callers can assert any_on and a
    non-trivial accepted fraction, proving the whole decision path (not just
    the coverage/score plumbing) executes under the sharded mesh.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    mesh = make_mesh(devices[:n], barcode_shards=barcode_shards)
    gsize = mesh.shape[mesh.axis_names[-1]]
    rng = np.random.default_rng(seed)
    nb = max(2, barcode_shards) if barcode_shards > 1 else 1
    contigs = {
        "c1": rng.integers(0, 4, 150_000).astype(np.uint8),
        "c2": rng.integers(0, 4, 120_000).astype(np.uint8),
    }
    layout = build_layout(contigs, n_barcodes=nb, align_chunks=gsize)
    eng = ShardedRunsEngine(layout, mesh)
    state = eng.init_state()

    n_runs, run_len = 768, 2048
    rstart = rng.integers(0, 148_000 - run_len, n_runs).astype(np.int32)
    pos = np.concatenate([np.arange(s0, s0 + run_len) for s0 in rstart])
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 4, int(flip.sum()))
    from ..io.coo_native import pad_split, split_runs

    split = split_runs(
        layout, sym,
        np.full(pos.shape[0], 40, np.int8), rstart.astype(np.int64),
        np.full(n_runs, run_len, np.int32),
        rng.integers(0, nb, n_runs).astype(np.int32),
    )
    batch = eng.put_batch(
        ReadBatch(
            **pad_split(split),
            rs_row=rng.integers(0, layout.n_fhat, 512).astype(np.int32),
            rs_strand=rng.integers(0, 2, 512).astype(np.int32),
            rs_w=np.ones(512, np.float32),
        )
    )
    params = eng.make_params(
        np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400]), 5300.0
    )
    aux = None
    for _ in range(n_steps):
        state, aux = eng.step(state, batch, params)
    jax.block_until_ready(state)
    return eng, state, aux
