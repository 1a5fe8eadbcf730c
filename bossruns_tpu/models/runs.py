"""BOSS-RUNS update engine: one jitted state transition per read batch.

The reference spreads each update over per-contig Python loops
(/root/reference/boss/runs/core.py:202-224 + update_wrapper :160-198). Here the
whole per-batch pipeline is a single pure function

    (GenomeState, ReadBatch, StepParams) -> (GenomeState, StepAux)

over dense, padded, genome-axis arrays (see models/layout.py), jitted once and
re-used for every batch; window sizes and the time cost arrive as traced
scalars so the read-length distribution never forces recompilation. The same
function runs single-chip or genome-sharded under a jax Mesh (parallel/).

Pipeline per batch (reference call sites in parens):
  1. coverage scatter-add + per-site change flags   (reference.py:122-144)
  2. dense posterior/score recompute                (sequences.py:398-455)
     - sites with total coverage >= 30 freeze to tiny  (sequences.py:419-430)
     - dropout sites (cov <= contig_mean/8 once mean > 5) score 0
       (reference.py:148-178); zeroing is sticky until the site changes,
       matching the reference's changed-sites-only recompute.
  3. bucket activation switches                     (reference.py:183-211)
  4. read-start (fhat) posterior                    (readstartdist.py:43-117)
  5. S_mu + CCL-weighted expected benefit           (reference.py:215-269)
  6. global exponent-binned threshold -> strategy   (sequences.py:565-649)
     gated per 20kb bucket                          (runs/core.py:125-155)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import genome_ops as gops
from ..ops.model import ObservationModel, make_model
from ..ops.scores import ScoreTables, site_scores_t_scan
from .layout import BUCKET, CHUNK, DS, GenomeLayout


class GenomeState(NamedTuple):
    coverage: jax.Array      # [NB, 5, G_pad] uint16 (genome axis last;
    #   the reference's dtype, reference.py:71-79 — halves the dominant HBM
    #   array. Adds SATURATE at 65535 instead of the reference's silent
    #   np.add.at wraparound (a deliberate safety deviation; scoring freezes
    #   at total>=30 so values this high never influence decisions anyway)
    zeroed: jax.Array        # [NB, G_pad] bool — sticky dropout zeros
    bucket_on: jax.Array     # [NB, NBk_pad] bool — sticky activation switches
    read_starts: jax.Array   # [Wf_pad, 2] f32 — accumulated start counts
    strat: jax.Array         # [NB, Gd_pad, 2] bool — current strategy


class ReadBatch(NamedTuple):
    """Match-run + explicit-observation batch (host-built).

    ~90-95% of aligned bases match the reference, in runs broken only by
    errors, so coverage splits into (a) reference-match intervals added on
    device with a +1/-1 boundary scatter and a cumulative sum and (b) an
    explicit COO of mismatch/deletion observations. One scatter row per
    interval/exception instead of per base: ~10x fewer rows through the
    coverage scatter, and ~10x less host->device transfer again. Quality
    masking (qual < qt) and the 4-symbol model's deletion drop are applied
    host-side (io/coo_native.py + native/split_match_runs_wide_v2). Padding:
    match runs carry mr_len 0; explicit entries carry ex_g = 0xFFFFFFFF
    (io.coo_native.EX_PAD), which flattens to a dropped scatter index — no
    separate weight array rides the transfer.

    Positions are (barcode, uint32 position) pairs, NOT flattened bc*G+g
    indices: uint32 carries genomes to 2^32 sites (human = 3.1e9), and each
    engine flattens into ITS OWN scatter domain on device — global int32 for
    the single-chip engine (assert in __init__), shard-local int32 for the
    sharded engine. The batch stays replicated either way. Dtypes are the
    narrowest that carry the ranges (uint8 barcode, uint16 run length with
    host-side chunking of longer runs), so each batch moves few bytes from
    host to device.
    """

    mr_bc: jax.Array     # [RM] uint8 barcode row of a match run
    mr_g: jax.Array      # [RM] uint32 genome start position of the run
    mr_len: jax.Array    # [RM] uint16 run length (0 = padding)
    ex_bcsym: jax.Array  # [ME] uint16 bc*5 + sym of an explicit observation
    ex_g: jax.Array      # [ME] uint32 genome position (EX_PAD = padding)
    rs_row: jax.Array    # [Rs] int32 global fhat window row
    rs_strand: jax.Array  # [Rs] int32 0=fwd 1=rev
    rs_w: jax.Array      # [Rs] f32


def normalize_state(state: GenomeState) -> GenomeState:
    """Cast a restored checkpoint to the current state dtypes.

    Checkpoints written before the uint16-coverage change stored int32;
    without the cast a resumed run would recompile the step twice (once for
    the legacy dtype, once after the first step emits uint16)."""
    if state.coverage.dtype != jnp.uint16:
        state = state._replace(
            coverage=jnp.clip(state.coverage, 0, 65535).astype(jnp.uint16)
        )
    return state


class StepParams(NamedTuple):
    approx_ccl: jax.Array       # [10] int32 full-res CCL pieces
    time_cost: jax.Array        # f32 scalar (lambda - mu - rho)
    bucket_threshold: jax.Array  # f32 scalar


class StepAux(NamedTuple):
    any_on: jax.Array        # bool — any bucket switched on (strategy active)
    updated: jax.Array       # bool — strategy was recomputed this step
    threshold: jax.Array     # f32 — accept threshold (benefit units)
    mean_coverage: jax.Array  # f32 — mean site coverage over real sites
    vec: jax.Array           # f32[4] — the four scalars packed for one D2H pull
    scores: jax.Array | None = None  # [NB, G] post-mask scores (debug_aux only)


class EngineConsts(NamedTuple):
    """Genome-sized device constants, passed as step arguments (NOT closure
    captures — see RunsEngine.__init__). The one-hot reference is NOT stored:
    it is recomputed from ``seq`` inside the step (an elementwise compare XLA
    fuses into its consumer), saving 5*G bytes of HBM and a 5*G host
    materialisation at human-genome scale."""

    seq: jax.Array           # [G] int8 (0..4)
    site_valid: jax.Array    # [G] bool
    contig_id_ds: jax.Array  # [Gd] int32
    seg_start: jax.Array     # [Gd] int32
    seg_end: jax.Array       # [Gd] int32
    strat_valid: jax.Array   # [Gd] bool
    fhat_idx: jax.Array      # [Gd] int32
    bucket_idx: jax.Array    # [Gd] int32
    win_id_ds: jax.Array     # [Gd] int32
    bucket_src: jax.Array    # [NBk] int32
    bucket_valid: jax.Array  # [NBk] bool
    fhat_valid: jax.Array    # [Wf] bool
    fhat_rows: jax.Array     # [Wf] benefit_dtype
    contig_denom: jax.Array  # [C+1] dtype


class AuxHost(NamedTuple):
    """Host copy of StepAux, fetched with a single device->host transfer.

    Reading the four aux scalars field-by-field would cost four device->host
    round trips instead of one. Always pull via RunsEngine.pull_aux.
    """

    any_on: bool
    updated: bool
    threshold: float
    mean_coverage: float


@dataclasses.dataclass(frozen=True)
class RunsConfig:
    mu: int = 400
    qt: int = 0                   # quality threshold (sequences.py:659)
    freeze_cov: int = 30          # sequences.py:419
    dropout_mod: int = 8          # reference.py:166
    dropout_min_mean: float = 5.0  # reference.py:158
    bucket_threshold: float = 5.0  # config.py:51
    fhat_alpha: float = 1.0
    fhat_p0: float = 0.1
    on_target: float = 1.0
    dtype: str = "float32"
    # decision-path precision: benefit window sums, fhat and the threshold
    # scan run in this dtype (scores stay in `dtype`). float64 makes the
    # strategy decisions match a sequential f64 implementation to ~1 ulp —
    # the BASELINE "bit-identical decisions" contract; the arrays are
    # genome/100 sized, so the f64 work is small beside the per-site scores.
    # Falls back to f32 automatically when jax x64 is disabled.
    benefit_dtype: str = "float64"
    # static clamp (ds rows) on the CCL benefit windows; bounds the halo the
    # sharded engine exchanges between neighbour shards. 4096 ds rows =
    # 409.6 kb reads — far beyond any nanopore read-length distribution.
    ccl_clamp_ds: int = 4096
    # score computation proceeds in genome-axis blocks of ~this many sites
    # (rounded to a chunk-aligned divisor of the local axis): caps the
    # [genotypes, sites] f32 posterior temporaries at the block size instead
    # of the whole (per-shard) genome — the dominant transient at chromosome
    # scale. Bit-identical to unblocked (ops/scores.site_scores_t_scan).
    # <= 0 disables blocking.
    score_block: int = 16 * CHUNK
    # return the post-mask score array in StepAux (parity tests/debugging)
    debug_aux: bool = False
    # reference-quirk Q1 (docs/PARITY.md deviation 1): compute the threshold
    # scan's ubar0 term from BENEFIT instead of S_mu, reproducing the
    # reference's variable swap (runs/core.py:178-186 passes `benefit` to
    # both adjust_length calls). The full bug-compatible pipeline (incl. the
    # Q3 merged-row drift, which is a host-layout property and deliberately
    # NOT reproduced on device) is oracle_quirks.ReferenceQuirkOracle.
    reference_quirks: bool = False
    # Fused hand-written kernels for the score closed form and the benefit
    # windows were built once and removed: XLA already fuses the masking
    # chain into the matmuls, and the benefit kernel was f32-only, which the
    # f64 bit-exact decision path cannot use.


class RunsEngine:
    """Builds device constants for a layout and exposes the jitted step."""

    #: step_from_numpy (single-transfer wire upload) is valid on this engine
    wire_capable = True

    def __init__(
        self,
        layout: GenomeLayout,
        model: ObservationModel | None = None,
        config: RunsConfig = RunsConfig(),
    ):
        self.layout = layout
        self.config = config
        self.model = model if model is not None else make_model(ploidy=1)
        self.dtype = jnp.dtype(config.dtype)
        # canonicalize: float64 becomes float32 when jax x64 is disabled
        self.benefit_dtype = jax.dtypes.canonicalize_dtype(jnp.dtype(config.benefit_dtype))
        if self.benefit_dtype != jnp.dtype(config.benefit_dtype):
            import logging

            logging.getLogger("bossruns").warning(
                "jax x64 is disabled: decision path falls back to float32 "
                "(enable with jax.config.update('jax_enable_x64', True) for "
                "f64-exact strategy decisions)"
            )
        self.tables = ScoreTables(self.model, self.dtype)
        self.tiny = float(np.finfo(self.dtype).tiny)

        lay = layout
        self.nb = lay.n_barcodes
        # flat scatter indices are int32; beyond this, shard the genome axis
        # (parallel/mesh.py) so the per-shard scatter domain stays in range.
        # The batch format itself is (bc, uint32 g) pairs, good to 2^32
        # global sites — only the LOCAL flat domain must fit int32.
        div_b, div_g = getattr(self, "_shard_div", (1, 1))
        assert (lay.n_barcodes // div_b) * (lay.G_pad // div_g) * 5 < 2**31, (
            "genome too large for int32 scatter domain; shard it (parallel/mesh.py)"
        )
        # device constants (seq int8: at 3.1e9 sites every byte per site is
        # ~3 GB of HBM across the mesh)
        self.c_seq = jnp.asarray(lay.seq_int.astype(np.int8))
        self.c_site_valid = jnp.asarray(lay.site_valid())
        self.c_contig_id_ds = jnp.asarray(np.where(lay.contig_id_ds < 0, lay.n_contigs, lay.contig_id_ds), jnp.int32)
        self.c_seg_start = jnp.asarray(lay.ds_seg_start, jnp.int32)
        self.c_seg_end = jnp.asarray(lay.ds_seg_end, jnp.int32)
        self.c_strat_valid = jnp.asarray(lay.strat_row_valid)
        self.c_fhat_idx = jnp.asarray(lay.fhat_idx, jnp.int32)
        self.c_bucket_idx = jnp.asarray(lay.bucket_idx, jnp.int32)
        self.c_bucket_valid = jnp.asarray(np.arange(lay.NBk_pad) < lay.n_buckets)
        self.c_fhat_valid = jnp.asarray(np.arange(lay.Wf_pad) < lay.n_fhat)
        # bucket source windows as a scatter domain: every bucket reads the
        # mean of one full 200-ds-row window (the tail bucket re-reads the
        # last full one, reference.py:183-211). Summing rows INTO windows and
        # gathering per bucket — instead of cumsum differences — makes the
        # sums integer-exact in benefit_dtype and therefore identical between
        # the single-chip and genome-sharded engines (order-invariant).
        win_rows = BUCKET // DS
        uniq_lo = np.unique(lay.bucket_lo_ds[lay.bucket_lo_ds >= 0])
        self.n_win = int(uniq_lo.shape[0])
        self.NW_pad = max(8, -(-self.n_win // 8) * 8)
        win_id = np.full(lay.Gd_pad, -1, np.int32)
        if self.n_win:
            rows_f = (uniq_lo[:, None] + np.arange(win_rows)[None, :]).ravel()
            win_id[rows_f] = np.repeat(np.arange(self.n_win, dtype=np.int32), win_rows)
        src = np.searchsorted(uniq_lo, lay.bucket_lo_ds).astype(np.int32)
        self.c_win_id_ds = jnp.asarray(win_id)
        self.c_bucket_src = jnp.asarray(np.where(lay.bucket_lo_ds >= 0, src, -1), jnp.int32)
        # rows per fhat window: closes the fhat normaliser into a replicated
        # [Wf]-sized sum (identical across shards/topologies by construction)
        fhat_rows = np.bincount(
            lay.fhat_idx[lay.fhat_idx >= 0], minlength=lay.Wf_pad
        ).astype(np.float64)
        self.c_fhat_rows = jnp.asarray(fhat_rows, self.benefit_dtype)
        # per-contig site counts (incl. a trailing pseudo-contig for padding)
        denom = np.append(lay.lengths * lay.n_barcodes, 1).astype(np.float64)
        self.c_contig_denom = jnp.asarray(denom, self.dtype)
        self.n_real_sites = float(lay.lengths.sum())
        # the genome-sized constants are ARGUMENTS of the jitted step, not
        # closure captures: closed-over arrays get embedded as literals in
        # the HLO, which bloats the executable and its compile with O(G)
        # bytes
        self._consts = EngineConsts(
            seq=self.c_seq,
            site_valid=self.c_site_valid, contig_id_ds=self.c_contig_id_ds,
            seg_start=self.c_seg_start, seg_end=self.c_seg_end,
            strat_valid=self.c_strat_valid, fhat_idx=self.c_fhat_idx,
            bucket_idx=self.c_bucket_idx, win_id_ds=self.c_win_id_ds,
            bucket_src=self.c_bucket_src, bucket_valid=self.c_bucket_valid,
            fhat_valid=self.c_fhat_valid, fhat_rows=self.c_fhat_rows,
            contig_denom=self.c_contig_denom,
        )
        self._jit_step = jax.jit(self._step, donate_argnums=(0,))
        self.step = lambda state, batch, params: self._jit_step(
            state, batch, params, self._consts
        )
        self._jit_step_wire = jax.jit(
            self._step_wire, donate_argnums=(0,), static_argnums=(4,)
        )
        self._jit_step_gated = jax.jit(
            self._step_gated, donate_argnums=(0,), static_argnums=(5,)
        )

    # ------------------------------------------------------- wire format ----
    #
    # Ship a ReadBatch as ONE uint32 buffer (pure memcpy host-side; fused
    # bitcasts device-side) instead of 8 separate host arrays: one
    # host->device transfer per batch instead of eight. Whether that still
    # pays on a locally attached card is an open measurement. Bit-exact
    # round trip pinned by tests/test_wide_format.py::test_wire_roundtrip.

    _WIRE_FIELDS = (
        ("mr_bc", np.uint8), ("mr_g", np.uint32), ("mr_len", np.uint16),
        ("ex_bcsym", np.uint16), ("ex_g", np.uint32), ("rs_row", np.int32),
        ("rs_strand", np.int32), ("rs_w", np.float32),
    )

    #: gated-batch wire: BOTH candidate coverage sets (f_* = full-length
    #: records, t_* = mu-truncated records) + per-row source-read indices +
    #: read-start rows for the full set. Shipped during PREFETCH (strategy-
    #: independent); at decision time only a per-read bit vector crosses to
    #: the device and selects full rows (accepted) vs trunc rows (rejected).
    _GATED_FIELDS = (
        ("f_mr_bc", np.uint8), ("f_mr_g", np.uint32), ("f_mr_len", np.uint16),
        ("f_mr_read", np.uint32),
        ("f_ex_bcsym", np.uint16), ("f_ex_g", np.uint32), ("f_ex_read", np.uint32),
        ("t_mr_bc", np.uint8), ("t_mr_g", np.uint32), ("t_mr_len", np.uint16),
        ("t_mr_read", np.uint32),
        ("t_ex_bcsym", np.uint16), ("t_ex_g", np.uint32), ("t_ex_read", np.uint32),
        ("rs_row", np.int32), ("rs_strand", np.int32), ("rs_read", np.int32),
    )

    @classmethod
    def _pack_fields(cls, get, fields):
        parts = []
        spec = []
        for name, dt in fields:
            a = np.ascontiguousarray(get(name), dtype=dt)
            spec.append((name, int(a.shape[0])))
            nb = a.nbytes
            pad = (-nb) % 4
            if pad:
                buf = np.zeros(nb + pad, np.uint8)
                buf[:nb] = a.view(np.uint8)
                parts.append(buf.view(np.uint32))
            else:
                parts.append(a.view(np.uint32))
        return np.concatenate(parts), tuple(spec)

    @classmethod
    def pack_wire(cls, batch: dict | ReadBatch):
        """dict/ReadBatch of numpy arrays -> (wire uint32[W], spec).

        spec = tuple of (name, n_elems) per field, static per shape — it
        keys the jit cache exactly like the per-field shapes did."""
        get = batch.__getitem__ if isinstance(batch, dict) else lambda f: getattr(batch, f)
        return cls._pack_fields(get, cls._WIRE_FIELDS)

    @classmethod
    def pack_gated(cls, d: dict):
        """dict of the _GATED_FIELDS arrays -> (wire uint32[W], spec)."""
        return cls._pack_fields(d.__getitem__, cls._GATED_FIELDS)

    @staticmethod
    def _unpack_fields(wire, spec, fields):
        dts = dict(fields)
        out = {}
        off = 0
        for name, n in spec:
            dt = np.dtype(dts[name])
            nwords = (n * dt.itemsize + 3) // 4
            words = wire[off: off + nwords]
            off += nwords
            if dt.itemsize == 4:
                arr = jax.lax.bitcast_convert_type(words, jnp.dtype(dt))
            else:
                arr = jax.lax.bitcast_convert_type(
                    words, jnp.dtype(dt)
                ).reshape(-1)[:n]
            out[name] = arr[:n]
        return out

    @staticmethod
    def unpack_wire(wire, spec) -> ReadBatch:
        """Device-side inverse of pack_wire (inside jit; fused bitcasts)."""
        return ReadBatch(**RunsEngine._unpack_fields(
            wire, spec, RunsEngine._WIRE_FIELDS
        ))

    def _step_wire(self, state: GenomeState, wire, params: StepParams,
                   C: EngineConsts, spec):
        return self._step(state, self.unpack_wire(wire, spec), params, C)

    def step_from_numpy(self, state: GenomeState, batch_np: dict,
                        params: StepParams):
        """One step from a HOST batch dict: single-transfer wire upload."""
        wire, spec = self.pack_wire(batch_np)
        return self._jit_step_wire(state, wire, params, self._consts, spec)

    # ------------------------------------------------------- gated step ----

    def _step_gated(self, state: GenomeState, wire, bits, params: StepParams,
                    C: EngineConsts, spec):
        """Select full-set rows where bits[read]=1 and trunc-set rows where
        bits[read]=0, then run the ordinary step. Gating uses the existing
        padding semantics (mr_len 0 / ex_g EX_PAD rows are dropped), so the
        result is bit-identical to packing only the selected rows host-side
        (pinned by tests/test_gated_sim.py)."""
        from ..io.coo_native import EX_PAD

        f = self._unpack_fields(wire, spec, self._GATED_FIELDS)
        on = bits > 0  # [n_reads_pad] uint8 -> bool
        pad = jnp.uint32(EX_PAD)

        # ONE bit-gather per row family (the four separate f/t gathers cost
        # extra launches): a row survives iff its read's bit matches the
        # family's wanted state (full rows want ON, trunc rows want OFF)
        nf_mr = f["f_mr_read"].shape[0]
        mr_reads = jnp.concatenate([f["f_mr_read"], f["t_mr_read"]])
        mr_want = jnp.arange(mr_reads.shape[0]) < nf_mr
        mr_keep = on[mr_reads.astype(jnp.int32)] == mr_want
        mr_len = jnp.where(
            mr_keep, jnp.concatenate([f["f_mr_len"], f["t_mr_len"]]), 0
        ).astype(jnp.uint16)

        nf_ex = f["f_ex_read"].shape[0]
        ex_reads = jnp.concatenate([f["f_ex_read"], f["t_ex_read"]])
        ex_want = jnp.arange(ex_reads.shape[0]) < nf_ex
        ex_keep = on[ex_reads.astype(jnp.int32)] == ex_want
        # drop = (bcsym 0, ex_g EX_PAD): a NONZERO bcsym would wrap the
        # unsigned flat index bcsym*G + 0xFFFFFFFF back IN bounds
        ex_g = jnp.where(
            ex_keep, jnp.concatenate([f["f_ex_g"], f["t_ex_g"]]), pad
        )
        ex_bcsym = jnp.where(
            ex_keep, jnp.concatenate([f["f_ex_bcsym"], f["t_ex_bcsym"]]), 0
        )
        batch = ReadBatch(
            mr_bc=jnp.concatenate([f["f_mr_bc"], f["t_mr_bc"]]),
            mr_g=jnp.concatenate([f["f_mr_g"], f["t_mr_g"]]),
            mr_len=mr_len,
            ex_bcsym=ex_bcsym,
            ex_g=ex_g,
            rs_row=f["rs_row"],
            rs_strand=f["rs_strand"],
            # rs rows belong to full-set records: active iff accepted;
            # padding rows carry rs_read -1
            rs_w=jnp.where(
                (f["rs_read"] >= 0) & on[jnp.maximum(f["rs_read"], 0)],
                1.0, 0.0,
            ).astype(jnp.float32),
        )
        return self._step(state, batch, params, C)

    def step_gated(self, state: GenomeState, wire_dev, bits_np: np.ndarray,
                   params: StepParams, spec):
        """One step from a PRE-UPLOADED gated wire + host decision bits.

        The wire (both coverage sets) ships during prefetch, overlapped with
        the previous step; only the ~n_reads decision bits cross the link on
        the critical path."""
        return self._jit_step_gated(
            state, wire_dev, bits_np, params, self._consts, spec
        )

    def _score_block(self, n_local: int) -> int:
        """Chunk-aligned divisor of the local site axis closest to (and at
        most) cfg.score_block; 0 when blocking is disabled or pointless.

        Blocking exists to cap the [genotypes, sites] f32 posterior
        temporaries at chromosome scale; below a fixed 1.5 GB budget for
        them (~16 bytes/site/genotype across the scoring chain) the scan is
        pure overhead, so it auto-disables — the result is bit-identical
        either way (site_scores_t_scan), only the peak memory and latency
        differ."""
        want = self.config.score_block
        nc = n_local // CHUNK
        if want <= 0 or n_local % CHUNK or nc <= 1:
            return 0
        if self.nb * n_local * self.model.len_g * 16 < 1.5e9:
            return 0
        bc = max(1, min(want // CHUNK, nc))
        while nc % bc:
            bc -= 1
        return bc * CHUNK if bc * CHUNK < n_local else 0

    # ------------------------------------------------------------- state ----

    def init_state(self) -> GenomeState:
        lay = self.layout
        strat0 = jnp.broadcast_to(
            self.c_strat_valid[None, :, None], (self.nb, lay.Gd_pad, 2)
        )
        return GenomeState(
            coverage=jnp.zeros((self.nb, 5, lay.G_pad), jnp.uint16),
            zeroed=jnp.zeros((self.nb, lay.G_pad), bool),
            bucket_on=jnp.zeros((self.nb, lay.NBk_pad), bool),
            read_starts=jnp.zeros((lay.Wf_pad, 2), self.dtype),
            strat=strat0,
        )

    # -------------------------------------------------------------- step ----

    def _step(self, state: GenomeState, batch: ReadBatch, params: StepParams,
              C: EngineConsts):
        cfg = self.config
        dtype = self.dtype
        nb, G = state.coverage.shape[0], state.coverage.shape[2]
        Gd = G // DS

        # -- 1. coverage increments ------------------------------------------
        # match runs: +1/-1 interval boundaries scattered into [nb*G], then a
        # cumulative sum materialises per-site match counts. Explicit
        # (mismatch/deletion) observations are a plain flat scatter. The
        # reconstruction inc = explicit + onehot(ref) * match is exact: a
        # matching base is by definition an observation of ref_base[g].
        nbG = nb * G
        mr_len = batch.mr_len.astype(jnp.int32)
        sign = (mr_len > 0).astype(jnp.int32)
        # flatten (bc, g) pairs into this engine's global int32 domain
        # (guarded by the __init__ assert; the sharded engine flattens
        # shard-locally instead). ex_flat stays UNSIGNED: an EX_PAD-padded
        # row flattens to ~2^32, out of bounds, and the scatter drops it —
        # signed it would wrap to -1, which .at[] normalises to the LAST
        # element instead of dropping.
        mr_flat = batch.mr_bc.astype(jnp.int32) * G + batch.mr_g.astype(jnp.int32)
        ex_flat = (
            batch.ex_bcsym.astype(jnp.uint32) * jnp.uint32(G) + batch.ex_g
        )
        # ONE scatter for both interval boundaries (start +1 / end -1):
        # one launch instead of two half-sized scatters
        bounds = (
            jnp.zeros(nbG + 1, jnp.int32)
            .at[jnp.concatenate([mr_flat, mr_flat + mr_len])]
            .add(jnp.concatenate([sign, -sign]), mode="drop")
        )
        match_inc = jnp.cumsum(bounds[:nbG]).reshape(nb, G)
        # single flat-index scatter over a precomputed flat index (one index
        # array instead of the multi-index-array scatter form)
        exp_inc = (
            jnp.zeros(nb * 5 * G, jnp.int32)
            .at[ex_flat]
            .add(1, mode="drop")
            .reshape(nb, 5, G)
        )
        # one-hot reference recomputed from seq (elementwise compare, fused):
        # a matching base is by definition an observation of ref_base[g]
        onehot_ref = (
            C.seq[None, :] == jnp.arange(5, dtype=C.seq.dtype)[:, None]
        ).astype(jnp.int32)
        # saturating uint16 add (see GenomeState.coverage). The summed `inc`
        # is never formed as its own array: its only consumer is this fused
        # elementwise chain (a [NB,5,G] int32 inc buffer would rival the
        # coverage array itself at chromosome scale)
        coverage = jnp.minimum(
            state.coverage.astype(jnp.int32)
            + exp_inc
            + onehot_ref[None] * match_inc[:, None, :],
            65535,
        ).astype(jnp.uint16)
        # change flag per site: any barcode/symbol touched (reference.py:142
        # flags whole rows of the change mask). All increments are >= 0, so
        # inc != 0 decomposes exactly into (explicit touched) | (match run
        # covered) — no cancellation possible
        changed_site = jnp.any(exp_inc != 0, axis=(0, 1)) | jnp.any(
            match_inc != 0, axis=0
        )  # [G]

        covsum = jnp.sum(coverage, axis=1, dtype=jnp.int32)  # [NB, G]
        covsum_f = covsum.astype(dtype)
        bdt = self.benefit_dtype

        # -- 2. scores -------------------------------------------------------
        fresh = site_scores_t_scan(
            coverage, C.seq, self.tables, self._score_block(G)
        )  # [NB, G]
        maxed = covsum >= cfg.freeze_cov
        # the score is a mutual information (>= 0); f32 cancellation can leave
        # ~1e-5 negatives at resolved sites
        fresh = jnp.maximum(fresh, 0.0)
        scores = jnp.where(C.site_valid[None, :], fresh, 0.0)
        scores = jnp.where(maxed, self.tiny, scores)

        # dropout: per-contig mean coverage over sites and barcodes; thresholds
        # expand from ds resolution (a [Gd] gather instead of a [G] one).
        # covsum_ds carries integer counts in benefit_dtype: every reduction
        # over it is then exact (and order-invariant, so sharded == single)
        covsum_ds = jnp.sum(covsum_f.reshape(nb, Gd, DS), axis=2, dtype=bdt)  # [NB, Gd]
        per_contig = jnp.zeros(self.layout.n_contigs + 1, bdt).at[C.contig_id_ds].add(
            jnp.sum(covsum_ds, axis=0)
        )
        contig_mean = (per_contig / C.contig_denom.astype(bdt)).astype(dtype)  # [C+1]
        thr_ds = jnp.floor(contig_mean / cfg.dropout_mod)[C.contig_id_ds]  # [Gd]
        active_ds = (contig_mean > cfg.dropout_min_mean)[C.contig_id_ds]   # [Gd]
        low = jnp.any(
            covsum_f.reshape(nb, Gd, DS) <= thr_ds[None, :, None], axis=0
        )  # [Gd, DS]
        drop_site = (low & active_ds[:, None]).reshape(G) & C.site_valid
        drop_now = jnp.broadcast_to(drop_site[None, :], (nb, G))

        # sticky zeroing: a previously zeroed site stays zero until it changes
        # while unfrozen (the reference only recomputes changed sites)
        recomputed = changed_site[None, :] & ~maxed
        hold_zero = state.zeroed & ~recomputed
        scores = jnp.where(hold_zero | drop_now, 0.0, scores)
        zeroed = drop_now | hold_zero

        # -- 3. bucket switches ---------------------------------------------
        # sum ds rows into their source windows (one flat scatter; exact
        # integer sums in benefit_dtype), then gather each bucket's window
        win = C.win_id_ds
        row_off = jnp.arange(nb, dtype=jnp.int32)[:, None] * self.NW_pad
        win_idx = jnp.where(
            (win >= 0)[None, :], win[None, :] + row_off, nb * self.NW_pad
        )  # [NB, Gd]; invalid rows scatter out of range (dropped)
        winsums = (
            jnp.zeros(nb * self.NW_pad, bdt)
            .at[win_idx.ravel()]
            .add(covsum_ds.ravel(), mode="drop")
            .reshape(nb, self.NW_pad)
        )
        src = C.bucket_src
        wsum = jnp.take(winsums, jnp.maximum(src, 0), axis=1)  # [NB, NBk]
        bucket_mean = jnp.where((src >= 0)[None, :], wsum / BUCKET, 0.0).astype(dtype)
        bucket_on = state.bucket_on | (
            (bucket_mean >= params.bucket_threshold) & C.bucket_valid[None, :]
        )
        any_on = jnp.any(bucket_on)

        # -- 4. fhat ---------------------------------------------------------
        # the decision path (fhat, benefit sums, threshold scan) runs in
        # benefit_dtype (f64 by default): counts are integer-exact in f32, so
        # casting up reproduces a pure-f64 pipeline bit-for-bit while per-site
        # scores stay f32 (see RunsConfig.benefit_dtype)
        read_starts = gops.scatter_add_2d(
            state.read_starts, batch.rs_row, batch.rs_strand, batch.rs_w
        )
        fhat_w = gops.fhat_pointmass(
            read_starts.astype(bdt), C.fhat_valid, self.layout.n_fhat,
            cfg.fhat_alpha, cfg.fhat_p0,
        )  # [Wf, 2]
        # normaliser in closed form over the [Wf] window axis (each window
        # expands onto c_fhat_rows ds rows): replicated-identical regardless
        # of how the genome axis is sharded
        tot = jnp.sum(fhat_w * C.fhat_rows[:, None])
        fidx = C.fhat_idx
        fhat_exp = jnp.where(
            (fidx >= 0)[:, None], jnp.take(fhat_w, jnp.maximum(fidx, 0), axis=0), 0.0
        )  # [Gd, 2]
        fhat_exp = fhat_exp * jnp.where(tot > 0, cfg.on_target / tot, 0.0)
        # reduction-order-invariance contract: round the per-row weights to
        # f32 so every downstream f64 sum over them is exact in ANY order
        # (f32 summands spend <=24 of f64's 53 mantissa bits) — the sharded
        # and single-chip engines then agree bit-for-bit
        fhat_exp = fhat_exp.astype(jnp.float32).astype(bdt)

        # -- 5. benefit ------------------------------------------------------
        scores_ds = jnp.sum(scores.reshape(nb, Gd, DS), axis=2, dtype=bdt)  # [NB, Gd]
        smu, benefit = gops.expected_benefit(
            scores_ds,
            jnp.clip(params.approx_ccl // DS, 1, cfg.ccl_clamp_ds),
            C.seg_start,
            C.seg_end,
            mu_ds=cfg.mu // DS,
        )  # [NB, Gd, 2] each

        # -- 6. threshold + gated strategy ------------------------------------
        fhat_b = jnp.broadcast_to(fhat_exp[None], benefit.shape)
        res = gops.find_strategy(
            benefit,
            benefit if cfg.reference_quirks else smu,  # Q1 ubar0 swap
            fhat_b,
            params.time_cost.astype(bdt),
        )
        bidx = C.bucket_idx
        gate = jnp.take(bucket_on, jnp.maximum(bidx, 0), axis=1) & (bidx >= 0)[None, :]  # [NB, Gd]
        do_update = any_on & res.any_nonzero
        write = do_update & gate & C.strat_valid[None, :]
        strat = jnp.where(write[:, :, None], res.strat, state.strat)

        new_state = GenomeState(
            coverage=coverage,
            zeroed=zeroed,
            bucket_on=bucket_on,
            read_starts=read_starts,
            strat=strat,
        )
        mean_cov = (jnp.sum(covsum_ds) / self.n_real_sites).astype(dtype)
        aux = StepAux(
            any_on=any_on,
            updated=do_update,
            threshold=res.threshold,
            mean_coverage=mean_cov,
            vec=jnp.stack([
                any_on.astype(dtype), do_update.astype(dtype),
                res.threshold.astype(dtype), mean_cov.astype(dtype),
            ]),
            scores=scores if cfg.debug_aux else None,
        )
        return new_state, aux

    # ----------------------------------------------------------- host side --

    @staticmethod
    def pull_aux(aux: StepAux) -> AuxHost:
        """Fetch all step scalars in ONE device->host transfer (see AuxHost)."""
        v = np.asarray(aux.vec)
        return AuxHost(bool(v[0]), bool(v[1]), float(v[2]), float(v[3]))

    def strat_dict(self, state: GenomeState) -> dict[str, np.ndarray]:
        """Per-contig strategy arrays in the reference npz convention:
        shape (length//100, 2, n_barcodes) bool; rejected contigs get a
        single-False array (reference.py:109-118)."""
        strat = np.asarray(state.strat)  # [NB, Gd, 2]
        out = {}
        for c, name in enumerate(self.layout.names):
            r0, n = self.layout.strat_rows(c)
            out[name] = np.ascontiguousarray(strat[:, r0 : r0 + n, :].transpose(1, 2, 0))
        for name in self.layout.rejected_names:
            out[name] = np.zeros(1, dtype=bool)
        return out

    def make_params(self, approx_ccl: np.ndarray, time_cost: float) -> StepParams:
        return StepParams(
            approx_ccl=jnp.asarray(approx_ccl, jnp.int32),
            time_cost=jnp.asarray(time_cost, jnp.float32),
            bucket_threshold=jnp.asarray(self.config.bucket_threshold, jnp.float32),
        )
