"""Static genome layout: contigs -> one padded, shardable device axis.

The reference keeps one Python ``Contig`` object per reference sequence with
ragged per-contig numpy arrays (the reference's boss/runs/reference.py:18-118)
and loops over them on every update. A device-resident design wants *one* dense,
statically-shaped axis: all accepted contigs are concatenated onto a single
"site" axis, each padded to a multiple of CHUNK sites so that

  * the downsampled (100-site) strategy grid is an exact reshape,
  * contiguous chunks can be sharded across devices without ragged edges,
  * per-contig reductions become segment-sums over a contig-id table.

All tables here are host-side numpy, built once at init; the device carries
them as constants inside the jitted update step.

Grid hierarchy (sizes in full-resolution sites):
  1        coverage / scores            (site axis, G_pad)
  100      strategy & benefit rows      (ds axis, Gd_pad = G_pad // 100)
  2000     read-start (fhat) windows    (per contig: length // 2000 rows)
  20000    strategy activation buckets  (per contig: length // 20000 + 1 rows)

Row-validity / segment semantics mirror the reference:
  * strategy rows per contig: length // 100   (reference.py:109-118)
  * ds score rows meaningful: ceil(length/100); reference allocates
    length//100 + 1 (reference.py:225-231) — the possible extra row is zero
    and participates in nothing.
  * fhat windows: length // 2000 (readstartdist.py:26)
  * buckets: length // 20000 + 1, the tail bucket replicating the mean of the
    last full window (reference.py:183-211 + utils.py:206-226)
"""
from __future__ import annotations

import dataclasses

import numpy as np

CHUNK = 102_400          # full-res sites per alignment chunk (1024 ds rows)
DS = 100                 # strategy downsampling window
FHAT_WINDOW = 2000       # read-start counting window
BUCKET = 20_000          # strategy activation bucket
MIN_CONTIG_LEN = 100_000  # contigs shorter than this are skipped (reference.py:319-331)


@dataclasses.dataclass
class GenomeLayout:
    """Host-side static description of the concatenated genome axis."""

    names: list[str]                 # accepted contigs, in order
    lengths: np.ndarray              # [C] int64
    rejected_names: list[str]        # contigs present but always-reject
    n_barcodes: int

    # full-resolution axis
    offsets: np.ndarray              # [C] start site of each contig block
    block_sites: np.ndarray          # [C] padded block length (multiple of CHUNK)
    G_pad: int

    # downsampled axis tables, all [Gd_pad]
    Gd_pad: int
    contig_id_ds: np.ndarray         # int32, -1 on padding chunks
    ds_seg_start: np.ndarray         # int32 block start row (for window clamping)
    ds_seg_end: np.ndarray           # int32 block end row (exclusive)
    strat_row_valid: np.ndarray      # bool, True for the first length//100 rows
    fhat_idx: np.ndarray             # int32 global fhat window row, -1 = none
    bucket_idx: np.ndarray           # int32 global bucket row, -1 = none

    # fhat windows
    fhat_offsets: np.ndarray         # [C] start row per contig
    n_fhat: int                      # total valid fhat windows
    Wf_pad: int

    # buckets
    bucket_offsets: np.ndarray       # [C]
    n_buckets: int
    NBk_pad: int
    bucket_lo_ds: np.ndarray         # [NBk_pad] global ds row of source window start, -1 = empty
    seq_int: np.ndarray              # [G_pad] uint8, 0..3 (padding 0)

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    @property
    def n_sites(self) -> int:
        return int(self.lengths.sum())

    def site_valid(self) -> np.ndarray:
        """[G_pad] bool — True on real contig sites, False on padding."""
        v = np.zeros(self.G_pad, dtype=bool)
        for c in range(self.n_contigs):
            v[self.offsets[c] : self.offsets[c] + self.lengths[c]] = True
        return v

    def strat_rows(self, c: int) -> tuple[int, int]:
        """(start, n) rows of contig c's strategy block on the ds axis."""
        return int(self.offsets[c]) // DS, int(self.lengths[c]) // DS

    def global_pos(self, contig_index: int, pos) -> np.ndarray:
        """Translate contig-local site coordinates to the padded global axis."""
        return np.asarray(pos) + int(self.offsets[contig_index])


_BASE_LUT = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_LUT[_b] = _i
    _BASE_LUT[_b + 32] = _i  # lowercase


def seq_to_int(seq: bytes | str) -> np.ndarray:
    """ACGT -> 0..3; every other character -> 0 (reference.py:46-68)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def build_layout(
    contigs: dict[str, str | bytes | np.ndarray],
    n_barcodes: int = 1,
    reject_refs: set[str] | None = None,
    min_len: int = MIN_CONTIG_LEN,
    align_chunks: int = 1,
) -> GenomeLayout:
    """Build the static layout from a {name: sequence} mapping.

    ``align_chunks``: pad the total chunk count to a multiple of this (set to
    the device-mesh size so every shard gets whole chunks).
    """
    reject_refs = reject_refs or set()
    names, seqs, rejected = [], [], []
    for name, seq in contigs.items():
        name = name.strip().split(" ")[0]
        if len(seq) < min_len and name not in reject_refs:
            continue
        if name in reject_refs:
            rejected.append(name)
            continue
        names.append(name)
        if isinstance(seq, np.ndarray):
            seqs.append(seq.astype(np.uint8))
        else:
            seqs.append(seq_to_int(seq))
    if not names:
        raise ValueError("no usable contigs (all shorter than min_len or rejected)")

    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    block_sites = ((lengths + CHUNK - 1) // CHUNK) * CHUNK
    offsets = np.concatenate([[0], np.cumsum(block_sites)[:-1]])
    total = int(block_sites.sum())
    n_chunks = total // CHUNK
    if n_chunks % align_chunks:
        n_chunks += align_chunks - n_chunks % align_chunks
    G_pad = n_chunks * CHUNK
    Gd_pad = G_pad // DS

    seq_int = np.zeros(G_pad, dtype=np.uint8)
    contig_id_ds = np.full(Gd_pad, -1, dtype=np.int32)
    ds_seg_start = np.zeros(Gd_pad, dtype=np.int32)
    ds_seg_end = np.zeros(Gd_pad, dtype=np.int32)
    strat_row_valid = np.zeros(Gd_pad, dtype=bool)
    fhat_idx = np.full(Gd_pad, -1, dtype=np.int32)
    bucket_idx = np.full(Gd_pad, -1, dtype=np.int32)

    # padding chunks: each is its own zero segment so window sums stay local
    pad_rows = np.arange(int(block_sites.sum()) // DS, Gd_pad, dtype=np.int32)
    ds_seg_start[pad_rows] = pad_rows
    ds_seg_end[pad_rows] = pad_rows + 1

    fhat_counts = lengths // FHAT_WINDOW
    fhat_offsets = np.concatenate([[0], np.cumsum(fhat_counts)[:-1]]).astype(np.int64)
    n_fhat = int(fhat_counts.sum())
    Wf_pad = max(8, int(np.ceil(n_fhat / 8)) * 8)

    bucket_counts = lengths // BUCKET + 1
    bucket_offsets = np.concatenate([[0], np.cumsum(bucket_counts)[:-1]]).astype(np.int64)
    n_buckets = int(bucket_counts.sum())
    NBk_pad = max(8, int(np.ceil(n_buckets / 8)) * 8)
    bucket_lo_ds = np.full(NBk_pad, -1, dtype=np.int64)

    for c, (L, off, blk) in enumerate(zip(lengths, offsets, block_sites)):
        L, off, blk = int(L), int(off), int(blk)
        seq_int[off : off + L] = seqs[c]
        r0, r1 = off // DS, (off + blk) // DS
        rows = np.arange(r0, r1, dtype=np.int64)
        local = rows - r0
        contig_id_ds[r0:r1] = c
        ds_seg_start[r0:r1] = r0
        ds_seg_end[r0:r1] = r1
        strat_row_valid[r0:r1] = local < L // DS
        # fhat expansion: rows covering real sites map to window local//20,
        # clamped to the last window (tail replication like readstartdist.py:121-152)
        md = -(-L // DS)  # ceil: rows covering >= 1 real site
        wf = int(fhat_counts[c])
        if wf > 0:
            widx = np.minimum(local // (FHAT_WINDOW // DS), wf - 1)
            sel = local < md
            fhat_idx[r0:r1][sel] = (fhat_offsets[c] + widx[sel]).astype(np.int32)
        # bucket gating: strat row local -> bucket local//200, clamped
        nb = int(bucket_counts[c])
        bidx = np.minimum(local // (BUCKET // DS), nb - 1)
        sel = local < L // DS
        bucket_idx[r0:r1][sel] = (bucket_offsets[c] + bidx[sel]).astype(np.int32)
        # bucket source windows: bucket j takes the mean of full window
        # min(j, nfull-1); contigs without a full bucket keep -1 (mean 0)
        nfull = L // BUCKET
        if nfull > 0:
            src = np.minimum(np.arange(nb), nfull - 1)
            bucket_lo_ds[bucket_offsets[c] : bucket_offsets[c] + nb] = r0 + src * (BUCKET // DS)

    return GenomeLayout(
        names=names,
        lengths=lengths,
        rejected_names=rejected,
        n_barcodes=n_barcodes,
        offsets=offsets,
        block_sites=block_sites,
        G_pad=G_pad,
        Gd_pad=Gd_pad,
        contig_id_ds=contig_id_ds,
        ds_seg_start=ds_seg_start,
        ds_seg_end=ds_seg_end,
        strat_row_valid=strat_row_valid,
        fhat_idx=fhat_idx,
        bucket_idx=bucket_idx,
        fhat_offsets=fhat_offsets,
        n_fhat=n_fhat,
        Wf_pad=Wf_pad,
        bucket_offsets=bucket_offsets,
        n_buckets=n_buckets,
        NBk_pad=NBk_pad,
        bucket_lo_ds=bucket_lo_ds,
        seq_int=seq_int,
    )
