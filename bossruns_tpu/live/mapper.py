"""TpuAligner as the live readfish mapper plugin — the decision plane's
aligner, replacing readfish's mappy/mappy-rs Aligner plugin (the external C
component the reference depends on at its hottest edge,
/root/reference/boss/readfish_boss.py:506 `mapper.map_reads(calls)`).

Implements the protocol Analysis consumes (live/readfish_boss.py:219-225):
``map_reads(calls) -> iterable of Result-likes``, ``initialised``,
``load_index(fasta)`` (AEONS contig hot-swap), ``describe(regions,
barcodes)``. Each basecalled result gets ``alignment_data`` attached: a list
of alignment objects with mappy-compatible fields (.ctg, .r_st, .r_en,
.strand with readfish's 1/-1 convention, .q_st, .q_en, .mapq), so
``make_decision`` aggregates them into single_on/.../multi_off exactly like
the reference's mappy path (boss/dynamic_readfish.py:213-257). Secondary
alignments are kept (``all_records=True``) — mappy reports them too, and
they are what makes multi_* decisions reachable on repeat reads.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

logger = logging.getLogger("bossruns")

#: live chunks are ~400 bases; accept any alignment spanning at least this
#: much target (mappy reports short hits too — the decision plane should
#: see them, unlike the update plane's mu/2 floor)
LIVE_MIN_LEN = 50


@dataclass
class Alignment:
    """mappy.Alignment-compatible view of one record."""

    ctg: str
    r_st: int
    r_en: int
    strand: int  # readfish/mappy convention: 1 fwd, -1 rev
    q_st: int
    q_en: int
    mapq: int
    is_primary: bool


class AlignmentData:
    """Container with an .alignments attribute (readfish Result shape)."""

    def __init__(self, alignments: list[Alignment]):
        self.alignments = alignments

    def __iter__(self):
        return iter(self.alignments)

    def __len__(self):
        return len(self.alignments)

    def __bool__(self):
        return bool(self.alignments)


class TpuMapperPlugin:
    """readfish Aligner plugin backed by the in-repo aligner."""

    def __init__(self, fasta: str | Path | None = None, aligner=None,
                 min_len: int = LIVE_MIN_LEN, min_contig_len: int = 500):
        self.min_len = min_len
        self.min_contig_len = min_contig_len
        self.aligner = aligner
        self._fasta = str(fasta) if fasta else None
        if self.aligner is None and self._fasta:
            self.load_index(self._fasta)

    @property
    def initialised(self) -> bool:
        return self.aligner is not None

    def load_index(self, fasta: str) -> None:
        """(Re)build the index from a fasta — first call initialises, later
        calls are the AEONS contig hot-swap (dynamic_readfish.py:113-139).
        The dummy init index (BossBits.gen_dummy_idx, one 25-base contig)
        yields an aligner with an empty minimizer index: every read maps to
        nothing -> no_map -> proceed, matching readfish's warm-up phase."""
        from ..aligner import make_aligner
        from ..models.layout import build_layout
        from ..models.runs_sim import load_reference_contigs

        contigs = load_reference_contigs(fasta)
        min_len = self.min_contig_len
        if not any(len(s) >= min_len for s in contigs.values()):
            min_len = 1  # dummy/bootstrap index: keep the tiny contig
        layout = build_layout(contigs, min_len=min_len)
        if self.aligner is None:
            self.aligner = make_aligner(layout, source=fasta)
        else:
            self.aligner.load_index(fasta)
        self._fasta = fasta

    def describe(self, regions=None, barcodes=None) -> str:
        """Startup description logged by the hot loop (reference
        readfish_boss.py:460 mapper.describe)."""
        if not self.initialised:
            return "TpuMapperPlugin: index not initialised"
        lay = self.aligner.layout
        n_regions = len(regions) if regions is not None else 0
        return (
            f"TpuMapperPlugin: {len(lay.names)} contigs, "
            f"{int(lay.lengths.sum())} bases indexed "
            f"(k={self.aligner.index.k}, w={self.aligner.index.w}); "
            f"serving {n_regions} regions"
        )

    def disconnect(self) -> None:
        return None

    def map_reads(self, calls):
        """Batch-align one basecalled chunk batch and attach alignments.

        calls: iterable of result-likes with .read_id and .seq (plus
        whatever else the loop reads: .channel, .read_number, .barcode).
        Yields the same objects with .alignment_data set. The whole batch
        aligns in ONE device dispatch — per-read mappy calls under a thread
        pool (reference boss/mapper.py:69-108) become a single padded
        seeding kernel + native DP sweep.
        """
        batch = list(calls)
        seqs = {}
        for i, res in enumerate(batch):
            # key by slot: live read_ids could collide across re-basecalls
            if getattr(res, "seq", ""):
                seqs[str(i)] = res.seq
        recs = (
            self.aligner.map_sequences(seqs, min_len=self.min_len,
                                       all_records=True)
            if seqs else None
        )
        by_slot: dict[int, list[Alignment]] = {}
        if recs is not None:
            for r in range(len(recs)):
                slot = int(recs.qname[r])
                by_slot.setdefault(slot, []).append(Alignment(
                    ctg=str(recs.tname[r]),
                    r_st=int(recs.tstart[r]),
                    r_en=int(recs.tend[r]),
                    strand=-1 if recs.rev[r] else 1,
                    q_st=int(recs.qstart[r]),
                    q_en=int(recs.qend[r]),
                    mapq=int(recs.mapq[r]),
                    is_primary=bool(recs.primary[r]),
                ))
        for i, res in enumerate(batch):
            res.alignment_data = AlignmentData(by_slot.get(i, []))
            yield res
