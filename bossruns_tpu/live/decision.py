"""Per-read decision bits for the readfish side: mask lookup + hot reload.

Port of /root/reference/boss/dynamic_readfish.py semantics: the readfish
process polls the strategy npz (and, for AEONS, the contig fasta) written by
the BOSS process, mtime-gated, and resolves each basecalled chunk's first
mapping to an accept/reject/none decision:

  * mask lookup arr[start // 100, rev] (or [..., barcode]), where start is
    r_st on fwd and r_en on rev strand — :169-210, :229-236
  * a shape-(1,) array means "always reject this contig" — :196-200
  * any error in the lookup fails OPEN (accept) — :187-189, 209-210
  * readfish strand convention 1/-1 maps to boss 0/1 — :40-45

Decisions over a read's alignments aggregate to single_on/single_off/
multi_on/multi_off/no_map/no_seq exactly like make_decision_boss (:213-257).
"""
from __future__ import annotations

import logging
import time
from enum import Enum
from pathlib import Path

import numpy as np

logger = logging.getLogger("bossruns")

STRAND_CONVERTER = {1: 0, -1: 1}  # readfish strand -> boss strand index


class Decision(str, Enum):
    single_on = "single_on"
    single_off = "single_off"
    multi_on = "multi_on"
    multi_off = "multi_off"
    no_map = "no_map"
    no_seq = "no_seq"
    # override outcomes recorded by the hot loop (readfish_boss.py:296-445)
    above_max_chunks = "above_max_chunks"
    below_min_chunks = "below_min_chunks"
    first_read_override = "first_read_override"
    duplex_override = "duplex_override"


class StrategyStore:
    """mtime-gated view of the masks/boss.npz strategy file."""

    def __init__(self, mask_path: str | Path, barcode_index: dict | None = None):
        self.mask_path = Path(mask_path)
        self.barcode_index = barcode_index
        self.masks: dict[str, np.ndarray] = {}
        self.last_mtime = 0.0
        self.reload()

    def reload(self) -> bool:
        """Reload masks if the file changed; returns True if reloaded."""
        try:
            mtime = self.mask_path.stat().st_mtime
        except OSError:
            return False
        if mtime <= self.last_mtime:
            return False
        # the writer renames atomically, so a load after stat is consistent
        try:
            with np.load(self.mask_path) as z:
                self.masks = {k: z[k] for k in z}
            self.last_mtime = mtime
            logger.info(f"Reloaded strategies for {len(self.masks)} sequences")
            return True
        except Exception as e:  # noqa: BLE001 - fail open, keep old masks
            logger.info(f"strategy reload failed: {e}")
            return False

    def check_coord(self, contig: str, start_pos: int, reverse: bool | int,
                    barcode: str | int | None = None) -> bool:
        """Mask lookup; fails open (accept) on any error."""
        try:
            arr = self.masks[contig]
            if arr.shape[0] == 1:
                return False  # always-reject contig
            b = 0
            if self.barcode_index is not None and barcode is not None:
                b = self.barcode_index.get(barcode, 0)
            if arr.ndim == 3:
                return bool(arr[start_pos // 100, int(bool(reverse)), b])
            return bool(arr[start_pos // 100, int(bool(reverse))])
        except (KeyError, IndexError) as e:
            logger.info(f"error in mask lookup ({contig}:{start_pos}): {e}")
            return True  # fail open


def make_decision(store: StrategyStore, alignments, seq_len: int,
                  barcode=None) -> Decision:
    """Aggregate per-alignment mask lookups into a readfish decision.

    alignments: iterable of objects with .ctg, .r_st, .r_en, .strand
    (mappy/readfish Result alignment records). Mirrors
    dynamic_readfish.py:213-257.
    """
    alignments = list(alignments)
    hits = set()
    for al in alignments:
        reverse = STRAND_CONVERTER.get(al.strand, al.strand)
        # reference-exact coordinate: r_st on fwd, r_en on rev
        # (dynamic_readfish.py:233 `coord = al.r_st if al.strand == 1 else
        # al.r_en` — the exclusive end, not r_en - 1)
        start = al.r_en if reverse else al.r_st
        hits.add(store.check_coord(al.ctg, start, reverse, barcode))
    # alignment presence is checked BEFORE sequence length, like the
    # reference (dynamic_readfish.py:248-252)
    if not alignments:
        return Decision.no_map if seq_len > 0 else Decision.no_seq
    if len(alignments) == 1:
        return Decision.single_on if True in hits else Decision.single_off
    return Decision.multi_on if True in hits else Decision.multi_off


class ContigWatcher:
    """mtime-gated reload of AEONS contigs for re-indexing the mapper.

    The AEONS mode rewrites contigs/aeons.fa; the readfish side then rebuilds
    its aligner index (dynamic_readfish.py:113-139). The index build is
    supplied by the caller (mappy or the in-repo aligner).
    """

    def __init__(self, fasta_path: str | Path, rebuild_fn):
        self.fasta_path = Path(fasta_path)
        self.rebuild_fn = rebuild_fn
        self.last_mtime = 0.0

    def maybe_rebuild(self) -> bool:
        try:
            mtime = self.fasta_path.stat().st_mtime
        except OSError:
            return False
        if mtime <= self.last_mtime:
            return False
        t0 = time.time()
        self.rebuild_fn(str(self.fasta_path))
        self.last_mtime = mtime
        logger.info(f"rebuilt contig index in {time.time()-t0:.2f}s")
        return True
