"""Repeat filter: drop reads whose ends look like repeats (AEONS, optional).

Capability parity with /root/reference/boss/aeons/repeats.py: from an initial
read pool a repeat library is built; each batch then drops reads whose ends
carry repeat sequence (they would mislead the overlap graph).

Detection here is minimizer-occurrence based instead of the reference's
chop-and-map coverage counting (repeats.py:55-122): a minimizer index over
the pool with the occurrence cap lifted directly exposes repeat content —
positions whose k-mers occur far more often than the expected read coverage.
Runs of high-occurrence positions >= 100 bp (the reference's block floor)
become the library; batches are seeded against the library index and reads
with hits inside a 500 bp end window are dropped (repeats.py:160-202).
"""
from __future__ import annotations

import logging

import numpy as np

from .ava import PoolIndex, find_overlaps

logger = logging.getLogger("bossruns")

BLOCK_MIN = 100
END_WINDOW = 500


def _find_blocks_ge(arr: np.ndarray, x: float, min_len: int) -> list[tuple[int, int]]:
    """Runs of arr >= x longer than min_len (utils.py:162-188)."""
    pos = np.flatnonzero(arr >= x)
    if pos.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(pos) > 1)
    starts = np.concatenate([[pos[0]], pos[breaks + 1]])
    ends = np.concatenate([pos[breaks] + 1, [pos[-1] + 1]])
    return [(int(s), int(e)) for s, e in zip(starts, ends) if e - s > min_len]


class RepeatFilter:
    def __init__(self, seqs: dict[str, str], min_votes: int = 3):
        self.min_votes = min_votes
        # occurrence-uncapped index: repeats are exactly the high-occ keys
        pidx = PoolIndex(seqs, max_occ=1_000_000)
        idx = pidx.host  # occurrence stats come from the host CSR index
        counts_per_key = np.diff(np.asarray(idx.offsets, np.int64))
        n_real = int(idx.offsets[-1])
        positions = np.asarray(idx.positions, np.int64)[:n_real]
        # per minimizer occurrence: how often its key occurs in the pool
        occ = np.repeat(counts_per_key, counts_per_key)[:n_real]
        # threshold: 3x the typical multi-occurrence key count (~ read depth
        # after k-mer error attrition), floor 3 — the reference uses the
        # 99.9th coverage percentile with the same floor (repeats.py:98-122);
        # a depth-relative threshold is robust to repeat-dense pools
        multi = counts_per_key[counts_per_key >= 2]
        depth = float(np.median(multi)) if multi.size else 1.0
        self.lim = max(4.0 * depth, 3.0)
        hot = positions[occ >= self.lim]
        self.repeats: dict[str, str] = {}
        if hot.size:
            # map hot concat-positions back to (read, local); chain hot
            # minimizers with gap tolerance (sequencing errors knock out
            # ~2/3 of exact k-mers, fragmenting contiguous runs)
            hot.sort()
            rid_idx = np.searchsorted(pidx.starts, hot, side="right") - 1
            gap = 8 * idx.w + idx.k
            for r in np.unique(rid_idx):
                name = pidx.names[r]
                local = np.sort(hot[rid_idx == r] - pidx.starts[r])
                breaks = np.flatnonzero(np.diff(local) > gap)
                starts = np.concatenate([[0], breaks + 1])
                ends = np.concatenate([breaks, [local.shape[0] - 1]])
                for si, ei in zip(starts, ends):
                    s, e = int(local[si]), int(local[ei]) + idx.k
                    # require both span and hot-minimizer density
                    if e - s > BLOCK_MIN and (ei - si + 1) >= 5:
                        self.repeats[f"{name}-rep-{s}"] = seqs[name][s:e]
        logger.info(
            f"repeat filter: {len(self.repeats)} repeat blocks, limit {self.lim}"
        )
        self._lib_index = PoolIndex(self.repeats) if self.repeats else None

    @classmethod
    def from_library(cls, repeats: dict[str, str], lim: float, min_votes: int = 3):
        """Rebuild a filter from a persisted repeat library (checkpoint resume);
        the library is the only state `filter_batch` depends on."""
        self = cls.__new__(cls)
        self.min_votes = min_votes
        self.lim = lim
        self.repeats = dict(repeats)
        self._lib_index = PoolIndex(self.repeats) if self.repeats else None
        return self

    def filter_batch(self, seq_dict: dict[str, str]) -> dict[str, str]:
        """Drop reads with repeat hits near either end (repeats.py:160-202)."""
        if self._lib_index is None or not seq_dict:
            return seq_dict
        rows = find_overlaps(
            seq_dict, self._lib_index, min_votes=self.min_votes, exclude_self=False
        )
        danger = set()
        for i in range(len(rows["qname"])):
            q = rows["qname"][i]
            ql = rows["qlen"][i]
            if rows["qstart"][i] < END_WINDOW or rows["qend"][i] > ql - END_WINDOW:
                danger.add(q)
        logger.info(f"repeat filter: dropping {len(danger)} reads")
        return {h: s for h, s in seq_dict.items() if h not in danger}
