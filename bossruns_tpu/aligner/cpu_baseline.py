"""CPU baseline aligner: host seed+extend with a 4-worker thread pool.

The honest stand-in for the reference's mapper — mappy (minimap2's C
library) batch-mapped over a ThreadPoolExecutor of 4 workers
(/root/reference/boss/mapper.py:69-108). mappy is not installable in this
environment, so the baseline walks the SAME minimizer index on the host
(aligner/host_seed.py, vectorised NumPy + the native C k-mer scan) and
extends with the SAME native banded-DP (native/banded_align.cpp), pinned to
4 threads end-to-end like the reference's pool. Seeding is bit-identical to
the device kernels (tests/test_host_seed.py), so host and device paths differ
ONLY in where the seeding compute runs — exactly the comparison the BENCH
aligner lines normalise against (``vs_baseline`` = cpu_reads_per_s /
device_reads_per_s denominator).

Drop-in for TpuAligner: same constructor shape, same map_sequences contract.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..models.layout import GenomeLayout
from . import LENGTH_BUCKETS, TpuAligner, encode
from .host_seed import host_seed_topn
from .index import K, MinimizerIndex, W, build_index_layout, load_or_build_index
from .seed import NCAND

logger = logging.getLogger("bossruns")


class CpuAligner(TpuAligner):
    """TpuAligner with the device seeding stage replaced by the host mirror.

    Reuses map_sequences' bucket dispatch pipeline and _extend_bucket's
    candidate planning + native DP verbatim; only _seed_bucket_dispatch /
    _pull_seeds change (a thread-pool future instead of an async device
    dispatch — the same overlap structure: bucket i extends on the main
    thread while bucket i+1 seeds on the pool).
    """

    def __init__(
        self,
        layout: GenomeLayout,
        k: int = K,
        w: int = W,
        max_occ: int = 64,
        min_votes: int = 4,
        max_divergence: float = 0.35,
        mu: int = 400,
        threads: int = 4,
        source: str | None = None,
    ):
        # mirror TpuAligner.__init__ minus the DeviceIndex (no device state)
        self.layout = layout
        self.mu = mu
        self.min_votes = min_votes
        self.max_divergence = max_divergence
        self.threads = threads
        self.target = np.where(layout.site_valid(), layout.seq_int, 4).astype(np.int8)
        self.index: MinimizerIndex = (
            build_index_layout(layout, k=k, w=w, max_occ=max_occ)
            if source is None
            else load_or_build_index(
                layout.seq_int, layout.site_valid(), source, k=k, w=w, max_occ=max_occ
            )
        )
        logger.info(f"cpu baseline index: {self.index.n_minimizers} minimizers")
        self._block_starts = layout.offsets.astype(np.int64)
        self._block_ends = (layout.offsets + layout.lengths).astype(np.int64)
        self._pool = ThreadPoolExecutor(max_workers=threads)

    def _seed_bucket_dispatch(self, enc_reads: list[np.ndarray]):
        """Split the bucket over the worker pool (the reference splits its
        read batch over 4 mappy workers the same way, mapper.py:83-108)."""
        lens = [e.shape[0] for e in enc_reads]
        L = next((b for b in LENGTH_BUCKETS if max(lens, default=0) <= b),
                 LENGTH_BUCKETS[-1])
        reads = [e[:L] for e in enc_reads]
        nchunk = min(self.threads, max(len(reads), 1))
        bounds = np.linspace(0, len(reads), nchunk + 1).astype(int)
        return [
            self._pool.submit(host_seed_topn, reads[a:b], self.index, L, NCAND)
            for a, b in zip(bounds[:-1], bounds[1:])
            if b > a
        ]

    @staticmethod
    def _pull_seeds(out_dev, n: int):
        parts = [f.result() for f in out_dev]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
