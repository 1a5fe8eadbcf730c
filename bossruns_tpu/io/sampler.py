"""Simulation sampler: random no-replacement read batches from big files.

Mirrors the reference's mmap streaming design (/root/reference/boss/sampler.py):
byte offsets of every fastq record are scanned once and cached next to the
file (.offsets.npy), reshaped into (maxbatch, batchsize) rows, optionally
shuffled with a seed; each batch mmap-reads its records with MADV_WILLNEED
prefetch. PAF mappings of the sampled reads are retrieved through per-read
byte-offset indexes cached as .offsets.npz (the reference pickles a
defaultdict, sampler.py:400-404; we store parallel arrays instead).
"""
from __future__ import annotations

import logging
import mmap
from pathlib import Path

import numpy as np

from .fastq import parse_barcode

logger = logging.getLogger("bossruns")


def _cache_fresh(path: Path, cache: Path) -> bool:
    """A cached offset index is valid only for the exact file it was built
    from: invalidate when the data file is newer or its size changed (the
    stored size rides in a sidecar so the npy/npz format stays plain)."""
    side = Path(f"{cache}.size")
    try:
        if path.stat().st_mtime > cache.stat().st_mtime:
            return False
        return side.exists() and int(side.read_text()) == path.stat().st_size
    except OSError:
        return False


def _stamp_cache(path: Path, cache: Path) -> None:
    Path(f"{cache}.size").write_text(str(Path(path).stat().st_size))


def _atomic_np_write(cache: Path, saver) -> None:
    """Write an offset cache via a per-process tmp + rename: multi-host runs
    have every process scanning the same shared-filesystem inputs
    concurrently, and a reader must never see a half-written index."""
    import os

    tmp = cache.with_name(f"{cache.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as fh:  # file object: np.save/savez won't append a suffix
        saver(fh)
    tmp.rename(cache)


def materialize_gz(path: str | Path) -> str:
    """Return a plain-file path for a possibly-gzipped source.

    The reference streams gz sources through GzipFile-over-mmap with
    decompressed-stream offsets (/root/reference/boss/sampler.py:75-116),
    paying a full re-decompress per seek. Here a `.gz` source is inflated
    ONCE to a cached sidecar (`<src>.decompressed.fq`, atomic rename,
    size-stamped against the gz file) and the sampler mmaps the plain file —
    same sampling semantics, O(1) seeks, madvise prefetch kept.
    """
    p = Path(path)
    if p.suffix != ".gz":
        return str(p)
    side = Path(f"{p}.decompressed.fq")
    if _cache_fresh(p, side):
        return str(side)
    import gzip
    import os
    import shutil

    tmp = side.with_name(f"{side.name}.tmp{os.getpid()}")
    with gzip.open(p, "rb") as src, open(tmp, "wb") as dst:
        shutil.copyfileobj(src, dst, length=1 << 22)
    tmp.rename(side)
    _stamp_cache(p, side)
    logger.info(f"decompressed gz source {p} -> {side}")
    return str(side)


def scan_fastq_offsets(path: str | Path) -> np.ndarray:
    """Byte offset of every 4-line fastq record (cached as .offsets.npy)."""
    cache = Path(f"{path}.offsets.npy")
    if _cache_fresh(Path(path), cache):
        return np.load(cache)
    offsets = [0]
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        k = 0
        for _ in iter(mm.readline, b""):
            k += 1
            if k % 4 == 0:
                offsets.append(mm.tell())
        mm.close()
    arr = np.asarray(offsets[:-1] if k % 4 == 0 else offsets, dtype=np.uint64)
    _atomic_np_write(cache, lambda fh: np.save(fh, arr))
    _stamp_cache(Path(path), cache)
    logger.info(f"scanned {arr.shape[0]} fastq record offsets for {path}")
    return arr


class FastqStream:
    """Batch sampler over a fastq file; no read is sampled twice."""

    def __init__(
        self,
        source: str,
        batchsize: int = 1,
        maxbatch: int = 1,
        seed: int = 1,
        shuffle: bool = False,
    ):
        self.source = materialize_gz(source)
        offsets = scan_fastq_offsets(self.source)
        if seed == 0:
            seed = np.random.randint(1_000_000)
        if shuffle:
            rng = np.random.default_rng(seed)
            offsets = offsets.copy()
            rng.shuffle(offsets)
        n_needed = batchsize * (maxbatch + 1)
        if n_needed > offsets.shape[0]:
            raise ValueError(
                f"requested {n_needed} reads but {source} has {offsets.shape[0]}"
            )
        self.offsets = offsets[:n_needed].reshape(maxbatch + 1, batchsize)
        self.batch = 0
        # per-batch outputs
        self.read_sequences: dict[str, str] = {}
        self.read_qualities: dict[str, str] = {}
        self.read_barcodes: dict[str, int] = {}
        self.read_lengths: dict[str, int] = {}
        self.read_ids: set = set()
        self.total_bases = 0

    def read_batch(self) -> None:
        if self.offsets.shape[0] == 0:
            raise ValueError("No more reads left to sample")
        batch_offsets = np.sort(self.offsets[0])
        self.offsets = self.offsets[1:]
        seqs, quals, bcs = {}, {}, {}
        with open(self.source, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            pagesize = 4096
            for off in batch_offsets:
                try:
                    mm.madvise(mmap.MADV_RANDOM)
                    mm.madvise(mmap.MADV_WILLNEED, int(off) - int(off) % pagesize, 20)
                except (AttributeError, OSError):
                    pass
            for off in batch_offsets:
                mm.seek(int(off))
                header = mm.readline().decode()
                seq = mm.readline().decode().rstrip("\n")
                mm.readline()
                qual = mm.readline().decode().rstrip("\n")
                name = header[1:].split(" ", 1)[0].strip()
                seqs[name] = seq
                quals[name] = qual
                bcs[name] = parse_barcode(header)
            mm.close()
        self.read_sequences = seqs
        self.read_qualities = quals
        self.read_barcodes = bcs
        self.read_lengths = {r: len(s) for r, s in seqs.items()}
        self.read_ids = set(seqs)
        self.total_bases = int(sum(self.read_lengths.values()))
        self.batch += 1
        logger.info(f"sampled batch of {len(seqs)} reads")


def scan_paf_offsets(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-line (qname, offset, length) index of a PAF file, cached as npz."""
    cache = Path(f"{path}.offsets.npz")
    if _cache_fresh(Path(path), cache):
        with np.load(cache, allow_pickle=True) as z:
            return z["names"], z["offsets"], z["lengths"]
    names, offs, lens = [], [], []
    pos = 0
    with open(path, "rb") as f:
        for line in f:
            names.append(line.split(b"\t", 1)[0].decode())
            offs.append(pos)
            lens.append(len(line))
            pos += len(line)
    names = np.asarray(names, dtype=object)
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    _atomic_np_write(cache, lambda fh: np.savez(fh, names=names, offsets=offs, lengths=lens))
    _stamp_cache(Path(path), cache)
    return names, offs, lens


class PafStream:
    """Fetch the PAF lines of a set of read ids from full/truncated files."""

    def __init__(self, paf_full: str, paf_trunc: str):
        self.paf_full = paf_full
        self.paf_trunc = paf_trunc
        self.idx_full = self._build(paf_full)
        self.idx_trunc = self._build(paf_trunc)

    @staticmethod
    def _build(path: str) -> dict[str, list[tuple[int, int]]]:
        names, offs, lens = scan_paf_offsets(path)
        idx: dict[str, list[tuple[int, int]]] = {}
        for n, o, ln in zip(names, offs, lens):
            idx.setdefault(n, []).append((int(o), int(ln)))
        return idx

    @staticmethod
    def _grab(path: str, entries: list[tuple[int, int]]) -> str:
        chunks = []
        with open(path, "rb") as f:
            for off, ln in entries:
                f.seek(off)
                chunks.append(f.read(ln))
        return b"".join(chunks).decode()

    def grab_mappings(self, read_ids: set) -> tuple[str, str]:
        ef = [e for r in read_ids for e in self.idx_full.get(r, [])]
        et = [e for r in read_ids for e in self.idx_trunc.get(r, [])]
        return self._grab(self.paf_full, sorted(ef)), self._grab(self.paf_trunc, sorted(et))


class Sampler:
    """fastq + optional paf sampling facade (boss/sampler.py:20-56)."""

    def __init__(self, source: str, paf_full: str | None = None, paf_trunc: str | None = None, **kw):
        self.fq_stream = FastqStream(source, **kw)
        self.paf_stream = PafStream(paf_full, paf_trunc) if paf_full and paf_trunc else None

    def sample(self):
        self.fq_stream.read_batch()
        if self.paf_stream:
            paf_f, paf_t = self.paf_stream.grab_mappings(self.fq_stream.read_ids)
        else:
            paf_f, paf_t = "", ""
        return (
            self.fq_stream.read_sequences,
            self.fq_stream.read_qualities,
            self.fq_stream.read_barcodes,
            paf_f,
            paf_t,
        )
