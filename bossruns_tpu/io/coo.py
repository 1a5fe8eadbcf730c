"""Host->device batch helpers: shape padding + read-start (fhat) rows.

The coverage half of the ReadBatch is built by io/coo_native.py
(build_packed_runs + split_runs); _pad_len here is the shared power-of-two
padding policy so jit sees a small number of distinct shapes.

Read-start rows reproduce the reference's np.histogram semantics
(readstartdist.py:43-82): forward reads bin tstart, reverse reads bin tend,
window 2000, values beyond the last window edge are dropped, a value exactly
on the edge lands in the last window.
"""
from __future__ import annotations

import numpy as np

from ..models.layout import FHAT_WINDOW, GenomeLayout
from .paf import PafRecords

MIN_PAD = 1 << 12


def _pad_len(n: int) -> int:
    # pow2 up to 64k, then 64k granularity: pow2 all the way wastes up to
    # ~50% of the batch upload (553k rows -> a 1M pad). Drivers still pass
    # monotone floors, so a run sees few distinct shapes.
    p = MIN_PAD
    while p < n and p < (1 << 16):
        p *= 2
    if n <= p:
        return p
    return -(-n // (1 << 16)) * (1 << 16)


def build_read_start_rows(layout: GenomeLayout, rec: PafRecords, rows: list[int],
                          floor: int = 512):
    """(rs_row, rs_strand, rs_w) arrays for accepted records.

    floor: minimum padded length (drivers pass the largest seen so shrinking
    acceptance counts reuse one compiled step shape)."""
    tid_of = {n: i for i, n in enumerate(layout.names)}
    out_row, out_strand = [], []
    for i in rows:
        tid = tid_of.get(rec.tname[i])
        if tid is None:
            continue
        wf = int(layout.lengths[tid]) // FHAT_WINDOW
        if wf == 0:
            continue
        start = int(rec.tend[i]) if rec.rev[i] else int(rec.tstart[i])
        if start > FHAT_WINDOW * wf:
            continue  # beyond histogram range -> dropped
        w_idx = min(start // FHAT_WINDOW, wf - 1)
        out_row.append(int(layout.fhat_offsets[tid]) + w_idx)
        out_strand.append(int(rec.rev[i]))
    n = len(out_row)
    m = max(512, floor)
    while m < n:
        m *= 2
    rs_row = np.zeros(m, np.int32)
    rs_strand = np.zeros(m, np.int32)
    rs_w = np.zeros(m, np.float32)
    rs_row[:n] = out_row
    rs_strand[:n] = out_strand
    rs_w[:n] = 1.0
    return rs_row, rs_strand, rs_w
