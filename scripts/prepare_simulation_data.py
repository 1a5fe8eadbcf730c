#!/usr/bin/env python
"""Prepare simulation inputs: full + truncated PAFs and sampling offsets.

Equivalent of the reference's snakemake pipeline
(/root/reference/scripts/prepare_simulation_data.smk): from a reference fasta
and a big fastq, produce
    <fq>.offsets.npy          byte offsets of every read (mmap sampler)
    <out>/full.paf            alignments of full-length reads
    <out>/trunc.paf           alignments of the first mu bases of each read
    <paf>.offsets.npz         per-read PAF line offsets
using the in-repo aligner instead of minimap2 subprocesses.

Usage: python scripts/prepare_simulation_data.py --ref ref.fa --fq reads.fq
           [--out DIR] [--mu 400] [--batch 2000]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def paf_line(rec, i) -> str:
    cg = rec.cigars[i]
    if cg is not None and not isinstance(cg, str):  # packed uint32 array
        from bossruns_tpu.aligner.native import cigar_to_string

        cg = cigar_to_string(cg)
    tags = f"\ttp:A:P\tAS:i:{rec.align_score[i]}\ts1:i:{rec.s1[i]}"
    if cg:
        tags += f"\tcg:Z:{cg}"
    strand = "-" if rec.rev[i] else "+"
    return (
        f"{rec.qname[i]}\t{rec.qlen[i]}\t{rec.qstart[i]}\t{rec.qend[i]}\t{strand}\t"
        f"{rec.tname[i]}\t{rec.tlen[i]}\t{rec.tstart[i]}\t{rec.tend[i]}\t"
        f"{rec.nmatch[i]}\t{rec.blocklen[i]}\t{rec.mapq[i]}{tags}"
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True)
    ap.add_argument("--fq", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mu", type=int, default=400)
    ap.add_argument("--batch", type=int, default=2000)
    args = ap.parse_args()

    from bossruns_tpu.aligner import TpuAligner
    from bossruns_tpu.io.fastq import read_fastx
    from bossruns_tpu.io.sampler import scan_fastq_offsets, scan_paf_offsets
    from bossruns_tpu.models.layout import build_layout
    from bossruns_tpu.models.runs_sim import load_reference_contigs

    out = Path(args.out or Path(args.fq).parent)
    out.mkdir(parents=True, exist_ok=True)
    print("scanning fastq offsets ...")
    offs = scan_fastq_offsets(args.fq)
    print(f"  {offs.shape[0]} reads")

    layout = build_layout(load_reference_contigs(args.ref))
    aligner = TpuAligner(layout, source=args.ref)
    full_path = out / "full.paf"
    trunc_path = out / "trunc.paf"
    n = 0
    with open(full_path, "w") as ff, open(trunc_path, "w") as ft:
        batch: dict[str, str] = {}
        for name, _c, seq, _q in read_fastx(args.fq):
            batch[name] = seq
            if len(batch) >= args.batch:
                n += _flush(aligner, batch, ff, ft)
                batch = {}
        if batch:
            n += _flush(aligner, batch, ff, ft)
    print(f"aligned {n} reads -> {full_path}, {trunc_path}")
    scan_paf_offsets(full_path)
    scan_paf_offsets(trunc_path)
    print("PAF offsets cached")
    return 0


def _flush(aligner, batch, ff, ft) -> int:
    full = aligner.map_sequences(batch)
    trunc = aligner.map_sequences(batch, trunc=True)
    for i in range(len(full)):
        ff.write(paf_line(full, i) + "\n")
    for i in range(len(trunc)):
        ft.write(paf_line(trunc, i) + "\n")
    return len(batch)


if __name__ == "__main__":
    sys.exit(main())
