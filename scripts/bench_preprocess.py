#!/usr/bin/env python
"""Preprocess throughput benchmark on the reference's tumor-first30000.bam.

Generates N synthetic candidates (SNV/DEL/INS mix) across the BAM's covered
range on chr10 and times the full preprocess pipeline (fetch -> pileup ->
realignment -> observation write).  Usage:

    python scripts/bench_preprocess.py [N] [--profile] [--mode exact|fast]
"""

import cProfile
import pstats
import os
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from varlociraptor_tpu.utils.jaxcache import enable as _exc  # noqa: E402

_exc()

RES = Path("/root/reference/tests/resources")


def make_candidates(n, out_path):
    """SNVs (80%), deletions (10%), insertions (10%) spaced over the covered
    range, with alleles derived from the reference sequence."""
    from varlociraptor_tpu.io.fasta import FastaBuffer

    ref = FastaBuffer(RES / "chr10.fa")
    seq = ref.seq("chr10")
    start, end = 50200, 128400
    step = max(1, (end - start) // n)
    alt_of = {"A": "G", "C": "T", "G": "A", "T": "C"}
    with open(out_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write('##contig=<ID=chr10,length=135374737>\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        written = 0
        pos = start
        while written < n and pos < end:
            refbase = chr(seq[pos])
            if refbase not in alt_of:
                pos += 1
                continue
            kind = written % 10
            if kind < 8:  # SNV
                f.write(f"chr10\t{pos + 1}\t.\t{refbase}\t{alt_of[refbase]}\t.\t.\t.\n")
            elif kind == 8:  # 3bp deletion
                delref = "".join(chr(b) for b in seq[pos : pos + 4])
                f.write(f"chr10\t{pos + 1}\t.\t{delref}\t{refbase}\t.\t.\t.\n")
            else:  # 3bp insertion
                f.write(f"chr10\t{pos + 1}\t.\t{refbase}\t{refbase}ACT\t.\t.\t.\n")
            written += 1
            pos += step
    return written


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 1000
    profile = "--profile" in sys.argv
    mode = "exact"
    if "--mode" in sys.argv:
        mode = sys.argv[sys.argv.index("--mode") + 1]
    workers = 1
    if "--workers" in sys.argv:
        workers = int(sys.argv[sys.argv.index("--workers") + 1])

    from varlociraptor_tpu.calling.preprocess import PreprocessOptions, preprocess

    tmp = Path(tempfile.mkdtemp(prefix="vlt-benchpre-"))
    cand = tmp / "candidates.vcf"
    n_written = make_candidates(n, cand)
    out = tmp / "obs.jsonl"

    opts = PreprocessOptions(pairhmm_mode=mode, n_workers=workers)
    t0 = time.perf_counter()
    if profile:
        pr = cProfile.Profile()
        pr.enable()
    count = preprocess(
        cand,
        RES / "tumor-first30000.bam",
        RES / "chr10.fa",
        out,
        sample_name="tumor",
        options=opts,
    )
    if profile:
        pr.disable()
    dt = time.perf_counter() - t0
    print(
        f"preprocessed {count}/{n_written} candidates in {dt:.1f}s "
        f"-> {dt / max(count, 1) * 1000:.1f} ms/locus ({mode} mode)"
    )
    if profile:
        st = pstats.Stats(pr)
        st.sort_stats("cumulative").print_stats(30)


if __name__ == "__main__":
    main()
