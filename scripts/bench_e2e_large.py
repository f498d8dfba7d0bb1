#!/usr/bin/env python
"""Large-scale end-to-end witness: a >=100K-candidate two-sample pipeline
over simulated libraries with PLANTED germline and somatic SNVs and indels.

World (varlociraptor_tpu/simworld.py): an 8 Mb synthetic contig; both
samples share the germline variants (haplotype 1); the tumor additionally
carries the somatic ones. 30x paired-end libraries per sample, written as
indexed BAMs; then the production pipeline runs: alignment-property
estimation -> preprocess (W workers/sample) -> tumor-normal columnar call
-> somatic + germline FDR. Somatic `fdr_kept` MUST be > 0 (the planted
truth), and planted-site sensitivity is reported.

The world is simulated anew under <checkout>/.e2e_large on every run.

Usage: python scripts/bench_e2e_large.py [N_CANDIDATES] [--workers W]
"""

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WORK = ROOT / ".e2e_large"


def world_config(n_candidates):
    from varlociraptor_tpu.simworld import WorldConfig

    return WorldConfig(
        length=8_000_000, germline_snvs=2000, somatic_snvs=1000,
        germline_indels=600, somatic_indels=400, n_candidates=n_candidates,
    )


def run(n_candidates: int = 100_000, workers: int = 4):
    from varlociraptor_tpu.calling.call import CallOptions, call_generic
    from varlociraptor_tpu.calling.preprocess import (
        PreprocessOptions,
        preprocess,
    )
    from varlociraptor_tpu.estimation.alignment_properties import estimate
    from varlociraptor_tpu.filtration.fdr import control_fdr
    from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario
    from varlociraptor_tpu.io.bam import BamReader
    from varlociraptor_tpu.io.fasta import FastaBuffer
    from varlociraptor_tpu.io.vcf import VcfReader
    from varlociraptor_tpu.simworld import simulate_world, write_candidates

    if WORK.exists():
        shutil.rmtree(WORK)
    world = simulate_world(WORK / "world", world_config(n_candidates))
    tmp = WORK
    cand = tmp / "candidates.vcf"
    n = write_candidates(cand, world)

    t0 = time.perf_counter()
    props = estimate(
        BamReader(world["normal"]),
        reference=FastaBuffer(world["fa"]),
        num_records=30000,
    )
    obs = {}
    for sample in ("tumor", "normal"):
        out = tmp / f"{sample}.obs.bin"
        preprocess(
            cand,
            world[sample],
            world["fa"],
            out,
            sample_name=sample,
            alignment_properties=props,
            options=PreprocessOptions(n_workers=workers, log_mode="silent"),
        )
        obs[sample] = out
    t1 = time.perf_counter()

    calls = tmp / "calls.vcf"
    # batch 4096 = the same window programs scripts/bench_call_rate.py (and
    # bench.py's call_rate extra) compile — warm reuse across the bench
    call_generic(
        tumor_normal_scenario(0.75), obs, calls, CallOptions(batch_size=4096)
    )
    t2 = time.perf_counter()

    from varlociraptor_tpu.io.vcf import VcfReader as _VR

    calls_reader = _VR(calls)  # parsed once, shared by both FDR passes
    filtered = tmp / "filtered_somatic.vcf"
    kept_somatic = control_fdr(
        calls, filtered, events=["SOMATIC_TUMOR"], alpha=0.05,
        reader=calls_reader,
    )
    filtered_g = tmp / "filtered_germline.vcf"
    kept_germline = control_fdr(
        calls, filtered_g, events=["GERMLINE_HET", "GERMLINE_HOM"],
        alpha=0.05, reader=calls_reader,
    )
    t3 = time.perf_counter()
    assert kept_somatic > 0, "planted somatics were not kept by somatic FDR"
    assert kept_germline > 0, "planted germlines were not kept"

    som_truth = {v["pos"] for v in world["planted"] if v["somatic"]}
    kept_at_truth = sum(
        1 for r in VcfReader(filtered).records() if r.pos in som_truth
    )
    shutil.rmtree(WORK)
    return {
        "n_loci": n,
        "preprocess_s": round(t1 - t0, 2),
        "preprocess_ms_per_locus_per_sample": round(
            (t1 - t0) * 1000 / (2 * n), 2
        ),
        "call_s": round(t2 - t1, 2),
        "call_loci_per_sec": round(n / (t2 - t1), 1),
        "fdr_s": round(t3 - t2, 2),
        "e2e_s": round(t3 - t0, 2),
        "e2e_loci_per_sec": round(n / (t3 - t0), 1),
        "fdr_kept_somatic": kept_somatic,
        "fdr_kept_germline": kept_germline,
        "somatic_sensitivity": round(kept_at_truth / len(som_truth), 4),
        "n_planted_somatic": len(som_truth),
        "workers": workers,
        "world_setup_s": round(world["seconds"], 2),
    }


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 100_000
    workers = (
        int(sys.argv[sys.argv.index("--workers") + 1])
        if "--workers" in sys.argv
        else 4
    )
    res = run(n, workers)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
