#!/usr/bin/env python
"""Pair-HMM on a GPU host: the XLA wavefront on the card vs the native C++
host forward, at the widths and batch sizes of chip_smoke.py's world.

    python scripts/bench_pairhmm_kernels.py [--loci N] [--json PATH]

1. Simulates chip_smoke's world and preprocesses the first N candidates of
   the tumor (serial, device_chunk 64) once per gap model, recording every
   batch the pair-HMM receives: the estimated properties (finite
   extensions) and the reference defaults on the indel candidates (zero
   extensions).
2. Times each path on those batches, warm: the wavefront as device calls on
   pre-packed panels ending in block_until_ready, the host forward as one
   threaded native call, both with the production bands. Reports ms per
   batch and Gcells/s (cells = sum of allele x read lengths).
3. Times preprocess ms/locus end to end with each path, on the first N
   candidates and on the indel candidates (estimated properties), in
   rotating order after a warm-up round (every shape compiled).

Exits non-zero without a GPU. Prints one JSON line naming the device.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WORK = ROOT / ".bench_pairhmm"


def _record_batches(fn):
    """Run fn() while recording every BatchedPairHMM.forward batch."""
    from varlociraptor_tpu.ops.pairhmm import BatchedPairHMM

    batches = []
    orig = BatchedPairHMM.forward

    def forward(self, alleles, reads, quals, max_dists=None):
        batches.append((self.gap.copy(), list(alleles), list(reads),
                        list(quals), list(max_dists or [None] * len(alleles))))
        return orig(self, alleles, reads, quals, max_dists)

    BatchedPairHMM.forward = forward
    try:
        fn()
    finally:
        BatchedPairHMM.forward = orig
    return batches


def _time_batches(batches):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from varlociraptor_tpu.io.native import pairhmm_forward_batch
    from varlociraptor_tpu.ops.pairhmm import _forward_impl, _round_up, device_panels

    cells = sum(
        len(a) * len(r) for _g, al, rd, _q, _d in batches for a, r in zip(al, rd)
    )
    wave, nat = [], []
    for gap, alleles, reads, quals, dists in batches:
        n = len(alleles)
        B = max(8, 1 << (n - 1).bit_length())
        X = _round_up(max(map(len, alleles)), 32)
        Y = _round_up(max(map(len, reads)), 32)
        al, alen, rd, rlen, mis, me = device_panels(
            alleles, reads, quals, dists, B, X, Y
        )
        wave.append(([jnp.asarray(x) for x in (al, alen, rd, mis, rlen, gap, me)],
                     X, Y))
        miscalls = [
            -np.asarray(q, np.float32) * np.float32(math.log(10) / 10)
            for q in quals
        ]
        nat.append((alleles, reads, miscalls, gap, dists))

    def run_wave():
        return [_forward_impl(*a, X, Y) for a, X, Y in wave]

    def run_native():
        return [pairhmm_forward_batch(a, r, m, g, max_edit=d)
                for a, r, m, g, d in nat]

    out = {}
    for name, fn in (("wavefront", run_wave), ("native_host", run_native)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        out[name] = {
            "ms_per_batch": dt * 1e3 / len(batches),
            "gcells_per_s": cells / dt / 1e9,
            "first_run_incl_compile_s": first,
        }
    out["batches"] = len(batches)
    out["items"] = sum(len(b[1]) for b in batches)
    out["cells"] = cells
    return out


def _preprocess_ms_per_locus(cand, world, props, path):
    """One preprocess of the tumor with one pair-HMM path; ms/locus."""
    from varlociraptor_tpu.calling.preprocess import PreprocessOptions, preprocess

    os.environ["VLT_NATIVE_PAIRHMM"] = "1" if path == "native_host" else "0"
    try:
        t0 = time.perf_counter()
        n = preprocess(cand, world["tumor"], world["fa"],
                       WORK / f"obs_{path}.bin", sample_name="tumor",
                       alignment_properties=props,
                       options=PreprocessOptions(log_mode="silent",
                                                 device_chunk=64))
        return (time.perf_counter() - t0) * 1e3 / n
    finally:
        os.environ.pop("VLT_NATIVE_PAIRHMM", None)


PATHS = ("wavefront", "native_host")


def _preprocess_rounds(cand, world, props, reps):
    """ms/locus per path over ``reps`` rounds after one warm-up round; the
    order of the paths rotates every round, so that drift on the shared
    host does not favour one path."""
    for path in PATHS:
        _preprocess_ms_per_locus(cand, world, props, path)
    runs = {p: [] for p in PATHS}
    for r in range(reps):
        order = PATHS if r % 2 == 0 else PATHS[::-1]
        for path in order:
            runs[path].append(_preprocess_ms_per_locus(cand, world, props, path))
    import statistics

    return {
        p: {"median_ms_per_locus": statistics.median(v), "runs": v}
        for p, v in runs.items()
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loci", type=int, default=1500)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed preprocess rounds per path")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()

    import dataclasses
    import shutil

    from varlociraptor_tpu.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu.estimation.alignment_properties import GapParams, estimate
    from varlociraptor_tpu.io.bam import BamReader
    from varlociraptor_tpu.io.fasta import FastaBuffer
    from varlociraptor_tpu.simworld import simulate_world, write_candidates
    from varlociraptor_tpu.utils.device import require_gpu
    from varlociraptor_tpu.utils.jaxcache import enable

    enable()
    device, card = require_gpu()

    if WORK.exists():
        shutil.rmtree(WORK)
    world = simulate_world(WORK / "world")
    props = estimate(BamReader(world["normal"]),
                     reference=FastaBuffer(world["fa"]), num_records=30000)

    def first_n(src, dst, n):
        lines = Path(src).read_text().splitlines(keepends=True)
        head = [ln for ln in lines if ln.startswith("#")]
        body = [ln for ln in lines if not ln.startswith("#")][:n]
        Path(dst).write_text("".join(head + body))
        return len(body)

    cand_all = WORK / "candidates_all.vcf"
    write_candidates(cand_all, world)
    cand = WORK / "candidates.vcf"
    n_cand = first_n(cand_all, cand, args.loci)
    indel_all = WORK / "indels_all.vcf"
    write_candidates(indel_all, world, kinds=("indel",), background=False)
    indels = WORK / "indels.vcf"
    first_n(indel_all, indels, max(args.loci // 5, 50))
    exact_props = dataclasses.replace(props, gap_params=GapParams())

    def pre(c, p):
        return lambda: preprocess(
            c, world["tumor"], world["fa"], WORK / "rec.bin",
            sample_name="tumor", alignment_properties=p,
            options=PreprocessOptions(log_mode="silent", device_chunk=64))

    result = {
        "device": device,
        "card": card,
        "gap_params_estimated": dataclasses.asdict(props.gap_params),
        "general": _time_batches(_record_batches(pre(cand, props))),
        "exact": _time_batches(_record_batches(pre(indels, exact_props))),
        "preprocess_all": _preprocess_rounds(cand, world, props, args.reps),
        "preprocess_indels": _preprocess_rounds(indels, world, props, args.reps),
        "candidates": n_cand,
    }
    shutil.rmtree(WORK)
    line = json.dumps(result)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
