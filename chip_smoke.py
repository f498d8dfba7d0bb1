#!/usr/bin/env python
"""Run the main path once on one NVIDIA GPU and check what comes out.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # four cards: the sharded call only

Users call one genomic region at a time, so the run is one such region: a
seeded tumor-normal world of about 2 Mb at 30x per sample with planted
germline and somatic SNVs and 1-10 bp indels, about 10,000 candidates.

 1. device   fail unless JAX's first device is a GPU; print its kind, the
             device count and the card's name and power limit
 2. world    simulate the world (set-up time)
 3. preprocess both samples serially, so that the pair-HMM batches go to
             the card: once with the estimated alignment properties (finite
             gap extensions), and once for the indel candidates with the
             reference's zero-extension gap params; the device forward must
             have run for both gap models
 4. call     ``call_generic`` under the tumor-normal scenario, window 4096
 5. FDR      somatic and germline ``control_fdr``; kept > 0 and planted-site
             sensitivity for SNVs and indels at or above the thresholds
 6. kernels  the device pair-HMM forward (the XLA wavefront) against the
             native f64 forward on one batch at the world's real widths,
             for both gap models
 7. engine   the same observation files called and filtered through the
             CLI in a CPU-only child; PROB_*/AF within ENGINE_TOL; FDR keep
             sets identical but for records within FDR_BOUNDARY of the keep
             threshold on both backends

Any failed phase raises, so the script exits non-zero and prints no result
line. The last stdout line is one JSON object naming the device.

``--four-cards`` runs only the sharded path over a 1-D locus mesh of four
cards (``run_sharded_compact`` and ``control_fdr_sharded``) and compares it
with one card: calls and FDR-filtered calls byte-identical to the
single-device panels program's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"

# planted-site sensitivity floors: 90% of what a CPU rehearsal of the same
# world reached (native pair-HMM, CPU engine: somatic SNV 0.998, indel
# 1.0; germline SNV 0.615, indel 0.64), rounded down. Germline sites stay
# low because the tumor-normal prior leaves ~10% of a het site's mass on
# SOMATIC_NORMAL, above the 5% FDR
SENSITIVITY_MIN = {
    "somatic_snv": 0.89,
    "somatic_indel": 0.90,
    "germline_snv": 0.55,
    "germline_indel": 0.57,
}
# device forward vs reference: |d log-prob| / max(1, |ref|). The device
# forward is log-space f32, the reference linear-space f64; 5e-4 covers f32
# rounding over a ~400-step recurrence and is far below the gaps that
# separate alleles
KERNEL_TOL = 5e-4
# GPU vs CPU engine, |d| / max(1, |x|) on PROB_* (PHRED, 4 decimals) and
# AF. Both run the engine in f32. Measured on this world (H100), against an
# f64 copy of the engine on the same observations: the card within 2e-4,
# the CPU within 4e-4, the two within 4e-4 of each other (4 units of the
# VCF's last decimal). 5e-4 allows one unit more
ENGINE_TOL = 5e-4
# an FDR decision may differ between the backends only for a record whose
# posterior error probability lies this close to the keep threshold on
# both: twice the largest per-record disagreement in error probability
# measured on this world (5.1e-5 card vs CPU, 4.6e-5 CPU vs f64)
FDR_BOUNDARY = 1e-4
INDEL_WINDOW = 64  # PreprocessOptions.indel_window


def log(msg):
    print(msg, flush=True)


def device_phase():
    from varlociraptor_tpu.utils.device import require_gpu

    device, card = require_gpu()
    log(f"device: {device['kind']} x{device['count']} ({device['platform']})")
    log(f"card: {card}")
    return device, card


def world_phase(work, cfg=None):
    from varlociraptor_tpu.simworld import WorldConfig, simulate_world

    world = simulate_world(work / "world", cfg or WorldConfig())
    n_planted = len(world["planted"])
    log(f"world: {world['config']['length']} bp, {n_planted} planted sites, "
        f"set-up {world['seconds']:.2f} s")
    return world


def preprocess_phase(world, work):
    """Returns ({sample: observation file}, estimated properties, number
    of candidates)."""
    import dataclasses

    from varlociraptor_tpu.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu.estimation.alignment_properties import GapParams, estimate
    from varlociraptor_tpu.io.bam import BamReader
    from varlociraptor_tpu.io.fasta import FastaBuffer
    from varlociraptor_tpu.ops.pairhmm import forward_counts
    from varlociraptor_tpu.simworld import write_candidates

    cand = work / "candidates.vcf"
    n_cand = write_candidates(cand, world)
    t0 = time.perf_counter()
    props = estimate(
        BamReader(world["normal"]), reference=FastaBuffer(world["fa"]),
        num_records=30000,
    )
    gp = props.gap_params
    if not (math.isfinite(gp.prob_insertion_extend_artifact)
            and math.isfinite(gp.prob_deletion_extend_artifact)):
        raise AssertionError(f"estimated gap extensions not finite: {gp}")
    log(f"estimate: {time.perf_counter() - t0:.2f} s, gap params {gp}")

    opts = PreprocessOptions(log_mode="silent")
    forward_counts.clear()
    obs = {}
    for sample in ("tumor", "normal"):
        t0 = time.perf_counter()
        obs[sample] = work / f"{sample}.obs.bin"
        n = preprocess(cand, world[sample], world["fa"], obs[sample],
                       sample_name=sample, alignment_properties=props,
                       options=opts)
        if n != n_cand:
            raise AssertionError(f"{sample}: {n} of {n_cand} candidates written")
        log(f"preprocess {sample}: {n} loci, {time.perf_counter() - t0:.2f} s")
    general = dict(forward_counts)

    indels = work / "indels.vcf"
    n_indel = write_candidates(indels, world, kinds=("indel",), background=False)
    exact_props = dataclasses.replace(props, gap_params=GapParams())
    forward_counts.clear()
    t0 = time.perf_counter()
    preprocess(indels, world["tumor"], world["fa"], work / "indels.obs.bin",
               sample_name="tumor", alignment_properties=exact_props,
               options=opts)
    exact = dict(forward_counts)
    log(f"preprocess indels, zero-extension gaps: {n_indel} loci, "
        f"{time.perf_counter() - t0:.2f} s")
    counts = {"general": general, "exact": exact}
    log(f"pair-HMM forwards by path: {json.dumps(counts)}")
    if general.get("wavefront", 0) <= 0 or exact.get("wavefront", 0) <= 0:
        raise AssertionError(f"the device pair-HMM did not run: {counts}")
    return obs, props, n_cand


def call_phase(obs, work, n_cand):
    from varlociraptor_tpu.calling.call import CallOptions, call_generic
    from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario

    calls = work / "calls.vcf"
    t0 = time.perf_counter()
    n = call_generic(tumor_normal_scenario(0.75), obs, calls,
                     CallOptions(batch_size=4096))
    log(f"call: {n} loci, {time.perf_counter() - t0:.2f} s")
    if n != n_cand:
        raise AssertionError(f"called {n} of {n_cand} loci")
    return calls


FDR_EVENTS = {
    "somatic": ["SOMATIC_TUMOR"],
    "germline": ["GERMLINE_HET", "GERMLINE_HOM"],
}


def fdr_phase(calls, world, work):
    from varlociraptor_tpu.filtration.fdr import control_fdr
    from varlociraptor_tpu.io.vcf import VcfReader

    t0 = time.perf_counter()
    reader = VcfReader(calls)
    kept_pos = {}
    for name, events in FDR_EVENTS.items():
        out = work / f"filtered_{name}.vcf"
        kept = control_fdr(calls, out, events=events, alpha=0.05, reader=reader)
        if kept <= 0:
            raise AssertionError(f"{name} FDR kept nothing")
        kept_pos[name] = {r.pos for r in VcfReader(out).records()}
        log(f"fdr {name}: kept {kept}")
    sens = {}
    for v in world["planted"]:
        key = ("somatic" if v["somatic"] else "germline") + (
            "_snv" if v["kind"] == 0 else "_indel")
        hit, tot = sens.get(key, (0, 0))
        kind = key.split("_")[0]
        sens[key] = (hit + (v["pos"] in kept_pos[kind]), tot + 1)
    sens = {k: h / t for k, (h, t) in sens.items()}
    log(f"fdr: {time.perf_counter() - t0:.2f} s, planted-site sensitivity "
        f"{json.dumps(sens)}")
    low = {k: s for k, s in sens.items() if s < SENSITIVITY_MIN[k]}
    if low:
        raise AssertionError(f"sensitivity below {SENSITIVITY_MIN}: {low}")
    return {k: sorted(p) for k, p in kept_pos.items()}


def parity_batch(world, n=2048, seed=7):
    """(alleles, reads, quals) as realignment builds them: the tumor's
    150-base reads against reference windows spanning each read plus up to
    INDEL_WINDOW bases on either side."""
    import numpy as np

    from varlociraptor_tpu.io.bam import BamReader

    rng = np.random.default_rng(seed)
    ref = np.frombuffer(Path(world["ref_seq"]).read_bytes(), np.uint8)
    recs = BamReader(world["tumor"]).records
    pick = rng.choice(len(recs), size=n, replace=False)
    alleles, reads, quals = [], [], []
    for k in pick.tolist():
        r = recs[k]
        lo = max(0, r.pos - int(rng.integers(0, INDEL_WINDOW + 1)))
        hi = min(len(ref), r.end_pos + int(rng.integers(0, INDEL_WINDOW + 1)))
        alleles.append(ref[lo:hi].tobytes())
        reads.append(np.asarray(r.seq, np.uint8))
        quals.append(np.asarray(r.qual, np.uint8))
    return alleles, reads, quals


def kernel_check(alleles, reads, quals, gap_params):
    """The device pair-HMM forward (``BatchedPairHMM.forward`` on the GPU:
    the XLA wavefront) against the native f64 forward on one batch, full
    window; ``gap_params``: {name: GapParams}. Returns {name: worst
    relative difference}; raises above KERNEL_TOL."""
    import numpy as np

    from varlociraptor_tpu.io.native import pairhmm_forward_batch
    from varlociraptor_tpu.ops.pairhmm import BatchedPairHMM

    miscalls = [
        -q.astype(np.float32) * np.float32(math.log(10.0) / 10.0) for q in quals
    ]
    log(f"kernels: batch of {len(alleles)}, read {min(map(len, reads))}-"
        f"{max(map(len, reads))} bases, allele {min(map(len, alleles))}-"
        f"{max(map(len, alleles))} bases")
    worst = {}
    for name, gp in gap_params.items():
        hmm = BatchedPairHMM(gp)
        if hmm.device_path() != "wavefront" or hmm._native_ok():
            raise AssertionError("the device forward does not serve this batch")
        t0 = time.perf_counter()
        got = hmm.forward(alleles, reads, quals)
        t_dev = time.perf_counter() - t0
        ref = pairhmm_forward_batch(alleles, reads, miscalls, hmm.gap)
        if ref is None:
            raise AssertionError("native library unavailable")
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
        k = int(np.argmax(rel))
        worst[name] = float(rel[k])
        log(f"device forward ({name} gaps) vs native f64: worst rel "
            f"{rel[k]:.3e} (item {k}: {got[k]:.6f} vs {ref[k]:.6f}); first "
            f"call incl. compile {t_dev:.2f} s")
    bad = {k: v for k, v in worst.items() if not v <= KERNEL_TOL}
    if bad:
        raise AssertionError(f"device forward parity above {KERNEL_TOL}: {bad}")
    return worst


def kernel_phase(world, props):
    from varlociraptor_tpu.estimation.alignment_properties import GapParams

    return kernel_check(
        *parity_batch(world),
        {"exact": GapParams(), "general": props.gap_params},
    )


def _cli(args, env):
    return subprocess.run(
        [sys.executable, "-m", "varlociraptor_tpu", *map(str, args)],
        cwd=ROOT, env=env, check=True, capture_output=True, text=True,
        timeout=900,
    )


def _values(path):
    """Per record: (locus key, {field: float}) for every PROB_* INFO field
    and every sample's AF."""
    from varlociraptor_tpu.io.vcf import VcfReader

    out = []
    for r in VcfReader(path).records():
        vals = {}
        for k, v in r.info.items():
            if k.startswith("PROB_") and v not in (".", True):
                vals[k] = float(v)
        for i, s in enumerate(r.samples):
            af = s.get("AF")
            if af not in (None, "."):
                vals[f"AF{i}"] = float(af)
        out.append(((r.chrom, r.pos, r.ref, tuple(r.alts)), vals))
    return out


def engine_phase(obs, calls, kept_gpu, work):
    """The same observation files through the CLI in a child that sees only
    the CPU (JAX_PLATFORMS is set before the child imports JAX)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    cpu_calls = work / "calls_cpu.vcf"
    t0 = time.perf_counter()
    _cli(["call", "variants", "tumor-normal", "--tumor", obs["tumor"],
          "--normal", obs["normal"], "--purity", "0.75", "--output",
          cpu_calls], env)
    kept_cpu = {}
    for name, events in FDR_EVENTS.items():
        out = work / f"filtered_{name}_cpu.vcf"
        _cli(["filter-calls", "control-fdr", cpu_calls, "--events", *events,
              "--fdr", "0.05", "--output", out], env)
        from varlociraptor_tpu.io.vcf import VcfReader

        kept_cpu[name] = {r.pos for r in VcfReader(out).records()}
    log(f"engine: CPU child call + FDR {time.perf_counter() - t0:.2f} s")

    gpu, cpu = _values(calls), _values(cpu_calls)
    if [k for k, _ in gpu] != [k for k, _ in cpu]:
        raise AssertionError("GPU and CPU calls list different records")
    worst, where = 0.0, None
    for (key, a), (_k, b) in zip(gpu, cpu):
        if a.keys() != b.keys():
            raise AssertionError(f"{key}: fields differ {sorted(a)} vs {sorted(b)}")
        for f, x in a.items():
            y = b[f]
            if math.isinf(x) or math.isinf(y):
                if x != y:
                    raise AssertionError(f"{key} {f}: {x} vs {y}")
                continue
            rel = abs(x - y) / max(1.0, abs(y))
            if rel > worst:
                worst, where = rel, (key, f, x, y)
    log(f"engine: {len(gpu)} records, worst PROB_*/AF rel diff {worst:.3e} at "
        f"{where}")
    if worst > ENGINE_TOL:
        raise AssertionError(f"GPU vs CPU engine above {ENGINE_TOL}: {where}")
    pos_of = [k[1] for k, _ in gpu]
    for name, events in FDR_EVENTS.items():
        g, c = set(kept_gpu[name]), kept_cpu[name]
        if g == c:
            log(f"engine: {name} FDR keep sets identical ({len(g)})")
            continue
        # decisions may differ only at the threshold: every record kept on
        # one backend alone must sit, on both backends, within FDR_BOUNDARY
        # of the largest error probability kept on either
        pep = {
            side: {
                pos: 1.0 - sum(10 ** (-vals[f"PROB_{e}"] / 10) for e in events)
                for pos, (_k, vals) in zip(pos_of, table)
            }
            for side, table in (("gpu", gpu), ("cpu", cpu))
        }
        cut = max(max(pep["gpu"][p] for p in g), max(pep["cpu"][p] for p in c))
        far = {p: (pep["gpu"][p], pep["cpu"][p]) for p in g ^ c
               if max(abs(pep["gpu"][p] - cut), abs(pep["cpu"][p] - cut))
               > FDR_BOUNDARY}
        log(f"engine: {name} FDR keep sets GPU {len(g)}, CPU {len(c)}; "
            f"differ at {sorted(g ^ c)} (threshold error probability {cut:.5f})")
        if far:
            raise AssertionError(f"{name} FDR decisions differ off the threshold: {far}")
    return worst


def main_path():
    from varlociraptor_tpu.utils.jaxcache import enable

    enable()
    device, smi = device_phase()
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    stages = {}
    t0 = time.perf_counter()
    world = world_phase(WORK)
    stages["world_setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    obs, props, n_cand = preprocess_phase(world, WORK)
    stages["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    calls = call_phase(obs, WORK, n_cand)
    stages["call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept = fdr_phase(calls, world, WORK)
    stages["fdr_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernel_phase(world, props)
    stages["kernel_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_phase(obs, calls, kept, WORK)
    stages["engine_parity_s"] = time.perf_counter() - t0
    log(f"stage seconds ({smi}): {json.dumps(stages)}")
    shutil.rmtree(WORK)
    return device


def four_cards():
    import jax

    from __graft_entry__ import dryrun_multichip
    from varlociraptor_tpu.utils.jaxcache import enable

    enable()
    device, smi = device_phase()
    if device["count"] < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, have {device['count']}")
    t0 = time.perf_counter()
    res = dryrun_multichip(4, n_loci=16384, batch_size=4096)
    log(f"four cards ({smi}): {json.dumps(res)}, "
        f"{time.perf_counter() - t0:.2f} s")
    return {**device, "count": len(jax.devices()[:4])}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on four cards")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    device = four_cards() if args.four_cards else main_path()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
