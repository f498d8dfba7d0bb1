#!/usr/bin/env python
"""Trace the call stage on the GPU and read the posterior kernel's time.

    python scripts/trace_call.py [--out DIR]

Simulates chip_smoke.py's world, preprocesses both samples in CPU worker
processes (the parent alone holds the card), calls once to compile, then
calls again under ``jax.profiler.trace`` (with CUDA graphs off, so that
kernels appear one by one; the traced call is therefore not the production
timing). XLA dumps the optimized HLO of
the engine modules, which names the fusions that carry ops of the
``ll_cells`` scope (``ops/likelihood._ll_cells``). The reduction sums their
device time from the trace, beside the device's busy time and the traced
window. Exits non-zero without a GPU; prints one JSON line.
"""

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def scope_fusions(dump_dir, scope):
    """{(module, fusion instruction)} whose fused computation carries an
    op_name inside ``scope``, directly or through the computations it
    calls. A fusion that mixes scopes counts whole."""
    found = set()
    op_re = re.compile(r'op_name="[^"]*/' + re.escape(scope) + r'[/"]')
    call_re = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")
    for path in Path(dump_dir).glob("*after_optimizations.txt"):
        text = path.read_text()
        module = re.search(r"^HloModule ([\w.\-]+)", text, re.M).group(1)
        comp, tagged, callees, fusions = None, set(), {}, []
        for line in text.splitlines():
            head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
            if head:
                comp = head.group(1)
                continue
            if comp is None:
                continue
            if op_re.search(line):
                tagged.add(comp)
            callees.setdefault(comp, set()).update(call_re.findall(line))
            m = re.match(r"^\s*(?:ROOT )?%?([\w.\-]+) = .* fusion\(.*calls=%?([\w.\-]+)",
                         line)
            if m:
                fusions.append((m.group(1), m.group(2), bool(op_re.search(line))))
        changed = True
        while changed:
            changed = False
            for c, cs in callees.items():
                if c not in tagged and cs & tagged:
                    tagged.add(c)
                    changed = True
        found |= {(module, name) for name, called, own in fusions
                  if own or called in tagged}
    return found


def reduce_trace(trace_dir, fusions):
    """Device time per op, the scope's share, busy time and window."""
    import jax

    path = next(Path(trace_dir).rglob("*.xplane.pb"))
    pd = jax.profiler.ProfileData.from_file(str(path))
    per_op, spans, scope_ns = {}, [], 0.0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op, module = stats.get("hlo_op"), stats.get("hlo_module")
                if op is None:
                    continue
                key = f"{module}/{op}"
                per_op[key] = per_op.get(key, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if (module, op) in fusions:
                    scope_ns += ev.duration_ns
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:25]
    return {
        "scope_device_ms": scope_ns / 1e6,
        "device_busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1 - busy / window if window else None,
        "top_ops_ms": {k: v / 1e6 for k, v in top},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace_call"))
    args = ap.parse_args()
    out = Path(args.out)
    dump = out / "hlo"
    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
        # kernels run one by one instead of inside CUDA graphs, so that the
        # trace attributes time to each fusion
        + " --xla_gpu_enable_command_buffer="
    ).strip()
    import shutil

    import jax

    from varlociraptor_tpu.calling.call import CallOptions, call_generic
    from varlociraptor_tpu.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu.estimation.alignment_properties import estimate
    from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario
    from varlociraptor_tpu.io.bam import BamReader
    from varlociraptor_tpu.io.fasta import FastaBuffer
    from varlociraptor_tpu.simworld import simulate_world, write_candidates
    from varlociraptor_tpu.utils.device import require_gpu
    from varlociraptor_tpu.utils.jaxcache import enable

    enable()
    device, card = require_gpu()
    work = ROOT / ".trace_call"
    if work.exists():
        shutil.rmtree(work)
    world = simulate_world(work / "world")
    props = estimate(BamReader(world["normal"]),
                     reference=FastaBuffer(world["fa"]), num_records=30000)
    cand = work / "candidates.vcf"
    n = write_candidates(cand, world)
    obs = {}
    t0 = time.perf_counter()
    for sample in ("tumor", "normal"):
        obs[sample] = work / f"{sample}.obs.bin"
        preprocess(cand, world[sample], world["fa"], obs[sample],
                   sample_name=sample, alignment_properties=props,
                   options=PreprocessOptions(log_mode="silent", n_workers=8))
    pre_s = time.perf_counter() - t0

    def call(path):
        t = time.perf_counter()
        call_generic(tumor_normal_scenario(0.75), obs, path,
                     CallOptions(batch_size=4096))
        return time.perf_counter() - t

    cold = call(work / "calls_cold.vcf")
    warm = call(work / "calls_warm.vcf")
    trace_dir = out / "trace"
    if trace_dir.exists():
        shutil.rmtree(trace_dir)
    with jax.profiler.trace(str(trace_dir)):
        traced = call(work / "calls_traced.vcf")
    fusions = scope_fusions(dump, "ll_cells")
    res = {
        "device": device,
        "card": card,
        "loci": n,
        "preprocess_8_cpu_workers_s": pre_s,
        "call_cold_s": cold,
        "call_warm_s": warm,
        "call_traced_s": traced,
        "ll_cells_fusions": sorted("/".join(f) for f in fusions),
        **reduce_trace(trace_dir, fusions),
    }
    (out / "summary.json").write_text(json.dumps(res, indent=1))
    shutil.rmtree(work)
    # keep the optimized HLO of the modules that hold the scope only
    keep = {m for m, _f in fusions}
    for f in dump.iterdir():
        if f.is_dir():
            shutil.rmtree(f)
        elif not (f.name.endswith("after_optimizations.txt")
                  and any(f".{m}." in f.name for m in keep)):
            f.unlink()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
