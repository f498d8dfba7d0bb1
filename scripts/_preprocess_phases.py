"""Clean phase timers for the realistic preprocess bench (no cProfile)."""
import os
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import numpy as np  # noqa: E402

T = {}


def hook(mod, name, key=None):
    fn = getattr(mod, name)
    k = key or name
    T[k] = [0.0, 0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        T[k][0] += time.perf_counter() - t0
        T[k][1] += 1
        return r

    setattr(mod, name, timed)


from varlociraptor_tpu.evidence import extraction  # noqa: E402
from varlociraptor_tpu.io import native  # noqa: E402

hook(extraction, "collect_fragments")
hook(extraction, "extract_observations_begin")
hook(extraction, "extract_observations_finish")
hook(extraction, "evidence_to_observation")
hook(native, "pairhmm_forward_batch")
hook(native, "hybrid_hits_batch")
from varlociraptor_tpu.estimation import alignment_properties as ap  # noqa: E402

hook(ap, "estimate", "props_estimate")
from varlociraptor_tpu.evidence import realignment as rl, variants as vr, indels as idl, edit_distance as ed  # noqa: E402
hook(rl.Realigner, "allele_support", "rl.allele_support")
hook(rl.Realigner, "flush_scout", "rl.flush_scout")
hook(rl.Realigner, "collect_requests", "rl.collect_requests")
hook(rl.Realigner, "_patched_window", "rl._patched_window")
hook(ed, "derive_patched_allele", "ed.derive_patched_allele")


from varlociraptor_tpu.evidence import observation as ob  # noqa: E402
hook(ob, "process_observations")
hook(ob, "adjust_prob_mapping")
hook(extraction, "subsample_keep_mask")

# run the bench main
sys.argv = ["bench_preprocess_real.py", sys.argv[1] if len(sys.argv) > 1 else "2500"]
import runpy  # noqa: E402

t0 = time.perf_counter()
try:
    runpy.run_path("scripts/bench_preprocess_real.py", run_name="__main__")
except SystemExit:
    pass
total = time.perf_counter() - t0
print(f"total {total:.2f}s")
acc = 0.0
for k, (s, n) in sorted(T.items(), key=lambda kv: -kv[1][0]):
    print(f"  {k:34s} {s:7.2f}s  ({n} calls)")
