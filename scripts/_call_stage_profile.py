"""Single-process call-stage breakdown on the live backend (VERDICT r4
item 1: publish the stage breakdown).  Hooks the columnar pipeline's
stages across both the dispatch thread and the drain thread.

Usage: python scripts/_call_stage_profile.py [N] [--batch B] [--runs R]
"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from profile_call import ensure_obs  # noqa: E402

n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 10000
batch = (
    int(sys.argv[sys.argv.index("--batch") + 1])
    if "--batch" in sys.argv
    else 4096
)
runs = int(sys.argv[sys.argv.index("--runs") + 1]) if "--runs" in sys.argv else 3
obs = ensure_obs(n)

from varlociraptor_tpu.calling import columnar, fastcall, observations  # noqa: E402
from varlociraptor_tpu.calling.call import CallOptions, call_generic  # noqa: E402
from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario  # noqa: E402
from varlociraptor_tpu.ops import posterior as post_mod  # noqa: E402

T = {}


def hook(owner, name, key):
    fn = getattr(owner, name)
    T[key] = [0.0, 0]

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        T[key][0] += time.perf_counter() - t0
        T[key][1] += 1
        return r

    setattr(owner, name, timed)


hook(observations.ObservationReader, "read_window", "read_obs")
hook(columnar.ColumnarBatch, "from_sample_windows", "build_cb")
hook(fastcall.ColumnarCaller, "call_window_cb", "pack+dispatch")
_orig_piw = post_mod.PosteriorEngine.pack_in_wire
T["  pack_in_wire"] = [0.0, 0]
def _piw(spec, arrays):
    t0 = time.perf_counter()
    r = _orig_piw(spec, arrays)
    T["  pack_in_wire"][0] += time.perf_counter() - t0
    T["  pack_in_wire"][1] += 1
    return r
post_mod.PosteriorEngine.pack_in_wire = staticmethod(_piw)
_orig_rw = post_mod.PosteriorEngine.run_wire
T["  rw.asarray"] = [0.0, 0]
T["  rw.fncall"] = [0.0, 0]
T["  rw.other"] = [0.0, 0]
import jax.numpy as _jnp
def _rw(self, wire_in, Np, L, D, Bc, pj_shape=None, fetch=True):
    t0 = time.perf_counter()
    key = (int(Np), int(L), int(D), int(Bc), pj_shape)
    cache = getattr(self, "_run_wire_cache", None)
    have = cache is not None and key in cache
    if not have:
        r = _orig_rw(self, wire_in, Np, L, D, Bc, pj_shape=pj_shape, fetch=fetch)
        T["  rw.other"][0] += time.perf_counter() - t0
        T["  rw.other"][1] += 1
        return r
    fn = cache[key]
    xb = _jnp.asarray(wire_in)
    t1 = time.perf_counter()
    w = fn(xb)
    t2 = time.perf_counter()
    T["  rw.asarray"][0] += t1 - t0; T["  rw.asarray"][1] += 1
    T["  rw.fncall"][0] += t2 - t1; T["  rw.fncall"][1] += 1
    if not fetch:
        return w, L
    import numpy as _np
    return self._unpack_host(_np.asarray(w), L)
post_mod.PosteriorEngine.run_wire = _rw
from varlociraptor_tpu.calling import columnar as _colmod
hook(_colmod.ColumnarBatch, "learn_and_gate", "learn_and_gate")
hook(_colmod.ColumnarBatch, "pack_flat", "pack_flat")
hook(fastcall.PendingWindow, "finish", "finish(wait+fetch+unpack)")
hook(fastcall.ColumnarCaller, "format_window_text", "format_text")

for i in range(runs):
    for v in T.values():
        v[0], v[1] = 0.0, 0
    t0 = time.perf_counter()
    cnt = call_generic(
        tumor_normal_scenario(0.75),
        obs,
        Path("/tmp/bench_calls.vcf"),
        CallOptions(batch_size=batch),
    )
    dt = time.perf_counter() - t0
    print(f"run {i}: {cnt} loci in {dt:.2f}s = {cnt/dt:.0f} loci/s")
    for k, (s, c) in T.items():
        print(f"   {k:28s} {s:6.2f}s ({c} calls)")
