#!/usr/bin/env python
"""Benchmark: loci/sec/chip for posterior evaluation (tumor-normal).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Timing methodology: every timed iteration materializes ALL engine outputs
on the host (np.asarray), which waits for the device. A scaling sanity
check asserts wall-time grows with n_loci before the number is trusted.
The headline is the dispatch-ahead steady state (window i+1 computes while
window i's single packed output buffer is fetched) — the same
PendingWindow pattern the production caller uses; `extra.roofline` carries
the serial number, the compute-only split, the output bytes/locus and XLA
cost-analysis flops.

Needs a GPU: exits non-zero when JAX's first device is not one. The JSON
names the platform, device kind and count, and the card's name and power
limit.

The reference publishes no benchmark numbers (BASELINE.md) and cannot be
built in this image (no Rust toolchain), so vs_baseline is MEASURED against
the same engine + same locus batch on this host's XLA CPU backend
(scripts/bench_posterior_cpu.py, all cores); the measured figure is reported
alongside. The `extra` key carries the end-to-end pipeline number
(BAM -> preprocess x2 -> tumor-normal call -> FDR; scripts/bench_e2e.py).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

NOMINAL_BASELINE_LOCI_PER_SEC = 1000.0  # fallback if the CPU run fails


def _measured_cpu_baseline(n_loci=8192):
    """Same engine + inputs on the XLA CPU backend, in a subprocess (this
    process holds the GPU).  Returns (loci/s, flops_per_program,
    hbm_bytes_per_program) — the latter two from XLA cost analysis of the
    identical HLO (roofline provenance)."""
    try:
        out = subprocess.run(
            [sys.executable, os.path.join(SCRIPTS, "bench_posterior_cpu.py"), str(n_loci)],
            capture_output=True,
            text=True,
            timeout=420,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        lines = out.stdout.strip().splitlines()
        flops = next(
            (float(ln.split()[1]) for ln in lines if ln.startswith("FLOPS ")),
            None,
        )
        nbytes = next(
            (
                float(ln.split()[1])
                for ln in lines
                if ln.startswith("HBM_BYTES ")
            ),
            None,
        )
        return float(lines[-1]), flops, nbytes
    except Exception:  # noqa: BLE001
        return None, None, None


def _bench_e2e():
    try:
        sys.path.insert(0, SCRIPTS)
        from bench_e2e import run as e2e_run

        return e2e_run(n_candidates=3000, workers=4)
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"[:160]}


def _bench_e2e_large():
    """>=100K-candidate planted-variants witness (scripts/bench_e2e_large).
    Runs INLINE (the call stage must share this process's GPU); the world
    is simulated anew, at 20K candidates to bound the set-up."""
    try:
        sys.path.insert(0, SCRIPTS)
        import bench_e2e_large as bel

        return bel.run(n_candidates=20_000, workers=4)
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"[:160]}


def _bench_call_rate():
    """Production call-stage rate on cached real observation files, with
    the per-stage breakdown.  Uses the largest cached
    /tmp/vlt_prof_obs_* workload (generates a 20K one if none)."""
    try:
        import time as _t
        from pathlib import Path as _P

        sys.path.insert(0, SCRIPTS)
        from profile_call import ensure_obs

        n = next(
            (
                k
                for k in (100000, 50000, 20000, 10000)
                if _P(f"/tmp/vlt_prof_obs_{k}/tumor.obs.jsonl").exists()
            ),
            20000,
        )
        obs = ensure_obs(n)
        from varlociraptor_tpu.calling import fastcall, observations
        from varlociraptor_tpu.calling import columnar as colmod
        from varlociraptor_tpu.calling.call import CallOptions, call_generic
        from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario

        stages = {}

        def hook(owner, name, key):
            fn = getattr(owner, name)
            stages[key] = [0.0, 0]

            def timed(*a, **k):
                t0 = _t.perf_counter()
                r = fn(*a, **k)
                stages[key][0] += _t.perf_counter() - t0
                stages[key][1] += 1
                return r

            setattr(owner, name, timed)
            return fn

        orig = [
            (observations.ObservationReader, "read_window",
             hook(observations.ObservationReader, "read_window", "read_obs")),
            (colmod.ColumnarBatch, "from_sample_windows",
             hook(colmod.ColumnarBatch, "from_sample_windows", "build_cb")),
            (fastcall.ColumnarCaller, "call_window_cb",
             hook(fastcall.ColumnarCaller, "call_window_cb", "pack_dispatch")),
            (fastcall.PendingWindow, "finish",
             hook(fastcall.PendingWindow, "finish", "wait_fetch_unpack")),
            (fastcall.ColumnarCaller, "format_window_text",
             hook(fastcall.ColumnarCaller, "format_window_text", "format")),
        ]
        try:
            rates = []
            for i in range(3):
                for v in stages.values():
                    v[0], v[1] = 0.0, 0
                t0 = _t.perf_counter()
                cnt = call_generic(
                    tumor_normal_scenario(0.75), obs,
                    _P("/tmp/bench_calls.vcf"),
                    CallOptions(batch_size=4096),
                )
                rates.append(cnt / (_t.perf_counter() - t0))
        finally:
            for owner, name, fn in orig:
                setattr(owner, name, fn)
        return {
            "n_loci": cnt,
            "loci_per_sec_warm": round(max(rates), 1),
            "runs": [round(r, 1) for r in rates],
            "stage_seconds_last_run": {
                k: round(v[0], 2) for k, v in stages.items()
            },
            "note": (
                "stages overlap (dispatch thread + drain thread); "
                "pack_dispatch includes the async device dispatch"
            ),
        }
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"[:160]}


def _timed(engine, inputs, n_iter, pipelined=True):
    import jax.numpy as jnp

    args = [jnp.asarray(a) for a in inputs]
    # engine.run is the production path: it materializes EVERY output on
    # the host (posteriors, MAP AFs, deci-PHRED AFDs, MAP artifact slots),
    # packed into ONE output buffer fetch
    out = engine.run(*args)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    if not pipelined:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = engine.run(*args)
        return time.perf_counter() - t0
    # dispatch-ahead steady state: window i+1 computes on the device while
    # window i's output buffer is fetched and unpacked — exactly how
    # the production caller consumes the engine (fastcall.PendingWindow);
    # every iteration still fully host-materializes every output.
    t0 = time.perf_counter()
    prev = engine.run(*args, fetch=False)
    for _ in range(n_iter - 1):
        nxt = engine.run(*args, fetch=False)
        out = engine.fetch_run(prev)
        prev = nxt
    out = engine.fetch_run(prev)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    return time.perf_counter() - t0


def _timed_compute_only(engine, inputs, n_iter):
    """Device-compute time alone: the same program reduced to one scalar so
    the device->host transfer is ~0 bytes (roofline split of compute vs
    fetch)."""
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(a) for a in inputs]
    L = args[0].shape[0]
    n_art = jnp.full(
        (L,), float(engine.n_artifact_combos or 1), dtype=jnp.float32
    )
    try:
        fn = jax.jit(
            lambda *a: jnp.sum(
                engine._pack_out(engine._run_impl(*a), a[1])
            )
        )
        np.asarray(fn(*args, None, n_art))
    except Exception:  # noqa: BLE001
        return None
    t0 = time.perf_counter()
    for _ in range(n_iter):
        np.asarray(fn(*args, None, n_art))
    return time.perf_counter() - t0


def _device():
    """JAX's first device and the card's name and power limit; exits
    non-zero when there is no GPU."""
    from varlociraptor_tpu.utils.device import require_gpu

    device, card = require_gpu()
    return {
        "platform": device["platform"],
        "device_kind": device["kind"],
        "count": device["count"],
        "card": card,
    }


def main():
    device = _device()
    from varlociraptor_tpu.utils.jaxcache import enable as enable_xla_cache

    enable_xla_cache()
    from varlociraptor_tpu.bench_utils import engine_inputs, tumor_normal_engine

    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    depth = 64

    _, engine = tumor_normal_engine()

    # scaling sanity check: if wall-time does not grow with the locus count,
    # we are measuring dispatch, not execution — refuse to report.
    small = max(n_loci // 4, 64)
    small_inputs = engine_inputs(engine, n_loci=small, depth=depth)
    t_small = min(_timed(engine, small_inputs, 2) for _ in range(3))
    # best of three measurement rounds; every round forces full host
    # materialization of all outputs
    inputs = engine_inputs(engine, n_loci=n_loci, depth=depth)
    n_iter, rounds = 5, 3
    dt = min(_timed(engine, inputs, n_iter) for _ in range(rounds))
    dt_serial = min(
        _timed(engine, inputs, n_iter, pipelined=False) for _ in range(rounds)
    )
    dtc = _timed_compute_only(engine, inputs, n_iter)
    dt_compute = dtc / n_iter if dtc else None
    per_iter_small = t_small / 2
    per_iter_big = dt / n_iter
    if per_iter_big < 1.5 * per_iter_small and n_loci >= 4 * small:
        print(
            json.dumps(
                {
                    "metric": "loci_per_sec_per_chip_posterior_tumor_normal",
                    "value": 0.0,
                    "unit": "loci/s",
                    "vs_baseline": 0.0,
                    "device": device,
                    "error": "timing does not scale with n_loci (dispatch-only measurement)",
                }
            )
        )
        sys.exit(1)

    loci_per_sec = n_loci * n_iter / dt

    cpu_rate, flops, hbm_bytes = _measured_cpu_baseline()
    provenance = (
        "same engine + same batch on this host's XLA CPU backend "
        "(scripts/bench_posterior_cpu.py)"
        if cpu_rate
        else "nominal (CPU baseline run failed)"
    )
    baseline = cpu_rate if cpu_rate else NOMINAL_BASELINE_LOCI_PER_SEC
    # roofline: split the per-window wall time into device compute vs the
    # packed output fetch, and report HLO flops (XLA cost analysis of the
    # identical program at the CPU-baseline batch, scaled per locus)
    roofline = {
        "wire_bytes_per_locus": round(engine.wire_bytes(n_loci) / n_loci, 1),
        "methodology": (
            "headline = dispatch-ahead steady state (window i+1 computes "
            "while window i's output buffer transfers + unpacks; the "
            "production caller's PendingWindow pattern); every window "
            "fully host-materializes every output"
        ),
    }
    per_it_serial = dt_serial / n_iter
    roofline["serial_loci_per_sec"] = round(n_loci / per_it_serial, 1)
    if dt_compute:
        roofline["device_compute_loci_per_sec"] = round(n_loci / dt_compute, 1)
        fetch_s = max(per_it_serial - dt_compute, 1e-9)
        roofline["fetch_mb_per_s"] = round(
            engine.wire_bytes(n_loci) / fetch_s / 1e6, 1
        )
    if flops:
        # flops is for the CPU-baseline batch (8192 loci by default)
        flops_per_locus = flops / 8192.0
        roofline["flops_per_locus"] = round(flops_per_locus, 1)
        roofline["achieved_gflops"] = round(
            flops_per_locus * loci_per_sec / 1e9, 2
        )
        if dt_compute:
            roofline["device_gflops"] = round(
                flops_per_locus * n_loci / dt_compute / 1e9, 2
            )
    if hbm_bytes:
        roofline["hbm_bytes_per_locus"] = round(hbm_bytes / 8192.0, 1)
        roofline["hbm_bytes_provenance"] = (
            "XLA cost-analysis of the CPU-backend HLO (operand-use "
            "accounting, NOT device memory traffic)"
        )
    extra = {
        "e2e": _bench_e2e(),
        # call_rate first: it traces/warms the batch-4096 window programs
        # that e2e_large's call stage then reuses
        "call_rate": _bench_call_rate(),
        "e2e_large": _bench_e2e_large(),
        "roofline": roofline,
        "baseline_cpu_loci_per_sec": round(cpu_rate, 1) if cpu_rate else None,
        "baseline_provenance": provenance,
    }
    print(
        json.dumps(
            {
                "metric": "loci_per_sec_per_chip_posterior_tumor_normal",
                "value": round(float(loci_per_sec), 1),
                "unit": "loci/s",
                "vs_baseline": round(loci_per_sec / baseline, 2),
                "device": device,
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
