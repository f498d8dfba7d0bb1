#!/usr/bin/env python
"""Virtual-mesh strong-scaling measurement (VERDICT round-2 item 6).

Fixed problem (N loci of the tumor-normal posterior), swept over 1/2/4/8
virtual CPU devices: measures `run_sharded` wall time per mesh size and the
`all_gather_rows` collective used by the sharded global FDR.  CPU-device
counts beyond the physical core count (4 here) measure sharding OVERHEAD,
not speedup — the point is that the shard machinery costs <~15% vs the
single-device run of the same engine, not that virtual devices scale.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/bench_mesh_scaling.py [N_LOCI]
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from varlociraptor_tpu.utils.jaxcache import enable as _exc

    _exc()
    import numpy as np
    from varlociraptor_tpu.bench_utils import engine_inputs, tumor_normal_engine
    from varlociraptor_tpu.parallel.sharding import (
        all_gather_rows,
        locus_mesh,
        run_sharded,
    )

    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    _, engine = tumor_normal_engine()
    inputs = engine_inputs(engine, n_loci=n_loci, depth=64)

    devices = jax.devices()
    results = {}
    base = None
    for n_dev in (1, 2, 4, 8):
        if n_dev > len(devices):
            break
        mesh = locus_mesh(devices[:n_dev])
        run_sharded(engine, mesh, *inputs)  # compile + warm
        t0 = time.perf_counter()
        n_iter = 3
        for _ in range(n_iter):
            out = run_sharded(engine, mesh, *inputs)
        dt = (time.perf_counter() - t0) / n_iter
        assert all(isinstance(v, np.ndarray) for v in out.values())
        if n_dev == 1:
            base = dt
        results[f"run_sharded_{n_dev}dev_s"] = round(dt, 3)
        results[f"overhead_vs_1dev_{n_dev}dev"] = round(dt / base - 1.0, 3)

    # collective gather overhead (global FDR statistics path)
    mesh8 = locus_mesh(devices[: min(8, len(devices))])
    rows = np.random.default_rng(0).normal(size=(n_loci, 4)).astype(np.float64)
    all_gather_rows(rows, mesh8)  # compile + warm
    t0 = time.perf_counter()
    for _ in range(5):
        gathered = all_gather_rows(rows, mesh8)
    results["all_gather_rows_8dev_ms"] = round((time.perf_counter() - t0) / 5 * 1e3, 2)
    assert gathered.shape[0] == n_loci

    results["n_loci"] = n_loci
    results["physical_cores"] = os.cpu_count()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
