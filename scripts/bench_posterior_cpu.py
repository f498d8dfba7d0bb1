#!/usr/bin/env python
"""Measured CPU baseline for bench.py's vs_baseline: the SAME posterior
engine and the SAME synthetic locus batch as the GPU headline metric, run on
the XLA CPU backend of this host (all cores).  Prints one float: loci/s.

This replaces the round-1/2 nominal 1000 loci/s with a number that has
provenance (VERDICT round-2 item 5): the reference publishes no benchmark
figures and cannot be built in this image (no Rust toolchain), so the
sanctioned stand-in is the repo's own CPU path on identical inputs.
"""

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from varlociraptor_tpu.utils.jaxcache import enable as _exc

    _exc()
    import numpy as np
    from varlociraptor_tpu.bench_utils import engine_inputs, tumor_normal_engine

    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    depth = 64
    _, engine = tumor_normal_engine()
    import jax.numpy as jnp

    args = [jnp.asarray(a) for a in engine_inputs(engine, n_loci=n_loci, depth=depth)]
    out = engine.run(*args)  # compile + warm
    assert all(isinstance(v, np.ndarray) for v in out.values())
    n_iter = 3
    t0 = time.perf_counter()
    for _ in range(n_iter):
        engine.run(*args)
    dt = time.perf_counter() - t0
    # XLA cost analysis of the identical program (roofline provenance for
    # bench.py extra.roofline: flops here are backend-independent HLO
    # counts).  "FLOPS <n>" goes on a prefix line; the rate stays last.
    try:
        n_art = jnp.full((n_loci,), float(engine.n_artifact_combos or 1),
                         dtype=jnp.float32)
        cost = (
            engine._run_packed.lower(*args, None, n_art)
            .compile()
            .cost_analysis()
        )
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        print(f"FLOPS {cost.get('flops', 0.0)}")
        print(f"HBM_BYTES {cost.get('bytes accessed', 0.0)}")
    except Exception:  # noqa: BLE001
        pass
    print(n_loci * n_iter / dt)


if __name__ == "__main__":
    main()
