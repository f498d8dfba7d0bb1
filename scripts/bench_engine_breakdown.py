#!/usr/bin/env python
"""Time individual posterior-engine stages on the live backend.

Each stage is jitted separately and timed with a forced device->host fetch
of a scalar reduction.

Usage: python scripts/bench_engine_breakdown.py [n_loci] [depth]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def timed(fn, *args, n=3):
    import jax.numpy as jnp

    out = fn(*args)
    np.asarray(jnp.sum(out) if hasattr(out, "shape") else out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
        np.asarray(jnp.sum(out) if hasattr(out, "shape") else out)
    return (time.perf_counter() - t0) / n


def main():
    from varlociraptor_tpu.utils.jaxcache import enable

    enable()
    import jax
    import jax.numpy as jnp
    from varlociraptor_tpu.bench_utils import engine_inputs, tumor_normal_engine
    from varlociraptor_tpu.ops.likelihood import sample_loglik_grid
    from varlociraptor_tpu.ops.posterior import _pair_loglik_classes

    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 64

    _, engine = tumor_normal_engine()
    inputs = engine_inputs(engine, n_loci=n_loci, depth=depth)
    feats, mask, ba, br, by, active, gates, lpa = [jnp.asarray(a) for a in inputs]
    grid = jnp.asarray(engine.grid.values)
    print(f"L={n_loci} D={depth} B={ba.shape[2]} G={grid.shape[0]}")
    for si, (s, by_, frac) in enumerate(engine.pairs):
        nu_u, kappa_u, inv = engine.pair_class[s]
        print(f"pair sample {s}: U={len(nu_u)}")

    # full engine
    t_full = timed(lambda *a: engine._run(*a)["posteriors"],
                   feats, mask, ba, br, by, active, gates, lpa)
    print(f"full engine      : {t_full*1e3:9.1f} ms  ({n_loci/t_full:.0f} loci/s)")

    # stage 1: per-sample grid loglik
    f = jax.jit(sample_loglik_grid)
    t = timed(f, feats, mask, ba, br, by, grid)
    print(f"sample_loglik    : {t*1e3:9.1f} ms")

    # stage 2: contaminated pair classes
    for s, by_, frac in engine.pairs:
        nu_u, kappa_u, inv = engine.pair_class[s]
        g = jax.jit(_pair_loglik_classes)
        t = timed(
            g,
            feats[:, s],
            mask[:, s],
            ba[:, s],
            br[:, s],
            by[:, s],
            jnp.asarray(nu_u),
            jnp.asarray(kappa_u),
        )
        print(f"pair_classes s{s}  : {t*1e3:9.1f} ms")
        # the gather back to [L,B,G,G2]
        inv_a = jnp.asarray(inv)
        ll_u = g(feats[:, s], mask[:, s], ba[:, s], br[:, s], by[:, s],
                 jnp.asarray(nu_u), jnp.asarray(kappa_u))
        h = jax.jit(lambda x: x[:, :, inv_a])
        t = timed(h, ll_u)
        print(f"pair gather s{s}   : {t*1e3:9.1f} ms")


if __name__ == "__main__":
    main()
