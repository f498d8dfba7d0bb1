"""Worker for the true multi-process (multi-host-style) sharding test.

Run by tests/test_multihost.py as 2 separate processes, each with 4 local
CPU devices (8 global).  Exercises the DCN story end-to-end: distributed
init -> global mesh -> run_sharded over process-local loci blocks ->
collective all_gather_rows (the global-FDR reduction) -> per-process
output dump for the parent to verify against a single-process run.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]
outdir = sys.argv[3]

jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from varlociraptor_tpu.bench_utils import (  # noqa: E402
    engine_inputs,
    tumor_normal_engine,
)
from varlociraptor_tpu.parallel.sharding import (  # noqa: E402
    all_gather_rows,
    distributed_mesh,
    run_sharded,
)

assert jax.process_count() == 2
assert jax.device_count() == 8

mesh = distributed_mesh()

# identical full input batch on both processes (same seed); each process
# keeps only its own half — the multi-host input pipeline contract
_, engine = tumor_normal_engine()
L, HALF = 48, 24
full = engine_inputs(engine, n_loci=L, depth=16, seed=11)
local = [np.asarray(a)[pid * HALF : (pid + 1) * HALF] for a in full]

out = run_sharded(engine, mesh, *local)

# ragged collective gather (the global-FDR statistic merge): process 0
# contributes 3 rows, process 1 contributes 5
rows = {
    0: np.array([[1.5, -2.25], [3.0, 4.5], [-1.0, 0.125]], dtype=np.float64),
    1: np.arange(10, dtype=np.float64).reshape(5, 2) / 3.0,
}
gathered = all_gather_rows(rows[pid], mesh)
# device-order concat preserves row order: proc 0's rows then proc 1's,
# bit-exact f64 (the int32-pair bits trick)
expected = np.concatenate([rows[0], rows[1]])
assert gathered.shape == expected.shape, gathered.shape
assert np.array_equal(gathered, expected), gathered

np.savez(
    os.path.join(outdir, f"proc{pid}.npz"),
    posteriors=out["posteriors"],
    af=out["af"],
    marginal=out["marginal"],
    dphred=out["densities_dphred"],
    gathered=gathered,
)
print(f"proc {pid} ok", flush=True)
