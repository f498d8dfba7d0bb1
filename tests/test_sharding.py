"""Shard-count invariance + multi-device mesh tests (virtual 8-device CPU).

The reference guarantees determinism via seeded subsampling and ordered maps
(SURVEY.md §5); the batched equivalent is shard-count-invariant output: the same
posteriors regardless of how the locus batch is split over devices.
"""

import numpy as np
import pytest

import jax

from varlociraptor_tpu.parallel.sharding import locus_mesh, run_sharded


@pytest.fixture(scope="module")
def engine_and_inputs():
    from varlociraptor_tpu.bench_utils import engine_inputs, tumor_normal_engine

    _, engine = tumor_normal_engine(resolution=0.1)
    inputs = engine_inputs(engine, n_loci=16, depth=8, seed=3)
    return engine, inputs


def test_eight_devices_visible():
    assert len(jax.devices()) == 8


def test_sharded_matches_single(engine_and_inputs):
    from varlociraptor_tpu.parallel.sharding import locus_mesh, run_sharded

    engine, inputs = engine_and_inputs
    ref = engine.run(*inputs)

    mesh = locus_mesh(jax.devices())
    out = run_sharded(engine, mesh, *inputs)
    np.testing.assert_allclose(
        out["posteriors"], ref["posteriors"], rtol=1e-5, atol=1e-5
    )


def test_shard_count_invariance(engine_and_inputs):
    from varlociraptor_tpu.parallel.sharding import locus_mesh, run_sharded

    engine, inputs = engine_and_inputs
    out2 = run_sharded(engine, locus_mesh(jax.devices()[:2]), *inputs)
    out8 = run_sharded(engine, locus_mesh(jax.devices()[:8]), *inputs)
    np.testing.assert_allclose(
        out2["posteriors"], out8["posteriors"], rtol=1e-5, atol=1e-5
    )


def test_batch_split_invariance(engine_and_inputs):
    """Evaluating loci in two half-batches equals one batch (padding-free)."""
    engine, inputs = engine_and_inputs
    full = engine.run(*inputs)
    half_a = engine.run(*[a[:8] for a in inputs])
    half_b = engine.run(*[a[8:] for a in inputs])
    np.testing.assert_allclose(
        np.concatenate([half_a["posteriors"], half_b["posteriors"]]),
        full["posteriors"],
        rtol=1e-5,
        atol=1e-5,
    )


def test_mutual_contamination_shard_invariance():
    """The contamination-forest contraction (2-cycle) must be shard-invariant
    on the device mesh like the plain pair case."""
    import math

    from varlociraptor_tpu.bench_utils import engine_inputs
    from varlociraptor_tpu.grammar.compiler import compile_scenario_events
    from varlociraptor_tpu.grammar.scenario import Scenario
    from varlociraptor_tpu.ops.grid import AFGrid
    from varlociraptor_tpu.ops.posterior import PosteriorEngine, SampleConfig
    from varlociraptor_tpu.parallel.sharding import locus_mesh, run_sharded

    sc = Scenario(
        {
            "samples": {
                "tumor": {
                    "universe": "[0.0,1.0]",
                    "resolution": 0.1,
                    "contamination": {"by": "normal", "fraction": 0.2},
                },
                "normal": {
                    "universe": "0.0 | 0.5 | 1.0",
                    "contamination": {"by": "tumor", "fraction": 0.05},
                },
            },
            "events": {
                "somatic": "tumor:]0.0,1.0] & normal:0.0",
                "germline": "normal:0.5 | normal:1.0",
            },
        }
    )
    events, pts = compile_scenario_events(sc, "chr1")
    grid = AFGrid.build(0.1, extra_points=pts)
    samples = [
        SampleConfig("tumor", contaminated_by=1, contamination_fraction=0.2),
        SampleConfig("normal", contaminated_by=0, contamination_fraction=0.05),
    ]
    engine = PosteriorEngine(events, grid, samples, resolution=0.1, all_uniform_prior=True)
    inputs = engine_inputs(engine, n_loci=16, depth=8, seed=11)
    ref = engine.run(*inputs)
    mesh = locus_mesh(jax.devices())
    out = run_sharded(engine, mesh, *inputs)
    np.testing.assert_allclose(out["posteriors"], ref["posteriors"], rtol=1e-5, atol=1e-5)


def test_global_fdr_sharded_equals_single(ref_tests, tmp_path):
    """Collective global FDR over region shards == single-file pass
    (fdr.rs:116-144 semantics; the all_gather merges the genome-wide
    probability distribution)."""
    from varlociraptor_tpu.filtration.fdr import control_fdr, control_fdr_sharded
    from varlociraptor_tpu.io.vcf import VcfReader, VcfWriter, open_variant_file

    src = ref_tests / "resources" / "test_fdr_ev_2" / "calls.matched.bcf"
    reader = open_variant_file(src)
    records = reader.records()
    # split into two "region" shards preserving order
    mid = len(records) // 2
    shards = []
    for i, chunk in enumerate((records[:mid], records[mid:])):
        p = tmp_path / f"shard{i}.vcf"
        with VcfWriter(
            p, sample_names=reader.sample_names, header_lines=reader.header_lines
        ) as w:
            for r in chunk:
                w.write(r)
        shards.append(p)

    n_single = control_fdr(
        src, tmp_path / "single.vcf", events=["SOMATIC"], alpha=0.05,
        vartype="deletion", min_len=1, max_len=30,
    )
    mesh = locus_mesh(jax.devices())
    n_sharded = control_fdr_sharded(
        shards, tmp_path / "sharded.vcf", events=["SOMATIC"], alpha=0.05,
        mesh=mesh, vartype="deletion", min_len=1, max_len=30,
    )
    assert n_sharded == n_single == 985
    a = VcfReader(tmp_path / "single.vcf").records()
    b = VcfReader(tmp_path / "sharded.vcf").records()
    assert [(r.chrom, r.pos, r.ref, tuple(r.alts)) for r in a] == [
        (r.chrom, r.pos, r.ref, tuple(r.alts)) for r in b
    ]


def test_sharded_call_end_to_end_identical(tmp_path):
    """GenericCaller over the 8-device mesh must produce byte-identical
    VCF output to the single-device path."""
    import filecmp

    from varlociraptor_tpu.testcase import Testcase

    tc = Testcase("/root/reference/tests/resources/testcases/test13")
    recs_single, _ = tc.run(workdir=tmp_path / "single")
    # re-run the call step with a mesh: patch call_generic's mesh via
    # GenericCaller by calling the pipeline manually
    from varlociraptor_tpu.calling.call import CallOptions, call_generic
    from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario

    obs = {
        name: tmp_path / "single" / f"{name}.obs.jsonl"
        for name in tc.doc["samples"]
    }
    mesh = locus_mesh(jax.devices())
    out_a = tmp_path / "calls_nomesh.vcf"
    out_b = tmp_path / "calls_mesh.vcf"
    scenario = tumor_normal_scenario(tc.purity())
    call_generic(scenario, obs, out_a, CallOptions())
    call_generic(scenario, obs, out_b, CallOptions(), mesh=mesh)
    assert filecmp.cmp(out_a, out_b, shallow=False)
