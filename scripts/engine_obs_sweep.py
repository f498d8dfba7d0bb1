#!/usr/bin/env python
"""Engine-level bisection sweep: reference observations -> OUR engine.

For every golden testcase whose candidates.vcf embeds the reference's own
serialized per-read observations (preprocessing/mod.rs:921-1038), decode
them into an observation file, SKIP our preprocess entirely, run only the
calling engine, and evaluate the testcase's expected assertions.

This answers the question "does our engine reproduce the reference's
posteriors when given the reference's own evidence?" — the bisection that
separates engine residuals from observation-set-composition residuals.

Cases it cannot cover (and why that is a structural fact, not a choice):
  - test07 / test18 / test20 (the three remaining FAILs): their
    candidates.vcf are raw lancet/delly candidate calls with NO embedded
    observations (grep PROB_ALT -> 0 matches), and the image has no Rust
    toolchain or prebuilt reference binary to generate any.
  - multi-sample scenarios: the reference's testcase builder embeds the
    observations of a SINGLE captured sample per record.

Usage: python scripts/engine_obs_sweep.py [testcase ...]
Writes /tmp/engine_obs_sweep.json.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from varlociraptor_tpu.calling.observations import ObservationWriter  # noqa: E402
from varlociraptor_tpu.calling.ref_obs import (  # noqa: E402
    decode_reference_observations,
    is_reference_observation_record,
)
from varlociraptor_tpu.calling.variants import collect_variants  # noqa: E402
from varlociraptor_tpu.io.vcf import VcfReader  # noqa: E402
from varlociraptor_tpu.testcase import Testcase  # noqa: E402

RES = Path("/root/reference/tests/resources/testcases")


class EngineOnlyTestcase(Testcase):
    """Testcase whose run() decodes the embedded reference observations
    instead of running our preprocess — everything downstream (scenario,
    engine, formatting, expectation evaluation) is the production path."""

    def run(self, workdir=None, pairhmm_mode=None, obs_suffix="jsonl"):
        workdir = Path(workdir or tempfile.mkdtemp(prefix="vlt-engobs-"))
        workdir.mkdir(parents=True, exist_ok=True)
        samples = list(self.doc["samples"])
        if len(samples) != 1:
            raise RuntimeError("multi-sample case: embedded obs are single-sample")
        name = samples[0]
        out = workdir / f"{name}.obs.jsonl"
        n_emb = 0
        with ObservationWriter(out, sample_name=name, format="jsonl") as w:
            for rec in VcfReader(self.dir / self.doc["candidate"]).records():
                if not is_reference_observation_record(rec):
                    continue
                pileup = decode_reference_observations(rec)
                for vinfo in collect_variants(rec, skip_imprecise=False):
                    w.write_record(vinfo, pileup)
                    n_emb += 1
        if not n_emb:
            raise RuntimeError("no embedded observations")

        from varlociraptor_tpu.calling.call import call_generic
        from varlociraptor_tpu.grammar.scenario import (
            Scenario,
            tumor_normal_scenario,
        )

        if self.mode() == "TumorNormal" and "scenario" not in self.doc:
            scenario = tumor_normal_scenario(self.purity())
        else:
            scenario = Scenario.from_path(self.dir / self.doc["scenario"])
        out_vcf = workdir / "calls.vcf"
        from varlociraptor_tpu.calling.call import CallOptions

        call_options = CallOptions(
            omit_strand_bias=self.omit("strand_bias"),
            omit_read_orientation_bias=self.omit("read_orientation_bias"),
            omit_read_position_bias=self.omit("read_position_bias"),
            omit_softclip_bias=self.omit("softclip_bias"),
            omit_homopolymer_artifact_detection=self.omit(
                "homopolymer_artifact_detection"
            ),
            omit_alt_locus_bias=self.omit("alt_locus_bias"),
        )
        call_generic(scenario, {name: out}, out_vcf, call_options)
        reader = VcfReader(out_vcf)
        return reader.records(), reader.sample_names


def sweep(names):
    results = {}
    for name in names:
        tc_dir = RES / name
        if not (tc_dir / "testcase.yaml").exists():
            continue
        try:
            ok = EngineOnlyTestcase(tc_dir).check()
            results[name] = {"status": "PASS" if ok else "FAIL"}
        except RuntimeError as e:
            results[name] = {"status": "SKIP", "reason": str(e)}
        except AssertionError as e:
            results[name] = {"status": "FAIL", "reason": str(e)[:300]}
        except Exception as e:  # undecodable ancient capture layouts etc.
            results[name] = {
                "status": "ERROR",
                "reason": f"{type(e).__name__}: {str(e)[:200]}",
            }
        print(f"{name}: {results[name]['status']}"
              + (f" ({results[name].get('reason', '')})"
                 if results[name].get("reason") else ""))
    return results


def main():
    if len(sys.argv) > 1:
        names = sys.argv[1:]
    else:
        names = sorted(
            d.name
            for d in RES.iterdir()
            if (d / "testcase.yaml").exists()
        )
    results = sweep(names)
    counts = {}
    for r in results.values():
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    print(json.dumps(counts))
    Path("/tmp/engine_obs_sweep.json").write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
