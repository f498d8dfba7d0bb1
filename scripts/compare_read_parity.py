#!/usr/bin/env python
"""Per-read evidence parity vs the reference's own serialized observations.

Some testcase candidates embed the reference's preprocessed observations
(PROB_ALT/PROB_REF/... INFO arrays, bincode+f16 packed into u16 pairs,
preprocessing/mod.rs:921-1038).  This tool runs OUR preprocess on the same
BAM + candidate and prints, per testcase, the worst per-read deviation of
PROB_ALT and PROB_REF (compared as sorted lists — read order differs).

Usage: JAX_PLATFORMS=cpu python scripts/compare_read_parity.py [testcase ...]

CAVEAT (measured 2026-08, round 2): the embedded arrays were captured when
each testcase was CREATED, not with the snapshot reference — several show
capture-era semantics (PROB_MAPPING == 0.0 exactly i.e. no MAPQ
adjustment, PROB_MISSED_ALLELE == ln(1/4), PROB_ALT == ln(1/2) for
non-overlapping reads: test_giab_02, issue_154).  Only treat testcases
whose values match to ~f16 precision as live parity targets (test75,
test_giab_05 match to <= 1e-3); large deviations on old captures are
version drift, not necessarily bugs.
"""

import math
import os
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decode_ref_obs import decode_record_obs  # noqa: E402

RES = Path("/root/reference/tests/resources/testcases")

DEFAULT = [
    "issue_154",
    "test59",
    "test60",
    "test72",
    "test75",
    "test_false_negative_indel_call",
    "test_giab_04",
    "test_giab_05",
    "test_giab_06",
    "test_giab_08",
    "test_giab_01",
    "test_giab_02",
    "test39",
    "test43",
]


def ref_obs(tc_dir):
    """Decoded embedded observations of the first candidate record."""
    for line in open(tc_dir / "candidates.vcf"):
        if line.startswith("#"):
            continue
        cols = line.rstrip("\n").split("\t")
        return cols, decode_record_obs(cols[7])
    return None, None


def our_obs(tc_dir):
    """Run our preprocess via the Testcase machinery; return per-sample
    observation lists for the first locus."""
    from varlociraptor_tpu.testcase import Testcase
    from varlociraptor_tpu.calling.observations import ObservationReader

    tc = Testcase(tc_dir)
    workdir = Path(tempfile.mkdtemp(prefix="parity-"))
    # reuse run()'s preprocessing by monkeypatching call_generic to a no-op
    import varlociraptor_tpu.testcase as tmod

    orig = tmod.call_generic
    obs_files = {}

    def fake_call(scenario, obs_paths, out_vcf, options, **kw):
        obs_files.update(obs_paths)
        # write an empty vcf so run() completes
        with open(out_vcf, "w") as f:
            f.write("##fileformat=VCFv4.2\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")

    tmod.call_generic = fake_call
    try:
        try:
            tc.run(workdir)
        except Exception:
            pass  # empty VCF fails expectations downstream; we only need obs
    finally:
        tmod.call_generic = orig
    out = {}
    for name, path in obs_files.items():
        reader = ObservationReader(path)
        for variant, pileup in reader:
            out[name] = pileup.read_observations
            break
        reader.close()
    return out


def compare(name):
    tc_dir = RES / name
    cols, ref = ref_obs(tc_dir)
    if not ref or "PROB_ALT" not in ref:
        print(f"{name}: no embedded obs")
        return
    ours = our_obs(tc_dir)
    if not ours:
        print(f"{name}: our preprocess produced nothing")
        return
    # embedded obs belong to the single captured sample; compare against
    # each of ours and report the best-matching one
    vt = f"{cols[3][:12]}>{cols[4][:12]}"
    for sname, obs in ours.items():
        msg = []
        for field, attr in (("PROB_ALT", "prob_alt"), ("PROB_REF", "prob_ref")):
            r = sorted(ref.get(field, []))
            o = sorted(getattr(ob, attr) for ob in obs)
            if len(r) != len(o):
                msg.append(f"{field}: n {len(r)} vs {len(o)}")
                continue
            worst = max(
                (abs(a - b) for a, b in zip(r, o)), default=0.0
            )
            # f16 payloads quantize to ~2^-11 relative
            tol = max(0.02, 0.002 * max((abs(x) for x in r), default=1.0))
            flag = "" if worst <= tol else "  <-- DIVERGES"
            msg.append(f"{field}: n={len(r)} worst|d|={worst:.4f}{flag}")
        print(f"{name} [{sname}] {vt}: " + "; ".join(msg))


def main():
    names = sys.argv[1:] or DEFAULT
    for n in names:
        try:
            compare(n)
        except Exception as e:
            print(f"{n}: ERROR {type(e).__name__}: {e}")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    main()
