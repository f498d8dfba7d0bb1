"""Native C++ linear-space pair-HMM forward vs the JAX wavefront kernel.

Both implement the model of ops/pairhmm.py (semiglobal, free allele-axis
gaps); the native path serves the CPU preprocess backend, so it must agree
with the device kernel to f32 tolerance on random workloads.
"""

import math

import numpy as np
import pytest

from varlociraptor_tpu.io.native import available
from varlociraptor_tpu.ops.pairhmm import BatchedPairHMM


class _GapParams:
    prob_insertion_artifact = math.log(2.8e-6)
    prob_deletion_artifact = math.log(5.1e-6)
    prob_insertion_extend_artifact = -np.inf
    prob_deletion_extend_artifact = -np.inf


class _GapParamsExt(_GapParams):
    prob_insertion_extend_artifact = math.log(1e-3)
    prob_deletion_extend_artifact = math.log(2e-3)


def _workload(seed, n=40):
    rng = np.random.default_rng(seed)
    alleles, reads, quals = [], [], []
    for _ in range(n):
        la = int(rng.integers(8, 150))
        lr = int(rng.integers(5, 120))
        al = bytes(rng.choice([65, 67, 71, 84], la).astype(np.uint8))
        if rng.random() < 0.7 and la > lr:
            s = int(rng.integers(0, la - lr))
            rd = bytearray(al[s : s + lr])
            for k in range(len(rd)):
                if rng.random() < 0.05:
                    rd[k] = int(rng.choice([65, 67, 71, 84]))
            rd = bytes(rd)
        else:
            rd = bytes(rng.choice([65, 67, 71, 84, 78], lr).astype(np.uint8))
        alleles.append(al)
        reads.append(np.frombuffer(rd, np.uint8))
        quals.append(rng.integers(10, 45, lr).astype(np.uint8))
    return alleles, reads, quals


@pytest.mark.skipif(not available(), reason="native library unavailable")
@pytest.mark.parametrize("gp", [_GapParams, _GapParamsExt])
def test_native_matches_jax_forward(gp):
    hmm = BatchedPairHMM(gp())
    alleles, reads, quals = _workload(3)
    hmm._use_native = True
    nat = hmm.forward(alleles, reads, quals)
    hmm._use_native = False
    jx = hmm.forward(alleles, reads, quals)
    finite = (jx > -9e29) & (nat > -9e29)
    assert (finite == ((jx > -9e29) | (nat > -9e29))).all()  # agree on zeros
    np.testing.assert_allclose(nat[finite], jx[finite], atol=5e-3, rtol=1e-4)


@pytest.mark.skipif(not available(), reason="native library unavailable")
def test_myers_hybrid_matches_full_dp():
    """Myers bit-parallel + windowed traceback must equal the full O(nm) DP
    (edit_distance.rs:132-158 parity) on random long-window workloads,
    including patterns > 64 (two-block Myers)."""
    from varlociraptor_tpu.io.native import semiglobal_edit, semiglobal_edit_hybrid

    rng = np.random.default_rng(13)
    for _ in range(200):
        n = int(rng.integers(256, 520))
        m = int(rng.integers(5, 128))
        text = bytes(rng.choice([65, 67, 71, 84], n).astype(np.uint8))
        if rng.random() < 0.7:
            s = int(rng.integers(0, n - m))
            rd = bytearray(text[s : s + m])
            for k in range(len(rd)):
                p = rng.random()
                if p < 0.04:
                    rd[k] = int(rng.choice([65, 67, 71, 84]))
            # occasional indel
            if rng.random() < 0.3 and len(rd) > 6:
                del rd[int(rng.integers(0, len(rd) - 1))]
            read = bytes(rd)
        else:
            read = bytes(rng.choice([65, 67, 71, 84], m).astype(np.uint8))
        full = semiglobal_edit(text, read)
        hyb = semiglobal_edit_hybrid(text, read)
        assert full[0] == hyb[0], (full[0], hyb[0])  # distance
        assert full[1] == hyb[1], "first traceback start"
        assert full[2] == hyb[2], "ops"
        assert full[3] == hyb[3], "last co-optimal start"
