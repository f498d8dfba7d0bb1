"""The device pair-HMM forward on the card at the main path's widths.

Runs only on a GPU host (``gpu`` fixture); chip_smoke.py's kernel phase
runs the same check (``chip_smoke.kernel_check``) on the world's reads.
"""

import math

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _batch(n=4096, read_len=150, window=64, seed=0):
    """150-base reads against allele windows spanning the read plus up to
    ``window`` bases either side, as realignment builds them."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    alleles, reads, quals = [], [], []
    for _ in range(n):
        lo, hi = rng.integers(0, window + 1, 2)
        a = rng.choice(bases, read_len + lo + hi)
        r = a[lo : lo + read_len].copy()
        k = rng.integers(0, read_len, 3)
        r[k] = rng.choice(bases, 3)
        alleles.append(a.tobytes())
        reads.append(r)
        quals.append(rng.integers(20, 41, read_len).astype(np.uint8))
    return alleles, reads, quals


def test_device_forward_parity_at_real_widths(gpu):
    import chip_smoke
    from varlociraptor_tpu.estimation.alignment_properties import GapParams

    estimated = GapParams(
        prob_insertion_artifact=math.log(1e-4),
        prob_deletion_artifact=math.log(1e-4),
        prob_insertion_extend_artifact=math.log(0.5),
        prob_deletion_extend_artifact=math.log(0.5),
    )
    worst = chip_smoke.kernel_check(
        *_batch(), {"exact": GapParams(), "general": estimated}
    )
    assert max(worst.values()) <= chip_smoke.KERNEL_TOL
