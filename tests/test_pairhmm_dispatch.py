"""Which pair-HMM forward serves a batch, and how a ragged batch is padded
for the XLA wavefronts.

On the CPU backend the native C++ forward serves every gap model; on any
other backend the XLA anti-diagonal wavefront does (``_forward_hp_impl``
for homopolymer mode). ``forward_counts`` records which path ran."""

import math

import numpy as np
import pytest

from varlociraptor_tpu.estimation.alignment_properties import GapParams, HopParams
from varlociraptor_tpu.ops import pairhmm
from varlociraptor_tpu.ops.pairhmm import (
    NEG_INF,
    BatchedPairHMM,
    device_panels,
    ragged_panel,
)

ZERO_EXT = GapParams()
FINITE_EXT = GapParams(
    prob_insertion_artifact=math.log(1e-4),
    prob_deletion_artifact=math.log(1e-4),
    prob_insertion_extend_artifact=math.log(0.4),
    prob_deletion_extend_artifact=math.log(0.5),
)


@pytest.mark.parametrize(
    "mode,expected", [("exact", "wavefront"), ("homopolymer", "hp_wavefront")]
)
def test_device_path_by_mode(mode, expected):
    hop = HopParams() if mode == "homopolymer" else None
    assert BatchedPairHMM(FINITE_EXT, hop_params=hop, mode=mode).device_path() == expected


@pytest.mark.parametrize(
    "native,backend,gap,path",
    [
        ("1", "cpu", FINITE_EXT, "native"),
        ("1", "cpu", ZERO_EXT, "native"),
        ("0", "gpu", FINITE_EXT, "wavefront"),
        ("0", "gpu", ZERO_EXT, "wavefront"),
    ],
)
def test_forward_follows_the_path_and_counts_items(monkeypatch, native, backend,
                                                   gap, path):
    """forward() sends the batch down one path, counts its items there, and
    the native and wavefront paths agree on the same batch."""
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", native)
    monkeypatch.setattr(pairhmm.jax, "default_backend", lambda: backend)
    pairhmm.forward_counts.clear()
    alleles = [b"ACGTACGTAC", b"TTGACCA"]
    reads = [np.frombuffer(b"GTACG", np.uint8), np.frombuffer(b"GACC", np.uint8)]
    quals = [np.full(5, 30, np.uint8), np.full(4, 30, np.uint8)]
    out = BatchedPairHMM(gap).forward(alleles, reads, quals, [None, None])
    assert dict(pairhmm.forward_counts) == {path: 2}
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "1" if native == "0" else "0")
    other = BatchedPairHMM(gap).forward(alleles, reads, quals, [None, None])
    np.testing.assert_allclose(out, other, rtol=1e-4)


@pytest.mark.parametrize(
    "alens,rlens,rows",
    [([40, 300], [30, 100], 8), ([10], [1], 8), ([129] * 70, [150] * 70, 128)],
)
def test_device_panels_pad_ragged_batches(alens, rlens, rows):
    """Bytes land in their own rows, uppercased; pad rows get length 1;
    log miscalls stop at each read's end; bands default to -1 (full)."""
    rng = np.random.default_rng(0)
    alleles = [bytes(rng.choice(list(b"acgtACGT"), n).astype(np.uint8)) for n in alens]
    reads = [rng.choice(list(b"ACGTN"), n).astype(np.uint8) for n in rlens]
    quals = [rng.integers(2, 41, n).astype(np.uint8) for n in rlens]
    X = -(-max(alens) // 32) * 32
    Y = -(-max(rlens) // 32) * 32
    bands = [None] * (len(alens) - 1) + [7]
    allele, alen, read, rlen, mis, medge = device_panels(
        alleles, reads, quals, bands, rows, X, Y
    )
    n = len(alens)
    assert allele.shape == (rows, X) and read.shape == mis.shape == (rows, Y)
    np.testing.assert_array_equal(alen[:n], alens)
    np.testing.assert_array_equal(rlen[:n], rlens)
    assert (alen[n:] == 1).all() and (rlen[n:] == 1).all()
    for k in range(n):
        assert bytes(allele[k, : alens[k]]) == alleles[k].upper()
        assert not allele[k, alens[k]:].any()
        np.testing.assert_array_equal(read[k, : rlens[k]], reads[k])
        np.testing.assert_allclose(
            mis[k, : rlens[k]], -quals[k].astype(float) * math.log(10) / 10,
            rtol=1e-6,
        )
        assert (mis[k, rlens[k]:] == np.float32(NEG_INF)).all()
    assert list(medge[:n]) == [-1] * (n - 1) + [7] and (medge[n:] == -1).all()


def test_ragged_panel_accepts_bytes_arrays_and_lists():
    items = [b"AC", np.frombuffer(b"GTA", np.uint8), bytearray(b"CG")]
    panel, lens = ragged_panel(items, 4, 4)
    assert list(lens) == [2, 3, 2]
    assert [bytes(r) for r in panel] == [b"AC\0\0", b"GTA\0", b"CG\0\0", b"\0" * 4]
    # wider items are refused, not cast
    with pytest.raises(TypeError):
        ragged_panel([np.array([30, 31], np.int64)], 1, 4)
    with pytest.raises(TypeError):
        ragged_panel([[67, 71]], 1, 4)


def test_empty_read_gives_the_empty_result(monkeypatch):
    """A zero-length read window has no path: the wavefront returns its
    -1e30 floor, not a positive log-prob from a pad column."""
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    out = BatchedPairHMM(ZERO_EXT).forward(
        [b"ACGTACGTAC", b"ACGTACGTAC"],
        [np.zeros(0, np.uint8), np.frombuffer(b"ACGT", np.uint8)],
        [np.zeros(0, np.uint8), np.full(4, 30, np.uint8)],
    )
    assert out[0] <= NEG_INF / 2
    # ACGT matches at 2 start positions -> ~log(2*(1-1e-3)^4)
    assert abs(out[1] - math.log(2.0)) < 0.05
