"""Differential test: the vectorized SNV observation fast path
(variants.snv_vector_observations) vs the scalar scout/replay machinery
(VLT_FAST_SNV=0) must produce identical observations — including mixed
pileups where indel-op reads route to the realigner."""

import json
import os
from pathlib import Path

import numpy as np
import pytest

RES = Path("/root/reference/tests/resources")


def _extract(monkeypatch, fast: bool, tmp_path, n=400):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    from bench_preprocess import make_candidates

    from varlociraptor_tpu.calling.preprocess import (
        PreprocessOptions,
        preprocess,
    )

    monkeypatch.setenv("VLT_FAST_SNV", "1" if fast else "0")
    cand = tmp_path / "c.vcf"
    make_candidates(n, cand)
    monkeypatch.setenv("VLT_OBS_FORMAT", "jsonl")
    out = tmp_path / f"obs_{fast}.jsonl"
    preprocess(
        cand,
        RES / "tumor-first30000.bam",
        RES / "chr10.fa",
        out,
        sample_name="s",
        options=PreprocessOptions(log_mode="silent"),
    )
    return out.read_text()


@pytest.mark.skipif(not RES.exists(), reason="resources missing")
def test_fast_snv_matches_scalar(monkeypatch, tmp_path):
    a = _extract(monkeypatch, True, tmp_path)
    b = _extract(monkeypatch, False, tmp_path)
    # headers embed option provenance; compare records only
    ra = a.splitlines()[1:]
    rb = b.splitlines()[1:]
    assert len(ra) == len(rb)
    for la, lb in zip(ra, rb):
        assert json.loads(la) == json.loads(lb)
