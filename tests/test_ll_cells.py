"""The posterior engine's per-read likelihood sum (``_read_terms`` +
``_ll_cells`` through ``_pair_loglik_classes``) against a plain numpy f64
sum over reads of log(w*exp(A) + (1-w)*exp(R) + exp(M)).

Tolerance 1e-4 absolute per class sum: f32 over ~24 reads with the
max-scaled coefficients; the f64 sum takes no shortcut."""

import numpy as np
import pytest

from varlociraptor_tpu.evidence.observation import F, FEATURES
from varlociraptor_tpu.ops.posterior import _pair_loglik_classes


def _inputs(seed, L=16, B=3, D=24, U=37):
    rng = np.random.default_rng(seed)
    feats = np.full((L, D, len(FEATURES)), -1.0, np.float32)
    for k in ("prob_alt", "prob_ref", "prob_mapping", "prob_mismapping",
              "prob_missed_allele", "prob_sample_alt"):
        feats[..., F[k]] = np.log(rng.uniform(0.01, 1.0, (L, D)))
    mask = rng.uniform(size=(L, D)) < 0.8
    ba, br, by = (np.log(rng.uniform(0.1, 1, (L, B, D))).astype(np.float32)
                  for _ in range(3))
    nu = rng.uniform(0, 1, U).astype(np.float32)
    nu[3] = 1.0
    kappa = np.zeros(U, np.float32)
    kappa[3] = 1.0
    return feats, mask, ba, br, by, nu, kappa


def _reference(feats, mask, ba, br, by, nu, kappa):
    f = feats.astype(np.float64)[:, None, :, :]  # [L,1,D,Fe]
    A = f[..., F["prob_mapping"]] + ba + f[..., F["prob_alt"]]
    R = f[..., F["prob_mapping"]] + br + f[..., F["prob_ref"]]
    M = f[..., F["prob_mismapping"]] + f[..., F["prob_missed_allele"]] + by
    psa = np.exp(np.minimum(f[..., F["prob_sample_alt"]], 0.0))  # [L,1,D]
    w = psa[:, :, None, :] * nu[:, None] + kappa[:, None] * (1 - psa[:, :, None, :])
    w = np.clip(w, 0.0, 1.0)  # [L,1,U,D]
    per_read = np.log(
        w * np.exp(A)[:, :, None, :]
        + (1 - w) * np.exp(R)[:, :, None, :]
        + np.exp(M)[:, :, None, :]
    )
    return np.where(mask[:, None, None, :], per_read, 0.0).sum(-1)  # [L,B,U]


@pytest.mark.parametrize("seed", [0, 7])
def test_ll_classes_matches_numpy_f64(seed):
    import jax.numpy as jnp

    args = _inputs(seed)
    got = np.asarray(_pair_loglik_classes(*(jnp.asarray(a) for a in args)))
    ref = _reference(*args)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
