"""Batched per-read likelihood kernel (JAX).

The elementwise formula of the reference's ``likelihood_mapping``
(``/root/reference/src/variants/model/likelihood.rs:196-220``) and the
single/contaminated sample models (``likelihood.rs:63-250``), vectorized over
(locus, bias-combo, AF-grid-point, read).  The reference's LRU caches vanish:
the dense grid *is* the memoization (SURVEY.md §7.1.4).

Formulation: the per-read likelihood is AFFINE in the effective
alt-sampling weight

    w = psa * nu + kappa * (1 - psa),
    nu = af                      (single sample)
    nu = purity*af_p + impurity*af_s   (contaminated mixture,
                                        likelihood.rs:86-115)
    kappa = [af == 1]-style bypass mass (prob_sample_alt is skipped at
            af == 1, likelihood.rs:43-53)

so with per-read max-scaled linear coefficients (three exps per read,
computed ONCE outside the grid loop)

    t(w) = base + w * diff,      ll = log t + c

the per-grid-cell work is ~3 fused multiply-adds plus ONE log, instead of
the chain of logaddexp/ln1mexp transcendentals a direct log-space
evaluation needs.  This matters most for the contaminated kernel, whose
cell count is L*B*G*G2*D.  Accuracy: identical up to f32 rounding except
for per-read dynamic range, which is limited to ~e^-87 relative to the
read's dominant term (beyond that the cell underflows to -inf; the old
log-space path kept absolute range, but such cells only arise for branch
likelihoods that are astronomically excluded anyway).

Shapes (per call):
  feats       [L, S, D, Fe]  observation features (observation.FEATURES)
  mask        [L, S, D]      read validity
  bias_alt/ref/any [L, S, B, D]
  grid        [G]            allele frequencies in [0, 1]

Outputs:
  loglik      [L, S, B, G]       per-sample likelihood sums (uncontaminated)
  loglik_pair [L, B, G, G2]      for contaminated samples (primary af x
                                 contaminant af), computed on demand
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..evidence.observation import F
from ..utils.logprob import NUMERICAL_EPSILON

NEG_INF = -jnp.inf


def _ln1mexp(x):
    """log(1-exp(x)) for x<=0, stable, with exact -inf at x==0."""
    x = jnp.minimum(x, 0.0)
    near = x > -math.log(2.0)
    safe_expm1 = -jnp.expm1(jnp.where(near, x, -1.0))
    a = jnp.log(jnp.maximum(safe_expm1, 1e-38))
    b = jnp.log1p(-jnp.exp(jnp.where(near, -1.0, x)))
    out = jnp.where(near, a, b)
    return jnp.where(x >= 0.0, NEG_INF, out)


def _ln_add_exp(a, b):
    m = jnp.maximum(a, b)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log1p(jnp.exp(-jnp.abs(a - b)))
    return jnp.where(jnp.isfinite(m), out, m)


def prob_sample_alt_scaled(ln_af, prob_sample_alt):
    """af * prob_sample_alt with overshoot capping; af==1 bypasses sampling
    bias (likelihood.rs:43-53)."""
    scaled = ln_af + prob_sample_alt
    scaled = jnp.where((scaled > 0.0) & (scaled <= NUMERICAL_EPSILON), 0.0, scaled)
    return jnp.where(ln_af == 0.0, 0.0, scaled)


def likelihood_mapping(ln_af, feats, bias_alt, bias_ref):
    """P(obs | af, mapped) (likelihood.rs:196-220), log-space scalar form.

    Kept for reference/parity tests; the grid kernels below use the affine
    factorization instead.  ln_af broadcasts against feats[..., D, :]
    leading axes.
    """
    p_alt = feats[..., F["prob_alt"]]
    p_ref = feats[..., F["prob_ref"]]
    p_sample_alt = prob_sample_alt_scaled(ln_af, feats[..., F["prob_sample_alt"]])
    p_sample_ref = _ln1mexp(p_sample_alt)
    return _ln_add_exp(
        p_sample_alt + bias_alt + p_alt,
        p_sample_ref + p_ref + bias_ref,
    )


def per_read_likelihood(ln_af, feats, bias_alt, bias_ref, bias_any):
    """Total per-read likelihood incl. mismapping term
    (likelihood.rs:171-193), log-space scalar form."""
    lm = likelihood_mapping(ln_af, feats, bias_alt, bias_ref)
    p_map = feats[..., F["prob_mapping"]]
    p_mismap = feats[..., F["prob_mismapping"]]
    p_missed = feats[..., F["prob_missed_allele"]]
    return _ln_add_exp(p_map + lm, p_mismap + p_missed + bias_any)


# ----------------------------------------------------------------------
# Affine-coefficient grid kernels


def _read_terms(feats, bias_alt, bias_ref, bias_any):
    """Per-read max-scaled linear coefficients (see module docstring).

    feats [..., D, Fe]; bias_* [..., B, D].
    Returns (a, r, m, c) each [..., B, D] and psa_lin [..., 1, D]:
        per-read likelihood = exp(c) * (w*a + (1-w)*r + m)
    with w the effective alt-sampling weight in [0, 1].  The all-positive
    form avoids the cancellation a (base + w*diff) form suffers at w ~= 1.
    """
    pa = feats[..., F["prob_alt"]][..., None, :]
    pr = feats[..., F["prob_ref"]][..., None, :]
    pmap = feats[..., F["prob_mapping"]][..., None, :]
    pmm = feats[..., F["prob_mismapping"]][..., None, :]
    pmiss = feats[..., F["prob_missed_allele"]][..., None, :]
    A = pmap + bias_alt + pa  # alt path (without the w factor)
    R = pmap + bias_ref + pr  # ref path (without the 1-w factor)
    M = pmm + pmiss + bias_any  # mismapping path
    c = jnp.maximum(jnp.maximum(A, R), M)
    c_safe = jnp.where(jnp.isfinite(c), c, 0.0)
    a = jnp.exp(A - c_safe)
    r = jnp.exp(R - c_safe)
    m = jnp.exp(M - c_safe)
    # clamp psa <= 1 (the NUMERICAL_EPSILON overshoot capping of
    # likelihood.rs:43-53 in linear space)
    psa = jnp.exp(jnp.minimum(feats[..., F["prob_sample_alt"]], 0.0))
    return a, r, m, c, psa[..., None, :]


def _logfold_enabled():
    """8-wide exponent/mantissa log folding — measured NEGATIVE result,
    default OFF everywhere (``VLT_LOGFOLD=1`` opts in).

    On the accelerator it was first written for, and on the CPU (naive
    1138 vs fold 689 loci/s, 8192-locus tumor-normal batch), the fold was
    slower: the bitcast/int-sum machinery and the extra intermediates cost
    more than 7/8 of the logs saved, so the kernel is bound by the
    [L,B,U,D] elementwise traffic, which the fold does not shrink. Not
    measured on the GPU. Kept for study parity (golden-sweep-certified
    identical calls)."""
    import os

    return os.environ.get("VLT_LOGFOLD") in ("1", "true")


def _ll_cells(a, r, m, c, w, mask):
    """Masked read-sum of log(exp(c) * (w*a + (1-w)*r + m)); see
    ``_ll_cells_body``. The named scope lets a profiler trace find the
    fusions it becomes."""
    with jax.named_scope("ll_cells"):
        return _ll_cells_body(a, r, m, c, w, mask)


def _ll_cells_body(a, r, m, c, w, mask):
    """Masked read-sum of log(exp(c) * (w*a + (1-w)*r + m)).

    a/r/m/c [..., D]; w broadcastable to them; mask [..., D] bool.
    Reduces the last (read) axis.

    With ``VLT_LOGFOLD=1`` the read axis is folded 8-wide before the log
    via an
    exact exponent/mantissa split: ``t = mant * 2^(e-191)`` with
    ``mant in [1,2)`` (bitcast; the 2^64 pre-scale is a power of two —
    exact — and lifts f32 subnormals into normal range first).  The
    integer exponents sum EXACTLY; the mantissas fold in groups of 8
    (product in [1,256), logged at small magnitude), cutting the log
    count 8x with rounding error comparable to the naive per-read log.
    ``t == 0`` (all three max-scaled paths underflowed) is detected up
    front and still yields -inf exactly as the unpaired log did.  The
    class-independent ``c`` term is likewise hoisted out of the
    grid-class axes: one masked D-reduction total instead of one per
    class.  (Both folds reassociate f32 sums; validated against the
    full golden testcase sweep.)
    """
    w = jnp.clip(w, 0.0, 1.0)  # fp insurance: keep 1-w >= 0
    t = w * a + (1.0 - w) * r + m
    t = jnp.where(mask, t, t.dtype.type(1.0))  # masked slots: log 1 = 0
    if t.dtype != jnp.float32 or not _logfold_enabled():
        # naive per-read log: the x64 parity-study profile, and the CPU
        # default (vectorized libm logs are cheap there — measured 1138
        # vs 689 loci/s with the fold on the 8192-locus CPU bench)
        ll = jnp.log(t) + c
        return jnp.sum(jnp.where(mask, ll, 0.0), axis=-1)
    neg_inf = jnp.asarray(NEG_INF, t.dtype)
    zero_any = jnp.any(t == 0.0, axis=-1)
    t = jnp.where(t == 0.0, t.dtype.type(1.0), t)
    D = t.shape[-1]
    FOLD = 8
    pad_d = (-D) % FOLD
    if pad_d:
        pad = [(0, 0)] * (t.ndim - 1) + [(0, pad_d)]
        t = jnp.pad(t, pad, constant_values=1.0)
        D += pad_d
    ts = t * t.dtype.type(2.0 ** 64)  # exact; normalizes subnormals
    bits = jax.lax.bitcast_convert_type(ts, jnp.int32)
    e = jax.lax.shift_right_logical(bits, 23) & 0xFF  # biased exponent
    mant = jax.lax.bitcast_convert_type(
        (bits & 0x007FFFFF) | 0x3F800000, jnp.float32
    )  # in [1, 2)
    esum = jnp.sum(e - (127 + 64), axis=-1)  # exact int32
    mprod = mant
    for _ in range(3):  # successive contiguous halving: 8-wide fold
        h = mprod.shape[-1] // 2
        mprod = mprod[..., :h] * mprod[..., h:]  # in [1, 2^FOLD)
    ll = jnp.sum(jnp.log(mprod), axis=-1) + esum.astype(t.dtype) * t.dtype.type(
        math.log(2.0)
    )
    ll = jnp.where(zero_any, neg_inf, ll)
    csum = jnp.sum(jnp.where(mask, c, c.dtype.type(0.0)), axis=-1)
    return ll + csum


@partial(jax.jit, static_argnames=())
def sample_loglik_grid(feats, mask, bias_alt, bias_ref, bias_any, grid):
    """[L, S, B, G] log-likelihood sums over reads for every AF grid point."""
    a, r, m, c, psa = _read_terms(feats, bias_alt, bias_ref, bias_any)
    nu = grid[:, None]  # [G, 1(D)]
    kappa = (grid == 1.0).astype(feats.dtype)[:, None]
    # w: [L,S,1,G,D] = psa[L,S,1,1,D]*nu + kappa*(1-psa)
    w = psa[:, :, :, None, :] * nu + kappa * (1.0 - psa[:, :, :, None, :])
    return _ll_cells(
        a[:, :, :, None, :],
        r[:, :, :, None, :],
        m[:, :, :, None, :],
        c[:, :, :, None, :],
        w,
        mask[:, :, None, None, :],
    )


@partial(jax.jit, static_argnames=())
def sample_loglik_grid_contaminated(
    feats, mask, bias_alt, bias_ref, bias_any, grid, ln_purity, ln_impurity
):
    """[L, B, G, G2] contaminated-sample likelihood sums
    (likelihood.rs:86-115): primary af on axis G, contaminant af on G2.

    feats/mask/bias here are for ONE sample: feats [L, D, Fe], mask [L, D],
    bias_* [L, B, D].  The purity-weighted mixture of the two mapping
    likelihoods collapses to the same affine form with
    nu = purity*af_p + impurity*af_s (see module docstring).
    """
    purity = jnp.exp(ln_purity)  # exp(-inf) = 0 handles fraction 0/1
    impurity = jnp.exp(ln_impurity)
    a, r, m, c, psa = _read_terms(feats, bias_alt, bias_ref, bias_any)
    one = (grid == 1.0).astype(feats.dtype)
    nu = purity * grid[:, None, None] + impurity * grid[None, :, None]  # [G,G2,1]
    kappa = purity * one[:, None, None] + impurity * one[None, :, None]
    psa_ = psa[:, :, None, None, :]  # [L,B,1,1,D]
    w = psa_ * nu + kappa * (1.0 - psa_)  # [L,B,G,G2,D]
    return _ll_cells(
        a[:, :, None, None, :],
        r[:, :, None, None, :],
        m[:, :, None, None, :],
        c[:, :, None, None, :],
        w,
        mask[:, None, None, None, :],
    )
