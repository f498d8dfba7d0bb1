"""Log-space probability substrate (numpy + jax twins).

Re-implementation of the numerics the reference gets from the
``rust-bio`` crate (``bio::stats::LogProb``) plus the epsilon-capping helpers in
the reference's ``src/utils/mod.rs:41`` (``NUMERICAL_EPSILON = 1e-3``,
``cap_numerical_overshoot``).

Two parallel implementations are provided:

* ``np_*`` functions operate on numpy arrays / python floats (host-side code:
  grammar compilation, prior precomputation, I/O packing).
* ``jnp_*`` functions are jittable jax transforms used inside device kernels.

All probabilities are natural-log-space float (``-inf`` == probability zero,
``0.0`` == probability one).  PHRED conversion matches the reference's output
encoding (``PROB_* `` fields are PHRED-scaled: ``-10 * log10(p)``).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

# Matches NUMERICAL_EPSILON in reference src/utils/mod.rs:41
NUMERICAL_EPSILON = 1e-3

LOG_ZERO = -np.inf
LOG_ONE = 0.0

# frequently used constants (reference src/utils/mod.rs:46-52)
PROB_05 = math.log(0.5)
PROB_033 = math.log(1.0 / 3.0)
PROB_025 = math.log(0.25)
PROB_095 = math.log(0.95)
PROB_09 = math.log(0.9)


# ---------------------------------------------------------------------------
# numpy / scalar versions (host side)
# ---------------------------------------------------------------------------


def np_ln_add_exp(a, b):
    """log(exp(a) + exp(b)), elementwise, -inf safe."""
    if not isinstance(a, np.ndarray) and not isinstance(b, np.ndarray):
        # scalar fast path (hot in per-read host loops; numpy scalar
        # dispatch costs ~30x a math-module call)
        a = float(a)
        b = float(b)
        m = a if a >= b else b
        if m == LOG_ZERO:
            return LOG_ZERO
        return m + math.log1p(math.exp((b if a >= b else a) - m))
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m = np.maximum(a, b)
    out = np.where(
        np.isneginf(m),
        LOG_ZERO,
        m + np.log1p(np.exp(np.minimum(a, b) - np.where(np.isneginf(m), 0.0, m))),
    )
    return out if out.ndim else float(out)


def np_ln_sum_exp(x, axis=None):
    """log(sum(exp(x))) along axis, -inf safe."""
    x = np.asarray(x, dtype=np.float64)
    m = np.max(x, axis=axis, keepdims=True) if x.size else np.float64(LOG_ZERO)
    m_safe = np.where(np.isneginf(m), 0.0, m)
    with np.errstate(divide="ignore"):
        s = np.log(np.sum(np.exp(x - m_safe), axis=axis, keepdims=True)) + m_safe
    s = np.where(np.isneginf(m), LOG_ZERO, s)
    if axis is None:
        return float(s.reshape(()))
    return np.squeeze(s, axis=axis)


_LN2 = math.log(2.0)


def np_ln_one_minus_exp(x):
    """log(1 - exp(x)) for x <= 0, elementwise; x==0 -> -inf."""
    if not isinstance(x, np.ndarray):
        x = float(x)
        if x >= 0.0:
            return LOG_ZERO
        if x < -_LN2:
            return math.log1p(-math.exp(x))
        return math.log(-math.expm1(x))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(
            x >= 0.0,
            LOG_ZERO,
            np.where(x < -_LN2, np.log1p(-np.exp(x)), np.log(-np.expm1(x))),
        )
    return out if out.ndim else float(out)


def np_cap_numerical_overshoot(x, epsilon=NUMERICAL_EPSILON):
    """Cap a log-prob that overshot 0.0 by at most ``epsilon`` back to 0.0.

    Mirrors ``LogProb::cap_numerical_overshoot`` used with
    ``NUMERICAL_EPSILON`` throughout the reference (e.g.
    ``src/variants/model/likelihood.rs:47``).  Values above 0 but within
    ``epsilon`` (in linear space the check is on the log value directly) are
    clamped to log(1)=0; larger overshoots indicate a bug and are clamped too
    (numpy version raises in strict contexts via assertion at call sites).
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.where((x > 0.0) & (x <= epsilon), 0.0, np.minimum(x, 0.0))
    return out if out.ndim else float(out)


def np_phred_from_log(x):
    """natural-log prob -> PHRED (-10*log10(p))."""
    x = np.asarray(x, dtype=np.float64)
    out = -10.0 * x / math.log(10.0)
    return out if out.ndim else float(out)


def np_log_from_phred(p):
    p = np.asarray(p, dtype=np.float64)
    out = -p * math.log(10.0) / 10.0
    return out if out.ndim else float(out)


def np_ln_trapezoidal_integrate_grid(log_density, grid):
    """Trapezoidal integration of exp(log_density) over sorted ``grid``.

    log-space equivalent of
    ``LogProb::ln_trapezoidal_integrate_grid_exp`` (used by the reference's
    adaptive integration, ``src/utils/adaptive_integration.rs:136``).
    """
    grid = np.asarray(grid, dtype=np.float64)
    ld = np.asarray(log_density, dtype=np.float64)
    if grid.size < 2:
        return float(ld[0]) if grid.size else LOG_ZERO
    widths = np.log(np.diff(grid)) - math.log(2.0)
    pair = np_ln_add_exp(ld[:-1], ld[1:])
    return np_ln_sum_exp(widths + pair)


def np_ln_simpsons_integrate(log_density_fn, a, b, n):
    """Simpson integration in log space with n (odd) grid points.

    Mirrors ``LogProb::ln_simpsons_integrate_exp`` used for the small-interval
    and low-depth special cases in ``src/variants/model/modes/generic.rs:370-384``.
    """
    assert n % 2 == 1 and n >= 3
    h = (b - a) / (n - 1)
    xs = np.linspace(a, b, n)
    ld = np.array([log_density_fn(x) for x in xs], dtype=np.float64)
    coefs = np.full(n, math.log(4.0))
    coefs[0::2] = math.log(2.0)
    coefs[0] = 0.0
    coefs[-1] = 0.0
    return math.log(h / 3.0) + np_ln_sum_exp(ld + coefs) if h > 0 else float(ld[0])


# ---------------------------------------------------------------------------
# jax versions (device side, jittable)
# ---------------------------------------------------------------------------

# A large negative float used in place of -inf inside kernels where -inf could
# poison gradients / produce NaN via (-inf) - (-inf).  exp(-1e30) == 0 in f32.
NEG_INF_F32 = -1e30


def jnp_ln_add_exp(a, b):
    m = jnp.maximum(a, b)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log1p(jnp.exp(jnp.minimum(a, b) - m_safe))
    return jnp.where(jnp.isfinite(m), out, m)


def jnp_ln_sum_exp(x, axis=None, keepdims=False):
    m = jnp.max(x, axis=axis, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.log(jnp.sum(jnp.exp(x - m_safe), axis=axis, keepdims=True)) + m_safe
    s = jnp.where(jnp.isfinite(m), s, m)
    if not keepdims and axis is not None:
        s = jnp.squeeze(s, axis=axis)
    elif not keepdims:
        s = s.reshape(())
    return s


def jnp_ln_one_minus_exp(x):
    # log(1 - exp(x)) for x <= 0; stable both near 0 and for very negative x.
    x = jnp.minimum(x, 0.0)
    near_zero = x > -math.log(2.0)
    # guard against log(0) when x == 0
    expm1 = -jnp.expm1(jnp.where(near_zero, x, -1.0))
    log_branch = jnp.log1p(-jnp.exp(jnp.where(near_zero, -1.0, x)))
    out = jnp.where(near_zero, jnp.log(jnp.maximum(expm1, 1e-300)), log_branch)
    return jnp.where(x >= 0.0, -jnp.inf, out)


def jnp_cap_numerical_overshoot(x, epsilon=NUMERICAL_EPSILON):
    return jnp.where((x > 0.0) & (x <= epsilon), 0.0, jnp.minimum(x, 0.0))


def jnp_phred_from_log(x):
    return -10.0 * x / math.log(10.0)


def jnp_log_from_phred(p):
    return -p * math.log(10.0) / 10.0


# ---------------------------------------------------------------------------
# Kass-Raftery Bayes-factor classification
# (rust-bio bio::stats::bayesian::bayes_factors::evidence::KassRaftery)
# ---------------------------------------------------------------------------

KR_NONE = 0
KR_BARELY = 1
KR_POSITIVE = 2
KR_STRONG = 3
KR_VERY_STRONG = 4

_KR_NAMES = ["None", "Barely", "Positive", "Strong", "VeryStrong"]


def kass_raftery(bayes_factor: float) -> int:
    """Classify a (linear-space) Bayes factor per Kass & Raftery 1995."""
    if bayes_factor <= 1.0:
        return KR_NONE
    if bayes_factor <= 3.2:
        return KR_BARELY
    if bayes_factor <= 10.0:
        return KR_POSITIVE
    if bayes_factor <= 100.0:
        return KR_STRONG
    return KR_VERY_STRONG


def kass_raftery_name(level: int) -> str:
    return _KR_NAMES[level]


# ---------------------------------------------------------------------------
# MiniLogProb f16 codec (reference src/utils/mod.rs:448-474)
# ---------------------------------------------------------------------------


def encode_minilogprob(values: np.ndarray):
    """Compress log-probs to f16 where exactly round-trippable, else f32.

    The reference stores each observation log-prob as f16 iff converting to
    f16 and back is lossless *enough* (it checks ``is_finite`` after f16
    round-trip and relative closeness); we keep the simpler rule: use f16 when
    finite in f16 and within 1e-2 relative error, tagging per-value.
    Returns (tags: bool array use_f16, f16 array, f32 array).
    """
    v = np.asarray(values, dtype=np.float32)
    v16 = v.astype(np.float16)
    back = v16.astype(np.float32)
    with np.errstate(invalid="ignore"):
        ok = np.isfinite(v16) | np.isneginf(v)
        rel = np.abs(back - v) <= 1e-2 * np.maximum(np.abs(v), 1.0)
    use16 = ok & (rel | np.isneginf(v))
    return use16, v16, v


__all__ = [k for k in dir() if not k.startswith("_")]
