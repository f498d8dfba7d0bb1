"""Compact observation encoding + on-device expansion.

The call pipeline keeps host->device bytes small, so it does not ship the
classic engine inputs (f32 feature tensor
[L,S,D,20] + three host-built f32 bias tensors [L,S,B,D] ~ 16 KB/locus at
depth 64).  This module defines the wire format that replaces them:

    obs_f16 [L, S, D, 9]  float16   log-probs (already f16-quantized at the
                                    observation-file level, MiniLogProb
                                    semantics — shipping f16 loses nothing)
    obs_u8  [L, S, D, 4]  uint8     categorical fields
    hil     [L, S, D]     int8      homopolymer indel length (127 = none)
    mask    [L, S, D]     bool

~24 B/obs instead of ~ (80 + 12*B) B/obs.  The f32 feature tensor the
likelihood kernels consume AND the per-combo bias factor tensors (the
reference's 6-dimension artifact model, ``src/variants/model/bias/``) are
reconstructed INSIDE the engine jit — XLA fuses the expansion into the first
consumers, so the full tensors never round-trip through HBM either.

The bias factor math mirrors ``ops.biases.combo_factors_for_obs``
(bias/mod.rs:259-284) exactly, vectorized over (locus, sample, combo-slot,
read); combo identity arrives as a per-locus slot map into the static
FULL_COMBOS table (host-side gating still decides WHICH combos are active —
see ``calling.columnar`` — the device only evaluates them).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logprob import PROB_05
from ..evidence.observation import (
    ALT_LOCUS_MAJOR,
    HOMOPOLYMER_NONE,
    N_FEATURES,
    READ_POSITION_MAJOR,
    RO_F1R2,
    RO_F2R1,
    STRAND_BOTH,
    STRAND_FORWARD,
    STRAND_NONE,
    STRAND_REVERSE,
    F,
)
from .biases import (
    ALB_SOME,
    FULL_COMBOS_DEFAULT,
    ROB_F1R2,
    ROB_F2R1,
    ROB_NONE,
    RPB_SOME,
    SB_FORWARD,
    SB_NONE,
    SB_REVERSE,
    SCB_SOME,
    HE_SOME,
)

NEG_INF = -jnp.inf

# ---- f16 column layout -----------------------------------------------------
CF_PM = 0   # effective (MAPQ-adjusted) prob_mapping
CF_PA = 1   # effective prob_alt
CF_PR = 2   # effective prob_ref
CF_PME = 3  # prob_missed_allele
CF_PSA = 4  # prob_sample_alt
CF_PDO = 5  # prob_double_overlap
CF_PHB = 6  # prob_hit_base
CF_PHA = 7  # prob_observable_at_homopolymer_artifact (NaN = None)
CF_PHV = 8  # prob_observable_at_homopolymer_variant (NaN = None)
N_CF = 9

# ---- u8 column layout ------------------------------------------------------
CU_STRAND = 0
CU_RO = 1
CU_FLAGS = 2
CU_ALT_LOCUS = 3
N_CU = 4

FLAG_SOFTCLIPPED = 1
FLAG_PAIRED = 2
FLAG_READ_POSITION_MAJOR = 4
FLAG_IS_MAX_MAPQ = 8

# static table: combo index -> 6 dimension codes (matches FULL_COMBOS_DEFAULT)
COMBO_CODES = np.array(
    [
        [c.strand, c.read_orientation, c.read_position,
         c.softclip, c.homopolymer, c.alt_locus]
        for c in FULL_COMBOS_DEFAULT
    ],
    dtype=np.int32,
)


# ---------------------------------------------------------------------------
# device-side expansion
# ---------------------------------------------------------------------------


def _ln1mexp(x):
    """log(1-exp(x)) for x<=0, stable, exact -inf at x==0 (device twin of
    utils.logprob.np_ln_one_minus_exp)."""
    x = jnp.minimum(x, 0.0)
    near = x > -math.log(2.0)
    safe_expm1 = -jnp.expm1(jnp.where(near, x, -1.0))
    a = jnp.log(jnp.maximum(safe_expm1, 1e-38))
    b = jnp.log1p(-jnp.exp(jnp.where(near, -1.0, x)))
    out = jnp.where(near, a, b)
    return jnp.where(x >= 0.0, NEG_INF, out)


def expand_features(obs_f16, obs_u8, hil_i8):
    """Compact wire arrays -> f32 feature tensor [..., N_FEATURES] matching
    ``evidence.observation.pileup_to_arrays`` semantics (unused columns are
    dead-code-eliminated by XLA where not consumed)."""
    p = obs_f16.astype(jnp.float32)
    u = obs_u8.astype(jnp.float32)
    flags = obs_u8[..., CU_FLAGS]
    cols = [None] * N_FEATURES
    cols[F["prob_mapping"]] = p[..., CF_PM]
    cols[F["prob_mismapping"]] = _ln1mexp(p[..., CF_PM])
    cols[F["prob_alt"]] = p[..., CF_PA]
    cols[F["prob_ref"]] = p[..., CF_PR]
    cols[F["prob_missed_allele"]] = p[..., CF_PME]
    cols[F["prob_sample_alt"]] = p[..., CF_PSA]
    cols[F["prob_double_overlap"]] = p[..., CF_PDO]
    cols[F["prob_single_overlap"]] = _ln1mexp(p[..., CF_PDO])
    cols[F["prob_hit_base"]] = p[..., CF_PHB]
    cols[F["strand"]] = u[..., CU_STRAND]
    cols[F["read_orientation"]] = u[..., CU_RO]
    cols[F["softclipped"]] = (flags & FLAG_SOFTCLIPPED).astype(jnp.float32)
    cols[F["paired"]] = ((flags & FLAG_PAIRED) >> 1).astype(jnp.float32)
    cols[F["read_position"]] = (
        (flags & FLAG_READ_POSITION_MAJOR) >> 2
    ).astype(jnp.float32)
    cols[F["prob_homopolymer_artifact_observable"]] = p[..., CF_PHA]
    cols[F["prob_homopolymer_variant_observable"]] = p[..., CF_PHV]
    cols[F["homopolymer_indel_len"]] = hil_i8.astype(jnp.float32)
    cols[F["is_max_mapq"]] = ((flags & FLAG_IS_MAX_MAPQ) >> 3).astype(jnp.float32)
    cols[F["alt_locus"]] = u[..., CU_ALT_LOCUS]
    cols[F["third_allele_evidence"]] = jnp.full_like(p[..., CF_PM], jnp.nan)
    return jnp.stack(cols, axis=-1)


def bias_factors(obs_f16, obs_u8, slot_map, fwd_rate, has_alt_loci):
    """Per-observation bias factors for each locus's active combo slots.

    obs_f16 [L,S,D,9] f16; obs_u8 [L,S,D,4] u8; slot_map [L,Bc] int32
    (indices into FULL_COMBOS_DEFAULT); fwd_rate [L] f32 (learned forward
    strand rate); has_alt_loci [L] bool.

    Returns (bias_alt, bias_ref, bias_any) each [L, S, Bc, D] f32 —
    vectorized twin of ``ops.biases.combo_factors_for_obs``.
    """
    p = obs_f16.astype(jnp.float32)
    strand = obs_u8[..., CU_STRAND].astype(jnp.int32)[:, :, None, :]  # [L,S,1,D]
    ro = obs_u8[..., CU_RO].astype(jnp.int32)[:, :, None, :]
    flags = obs_u8[..., CU_FLAGS].astype(jnp.int32)[:, :, None, :]
    alt_locus = obs_u8[..., CU_ALT_LOCUS].astype(jnp.int32)[:, :, None, :]
    pdo = p[..., CF_PDO][:, :, None, :]
    pso = _ln1mexp(p[..., CF_PDO])[:, :, None, :]
    hit = p[..., CF_PHB][:, :, None, :]
    pha = p[..., CF_PHA][:, :, None, :]
    phv = p[..., CF_PHV][:, :, None, :]

    codes = jnp.asarray(COMBO_CODES)[slot_map]  # [L, Bc, 6]
    # broadcast to [L, 1(S), Bc, 1(D)]
    c_sb = codes[..., 0][:, None, :, None]
    c_rob = codes[..., 1][:, None, :, None]
    c_rpb = codes[..., 2][:, None, :, None]
    c_scb = codes[..., 3][:, None, :, None]
    c_he = codes[..., 4][:, None, :, None]
    c_alb = codes[..., 5][:, None, :, None]

    softclipped = (flags & FLAG_SOFTCLIPPED) != 0
    rp_major = (flags & FLAG_READ_POSITION_MAJOR) != 0
    max_mapq = (flags & FLAG_IS_MAX_MAPQ) != 0

    half = jnp.float32(PROB_05)
    rate_f = fwd_rate[:, None, None, None]  # [L,1,1,1]
    has_al = has_alt_loci[:, None, None, None]

    # ---- strand (strand_bias.rs:28-56)
    a_fwd = jnp.where(
        (strand == STRAND_FORWARD) | (strand == STRAND_NONE), 0.0, NEG_INF
    )
    a_rev = jnp.where(
        (strand == STRAND_REVERSE) | (strand == STRAND_NONE), 0.0, NEG_INF
    )
    rate = jnp.where(strand == STRAND_FORWARD, rate_f, 1.0 - rate_f)
    a_none = jnp.where(
        strand == STRAND_BOTH,
        pdo,
        jnp.where(strand == STRAND_NONE, 0.0, jnp.log(rate) + pso),
    )
    a = jnp.where(
        c_sb == SB_FORWARD, a_fwd, jnp.where(c_sb == SB_REVERSE, a_rev, a_none)
    )
    alt = a
    ref = jnp.zeros_like(a) + half
    anyp = jnp.zeros_like(a) + half

    # ---- read orientation (read_orientation_bias.rs:18-33)
    a_f1r2 = jnp.where(
        ro == RO_F1R2, 0.0, jnp.where(ro == RO_F2R1, NEG_INF, half)
    )
    a_f2r1 = jnp.where(
        ro == RO_F2R1, 0.0, jnp.where(ro == RO_F1R2, NEG_INF, half)
    )
    a = jnp.where(
        c_rob == ROB_F1R2, a_f1r2, jnp.where(c_rob == ROB_F2R1, a_f2r1, half)
    )
    alt = alt + a
    ref = ref + half
    anyp = anyp + half

    # ---- read position (read_position_bias.rs:17-38)
    omh = jnp.where((hit == 0.0) | jnp.isneginf(hit), 0.0, _ln1mexp(hit))
    any_rp = jnp.where(rp_major, hit, omh)
    a = jnp.where(
        c_rpb == RPB_SOME, jnp.where(rp_major, 0.0, NEG_INF), any_rp
    )
    alt = alt + a
    ref = ref + any_rp
    anyp = anyp + any_rp

    # ---- softclip (softclip_bias.rs:15-29)
    alt = alt + jnp.where(
        c_scb == SCB_SOME, jnp.where(softclipped, 0.0, NEG_INF), 0.0
    )

    # ---- homopolymer (homopolymer_error.rs:23-41); None (NaN) -> ln(1)
    h = jnp.where(c_he == HE_SOME, pha, phv)
    h = jnp.where(jnp.isnan(h), 0.0, h)
    alt = alt + h
    ref = ref + h

    # ---- alt locus (alt_locus_bias.rs:62-105)
    a_some = jnp.where(
        has_al,
        jnp.where(alt_locus == ALT_LOCUS_MAJOR, 0.0, NEG_INF),
        jnp.where(max_mapq, NEG_INF, 0.0),
    )
    r_some = jnp.where(
        has_al,
        jnp.where(alt_locus == ALT_LOCUS_MAJOR, NEG_INF, 0.0),
        half,
    )
    alt = alt + jnp.where(c_alb == ALB_SOME, a_some, half)
    ref = ref + jnp.where(c_alb == ALB_SOME, r_some, half)
    anyp = anyp + half

    return alt, ref, anyp
