"""Batched semiglobal pair-HMM forward kernel (JAX).

Batched replacement for the reference's per-read banded forward
(``bio::stats::pairhmm::PairHMM`` invoked at
``src/variants/evidence/realignment/mod.rs:526-543``): instead of banding
each read separately, we compute the forward probability over the
(shrunken) windows for a whole batch of (read-window x allele-window) work
items at once, marching an anti-diagonal wavefront along the read axis.
The full forward is >= the reference's banded approximation in accuracy;
ref/alt ratio normalization
(``realignment/mod.rs:350-376``) cancels constant factors.

Model (semiglobal; free, unpenalized start/end gaps on the allele axis x;
read axis y fully consumed; reference pairhmm.rs:186-204):

  M(i,j) = e_m(i,j) * [ t_mm M(i-1,j-1) + t_dm D(i-1,j-1) + t_im I(i-1,j-1) ]
  D(i,j) =            [ t_md M(i-1,j)   + t_dd D(i-1,j) ]          (gap in read)
  I(i,j) = e_i(j)   * [ t_mi M(i,j-1)   + t_ii I(i,j-1) ]          (read insertion)

with e_m = 1-miscall on match, miscall/3 on mismatch; e_i = miscall
(reference pairhmm.rs:462-486); t_mi = prob_insertion_artifact,
t_md = prob_deletion_artifact (pairhmm.rs:164-184).  Zero extension
probabilities (the reference default) are treated as re-open (gap cost per
base), a deliberate modeling simplification over rust-bio's banded chain.
"""

from __future__ import annotations

import math
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -1.0e30  # finite -inf proxy inside the kernel (f32-safe)
LN_CONFUSION = math.log(0.3333)


def _lse3(a, b, c):
    m = jnp.maximum(jnp.maximum(a, b), c)
    out = m + jnp.log(
        jnp.exp(a - m) + jnp.exp(b - m) + jnp.exp(c - m)
    )
    return jnp.where(m <= NEG_INF / 2, NEG_INF, out)


def _lse2(a, b):
    m = jnp.maximum(a, b)
    out = m + jnp.log1p(jnp.exp(-jnp.abs(a - b)))
    return jnp.where(m <= NEG_INF / 2, NEG_INF, out)


@partial(jax.jit, static_argnames=("x_len", "y_len"))
def _forward_impl(
    allele, allele_len, read, miscall, read_len, gaps, max_edit, x_len, y_len
):
    """Batched forward log-probabilities.

    allele     [B, X] uint8 (uppercase ASCII, 0 padding)
    allele_len [B] int32
    read       [B, Y] uint8
    miscall    [B, Y] f32 log miscall prob per base
    read_len   [B] int32
    gaps       [4] f32: t_mi (ins open), t_md (del open), t_ii, t_dd (log)
    max_edit   [B] int32 band (cells whose min edit distance exceeds it are
               pruned, rust-bio PairHMM parity); negative = full forward
    """
    B = allele.shape[0]
    X, Y = x_len, y_len
    W = Y + 1  # diagonal width indexed by j=0..Y

    t_mi, t_md, t_ii, t_dd = gaps[0], gaps[1], gaps[2], gaps[3]
    # no-gap / close probabilities
    t_mm = jnp.log(
        jnp.maximum(1.0 - jnp.exp(t_mi) - jnp.exp(t_md), 1e-12)
    )
    t_im = jnp.log(jnp.maximum(1.0 - jnp.exp(t_ii), 1e-12))
    t_dm = jnp.log(jnp.maximum(1.0 - jnp.exp(t_dd), 1e-12))

    j_idx = jnp.arange(W)  # [W]
    no_call = jnp.log1p(-jnp.exp(miscall))  # log(1-miscall) [B, Y]
    # shift emissions to j-indexing (emission for cell j uses read[j-1])
    mis_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), miscall], axis=1)  # [B,W]
    noc_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), no_call], axis=1)
    read_j = jnp.concatenate([jnp.zeros((B, 1), jnp.uint8), read], axis=1)

    # reversed allele padded for diagonal gathers:
    # diag k needs allele[k-1-j] = rev_pad[X - k + j + PAD] with PAD = W
    PAD = W
    rev = allele[:, ::-1]
    rev_pad = jnp.concatenate(
        [jnp.zeros((B, PAD), jnp.uint8), rev, jnp.zeros((B, PAD), jnp.uint8)],
        axis=1,
    )

    neg = jnp.full((B, W), NEG_INF)

    # banded-pruning edit-distance DP carried on the same diagonals
    EINF = jnp.int32(1 << 29)
    me = jnp.where(max_edit < 0, EINF, max_edit)[:, None]  # [B,1]
    einf = jnp.full((B, W), EINF, dtype=jnp.int32)

    def body(carry, k):
        M2, D2, I2, M1, D1, I1, E2, E1, acc = carry
        # cell (i=k-j, j); valid iff 1<=j<=min(k-?,...)
        i = k - j_idx[None, :]  # [1->B, W]
        valid = (
            (j_idx[None, :] >= 1)
            & (j_idx[None, :] <= read_len[:, None])
            & (i >= 1)
            & (i <= allele_len[:, None])
        )
        # I at i==0 (pure leading insertion) is also valid
        valid_i0 = (
            (j_idx[None, :] >= 1)
            & (j_idx[None, :] <= read_len[:, None])
            & (i == 0)
        )

        # emission for M: allele base at i-1 vs read base at j-1
        offset = X - k + PAD
        ab = jax.lax.dynamic_slice(rev_pad, (0, offset), (B, W))  # allele[k-1-j]
        match = ab == read_j
        is_n = read_j == ord("N")
        e_m = jnp.where(
            match, noc_j, jnp.where(is_n, math.log(0.25), mis_j + LN_CONFUSION)
        )

        # transitions from diag k-2 at j-1
        M2s = jnp.concatenate([neg[:, :1], M2[:, :-1]], axis=1)
        D2s = jnp.concatenate([neg[:, :1], D2[:, :-1]], axis=1)
        I2s = jnp.concatenate([neg[:, :1], I2[:, :-1]], axis=1)
        # free start: virtual start state at any (i-1, j-1=0) with weight 1
        start_m = jnp.where(j_idx[None, :] == 1, 0.0, NEG_INF)
        Mk = e_m + _lse2(
            _lse3(t_mm + M2s, t_dm + D2s, t_im + I2s), start_m
        )
        Mk = jnp.where(valid, Mk, NEG_INF)

        # D from diag k-1 at same j
        Dk = _lse2(t_md + M1, t_dd + D1)
        Dk = jnp.where(valid, Dk, NEG_INF)

        # I from diag k-1 at j-1
        M1s = jnp.concatenate([neg[:, :1], M1[:, :-1]], axis=1)
        I1s = jnp.concatenate([neg[:, :1], I1[:, :-1]], axis=1)
        start_i = jnp.where(j_idx[None, :] == 1, t_mi, NEG_INF)
        Ik = mis_j + _lse2(_lse2(t_mi + M1s, t_ii + I1s), start_i)
        Ik = jnp.where(valid | valid_i0, Ik, NEG_INF)

        # edit-distance DP + banded skip (rust-bio PairHMM min_edit_dist)
        E2s = jnp.concatenate([einf[:, :1], E2[:, :-1]], axis=1)  # topleft
        E1s = jnp.concatenate([einf[:, :1], E1[:, :-1]], axis=1)  # top
        lf = E1  # left
        pred_min = jnp.minimum(jnp.minimum(E2s, E1s), lf)
        skip = pred_min > me
        sub = jnp.where(match, E2s, jnp.minimum(E2s + 1, EINF))
        Ek = jnp.minimum(
            sub, jnp.minimum(jnp.minimum(E1s, lf) + 1, EINF)
        )
        cell_ok = (valid | valid_i0) & ~skip
        Ek = jnp.where(cell_ok, Ek, EINF)
        # column j=0 of every diagonal anchors a free start (distance 0)
        Ek = Ek.at[:, 0].set(jnp.where(k <= allele_len, 0, EINF))
        Mk = jnp.where(skip, NEG_INF, Mk)
        Dk = jnp.where(skip, NEG_INF, Dk)
        Ik = jnp.where(skip, NEG_INF, Ik)

        # accumulate final cells (j == read_len; free end gap in x)
        at_end = j_idx[None, :] == read_len[:, None]
        fin = jnp.where(at_end, _lse2(Mk, Ik), NEG_INF)
        acc = _lse2(acc, _diag_lse(fin))
        return (M1, D1, I1, Mk, Dk, Ik, E1, Ek, acc), None

    def _diag_lse(x):
        m = jnp.max(x, axis=1)
        out = m + jnp.log(jnp.sum(jnp.exp(x - m[:, None]), axis=1))
        return jnp.where(m <= NEG_INF / 2, NEG_INF, out)[:, None]

    # diag 0 = cell (0,0): distance 0 at j=0
    e1_init = einf.at[:, 0].set(0)
    init = (
        neg, neg, neg, neg, neg, neg, einf, e1_init,
        jnp.full((B, 1), NEG_INF),
    )
    ks = jnp.arange(1, X + Y + 1)
    (*_, acc), _ = jax.lax.scan(body, init, ks)
    return acc[:, 0]


@partial(jax.jit, static_argnames=("x_len", "y_len"))
def _forward_hp_impl(
    allele,
    allele_len,
    read,
    miscall,
    read_len,
    ins_open,
    ins_ext,
    del_open,
    del_ext,
    max_edit,
    x_len,
    y_len,
):
    """Homopolymer-aware forward: positional gap probabilities.

    Approximates the reference's ``HomopolyPairHMM`` (hop states per base,
    pairhmm.rs:208-294) by making gap open/extend probabilities
    position-dependent: a gap involving a base equal to its predecessor (a
    homopolymer run continuation) uses the per-base hop probabilities from
    the alignment-properties MLE instead of the global spurious-gap rates.

    ins_open/ins_ext: [B, Y] log-probs per read base (j axis)
    del_open/del_ext: [B, X] log-probs per allele base (i axis)
    """
    B = allele.shape[0]
    X, Y = x_len, y_len
    W = Y + 1

    j_idx = jnp.arange(W)
    no_call = jnp.log1p(-jnp.exp(miscall))
    mis_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), miscall], axis=1)
    noc_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), no_call], axis=1)
    read_j = jnp.concatenate([jnp.zeros((B, 1), jnp.uint8), read], axis=1)
    ins_open_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), ins_open], axis=1)
    ins_ext_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), ins_ext], axis=1)

    PAD = W
    rev = allele[:, ::-1]
    rev_pad = jnp.concatenate(
        [jnp.zeros((B, PAD), jnp.uint8), rev, jnp.zeros((B, PAD), jnp.uint8)],
        axis=1,
    )
    del_open_pad = jnp.concatenate(
        [
            jnp.full((B, PAD), NEG_INF),
            del_open[:, ::-1],
            jnp.full((B, PAD), NEG_INF),
        ],
        axis=1,
    )
    del_ext_pad = jnp.concatenate(
        [
            jnp.full((B, PAD), NEG_INF),
            del_ext[:, ::-1],
            jnp.full((B, PAD), NEG_INF),
        ],
        axis=1,
    )

    neg = jnp.full((B, W), NEG_INF)
    EINF = jnp.int32(1 << 29)
    me = jnp.where(max_edit < 0, EINF, max_edit)[:, None]
    einf = jnp.full((B, W), EINF, dtype=jnp.int32)

    def body(carry, k):
        M2, D2, I2, M1, D1, I1, E2, E1, acc = carry
        i = k - j_idx[None, :]
        valid = (
            (j_idx[None, :] >= 1)
            & (j_idx[None, :] <= read_len[:, None])
            & (i >= 1)
            & (i <= allele_len[:, None])
        )
        valid_i0 = (
            (j_idx[None, :] >= 1)
            & (j_idx[None, :] <= read_len[:, None])
            & (i == 0)
        )

        offset = X - k + PAD
        ab = jax.lax.dynamic_slice(rev_pad, (0, offset), (B, W))
        d_open = jax.lax.dynamic_slice(del_open_pad, (0, offset), (B, W))
        d_ext = jax.lax.dynamic_slice(del_ext_pad, (0, offset), (B, W))
        match = ab == read_j
        is_n = read_j == ord("N")
        e_m = jnp.where(
            match, noc_j, jnp.where(is_n, math.log(0.25), mis_j + LN_CONFUSION)
        )

        # positional no-gap probability at this cell
        t_mm = jnp.log(
            jnp.maximum(1.0 - jnp.exp(ins_open_j) - jnp.exp(d_open), 1e-12)
        )
        t_im = jnp.log(jnp.maximum(1.0 - jnp.exp(ins_ext_j), 1e-12))
        t_dm = jnp.log(jnp.maximum(1.0 - jnp.exp(d_ext), 1e-12))

        M2s = jnp.concatenate([neg[:, :1], M2[:, :-1]], axis=1)
        D2s = jnp.concatenate([neg[:, :1], D2[:, :-1]], axis=1)
        I2s = jnp.concatenate([neg[:, :1], I2[:, :-1]], axis=1)
        start_m = jnp.where(j_idx[None, :] == 1, 0.0, NEG_INF)
        Mk = e_m + _lse2(_lse3(t_mm + M2s, t_dm + D2s, t_im + I2s), start_m)
        Mk = jnp.where(valid, Mk, NEG_INF)

        Dk = _lse2(d_open + M1, d_ext + D1)
        Dk = jnp.where(valid, Dk, NEG_INF)

        M1s = jnp.concatenate([neg[:, :1], M1[:, :-1]], axis=1)
        I1s = jnp.concatenate([neg[:, :1], I1[:, :-1]], axis=1)
        start_i = jnp.where(j_idx[None, :] == 1, ins_open_j, NEG_INF)
        Ik = mis_j + _lse2(_lse2(ins_open_j + M1s, ins_ext_j + I1s), start_i)
        Ik = jnp.where(valid | valid_i0, Ik, NEG_INF)

        # edit-distance DP + banded skip (rust-bio PairHMM min_edit_dist)
        E2s = jnp.concatenate([einf[:, :1], E2[:, :-1]], axis=1)  # topleft
        E1s = jnp.concatenate([einf[:, :1], E1[:, :-1]], axis=1)  # top
        lf = E1  # left
        pred_min = jnp.minimum(jnp.minimum(E2s, E1s), lf)
        skip = pred_min > me
        sub = jnp.where(match, E2s, jnp.minimum(E2s + 1, EINF))
        Ek = jnp.minimum(sub, jnp.minimum(jnp.minimum(E1s, lf) + 1, EINF))
        cell_ok = (valid | valid_i0) & ~skip
        Ek = jnp.where(cell_ok, Ek, EINF)
        Ek = Ek.at[:, 0].set(jnp.where(k <= allele_len, 0, EINF))
        Mk = jnp.where(skip, NEG_INF, Mk)
        Dk = jnp.where(skip, NEG_INF, Dk)
        Ik = jnp.where(skip, NEG_INF, Ik)

        at_end = j_idx[None, :] == read_len[:, None]
        fin = jnp.where(at_end, _lse2(Mk, Ik), NEG_INF)
        m = jnp.max(fin, axis=1)
        dl = m + jnp.log(jnp.sum(jnp.exp(fin - m[:, None]), axis=1))
        dl = jnp.where(m <= NEG_INF / 2, NEG_INF, dl)[:, None]
        acc = _lse2(acc, dl)
        return (M1, D1, I1, Mk, Dk, Ik, E1, Ek, acc), None

    e1_init = einf.at[:, 0].set(0)
    init = (
        neg, neg, neg, neg, neg, neg, einf, e1_init,
        jnp.full((B, 1), NEG_INF),
    )
    ks = jnp.arange(1, X + Y + 1)
    (*_, acc), _ = jax.lax.scan(body, init, ks)
    return acc[:, 0]


@partial(jax.jit, static_argnames=("x_len", "y_len"))
def _forward_hop_impl(
    allele, allele_len, read, miscall, read_len, gaps, hop16, max_edit,
    x_len, y_len,
):
    """Hop-state homopolymer forward on anti-diagonals (device analog of
    native vlt_pairhmm_hop_one): M/D/I lanes plus HX (read homopolymer
    hop: extra read copies of the last matched allele base, gated on base
    equality) and HY (allele homopolymer hop: skipped run continuation).
    hop16: [16] log probs (seq open[ACGT], seq ext, ref open, ref ext).
    Hop states carry no emission factor (the MLE hop rates are per-base
    event frequencies)."""
    B = allele.shape[0]
    X, Y = x_len, y_len
    W = Y + 1

    t_mi, t_md, t_ii, t_dd = gaps[0], gaps[1], gaps[2], gaps[3]
    t_im = jnp.log(jnp.maximum(1.0 - jnp.exp(t_ii), 1e-12))
    t_dm = jnp.log(jnp.maximum(1.0 - jnp.exp(t_dd), 1e-12))

    # 256-entry per-base lookup tables for the hop params
    def _table(vals4):
        t = jnp.full(256, NEG_INF, dtype=jnp.float32)
        for bi, ch in enumerate(b"ACGT"):
            t = t.at[ch].set(vals4[bi])
        return t

    hox_t = _table(hop16[0:4])    # seq (read) hop open
    hex_t = _table(hop16[4:8])    # seq hop extend
    hoy_t = _table(hop16[8:12])   # ref (allele) hop open
    hey_t = _table(hop16[12:16])  # ref hop extend

    j_idx = jnp.arange(W)
    no_call = jnp.log1p(-jnp.exp(miscall))
    mis_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), miscall], axis=1)
    noc_j = jnp.concatenate([jnp.full((B, 1), NEG_INF), no_call], axis=1)
    read_j = jnp.concatenate([jnp.zeros((B, 1), jnp.uint8), read], axis=1)
    # previous read base per j (read[j-2]); 0 at j<=1
    read_jp = jnp.concatenate([jnp.zeros((B, 2), jnp.uint8), read[:, :-1]], axis=1)[:, :W]
    hox_r = hox_t[read_j]          # entry prob of hopping read base y_j
    hex_r = hex_t[read_j]
    same_read = (read_j == read_jp) & (read_j != 0)
    # closing prob out of an HX run whose last base was read[j-2]
    hxclose = jnp.log(jnp.maximum(1.0 - jnp.exp(hex_t[read_jp]), 1e-12))

    PAD = W
    rev = allele[:, ::-1]
    rev_pad = jnp.concatenate(
        [jnp.zeros((B, PAD), jnp.uint8), rev, jnp.zeros((B, PAD), jnp.uint8)],
        axis=1,
    )

    neg = jnp.full((B, W), NEG_INF)
    EINF = jnp.int32(1 << 29)
    me = jnp.where(max_edit < 0, EINF, max_edit)[:, None]
    einf = jnp.full((B, W), EINF, dtype=jnp.int32)

    def body(carry, k):
        (M2, D2, I2, HX2, HY2, M1, D1, I1, HX1, HY1, E2, E1, acc) = carry
        i = k - j_idx[None, :]
        valid = (
            (j_idx[None, :] >= 1)
            & (j_idx[None, :] <= read_len[:, None])
            & (i >= 1)
            & (i <= allele_len[:, None])
        )
        valid_i0 = (
            (j_idx[None, :] >= 1)
            & (j_idx[None, :] <= read_len[:, None])
            & (i == 0)
        )

        offset = X - k + PAD
        ab = jax.lax.dynamic_slice(rev_pad, (0, offset), (B, W))   # allele[i-1]
        abp = jax.lax.dynamic_slice(rev_pad, (0, offset + 1), (B, W))  # allele[i-2]
        match = ab == read_j
        is_n = read_j == ord("N")
        e_m = jnp.where(
            match, noc_j, jnp.where(is_n, math.log(0.25), mis_j + LN_CONFUSION)
        )

        # Match->Match continuation: hops are ADDITIVE channels (subtracting
        # per-base hop mass would penalize longer homopolymer alleles one
        # factor per extra base; see native vlt_pairhmm_hop_one)
        t_mm = jnp.log(
            jnp.maximum(1.0 - jnp.exp(t_mi) - jnp.exp(t_md), 1e-12)
        )
        # closing prob out of an HY run whose last skipped base is allele[i-2]
        hyclose_p = jnp.log(jnp.maximum(1.0 - jnp.exp(hey_t[abp]), 1e-12))

        M2s = jnp.concatenate([neg[:, :1], M2[:, :-1]], axis=1)
        D2s = jnp.concatenate([neg[:, :1], D2[:, :-1]], axis=1)
        I2s = jnp.concatenate([neg[:, :1], I2[:, :-1]], axis=1)
        HX2s = jnp.concatenate([neg[:, :1], HX2[:, :-1]], axis=1)
        HY2s = jnp.concatenate([neg[:, :1], HY2[:, :-1]], axis=1)
        # HX(i-1, j-1)'s last consumed read base is y[j-2] -> hxclose[:, j]
        start_m = jnp.where(j_idx[None, :] == 1, 0.0, NEG_INF)
        Mk = e_m + _lse2(
            _lse2(
                _lse3(t_mm + M2s, t_dm + D2s, t_im + I2s),
                _lse2(hxclose + HX2s, hyclose_p + HY2s),
            ),
            start_m,
        )
        Mk = jnp.where(valid, Mk, NEG_INF)

        Dk = _lse2(t_md + M1, t_dd + D1)
        Dk = jnp.where(valid, Dk, NEG_INF)

        M1s = jnp.concatenate([neg[:, :1], M1[:, :-1]], axis=1)
        I1s = jnp.concatenate([neg[:, :1], I1[:, :-1]], axis=1)
        HX1s = jnp.concatenate([neg[:, :1], HX1[:, :-1]], axis=1)
        start_i = jnp.where(j_idx[None, :] == 1, t_mi, NEG_INF)
        Ik = mis_j + _lse2(_lse2(t_mi + M1s, t_ii + I1s), start_i)
        Ik = jnp.where(valid | valid_i0, Ik, NEG_INF)

        # HX: consume read base y_j without advancing the allele
        hx_entry = jnp.where(match, hox_r + M1s, NEG_INF)
        hx_ext = jnp.where(same_read, hex_r + HX1s, NEG_INF)
        HXk = _lse2(hx_entry, hx_ext)
        HXk = jnp.where(valid, HXk, NEG_INF)

        # HY: skip allele base x_i within a homopolymer run
        same_allele = (ab == abp) & (ab != 0)
        hoy_a = hoy_t[ab]
        hey_a = hey_t[ab]
        hy_in = jnp.where(same_allele, _lse2(hoy_a + M1, hey_a + HY1), NEG_INF)
        HYk = jnp.where(valid, hy_in, NEG_INF)

        # banded pruning (same edit DP as the exact kernel)
        E2s = jnp.concatenate([einf[:, :1], E2[:, :-1]], axis=1)
        E1s = jnp.concatenate([einf[:, :1], E1[:, :-1]], axis=1)
        lf = E1
        pred_min = jnp.minimum(jnp.minimum(E2s, E1s), lf)
        skip = pred_min > me
        sub = jnp.where(match, E2s, jnp.minimum(E2s + 1, EINF))
        Ek = jnp.minimum(sub, jnp.minimum(jnp.minimum(E1s, lf) + 1, EINF))
        cell_ok = (valid | valid_i0) & ~skip
        Ek = jnp.where(cell_ok, Ek, EINF)
        Ek = Ek.at[:, 0].set(jnp.where(k <= allele_len, 0, EINF))
        Mk = jnp.where(skip, NEG_INF, Mk)
        Dk = jnp.where(skip, NEG_INF, Dk)
        Ik = jnp.where(skip, NEG_INF, Ik)
        HXk = jnp.where(skip, NEG_INF, HXk)
        HYk = jnp.where(skip, NEG_INF, HYk)

        at_end = j_idx[None, :] == read_len[:, None]
        fin = jnp.where(at_end, _lse2(_lse2(Mk, Ik), HXk), NEG_INF)
        m = jnp.max(fin, axis=1)
        dl = m + jnp.log(jnp.sum(jnp.exp(fin - m[:, None]), axis=1))
        dl = jnp.where(m <= NEG_INF / 2, NEG_INF, dl)[:, None]
        acc = _lse2(acc, dl)
        return (
            M1, D1, I1, HX1, HY1, Mk, Dk, Ik, HXk, HYk, E1, Ek, acc,
        ), None

    e1_init = einf.at[:, 0].set(0)
    init = (
        neg, neg, neg, neg, neg, neg, neg, neg, neg, neg, einf, e1_init,
        jnp.full((B, 1), NEG_INF),
    )
    ks = jnp.arange(1, X + Y + 1)
    (*_, acc), _ = jax.lax.scan(body, init, ks)
    return acc[:, 0]


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def ragged_panel(items, rows, width):
    """Ragged byte sequences (bytes or uint8 arrays) -> ([rows, width] uint8
    panel, zero-padded; [len(items)] lengths). One C-level join and one
    scatter: no numpy call per item, which at ~10K items per batch cost
    more host time than the device forward."""
    n = len(items)
    lens = np.fromiter(map(len, items), np.int64, n)
    flat = np.frombuffer(b"".join(items), np.uint8)
    if len(flat) != lens.sum():
        raise TypeError("ragged_panel takes bytes-like or uint8 items")
    panel = np.zeros((rows, width), np.uint8)
    # a row-major boolean mask visits the cells in concatenation order
    panel[:n][np.arange(width) < lens[:, None]] = flat
    return panel, lens


def device_panels(alleles, reads, quals, max_dists, rows, x_len, y_len):
    """Padded inputs of the XLA wavefronts: uppercase allele/read panels,
    lengths (pad rows get 1), log-miscall panel (NEG_INF beyond each read),
    and the band per item (-1 = full forward)."""
    n = len(alleles)
    allele, alens = ragged_panel(alleles, rows, x_len)
    read, rlens = ragged_panel(reads, rows, y_len)
    qual, qlens = ragged_panel(quals, rows, y_len)
    allele &= np.uint8(0xDF)
    read &= np.uint8(0xDF)
    alen = np.ones(rows, np.int32)
    rlen = np.ones(rows, np.int32)
    alen[:n] = alens
    rlen[:n] = rlens
    qlen = np.zeros(rows, np.int64)
    qlen[:n] = qlens
    mis = np.where(
        np.arange(y_len)[None, :] < qlen[:, None],
        -qual.astype(np.float64) * (math.log(10.0) / 10.0),
        NEG_INF,
    ).astype(np.float32)
    medge = np.full(rows, -1, np.int32)
    if max_dists is not None:
        medge[:n] = [-1 if d is None else int(d) for d in max_dists]
    return allele, alen, read, rlen, mis, medge


_BASE_IDX = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T

# work items this process sent down each forward path ("native", or one of
# ``BatchedPairHMM.device_path``'s names): observability for runs that must
# show which path served them
forward_counts: Counter = Counter()


class BatchedPairHMM:
    """Convenience wrapper with shape bucketing + numpy I/O.

    mode: "exact" (full forward), "homopolymer" (positional hop gaps from
    alignment-properties hop params). The "fast" path-scoring mode lives in
    evidence.realignment (it scores the edit-distance path host-side).
    """

    def __init__(self, gap_params, hop_params=None, mode: str = "exact"):
        self.mode = mode
        self.hop = hop_params
        self._init_gaps(gap_params)
        self._use_native = None  # resolved lazily (env override / backend)

    def _native_ok(self):
        """Use the C++ linear-space forward when running on the CPU backend
        (the JAX wavefront kernel pays a large anti-diagonal overhead there);
        the XLA wavefronts serve accelerators.  VLT_NATIVE_PAIRHMM=0/1
        overrides."""
        if self._use_native is None:
            import os

            env = os.environ.get("VLT_NATIVE_PAIRHMM")
            if env is not None:
                self._use_native = env not in ("0", "false")
            else:
                import jax

                self._use_native = jax.default_backend() == "cpu"
            if self._use_native:
                from ..io.native import available

                self._use_native = available()
        return self._use_native

    def device_path(self):
        """The device forward that serves this gap model off the CPU:
        "hp_wavefront" (homopolymer mode's positional gaps,
        ``_forward_hp_impl``) or "wavefront" (``_forward_impl``)."""
        if self.mode == "homopolymer" and self.hop is not None:
            return "hp_wavefront"
        return "wavefront"

    def _init_gaps(self, gap_params):
        # zero (= -inf log) extension probability means multi-base spurious
        # gaps are impossible through the gap states (rust-bio semantics:
        # X->X only via the extension transition) — the default model, where
        # gaps model per-base sequencing errors and real indels live in the
        # alt-allele emission instead.
        def _f(x):
            return x if math.isfinite(x) else NEG_INF

        self.gap = np.array(
            [
                _f(gap_params.prob_insertion_artifact),
                _f(gap_params.prob_deletion_artifact),
                _f(gap_params.prob_insertion_extend_artifact),
                _f(gap_params.prob_deletion_extend_artifact),
            ],
            dtype=np.float32,
        )

    def _hop16(self):
        """[16] log hop probs: seq open[ACGT], seq ext, ref open, ref ext."""
        def _f(vals):
            return [
                v if (v is not None and math.isfinite(v)) else NEG_INF
                for v in vals
            ]

        return np.array(
            _f(self.hop.prob_seq_homopolymer)
            + _f(self.hop.prob_seq_extend_homopolymer)
            + _f(self.hop.prob_ref_homopolymer)
            + _f(self.hop.prob_ref_extend_homopolymer),
            dtype=np.float32,
        )

    def _use_hop_states(self):
        """Opt-in (VLT_HOP_STATES=1) hop-state homopolymer HMM: a
        reconstruction of bio::stats::pairhmm::HomopolyPairHMM with
        dedicated per-base hop lanes (native vlt_pairhmm_hop_one and the
        _forward_hop_impl wavefront kernel).  rust-bio's source is not in
        this image, so the reconstruction's topology details (hop-state
        emissions, transition normalization) are unverifiable; calibrated
        against the reference's own nanopore/pcr/giab homopolymer
        testcases, the positional-gap approximation matches the reference's
        expected outputs better (the reconstruction flips test_nanopore_03),
        so the approximation remains the default."""
        import os

        return (
            self.mode == "homopolymer"
            and self.hop is not None
            and os.environ.get("VLT_HOP_STATES", "0") == "1"
        )

    def forward(self, alleles, reads, quals, max_dists=None):
        """alleles: list[bytes-like]; reads: list[bytes-like];
        quals: list[uint8 array]; max_dists: optional list[int|None] band
        per item (None = full forward; ints reproduce rust-bio's banded
        pruning with max_edit_dist = hit.dist + EDIT_BAND).
        Returns np.array [B] log-probs."""
        n_req = len(alleles)
        assert n_req == len(reads) == len(quals)
        if max_dists is not None:
            assert len(max_dists) == n_req
        if self._use_hop_states():
            return self._forward_hop(alleles, reads, quals, max_dists)
        if self._native_ok():
            forward_counts["native"] += n_req
            return self._forward_native(alleles, reads, quals, max_dists)
        path = self.device_path()
        forward_counts[path] += n_req
        # pad the batch axis to a pow2 bucket so jit programs are reused
        # across pileups (unpadded batch sizes caused one XLA compile per
        # distinct request count)
        B = max(8, 1 << (max(n_req, 1) - 1).bit_length())
        X = _round_up(max((len(a) for a in alleles), default=1), 32)
        Y = _round_up(max((len(r) for r in reads), default=1), 32)
        allele, alen, read, rlen, mis, medge = device_panels(
            alleles, reads, quals, max_dists, B, X, Y
        )
        if path == "hp_wavefront":
            io, ie = self._positional_gaps(
                read, rlen, self.gap[0], self.gap[2],
                self.hop.prob_seq_homopolymer, self.hop.prob_seq_extend_homopolymer,
            )
            do, de = self._positional_gaps(
                allele, alen, self.gap[1], self.gap[3],
                self.hop.prob_ref_homopolymer, self.hop.prob_ref_extend_homopolymer,
            )
            out = _forward_hp_impl(
                jnp.asarray(allele),
                jnp.asarray(alen),
                jnp.asarray(read),
                jnp.asarray(mis),
                jnp.asarray(rlen),
                jnp.asarray(io),
                jnp.asarray(ie),
                jnp.asarray(do),
                jnp.asarray(de),
                jnp.asarray(medge),
                X,
                Y,
            )
            return np.asarray(out, dtype=np.float64)[:n_req]
        out = _forward_impl(
            jnp.asarray(allele),
            jnp.asarray(alen),
            jnp.asarray(read),
            jnp.asarray(mis),
            jnp.asarray(rlen),
            jnp.asarray(self.gap),
            jnp.asarray(medge),
            X,
            Y,
        )
        return np.asarray(out, dtype=np.float64)[:n_req]

    def _forward_hop(self, alleles, reads, quals, max_dists=None):
        """True hop-state homopolymer forward (HomopolyPairHMM
        reconstruction, reference realignment/mod.rs:679-731): adds read-
        and allele-side hop lanes with per-base entry/extension probs from
        the alignment-properties MLE.  Native C++ on the CPU backend; the
        JAX wavefront kernel (_forward_hop_impl) on devices."""
        n_req = len(alleles)
        hop16 = self._hop16()
        if self._native_ok():
            from ..io.native import pairhmm_hop_batch

            miscalls = [
                -np.asarray(q, dtype=np.float32)
                * np.float32(math.log(10.0) / 10.0)
                for q in quals
            ]
            out = pairhmm_hop_batch(
                [bytes(a) for a in alleles],
                reads,
                miscalls,
                self.gap,
                hop16,
                max_edit=max_dists,
            )
            if out is not None:
                return out
            self._use_native = False
        B = max(8, 1 << (max(n_req, 1) - 1).bit_length())
        X = _round_up(max((len(a) for a in alleles), default=1), 32)
        Y = _round_up(max((len(r) for r in reads), default=1), 32)
        allele, alen, read, rlen, mis, medge = device_panels(
            alleles, reads, quals, max_dists, B, X, Y
        )
        out = _forward_hop_impl(
            jnp.asarray(allele),
            jnp.asarray(alen),
            jnp.asarray(read),
            jnp.asarray(mis),
            jnp.asarray(rlen),
            jnp.asarray(self.gap),
            jnp.asarray(hop16),
            jnp.asarray(medge),
            X,
            Y,
        )
        return np.asarray(out, dtype=np.float64)[:n_req]

    def _forward_native(self, alleles, reads, quals, max_dists=None):
        """C++ linear-space forward (io/native.py); same model as the JAX
        kernels, per-item exact lengths (no padding)."""
        from ..io.native import pairhmm_forward_batch

        miscalls = [
            -np.asarray(q, dtype=np.float32) * np.float32(math.log(10.0) / 10.0)
            for q in quals
        ]
        kw = {}
        if self.mode == "homopolymer" and self.hop is not None:
            ins_open, ins_ext, del_open, del_ext = [], [], [], []
            for a, r in zip(alleles, reads):
                rarr = np.frombuffer(
                    bytes(bytearray(np.asarray(r, dtype=np.uint8))), dtype=np.uint8
                )[None, :]
                aarr = np.frombuffer(bytes(a), dtype=np.uint8)[None, :]
                io_, ie_ = self._positional_gaps(
                    rarr & ~np.uint8(0x20),
                    np.array([rarr.shape[1]]),
                    self.gap[0],
                    self.gap[2],
                    self.hop.prob_seq_homopolymer,
                    self.hop.prob_seq_extend_homopolymer,
                )
                do_, de_ = self._positional_gaps(
                    aarr & ~np.uint8(0x20),
                    np.array([aarr.shape[1]]),
                    self.gap[1],
                    self.gap[3],
                    self.hop.prob_ref_homopolymer,
                    self.hop.prob_ref_extend_homopolymer,
                )
                ins_open.append(io_[0])
                ins_ext.append(ie_[0])
                del_open.append(do_[0])
                del_ext.append(de_[0])
            kw = dict(
                ins_open=ins_open,
                ins_ext=ins_ext,
                del_open=del_open,
                del_ext=del_ext,
            )
        import os

        # VLT_PAIRHMM_F64LOG=1: the f64 log-space per-cell ln_sum_exp
        # profile (rust-bio LogProb semantics) — the third numeric profile
        # of docs/calibration_failures.md, for sequential-parity studies
        profile = (
            "log"
            if os.environ.get("VLT_PAIRHMM_F64LOG") == "1"
            else "linear"
        )
        out = pairhmm_forward_batch(
            alleles, reads, miscalls, self.gap, max_edit=max_dists,
            profile=profile, **kw
        )
        if out is None:  # native lib unavailable after all: fall back
            self._use_native = False
            return self.forward(alleles, reads, quals, max_dists)
        return out

    @staticmethod
    def _positional_gaps(seqs, lens, base_open, base_ext, hop_open, hop_ext):
        """Per-position gap open/extend: hop probs inside homopolymer runs."""
        B, N = seqs.shape
        open_arr = np.full((B, N), base_open, dtype=np.float32)
        ext_arr = np.full((B, N), base_ext, dtype=np.float32)
        same = np.zeros((B, N), dtype=bool)
        same[:, 1:] = (seqs[:, 1:] == seqs[:, :-1]) & (seqs[:, 1:] != 0)
        for base_ascii, bi in _BASE_IDX.items():
            sel = same & (seqs == base_ascii)
            ho = hop_open[bi]
            he = hop_ext[bi]
            if math.isfinite(ho):
                open_arr[sel] = np.maximum(open_arr[sel], np.float32(ho))
            if math.isfinite(he):
                ext_arr[sel] = np.maximum(ext_arr[sel], np.float32(he))
        return open_arr, ext_arr
