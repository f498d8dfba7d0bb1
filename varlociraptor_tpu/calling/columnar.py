"""Columnar (structure-of-arrays) locus batches for the call pipeline.

The round-3 call stage ran at ~150 loci/s against a ~65K loci/s posterior
engine: the host loop built per-read Python objects, per-locus bias tensors
and per-record strings (``calling.rs:320-455`` territory).  This module
replaces the per-object path with flat numpy columns over all observations of
a locus window, so every per-locus decision the reference makes per
``Pileup`` — non-standard-alignment filtering (pileup.rs:26-43), singleton
evidence adjustment (read_observation.rs:548-562), bias parameter learning +
combo gating (bias/mod.rs:37-104 and the per-bias is_informative impls) —
becomes a handful of O(N_obs) vectorized reductions.

The shipped encoding (f16 log-probs + u8 categoricals) is defined in
``ops.compact_obs``; this module owns the HOST side: packing, filtering,
gating, and the padded panel scatter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..evidence.observation import (
    ALT_LOCUS_NONE,
    HOMOPOLYMER_NONE,
    READ_POSITION_MAJOR,
    RO_F1R2,
    RO_F2R1,
    RO_NONE,
    STRAND_BOTH,
    STRAND_FORWARD,
    STRAND_NONE,
    STRAND_REVERSE,
    Pileup,
)
from ..ops.biases import (
    ALB_SOME,
    FULL_COMBOS_DEFAULT,
    HE_SOME,
    ROB_F1R2,
    ROB_F2R1,
    RPB_SOME,
    SB_FORWARD,
    SB_NONE,
    SB_REVERSE,
    SCB_SOME,
)
from ..ops.compact_obs import (
    CF_PA,
    CF_PDO,
    CF_PHA,
    CF_PHB,
    CF_PHV,
    CF_PM,
    CF_PME,
    CF_PR,
    CF_PSA,
    CU_ALT_LOCUS,
    CU_FLAGS,
    CU_RO,
    CU_STRAND,
    FLAG_IS_MAX_MAPQ,
    FLAG_PAIRED,
    FLAG_READ_POSITION_MAJOR,
    FLAG_SOFTCLIPPED,
    N_CF,
    N_CU,
)
from ..utils.logprob import PROB_05, PROB_095

# Kass-Raftery "strong" support boundary: kass_raftery(bf) >= KR_STRONG
# <=> bf > 10.0 <=> (log-prob difference) > ln(10)
_LN_BF_STRONG = math.log(10.0)

_N_COMBOS = len(FULL_COMBOS_DEFAULT)

# combo index -> (dimension, code); dimension order matches BiasCombo fields
_COMBO_FIELDS = [
    (c.strand, c.read_orientation, c.read_position, c.softclip,
     c.homopolymer, c.alt_locus)
    for c in FULL_COMBOS_DEFAULT
]


@dataclass
class ColumnarBatch:
    """A window of L loci x S samples with all observations in flat columns.

    Obs are grouped by (locus, sample), loci in input order.  ``f16/u8/hil``
    are the SHIPPED values (post singleton-adjustment); ``pa_fmt/pr_fmt``
    keep the raw pre-adjustment log-probs the FORMAT audit strings use
    (the reference's OBS strings read the un-adjusted accessors,
    calling/variants/mod.rs:277-340).
    """

    variants: list
    S: int
    counts: np.ndarray  # [L, S] int32
    f16: np.ndarray  # [N, N_CF] float16
    u8: np.ndarray  # [N, N_CU] uint8
    hil: np.ndarray  # [N] int8 (HOMOPOLYMER_NONE = sentinel)
    third: np.ndarray  # [N] int16, -1 = None (host-only, OBS strings)
    pa_fmt: np.ndarray  # [N] float32 raw prob_alt
    pr_fmt: np.ndarray  # [N] float32 raw prob_ref
    n_filtered: np.ndarray  # [L, S] int32
    raw_depth: np.ndarray  # [L, S] int32, -1 = None
    hint_filtered: np.ndarray  # [L] bool
    hint_singleton: np.ndarray  # [L] bool

    # ------------------------------------------------------------------
    @property
    def L(self):
        return len(self.variants)

    @property
    def N(self):
        return self.f16.shape[0]

    def _seg_ids(self):
        """(ls_id [N] int64 = locus*S+sample, locus_id [N] int64)."""
        reps = self.counts.reshape(-1).astype(np.int64)
        ls = np.repeat(np.arange(self.L * self.S, dtype=np.int64), reps)
        return ls, ls // self.S

    # ------------------------------------------------------------------
    @classmethod
    def from_pileups(cls, variants, pileups_per_locus):
        """Fallback constructor from (VariantInfo, [Pileup]) records (one
        Python pass over observations; binary observation files bypass it)."""
        L = len(variants)
        S = len(pileups_per_locus[0]) if L else 0
        counts = np.zeros((L, S), dtype=np.int32)
        raw_depth = np.full((L, S), -1, dtype=np.int32)
        n_filtered = np.zeros((L, S), dtype=np.int32)
        obs_all = []
        for li, ps in enumerate(pileups_per_locus):
            for si, p in enumerate(ps):
                counts[li, si] = len(p.read_observations)
                if p.raw_depth is not None:
                    raw_depth[li, si] = p.raw_depth
                n_filtered[li, si] = p.n_filtered_out
                obs_all.extend(p.read_observations)
        N = len(obs_all)
        f16 = np.zeros((N, N_CF), dtype=np.float16)
        u8 = np.zeros((N, N_CU), dtype=np.uint8)
        hil = np.full(N, HOMOPOLYMER_NONE, dtype=np.int8)
        third = np.full(N, -1, dtype=np.int16)
        for i, o in enumerate(obs_all):
            f16[i, CF_PM] = o.eff_prob_mapping()
            f16[i, CF_PA] = o.eff_prob_alt()
            f16[i, CF_PR] = o.eff_prob_ref()
            f16[i, CF_PME] = o.prob_missed_allele
            f16[i, CF_PSA] = o.prob_sample_alt
            f16[i, CF_PDO] = o.prob_double_overlap
            f16[i, CF_PHB] = o.prob_hit_base
            f16[i, CF_PHA] = (
                o.prob_observable_at_homopolymer_artifact
                if o.prob_observable_at_homopolymer_artifact is not None
                else np.nan
            )
            f16[i, CF_PHV] = (
                o.prob_observable_at_homopolymer_variant
                if o.prob_observable_at_homopolymer_variant is not None
                else np.nan
            )
            u8[i, CU_STRAND] = o.strand
            u8[i, CU_RO] = o.read_orientation
            u8[i, CU_FLAGS] = (
                (FLAG_SOFTCLIPPED if o.softclipped else 0)
                | (FLAG_PAIRED if o.paired else 0)
                | (
                    FLAG_READ_POSITION_MAJOR
                    if o.read_position == READ_POSITION_MAJOR
                    else 0
                )
                | (FLAG_IS_MAX_MAPQ if o.is_max_mapq else 0)
            )
            u8[i, CU_ALT_LOCUS] = o.alt_locus
            if o.homopolymer_indel_len is not None:
                hil[i] = max(-126, min(126, o.homopolymer_indel_len))
            if o.third_allele_evidence is not None:
                third[i] = o.third_allele_evidence
        pa_fmt = f16[:, CF_PA].astype(np.float32)
        pr_fmt = f16[:, CF_PR].astype(np.float32)
        return cls(
            variants=list(variants),
            S=S,
            counts=counts,
            f16=f16,
            u8=u8,
            hil=hil,
            third=third,
            pa_fmt=pa_fmt,
            pr_fmt=pr_fmt,
            n_filtered=n_filtered,
            raw_depth=raw_depth,
            hint_filtered=np.zeros(L, dtype=bool),
            hint_singleton=np.zeros(L, dtype=bool),
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_sample_windows(cls, windows):
        """Combine per-sample columnar windows (observations.read_window
        output: (variants, counts [L], ObsColumns, raw_depth [L]); None for
        samples without observation files) into one (locus, sample)-ordered
        batch — the zero-object read path."""
        present = [w for w in windows if w is not None]
        if not present:
            raise ValueError("no observation windows")
        variants = present[0][0]
        L = len(variants)
        S = len(windows)
        for w in present[1:]:
            if len(w[0]) != L:
                raise ValueError(
                    "inconsistent observation files (different lengths)"
                )
            for v0, v1 in zip(variants, w[0]):
                if (v0.chrom, v0.pos, v0.ref_allele, v0.alt_allele) != (
                    v1.chrom, v1.pos, v1.ref_allele, v1.alt_allele,
                ):
                    raise ValueError(
                        "inconsistent observation files (different loci)"
                    )
        counts = np.zeros((L, S), dtype=np.int32)
        raw_depth = np.full((L, S), -1, dtype=np.int32)
        for si, w in enumerate(windows):
            if w is None:
                continue
            counts[:, si] = w[1]
            raw_depth[:, si] = w[3]
        # permutation: sample-major flats -> (locus, sample)-grouped flat
        seg = counts.astype(np.int64).reshape(-1)
        seg_off = np.concatenate([[0], np.cumsum(seg)[:-1]]).reshape(L, S)
        N = int(seg.sum())
        from ..ops.compact_obs import N_CF, N_CU

        f16 = np.empty((N, N_CF), dtype=np.float16)
        u8 = np.empty((N, N_CU), dtype=np.uint8)
        hil = np.empty(N, dtype=np.int8)
        third = np.empty(N, dtype=np.int16)
        for si, w in enumerate(windows):
            if w is None or w[2].f16.shape[0] == 0:
                continue
            c_s = counts[:, si].astype(np.int64)
            starts = seg_off[:, si]
            within = (
                np.arange(int(c_s.sum()), dtype=np.int64)
                - np.repeat(
                    np.concatenate([[0], np.cumsum(c_s)[:-1]]), c_s
                )
            )
            tgt = np.repeat(starts, c_s) + within
            cols = w[2]
            f16[tgt] = cols.f16
            u8[tgt] = cols.u8
            hil[tgt] = cols.hil
            third[tgt] = cols.third
        return cls(
            variants=list(variants),
            S=S,
            counts=counts,
            f16=f16,
            u8=u8,
            hil=hil,
            third=third,
            pa_fmt=f16[:, CF_PA].astype(np.float32),
            pr_fmt=f16[:, CF_PR].astype(np.float32),
            n_filtered=np.zeros((L, S), dtype=np.int32),
            raw_depth=raw_depth,
            hint_filtered=np.zeros(L, dtype=bool),
            hint_singleton=np.zeros(L, dtype=bool),
        )

    # ------------------------------------------------------------------
    def locus_flags(self, options):
        """Per-locus consider flags + snv keys, vectorized twin of
        GenericCaller.make_work_item's flag computation.  MUST run BEFORE
        apply_nonstandard_filter (has_homopolymer looks at the unfiltered
        pileups, matching the object path's ordering)."""
        L = self.L
        is_snv_mnv = np.fromiter(
            (len(v.ref_allele) == len(v.alt_allele) for v in self.variants),
            dtype=bool,
            count=L,
        )
        precise = np.fromiter(
            (v.precise for v in self.variants), dtype=bool, count=L
        )
        _, locus_id = self._seg_ids()
        has_hp = (
            np.bincount(
                locus_id[self.hil != HOMOPOLYMER_NONE], minlength=L
            )
            > 0
        )
        o = options
        flags = np.zeros((L, 6), dtype=bool)
        flags[:, 0] = is_snv_mnv & (not o.omit_read_orientation_bias) & precise
        flags[:, 1] = (not o.omit_strand_bias) & precise
        flags[:, 2] = is_snv_mnv & (not o.omit_read_position_bias) & precise
        flags[:, 3] = is_snv_mnv & (not o.omit_softclip_bias) & precise
        flags[:, 4] = has_hp & (not o.omit_homopolymer_artifact_detection)
        flags[:, 5] = not o.omit_alt_locus_bias
        snv_keys = [
            (v.ref_allele.upper(), v.alt_allele.upper())
            if len(v.ref_allele) == 1
            and len(v.alt_allele) == 1
            and v.kind == "snv"
            else None
            for v in self.variants
        ]
        return flags, is_snv_mnv, snv_keys

    # ------------------------------------------------------------------
    def apply_nonstandard_filter(self, is_snv_mnv, omit_read_orientation_bias):
        """Drop non-standard read orientations at SNV/MNV loci
        (pileup.rs:26-43).  Updates counts/n_filtered/hint_filtered and
        compacts the flat columns."""
        if omit_read_orientation_bias:
            return
        _, locus_id = self._seg_ids()
        ro = self.u8[:, CU_RO]
        drop = (
            is_snv_mnv[locus_id]
            & (ro != RO_F1R2)
            & (ro != RO_F2R1)
            & (ro != RO_NONE)
        )
        if not drop.any():
            return
        ls, _ = self._seg_ids()
        removed = np.bincount(ls[drop], minlength=self.L * self.S).astype(
            np.int32
        )
        keep = ~drop
        self.f16 = self.f16[keep]
        self.u8 = self.u8[keep]
        self.hil = self.hil[keep]
        self.third = self.third[keep]
        self.pa_fmt = self.pa_fmt[keep]
        self.pr_fmt = self.pr_fmt[keep]
        self.counts = self.counts - removed.reshape(self.L, self.S)
        self.n_filtered = self.n_filtered + removed.reshape(self.L, self.S)
        self.hint_filtered |= (
            removed.reshape(self.L, self.S).sum(axis=1) > 0
        ) & is_snv_mnv

    # ------------------------------------------------------------------
    def apply_singleton_adjust(self):
        """PCR-error guard: a locus with exactly ONE alt-supporting read
        across all samples gets that read's alt/ref evidence neutralized
        (read_observation.rs:548-562).  Only the SHIPPED values change;
        pa_fmt/pr_fmt keep the raw values for the audit strings."""
        _, locus_id = self._seg_ids()
        alt_sup = self.pa_fmt > self.pr_fmt
        n_alt = np.bincount(locus_id[alt_sup], minlength=self.L)
        single = n_alt == 1
        if not single.any():
            return
        hit = alt_sup & single[locus_id]
        half = np.float16(PROB_05)
        self.f16[hit, CF_PA] = half
        self.f16[hit, CF_PR] = half
        self.hint_singleton |= single

    # ------------------------------------------------------------------
    def _derived(self):
        """Shared per-obs f64 columns for the gating reductions."""
        d = {}
        d["pm"] = self.f16[:, CF_PM].astype(np.float64)
        d["pm_lin"] = np.exp(d["pm"])
        # bias gating reads the RAW probs through bayes_factor_* (the
        # singleton adjustment only sets the _adj overrides, which the
        # accessors ignore) -> use the pre-adjustment pa_fmt/pr_fmt copies
        pa = self.pa_fmt.astype(np.float64)
        pr = self.pr_fmt.astype(np.float64)
        d["pa"], d["pr"] = pa, pr
        # exact twin of bayes_factor_* + kass_raftery >= KR_STRONG
        # (exp then compare, to match the host's boundary rounding)
        with np.errstate(over="ignore"):
            d["strong_alt"] = (pa != pr) & (np.exp(pa - pr) > 10.0)
            d["strong_ref"] = (pa != pr) & (np.exp(pr - pa) > 10.0)
        d["ref_sup"] = pr > pa
        d["unique"] = d["pm"] >= PROB_095
        d["strand"] = self.u8[:, CU_STRAND].astype(np.int64)
        d["ro"] = self.u8[:, CU_RO].astype(np.int64)
        flags = self.u8[:, CU_FLAGS]
        d["softclipped"] = (flags & FLAG_SOFTCLIPPED) != 0
        d["rp_major"] = (flags & FLAG_READ_POSITION_MAJOR) != 0
        d["max_mapq"] = (flags & FLAG_IS_MAX_MAPQ) != 0
        d["alt_locus"] = self.u8[:, CU_ALT_LOCUS].astype(np.int64)
        d["pdo"] = self.f16[:, CF_PDO].astype(np.float64)
        d["phb"] = self.f16[:, CF_PHB].astype(np.float64)
        d["pha"] = self.f16[:, CF_PHA].astype(np.float64)
        d["phv"] = self.f16[:, CF_PHV].astype(np.float64)
        hil = self.hil.astype(np.int64)
        d["hil_eff"] = np.where(hil == HOMOPOLYMER_NONE, 0, hil)
        return d

    def learn_and_gate(self, allowed):
        """Vectorized bias parameter learning + combo gating.

        allowed: [L, n_combos] bool pre-gate (variant-class flags).
        Returns (combo_active [L,n_combos] bool, fwd_rate [L] f32,
        has_alt_loci [L] bool) matching build_bias_tensor's
        possible & informative & likely chain (ops.biases)."""
        L, S = self.L, self.S
        d = self._derived()
        ls, locus_id = self._seg_ids()
        LS = L * S

        def lsum(x, cond=None):
            """Per-locus f64 sum of x (over all samples)."""
            if cond is None:
                return np.bincount(locus_id, weights=x, minlength=L)
            return np.bincount(locus_id[cond], weights=x[cond], minlength=L)

        def lcount(cond):
            return np.bincount(locus_id[cond], minlength=L)

        def lscount(cond):
            return np.bincount(ls[cond], minlength=LS).reshape(L, S)

        def lssum(x, cond):
            return np.bincount(
                ls[cond], weights=x[cond], minlength=LS
            ).reshape(L, S)

        n_total = lcount(np.ones(self.N, dtype=bool))
        n_per_ls = self.counts.astype(np.int64)

        # ---- forward rate / strand informative (strand_bias.rs:79-123)
        sr = d["strong_ref"]
        strong_all = lsum(d["pm_lin"], sr & (d["strand"] != STRAND_BOTH))
        strong_fwd = lsum(d["pm_lin"], sr & (d["strand"] == STRAND_FORWARD))
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(strong_all > 0, strong_fwd / np.maximum(strong_all, 1e-300), 0.0)
        fr_est = np.where(
            (strong_all > 2.0) & (strong_all > 100.0) & (frac > 0.0) & (frac < 1.0),
            frac,
            np.where(
                (strong_all > 2.0) & (frac >= 0.4) & (frac <= 0.6), 0.5, np.nan
            ),
        )
        strand_informative = ~np.isnan(fr_est)
        fwd_rate = np.where(strand_informative, fr_est, 0.5)

        # ---- read orientation informative
        ro_known = (d["ro"] == RO_F1R2) | (d["ro"] == RO_F2R1)
        n_uncertain = lcount(~ro_known)
        enough = np.where(n_total > 0, n_uncertain < n_total / 2.0, False)
        st = lcount(sr & ro_known)
        sf = lcount(sr & (d["ro"] == RO_F1R2))
        with np.errstate(divide="ignore", invalid="ignore"):
            ro_ratio = np.where(st > 0, sf / np.maximum(st, 1), 0.0)
        uniform = (st > 2) & (ro_ratio >= 0.3) & (ro_ratio <= 0.7)
        ro_informative = enough & uniform

        # ---- read position informative (read_position_bias.rs:64-117,
        # per-sample, any)
        e_all = lssum(d["pm_lin"], sr)
        e_major = lssum(d["pm_lin"], sr & d["rp_major"])
        e_rate = lssum(np.exp(d["pm"] + d["phb"]), sr)
        with np.errstate(divide="ignore", invalid="ignore"):
            major_rate = np.where(e_all > 0, e_major / np.maximum(e_all, 1e-300), 0.0)
        rp_informative = (
            (e_all > 10.0)
            & (e_major > 0.0)
            & (np.abs(major_rate - e_rate) < 0.05)
        ).any(axis=1)

        # ---- softclip informative
        sc_informative = lcount(d["softclipped"]) > 0

        # ---- homopolymer informative (per-sample: every alt-supporting
        # pileup needs indels in both directions)
        has_alt_sup = lscount(d["strong_alt"]) > 0
        has_pos = lscount(d["hil_eff"] > 0) > 0
        has_neg = lscount(d["hil_eff"] < 0) > 0
        bad = has_alt_sup & ~(has_pos & has_neg)
        hp_informative = ~bad.any(axis=1)

        # ---- alt locus informative (alt_locus_bias.rs:123-144)
        n_alt = lcount(d["strong_alt"])
        nm_alt = lcount(d["strong_alt"] & ~d["max_mapq"])
        n_ref = lcount(d["strong_ref"])
        nm_ref = lcount(d["strong_ref"] & ~d["max_mapq"])
        enough_alt = (n_alt > 0) & (nm_alt > n_alt * 0.1) & ((n_alt - nm_alt) < 10)
        enough_ref = (n_ref > 0) & (nm_ref < n_ref * 0.9)
        has_alt_loci = lcount(d["alt_locus"] != ALT_LOCUS_NONE) > 0
        al_informative = enough_alt & (has_alt_loci | enough_ref)

        dim_informative = {
            "sb": strand_informative,
            "rob": ro_informative,
            "rpb": rp_informative,
            "scb": sc_informative,
            "he": hp_informative,
            "alb": al_informative,
        }

        # ---- per-(obs, combo) alt-factor FINITENESS (is_bias_evidence /
        # is_possible read alt > LOG_ZERO, i.e. finite; -inf only enters
        # through the where-branches below)
        fr_obs = fwd_rate[locus_id]
        hal_obs = has_alt_loci[locus_id]
        strand = d["strand"]
        rate = np.where(strand == STRAND_FORWARD, fr_obs, 1.0 - fr_obs)
        # none-dim strand term finite?
        sb_none_fin = np.where(
            strand == STRAND_BOTH,
            ~np.isinf(d["pdo"]),
            np.where(strand == STRAND_NONE, True, (rate > 0.0) & (d["pdo"] != 0.0)),
        )
        rp_none_fin = ~(d["rp_major"] & np.isinf(d["phb"]))

        evidence = np.zeros((self.N, _N_COMBOS), dtype=bool)
        for ci in range(1, _N_COMBOS):
            sb, rob, rpb, scb, he, alb = _COMBO_FIELDS[ci]
            fin = np.ones(self.N, dtype=bool)
            # strand dim
            if sb == SB_FORWARD:
                fin &= (strand == STRAND_FORWARD) | (strand == STRAND_NONE)
            elif sb == SB_REVERSE:
                fin &= (strand == STRAND_REVERSE) | (strand == STRAND_NONE)
            else:
                fin &= sb_none_fin
            # read orientation dim
            if rob == ROB_F1R2:
                fin &= d["ro"] != RO_F2R1
            elif rob == ROB_F2R1:
                fin &= d["ro"] != RO_F1R2
            # read position dim
            if rpb == RPB_SOME:
                fin &= d["rp_major"]
            else:
                fin &= rp_none_fin
            # softclip dim
            if scb == SCB_SOME:
                fin &= d["softclipped"]
            # homopolymer dim
            h = d["pha"] if he == HE_SOME else d["phv"]
            fin &= ~np.isinf(np.where(np.isnan(h), 0.0, h))
            # alt locus dim
            if alb == ALB_SOME:
                fin &= np.where(
                    hal_obs, d["alt_locus"] == 2, ~d["max_mapq"]
                )
            if he == HE_SOME:
                # homopolymer overrides is_bias_evidence with hil != 0
                evidence[:, ci] = d["hil_eff"] != 0
            else:
                evidence[:, ci] = fin

        # possible: any obs with finite alt factor (HE: hp_informative)
        # likely (bias/mod.rs:62-104): per-sample verdict, any
        n_strong = lscount(d["strong_alt"] & d["unique"])
        all_ref = lscount(d["ref_sup"]) == n_per_ls  # empty pileup -> True
        fallback_s = (n_strong < 10) & (n_per_ls > 0) & ~all_ref
        combo_active = np.zeros((L, _N_COMBOS), dtype=bool)
        combo_active[:, 0] = True
        for ci in range(1, _N_COMBOS):
            sb, rob, rpb, scb, he, alb = _COMBO_FIELDS[ci]
            if he == HE_SOME:
                possible = hp_informative
                likely = hp_informative
            else:
                # finiteness evidence for is_possible spans all samples
                possible = lcount(evidence[:, ci]) > 0
                n_biased = lscount(
                    d["strong_alt"] & d["unique"] & evidence[:, ci]
                )
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = np.where(
                        n_strong > 0,
                        n_biased / np.maximum(n_strong, 1),
                        0.0,
                    )
                verdict = ((n_strong >= 10) & (ratio >= 0.66666)) | fallback_s
                likely = verdict.any(axis=1)
            informative = np.ones(L, dtype=bool)
            if sb != SB_NONE:
                informative &= dim_informative["sb"]
            if rob != 0:
                informative &= dim_informative["rob"]
            if rpb != 0:
                informative &= dim_informative["rpb"]
            if scb != 0:
                informative &= dim_informative["scb"]
            if he != 0:
                informative &= dim_informative["he"]
            if alb != 0:
                informative &= dim_informative["alb"]
            combo_active[:, ci] = (
                allowed[:, ci] & possible & informative & likely
            )
        return combo_active, fwd_rate.astype(np.float32), has_alt_loci

    # ------------------------------------------------------------------
    def expected_depths(self):
        """[L,S] int64 expected depth (read_observation.rs:43-47)."""
        ls, _ = self._seg_ids()
        pm_lin = np.exp(self.f16[:, CF_PM].astype(np.float64))
        s = np.bincount(ls, weights=pm_lin, minlength=self.L * self.S)
        return np.rint(s).astype(np.int64).reshape(self.L, self.S)

    # ------------------------------------------------------------------
    def pack_panels(self, depth, locus_idx=None):
        """Scatter the flat columns into padded device panels.

        Returns (obs_f16 [L,S,D,9], obs_u8 [L,S,D,4], hil [L,S,D] i8,
        mask [L,S,D] bool); obs beyond ``depth`` are dropped (matches the
        object path's [:depth] truncation).  ``locus_idx``: optional int
        array — pack only those loci (rows in locus_idx order)."""
        S, D = self.S, depth
        full_counts = self.counts.astype(np.int64).reshape(-1)
        # position of each obs within its (locus, sample) segment
        off = np.concatenate([[0], np.cumsum(full_counts)[:-1]])
        pos = np.arange(self.N, dtype=np.int64) - np.repeat(off, full_counts)
        if locus_idx is None:
            L = self.L
            keep = pos < D
            row = np.repeat(np.arange(L * S, dtype=np.int64), full_counts)
        else:
            locus_idx = np.asarray(locus_idx, dtype=np.int64)
            L = len(locus_idx)
            new_row_of = np.full(self.L, -1, dtype=np.int64)
            new_row_of[locus_idx] = np.arange(L, dtype=np.int64)
            ls = np.repeat(np.arange(self.L * S, dtype=np.int64), full_counts)
            nl = new_row_of[ls // S]
            keep = (pos < D) & (nl >= 0)
            row = nl * S + (ls % S)
        flat_idx = (row * D + pos)[keep]
        obs_f16 = np.zeros((L * S * D, N_CF), dtype=np.float16)
        obs_u8 = np.zeros((L * S * D, N_CU), dtype=np.uint8)
        hil = np.full(L * S * D, HOMOPOLYMER_NONE, dtype=np.int8)
        mask = np.zeros(L * S * D, dtype=bool)
        obs_f16[flat_idx] = self.f16[keep]
        obs_u8[flat_idx] = self.u8[keep]
        hil[flat_idx] = self.hil[keep]
        mask[flat_idx] = True
        counts = np.minimum(
            (self.counts if locus_idx is None else self.counts[locus_idx])
            .astype(np.int64),
            D,
        )
        return (
            obs_f16.reshape(L, S, D, N_CF),
            obs_u8.reshape(L, S, D, N_CU),
            hil.reshape(L, S, D),
            mask.reshape(L, S, D),
            counts,
        )


    # ------------------------------------------------------------------
    def pack_flat(self, depth, locus_idx=None):
        """Flat wire layout for :meth:`PosteriorEngine.run_flat`: one row
        per (kept) observation plus its destination index in the padded
        [L,S,D] panel, scattered ON DEVICE.  Ships ~27 B/obs instead of
        ~24 B per padded slot — a cut of the host->device bytes at real
        pileup depths (mean ~18 vs panel 64).

        Returns (obs_f16 [N,N_CF], obs_u8 [N,N_CU], hil [N], row_idx [N]
        int32, counts [L,S]); obs beyond ``depth`` are dropped (same
        truncation as pack_panels)."""
        S, D = self.S, depth
        full_counts = self.counts.astype(np.int64).reshape(-1)
        off = np.concatenate([[0], np.cumsum(full_counts)[:-1]])
        pos = np.arange(self.N, dtype=np.int64) - np.repeat(off, full_counts)
        if locus_idx is None:
            L = self.L
            keep = pos < D
            row = np.repeat(np.arange(L * S, dtype=np.int64), full_counts)
        else:
            locus_idx = np.asarray(locus_idx, dtype=np.int64)
            L = len(locus_idx)
            new_row_of = np.full(self.L, -1, dtype=np.int64)
            new_row_of[locus_idx] = np.arange(L, dtype=np.int64)
            ls = np.repeat(np.arange(self.L * S, dtype=np.int64), full_counts)
            nl = new_row_of[ls // S]
            keep = (pos < D) & (nl >= 0)
            row = nl * S + (ls % S)
        row_idx = (row * D + pos)[keep].astype(np.int32)
        counts = np.minimum(
            (self.counts if locus_idx is None else self.counts[locus_idx])
            .astype(np.int64),
            D,
        )
        return (
            self.f16[keep],
            self.u8[keep],
            self.hil[keep],
            row_idx,
            counts,
        )


def compact_slots(combo_active, bucket=True):
    """Gather active combos into leading slots (vectorized twin of
    ops.biases.compact_combos for the compact path).

    Returns (slot_map [L,Bc] int32, slot_active [L,Bc] bool)."""
    L, B = combo_active.shape
    ca = combo_active.copy()
    ca[:, 0] = True
    counts = ca.sum(axis=1)
    max_active = max(1, int(counts.max()) if L else 1)
    Bc = 1 << (max_active - 1).bit_length() if bucket else max_active
    Bc = min(Bc, B)
    # stable order of active combo indices per row
    li, ci = np.nonzero(ca)
    row_counts = np.bincount(li, minlength=L)
    starts = np.concatenate([[0], np.cumsum(row_counts)[:-1]])
    slot = np.arange(len(li), dtype=np.int64) - np.repeat(starts, row_counts)
    keep = slot < Bc
    slot_map = np.zeros((L, Bc), dtype=np.int32)
    slot_active = np.zeros((L, Bc), dtype=bool)
    slot_map[li[keep], slot[keep]] = ci[keep]
    slot_active[li[keep], slot[keep]] = True
    return slot_map, slot_active
