"""Grid posterior engine: batched Bayesian event evaluation.

Replaces the reference's recursive VAF-tree walk + adaptive integration
(``/root/reference/src/variants/model/modes/generic.rs:191-460``) with masked
logsumexp/trapezoid reductions over a dense allele-frequency grid, batched
over loci.  Per event and branch (= flattened tree path):

  value = bias_prior + prior_event + logsumexp_{joint grid} [
              sum_s (loglik_s[g_s] + weights_s[g_s]) ]

with per-sample integration weights computed on device from the per-locus
depth (observable min/max bound adjustment, formula.rs:1172-1232; clear-ref
shortcut, generic.rs:270-300) and the absent-only prior applied exactly by
splitting out the all-zero joint grid point (prior.rs:718-761).

Samples are contracted as independent *units*: a contamination pair
(primary, contaminant) is one unit whose two grid axes are reduced jointly
through the two-axis likelihood (likelihood.rs:86-115); all other samples are
singleton units.  The branch integral is the product (log-sum) of unit
integrals — the factorization the reference's nested recursion computes
implicitly.

Performance structure:

* Per-sample ACTIVE subgrids: each sample's grid axis is restricted to the
  lattice at the sample's declared scenario ``resolution:``
  (generic.rs:357 ``self.resolutions[*sample]`` — the step at which the
  reference's adaptive integration terminates) plus that sample's set
  values, range endpoints and {0, 1}.  The builtin tumor-normal scenario
  (normal at 0.1) shrinks the contaminated plane [G, G'] from 103x103 to
  103x~10, and every contraction with it.  ``resolution=None`` keeps the
  full shared grid (bit-exact old behavior).
* Own-likelihood grids are computed only for contamination-tree ROOT
  samples — a contaminated child's evidence enters solely through the
  two-axis pair likelihood, so its single-axis grid would be dead compute.
* The contaminated two-axis likelihood [L,B,G,G'] is evaluated only on the
  UNIQUE (nu, kappa) classes of the effective-AF plane
  (nu = purity*af_p + impurity*af_s; kappa = the af==1 sampling-bias-bypass
  mass) and gathered back.
* Tree variable elimination over contamination components contracts each
  child axis as a shifted-exp einsum (a matrix product) instead of a
  materialized [L,B,NB,G,G'] logsumexp.  Shifts are taken per
  spectrum-support class of the eliminated sample so underflow can only
  drop terms that are negligible relative to the branch's own integral.
* Per-event AFD/MAP densities are computed for the per-locus MAP
  (non-artifact) event only, at the no-artifact bias slot only — the only
  densities the caller reports (calling.rs:844-937).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..evidence.observation import F
from .event_program import SPECTRUM_SET, EventSpec
from .grid import AFGrid
from .likelihood import (
    NEG_INF,
    _ln1mexp,
    _ln_add_exp,
    _read_terms,
    _ll_cells,
    sample_loglik_grid,
)

LN_32 = math.log(3.2)  # Kass-Raftery "positive" threshold
PROB_05 = math.log(0.5)

# AFD points shipped to the host per (locus, sample): the K densest subgrid
# points PLUS a static strided backbone across the whole subgrid (plus
# indices).  Mirrors the VAF set the reference's adaptive integration
# visits and reports (calling.rs:891+, adaptive_integration.rs): a coarse
# sweep across the full observable range to locate the peak, refined near
# it.  The backbone keeps the AFD's support spanning [0, 1] — the
# contamination estimator interpolates the AFD piecewise-linearly and
# treats points outside the support as probability zero
# (estimation/contamination.py pdf), so a peak-only set would hard-zero
# fraction candidates the reference scores with small finite density.
AFD_TOP_K = 16
AFD_BACKBONE_K = 16

# slack of the range-bound and lattice tests below, relative to max(1, |x|).
# f32 resolves ~1.2e-7; one backend rounds n*start + 1 once (an FMA), another
# twice, and a bound that lands on a grid point must not move that point in
# or out of the range on the last bit (a 1e-9 slack is below f32 resolution)
BOUND_TOL = 1e-6


def _ln_sub_exp(a, b):
    """log(exp(a) - exp(b)) for a >= b (clamped at -inf)."""
    out = a + _ln1mexp(jnp.minimum(b - a, 0.0))
    return jnp.where(b >= a, NEG_INF, out)


def _lse(x, axis):
    m = jnp.max(x, axis=axis, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.log(jnp.sum(jnp.exp(x - m_safe), axis=axis, keepdims=True)) + m_safe
    s = jnp.where(jnp.isfinite(m), s, m)
    if isinstance(axis, tuple):
        for ax in sorted([a % x.ndim for a in axis], reverse=True):
            s = jnp.squeeze(s, axis=ax)
        return s
    return jnp.squeeze(s, axis=axis)


def observable_bounds(start, end, left_excl, right_excl, n_obs):
    """Device version of VAFRange::observable_min/max
    (formula.rs:1172-1232). All args broadcast together; n_obs float."""
    n = jnp.maximum(n_obs, 1.0)
    possible = (end - start) * n_obs > 1.0 + BOUND_TOL
    small_n = n_obs < 10.0
    raw = small_n | ~possible

    # observable_max
    c_max = n_obs * end
    tol_max = BOUND_TOL * jnp.maximum(1.0, jnp.abs(c_max))
    is_int_max = jnp.abs(c_max - jnp.round(c_max)) < tol_max
    c_max = jnp.where(right_excl & is_int_max, c_max - 1.0, c_max)
    c_max = jnp.floor(c_max + tol_max)
    amax = jnp.where(raw | (c_max == 0.0), end, c_max / n)

    # observable_min
    c_min = n_obs * start
    tol_min = BOUND_TOL * jnp.maximum(1.0, jnp.abs(c_min))
    adj_min = jnp.ceil(c_min - tol_min) / n
    is_int_min = jnp.abs(c_min - jnp.round(c_min)) < tol_min
    cand1 = (c_min + 1.0) / n
    cand0 = c_min / n
    excl_min = jnp.where(
        (cand1 <= 1.0 + BOUND_TOL) & (cand1 <= amax + BOUND_TOL), cand1, cand0
    )
    amin = jnp.where(left_excl & is_int_min, excl_min, adj_min)
    amin = jnp.where(raw, start, amin)
    amin = jnp.where(amin >= amax - BOUND_TOL, start, amin)
    return amin, amax


def range_weights(grid, start, end, left_excl, right_excl, n_obs):
    """[..., G] log trapezoid weights for a range spectrum restricted to
    [observable_min, observable_max]. Leading dims come from the args."""
    amin, amax = observable_bounds(start, end, left_excl, right_excl, n_obs)
    amin = amin[..., None]
    amax = amax[..., None]
    inside = (grid >= amin - BOUND_TOL) & (grid <= amax + BOUND_TOL)
    left_in = jnp.concatenate(
        [jnp.zeros_like(inside[..., :1]), inside[..., :-1]], axis=-1
    )
    right_in = jnp.concatenate(
        [inside[..., 1:], jnp.zeros_like(inside[..., :1])], axis=-1
    )
    gl = jnp.where(left_in, jnp.concatenate([grid[:1], grid[:-1]]), grid)
    gr = jnp.where(right_in, jnp.concatenate([grid[1:], grid[-1:]]), grid)
    width = jnp.maximum(gr - gl, 0.0) * 0.5
    run_len = jnp.sum(inside, axis=-1, keepdims=True)
    single_width = jnp.maximum(amax - amin, 1e-12)
    width = jnp.where(run_len <= 1, single_width, width)
    return jnp.where(
        inside & (width > 0), jnp.log(jnp.maximum(width, 1e-38)), NEG_INF
    )


def _lfc_components(lfc_list):
    """Connected components of a branch's l2fc constraint graph (nodes =
    samples, edges = pairwise masks)."""
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, _ in lfc_list:
        parent[find(a)] = find(b)
    groups = {}
    for entry in lfc_list:
        groups.setdefault(find(entry[0]), []).append(entry)
    return list(groups.values())


class SampleConfig:
    def __init__(
        self,
        name,
        contaminated_by=None,
        contamination_fraction=0.0,
        resolution=None,
    ):
        self.name = name
        self.contaminated_by = contaminated_by
        self.contamination_fraction = contamination_fraction
        # per-sample integration resolution (scenario `resolution:` field,
        # generic.rs:357 `self.resolutions[*sample]`): range spectra of this
        # sample integrate over the lattice k*resolution (plus set points
        # and range endpoints), exactly like the reference terminates its
        # adaptive integration at this step size. None = the shared engine
        # grid (backward-compatible dense behavior).
        self.resolution = resolution


def _pair_class_setup(child_values, parent_values, fraction):
    """Unique (nu, kappa) classes of the contaminated-likelihood plane.

    Returns (nu_u [U] f32, kappa_u [U] f32, inv [Ac,Ap] int32) with
    plane[g_child, g_parent] = class inv[gc, gp].  The axes are the two
    samples' ACTIVE subgrids (per-sample resolution), which both shrinks
    the class set (U) and the gathered plane."""
    pur = np.float32(1.0 - fraction)
    imp = np.float32(fraction)
    gc = np.asarray(child_values, dtype=np.float32)
    gp = np.asarray(parent_values, dtype=np.float32)
    nu = pur * gc[:, None] + imp * gp[None, :]
    onec = (gc == 1.0).astype(np.float32)
    onep = (gp == 1.0).astype(np.float32)
    kappa = pur * onec[:, None] + imp * onep[None, :]
    pairs = np.stack([nu.ravel(), kappa.ravel()], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    return (
        uniq[:, 0].copy(),
        uniq[:, 1].copy(),
        inv.reshape(nu.shape).astype(np.int32),
    )


def _pair_loglik_classes(feats, mask, bias_alt, bias_ref, bias_any, nu_u, kappa_u):
    """[L, B, U] contaminated likelihood sums on the unique classes.
    feats [L,D,Fe]; bias [L,B,D]; nu_u/kappa_u [U]."""
    a, r, m, c, psa = _read_terms(feats, bias_alt, bias_ref, bias_any)
    psa_ = psa[:, :, None, :]  # [L,1,1,D]
    w = psa_ * nu_u[:, None] + kappa_u[:, None] * (1.0 - psa_)  # [L,1|B,U,D]
    return _ll_cells(
        a[:, :, None, :],
        r[:, :, None, :],
        m[:, :, None, :],
        c[:, :, None, :],
        w,
        mask[:, None, None, :],
    )


class PosteriorEngine:
    """Compiled engine for one scenario (event set + grid + contamination).

    jit-compiled once per (scenario, batch shape).
    """

    def __init__(
        self,
        events: list[EventSpec],
        grid: AFGrid,
        samples: list[SampleConfig],
        resolution: float = 0.01,
        all_uniform_prior: bool = False,
        valid_vaf_mask=None,
        n_artifact_combos: int | None = None,
    ):
        self.events = events
        self.grid = grid
        self.samples = samples
        self.resolution = resolution
        self.all_uniform_prior = all_uniform_prior
        self.n_samples = len(samples)
        # universe size of artifact combinations for the bias prior
        # (bias/mod.rs:131-218 splits 0.5 over all single-artifact combos,
        # independent of how many are active at a locus)
        self.n_artifact_combos = n_artifact_combos
        # [S, G] bool: per-sample grid points with nonzero prior mass
        # (prior.rs:298-438 zero structure — ploidy-0 contigs, uniform
        # universes, germline-multiple constraints). Applied as -inf
        # integration weight so impossible VAFs never contribute.
        self.valid_vaf_mask = (
            np.asarray(valid_vaf_mask, dtype=bool)
            if valid_vaf_mask is not None
            else None
        )

        # flatten branches
        self.branches = []
        for ei, ev in enumerate(events):
            for br in ev.branches:
                assert len(br.spectra) == self.n_samples, (
                    f"event {ev.name}: branch has {len(br.spectra)} spectra, "
                    f"expected {self.n_samples}"
                )
                self.branches.append((ei, br))
        self.n_branches = len(self.branches)

        G = grid.size
        NB = self.n_branches
        S = self.n_samples
        self.zero_idx = grid.index_of(0.0)

        # ---- per-sample ACTIVE subgrids (scenario per-sample resolution,
        # generic.rs:357).  A sample whose declared resolution is coarser
        # than the shared grid keeps only the lattice k*res plus its own
        # set values, range endpoints and {0, 1}; everything else keeps the
        # full shared grid (None / fine resolutions: bit-exact old path).
        gv64 = np.round(grid.values.astype(np.float64), 10)
        self.active_idx: list[np.ndarray] = []
        for si in range(S):
            res = getattr(samples[si], "resolution", None)
            if res is None or res <= resolution * (1.0 + 1e-9):
                self.active_idx.append(np.arange(G, dtype=np.int64))
                continue
            pts = {0.0, 1.0}
            ladder = set()
            k = 0
            while k * res <= 1.0 + res * 0.5:
                pts.add(round(min(k * res, 1.0), 10))
                k += 1
            for ei, br in self.branches:
                sp = br.spectra[si]
                if sp.kind == SPECTRUM_SET:
                    pts.update(round(float(v), 10) for v in sp.values)
                else:
                    start, end = float(sp.start), float(sp.end)
                    pts.add(round(start, 10))
                    pts.add(round(end, 10))
                    # METHOD: the reference's adaptive integration refines
                    # at resolution/3 spacing around the density optimum
                    # (adaptive_integration.rs:104-130).  The optimum of a
                    # range spectrum overwhelmingly sits at a range
                    # endpoint (e.g. the clear-ref normal's peak at 0), so
                    # statically refine a res/3 ladder inside each end.
                    for k in (1.0 / 3.0, 2.0 / 3.0):
                        for p in (start + k * res, end - k * res):
                            if start < p < end:
                                ladder.add(p)
            sel = np.zeros(G, dtype=bool)
            for v in pts:
                # snap to the NEAREST shared-grid slot: a resolution that
                # is not a multiple of the grid step (0.025, 1/3, ...)
                # produces lattice points between slots, and dropping them
                # would silently coarsen the integration far below the
                # declared per-sample resolution
                sel[int(np.argmin(np.abs(gv64 - v)))] = True
            for v in ladder:
                # refinement points snap likewise (off-lattice by design)
                sel[int(np.argmin(np.abs(gv64 - v)))] = True
            sel[self.zero_idx] = True
            self.active_idx.append(np.nonzero(sel)[0].astype(np.int64))
        self.values_s = [grid.values[idx] for idx in self.active_idx]
        self.zero_s = [
            int(np.nonzero(idx == self.zero_idx)[0][0]) for idx in self.active_idx
        ]
        self.valid_mask_s = [
            self.valid_vaf_mask[si][self.active_idx[si]]
            if self.valid_vaf_mask is not None
            else None
            for si in range(S)
        ]

        def _sub_index(si, vaf):
            vals = self.values_s[si]
            j = int(np.argmin(np.abs(vals.astype(np.float64) - vaf)))
            if abs(float(vals[j]) - vaf) > 1e-6:
                raise KeyError(
                    f"VAF {vaf} missing from sample {si} active subgrid"
                )
            return j

        self.is_range = np.zeros((NB, S), dtype=bool)
        self.rng_start = np.zeros((NB, S), dtype=np.float32)
        self.rng_end = np.zeros((NB, S), dtype=np.float32)
        self.rng_lexcl = np.zeros((NB, S), dtype=bool)
        self.rng_rexcl = np.zeros((NB, S), dtype=bool)
        # full-grid set masks kept for the compat `_branch_weights`
        self.set_mask = np.zeros((NB, S, G), dtype=bool)
        self.set_mask_s = [
            np.zeros((NB, len(self.active_idx[si])), dtype=bool)
            for si in range(S)
        ]
        self.spectrum_excludes_zero = np.zeros((NB, S), dtype=bool)
        self.spectrum_contains_zero = np.zeros((NB, S), dtype=bool)
        # static superset of each branch x sample integration support on the
        # sample's active subgrid (used only for einsum shift classes)
        support_s = [
            np.zeros((NB, len(self.active_idx[si])), dtype=bool)
            for si in range(S)
        ]
        for bi, (ei, br) in enumerate(self.branches):
            for si, sp in enumerate(br.spectra):
                sv = self.values_s[si]
                if sp.kind == SPECTRUM_SET:
                    self.set_mask[bi, si] = grid.set_mask(sp.values)
                    for v in sp.values:
                        self.set_mask_s[si][bi, _sub_index(si, v)] = True
                    # clear-ref shortcut (generic.rs:296-300): fires when
                    # every set VAF is > 0
                    self.spectrum_excludes_zero[bi, si] = all(v > 0 for v in sp.values)
                    self.spectrum_contains_zero[bi, si] = 0.0 in sp.values
                    support_s[si][bi] = self.set_mask_s[si][bi]
                else:
                    self.is_range[bi, si] = True
                    self.rng_start[bi, si] = sp.start
                    self.rng_end[bi, si] = sp.end
                    self.rng_lexcl[bi, si] = sp.left_exclusive
                    self.rng_rexcl[bi, si] = sp.right_exclusive
                    # clear-ref shortcut for ranges fires ONLY when
                    # start > 0 (generic.rs:342-347) - a left-exclusive
                    # ]0.0, x[ range is NOT short-cut (its observable_min
                    # is still integrated, formula.rs:1172-1232)
                    self.spectrum_excludes_zero[bi, si] = sp.start > 0
                    self.spectrum_contains_zero[bi, si] = sp.contains(0.0)
                    support_s[si][bi] = (sv >= sp.start - 1e-9) & (
                        sv <= sp.end + 1e-9
                    )
                if self.valid_mask_s[si] is not None:
                    support_s[si][bi] &= self.valid_mask_s[si]
        # per-sample spectrum-support classes for contraction shifts
        self.support_classes = []  # per sample: (class_of_branch [NB], masks [K,G])
        for si in range(S):
            keys = {}
            cls = np.zeros(NB, dtype=np.int64)
            masks = []
            for bi in range(NB):
                key = support_s[si][bi].tobytes()
                if key not in keys:
                    keys[key] = len(masks)
                    masks.append(support_s[si][bi])
                cls[bi] = keys[key]
            self.support_classes.append((cls, np.stack(masks)))

        self.branch_has_zero_point = self.spectrum_contains_zero.all(axis=1)

        self.event_branch_idx = [
            [bi for bi, (e, _) in enumerate(self.branches) if e == ei]
            for ei in range(len(events))
        ]
        self.branch_event = np.array(
            [e for (e, _) in self.branches], dtype=np.int32
        )
        self.event_is_artifact = [ev.is_artifact for ev in events]
        self.event_all_absent = [ev.all_absent() for ev in events]

        # l2fc constraints: per-branch pairwise [Ga,Gb] masks over the two
        # samples' active subgrids
        # (utils/log2_fold_change.rs; vaftree NodeKind::Log2FoldChange)
        self.branch_lfc_masks = {}  # bi -> list[(sample_a, sample_b, mask [Ga,Gb])]
        for bi, (ei, br) in enumerate(self.branches):
            if not br.lfcs:
                continue
            by_pair = {}
            for lfc in br.lfcs:
                # canonicalize to (min_sample, max_sample) orientation
                if lfc.sample_a <= lfc.sample_b:
                    key = (lfc.sample_a, lfc.sample_b)
                    va_list = self.values_s[lfc.sample_a].astype(np.float64)
                    vb_list = self.values_s[lfc.sample_b].astype(np.float64)
                    m = np.zeros((len(va_list), len(vb_list)), dtype=bool)
                    for ia, va in enumerate(va_list):
                        for ib, vb in enumerate(vb_list):
                            m[ia, ib] = lfc.holds(va, vb)
                else:
                    key = (lfc.sample_b, lfc.sample_a)
                    va_list = self.values_s[lfc.sample_a].astype(np.float64)
                    vb_list = self.values_s[lfc.sample_b].astype(np.float64)
                    m = np.zeros((len(vb_list), len(va_list)), dtype=bool)
                    for ia, va in enumerate(va_list):
                        for ib, vb in enumerate(vb_list):
                            m[ib, ia] = lfc.holds(va, vb)
                prev = by_pair.get(key)
                by_pair[key] = m if prev is None else (prev & m)
            self.branch_lfc_masks[bi] = [
                (a, b, m) for (a, b), m in by_pair.items()
            ]

        # contraction units: the contamination graph is a forest (each sample
        # has at most one contaminant parent; chains and shared contaminants
        # are allowed). Components are contracted by variable elimination
        # along the tree, so the factor tensors never exceed two grid axes.
        self.parent = [s.contaminated_by for s in samples]
        self.pairs = [
            (si, s.contaminated_by, s.contamination_fraction)
            for si, s in enumerate(samples)
            if s.contaminated_by is not None
        ]
        # unique (nu, kappa) gather classes per contaminated sample, on the
        # (child, parent) active subgrids
        self.pair_class = {
            si: _pair_class_setup(self.values_s[si], self.values_s[by], frac)
            for si, by, frac in self.pairs
        }
        # mutual contamination (A contaminated by B AND B by A) is a 2-cycle:
        # two pairwise factors over the same two grid axes — handled by the
        # tree eliminator directly.  Longer cycles (each sample has at most
        # one contaminant parent, so every component is a "rho": at most one
        # cycle with trees hanging off it) take the tree-width-2 path in
        # _component_reduce_cyclic.
        comp_of = list(range(S))

        def find(x):
            while comp_of[x] != x:
                comp_of[x] = comp_of[comp_of[x]]
                x = comp_of[x]
            return x

        for si, by, _ in self.pairs:
            comp_of[find(si)] = find(by)
        groups: dict[int, list] = {}
        for si in range(S):
            groups.setdefault(find(si), []).append(si)
        self.components = [sorted(v) for v in groups.values()]
        self.singletons = [c[0] for c in self.components if len(c) == 1]
        # samples whose own single-axis likelihood is needed (contamination
        # roots; a contaminated child's evidence enters via the pair factor)
        self.root_samples = [si for si in range(S) if self.parent[si] is None]

        self._run = jax.jit(self._run_impl)

        # AFD subgrid indices fit u8 when every active subgrid is < 256
        # points (typical: G=103); 4 pack into each f32 word of the wire
        self._afd_idx_u8 = all(
            len(self.active_idx[si]) <= 255 for si in range(S)
        )

        def _pack_out(out, mask):
            # ONE flat f32 wire buffer, assembled INSIDE the jit: every
            # un-jitted jnp op is a separate dispatch, every separate
            # fetch is a separate device->host copy, and np.asarray(mask)
            # on a device array re-fetched the [L,S,D] bool mask (~4 MB at
            # batch 32k).  `joint` is derived on the
            # host (posteriors + marginal) and not shipped at all; the
            # combo_joint panel is reduced to its argmax ``map_slot`` on
            # device (the callers only consume the MAP artifact slot).
            # Layout: f32 section | i16 section (bitcast, even-padded) |
            # u8 afd_idx section (bitcast, mult-of-4 padded, when indices
            # fit u8).  n_obs clamps to the int16 ceiling of the packed
            # buffer (pileups are depth-capped far below this).
            n_obs = jnp.minimum(mask.sum(axis=-1), 32767).astype(jnp.int16)
            map_slot = jnp.argmax(out["combo_joint"], axis=1).astype(jnp.int16)
            f32_flat = jnp.concatenate(
                [
                    out[k].astype(jnp.float32).ravel()
                    for k in ("posteriors", "marginal", "af")
                ]
            )
            i16_parts = [
                out["densities_dphred"].ravel(),
                out["best_nonartifact"].astype(jnp.int16).ravel(),
                map_slot.ravel(),
                n_obs.ravel(),
            ]
            if not self._afd_idx_u8:
                i16_parts.append(out["afd_idx"].ravel())
            i16_flat = jnp.concatenate(i16_parts)
            pad16 = (-i16_flat.size) % 2
            if pad16:
                i16_flat = jnp.concatenate(
                    [i16_flat, jnp.zeros((pad16,), jnp.int16)]
                )
            sections = [
                f32_flat,
                jax.lax.bitcast_convert_type(
                    i16_flat.reshape(-1, 2), jnp.float32
                ),
            ]
            if self._afd_idx_u8:
                u8_flat = out["afd_idx"].astype(jnp.uint8).ravel()
                pad8 = (-u8_flat.size) % 4
                if pad8:
                    u8_flat = jnp.concatenate(
                        [u8_flat, jnp.zeros((pad8,), jnp.uint8)]
                    )
                sections.append(
                    jax.lax.bitcast_convert_type(
                        u8_flat.reshape(-1, 4), jnp.float32
                    )
                )
            return jnp.concatenate(sections)

        self._pack_out = _pack_out

        def _packed_impl(*args):
            return _pack_out(self._run_impl(*args), args[1])

        self._run_packed = jax.jit(_packed_impl)
        self._run_packed_compact = None  # built lazily by run_compact

    # ------------------------------------------------------------------
    def _branch_weights(self, n_obs):
        """[L, NB, S, G] log integration weights on the FULL shared grid.

        Compat/diagnostic path (parity tests); the engine itself uses the
        per-sample `_weights_list`."""
        grid = jnp.asarray(self.grid.values)
        n = n_obs[:, None, :]  # [L,1,S]
        start = jnp.asarray(self.rng_start)[None]  # [1,NB,S]
        end = jnp.asarray(self.rng_end)[None]
        lex = jnp.asarray(self.rng_lexcl)[None]
        rex = jnp.asarray(self.rng_rexcl)[None]
        shape = jnp.broadcast_shapes(n.shape, start.shape)
        rw = range_weights(
            grid,
            jnp.broadcast_to(start, shape),
            jnp.broadcast_to(end, shape),
            jnp.broadcast_to(lex, shape),
            jnp.broadcast_to(rex, shape),
            jnp.broadcast_to(n, shape),
        )  # [L,NB,S,G]
        setw = jnp.where(jnp.asarray(self.set_mask)[None], 0.0, NEG_INF)
        w = jnp.where(jnp.asarray(self.is_range)[None, :, :, None], rw, setw)
        if self.valid_vaf_mask is not None:
            w = w + jnp.where(
                jnp.asarray(self.valid_vaf_mask)[None, None], 0.0, NEG_INF
            )
        return w

    def _weights_list(self, n_obs):
        """Per-sample [L, NB, G_i] log integration weights on the active
        subgrid (trapezoid widths taken on the SUBGRID lattice — the
        sample's declared integration resolution)."""
        out = []
        for si in range(self.n_samples):
            vals = jnp.asarray(self.values_s[si])
            n = n_obs[:, si][:, None]  # [L,1]
            start = jnp.asarray(self.rng_start[:, si])[None]  # [1,NB]
            end = jnp.asarray(self.rng_end[:, si])[None]
            lex = jnp.asarray(self.rng_lexcl[:, si])[None]
            rex = jnp.asarray(self.rng_rexcl[:, si])[None]
            shape = jnp.broadcast_shapes(n.shape, start.shape)
            rw = range_weights(
                vals,
                jnp.broadcast_to(start, shape),
                jnp.broadcast_to(end, shape),
                jnp.broadcast_to(lex, shape),
                jnp.broadcast_to(rex, shape),
                jnp.broadcast_to(n, shape),
            )  # [L,NB,Gi]
            setw = jnp.where(jnp.asarray(self.set_mask_s[si])[None], 0.0, NEG_INF)
            w = jnp.where(
                jnp.asarray(self.is_range[:, si])[None, :, None], rw, setw
            )
            if self.valid_mask_s[si] is not None:
                w = w + jnp.where(
                    jnp.asarray(self.valid_mask_s[si])[None, None], 0.0, NEG_INF
                )
            out.append(w)
        return out

    # ------------------------------------------------------------------
    def _lse_contract(self, F, S, classes, class_masks):
        """logsumexp over v of F[l,b,v,u] + S[l,b,n,v] -> [l,b,n,u].

        Shifted-exp einsum (a matrix product): shifts are taken per spectrum-support
        class of the eliminated sample so that exp underflow only drops
        terms negligible relative to the in-support maximum.
        classes: np [NB] -> class id; class_masks: np [K, Gv] bool.
        """
        L, B = F.shape[0], F.shape[1]
        Gu = F.shape[3]
        mS = jnp.max(S, axis=-1)  # [L,B,NB]
        mS_s = jnp.where(jnp.isfinite(mS), mS, 0.0)
        Q = jnp.exp(S - mS_s[..., None])  # [L,B,NB,Gv]
        out = jnp.zeros((L, B, S.shape[2], Gu))
        for k in range(class_masks.shape[0]):
            idx = tuple(int(i) for i in np.nonzero(classes == k)[0])
            if not idx:
                continue
            cmask = jnp.asarray(class_masks[k])  # [Gv]
            Fk = jnp.where(cmask[None, None, :, None], F, NEG_INF)
            mF = jnp.max(Fk, axis=2)  # [L,B,Gu]
            mF_s = jnp.where(jnp.isfinite(mF), mF, 0.0)
            P = jnp.where(
                cmask[None, None, :, None],
                jnp.exp(Fk - mF_s[:, :, None, :]),
                0.0,
            )  # [L,B,Gv,Gu]
            Qk = Q[:, :, idx, :]
            # f32 at full precision: a GPU runs f32 products in TF32 by
            # default (~3 decimal digits), which would move PHRED values
            R = jnp.einsum(
                "lbvu,lbnv->lbnu", P, Qk, precision=jax.lax.Precision.HIGHEST
            )
            vals = jnp.log(R) + mF_s[:, :, None, :] + mS_s[:, :, idx, None]
            out = out.at[:, :, idx, :].set(vals)
        return out

    def _component_reduce(self, comp, loglik, pair_logliks, w_list, keep=None):
        """Tree variable elimination over a component's grid axes.

        loglik {si: [L,B,G_i]} (own-likelihoods of root samples);
        pair_logliks {si: [L,B,G_i,G_parent]}; w_list [si] = [L,NB,G_i].
        Returns [L,B,NB] (keep=None) or [L,B,NB,G_keep] (keep's own axis
        retained).
        """
        from collections import deque

        cyc = self._component_cycle(comp)
        if len(cyc) >= 3:
            return self._component_reduce_cyclic(
                comp, cyc, loglik, pair_logliks, w_list, keep
            )

        NB = self.n_branches
        adj = {si: set() for si in comp}
        for si in comp:
            p = self.parent[si]
            if p is not None and p in adj:
                adj[si].add(p)
                adj[p].add(si)
        root = keep if keep is not None else comp[0]
        depth = {root: 0}
        dq = deque([root])
        while dq:
            u0 = dq.popleft()
            for v2 in adj[u0]:
                if v2 not in depth:
                    depth[v2] = depth[u0] + 1
                    dq.append(v2)
        order = sorted(comp, key=lambda s: -depth[s])

        # per-node 1-var parts: start with weights (+ own loglik for roots)
        parts = {}
        for si in comp:
            p_list = [w_list[si][:, None]]  # [L,1,NB,Gi]
            if self.parent[si] is None:
                p_list.append(loglik[si][:, :, None, :])  # [L,B,1,Gi]
            parts[si] = p_list
        # 2-var factors: (child, parent) -> F [L,B,Gchild,Gparent]
        edge_factors = {}
        for si in comp:
            p = self.parent[si]
            if p is not None and p in adj:
                edge_factors.setdefault(frozenset((si, p)), []).append(
                    (si, p, pair_logliks[si])
                )

        for v in order:
            if keep is not None and v == keep:
                continue
            nbrs = [u for u in adj[v] if frozenset((v, u)) in edge_factors]
            if not nbrs:
                continue  # singleton root handled at the end
            assert len(nbrs) == 1, "contamination graph is not a tree"
            u = nbrs[0]
            Fs = None
            for child, par, t in edge_factors.pop(frozenset((v, u))):
                tt = t if child == v else jnp.swapaxes(t, -1, -2)
                Fs = tt if Fs is None else Fs + tt  # mutual 2-cycle sums both
            S_v = None
            for p_ in parts.pop(v):
                S_v = p_ if S_v is None else S_v + p_
            S_v = jnp.broadcast_to(
                S_v,
                (S_v.shape[0], Fs.shape[1], NB, S_v.shape[-1]),
            )
            classes, class_masks = self.support_classes[v]
            msg = self._lse_contract(Fs, S_v, classes, class_masks)
            parts[u].append(msg)
            adj[u].discard(v)

        out = None
        for p_ in parts[root]:
            out = p_ if out is None else out + p_
        B = max(
            (t.shape[1] for t in loglik.values()),
            default=next(iter(pair_logliks.values())).shape[1]
            if pair_logliks
            else 1,
        )
        out = jnp.broadcast_to(
            out, (out.shape[0], B, NB, out.shape[-1])
        )
        if keep is not None:
            return out
        return _lse(out, axis=-1)

    def _component_cycle(self, comp):
        """Cycle nodes of a component in parent order (parent(c[i]) ==
        c[i+1 % k]), or [].  Each sample has at most one contaminant
        parent, so a component contains at most one cycle."""
        compset = set(comp)
        seen = {}
        p = comp[0]
        while p is not None and p in compset:
            if p in seen:
                cyc = [p]
                q = self.parent[p]
                while q != p:
                    cyc.append(q)
                    q = self.parent[q]
                return cyc
            seen[p] = True
            p = self.parent[p]
        # comp[0]'s chain ended at a root: the component is a tree (a
        # cycle, if present, is reachable from EVERY node's chain)
        return []

    def _component_reduce_cyclic(
        self, comp, cyc, loglik, pair_logliks, w_list, keep=None
    ):
        """Variable elimination for a rho-shaped component (one
        contamination cycle of length >= 3 with trees hanging off it).

        The cycle is contracted with a running two-axis frontier
        T[L,B,NB,G_i,G_base] — eliminating around the cycle keeps the
        treewidth at 2, matching the reference's semantics where the
        nested adaptive integration simply enumerates the full joint
        (generic.rs:191-460; contamination graphs are unrestricted there).
        Direct logsumexp (not the shifted einsum) — cyclic scenarios are
        rare and small, clarity wins over matrix-unit use here.
        """
        NB = self.n_branches
        B = next(iter(pair_logliks.values())).shape[1]
        cycset = set(cyc)

        parts = {si: [w_list[si][:, None]] for si in comp}
        for si in comp:
            if self.parent[si] is None:
                parts[si].append(loglik[si][:, :, None, :])

        # attachment/base node on the cycle + the keep->cycle path
        if keep is None or keep in cycset:
            base = keep if keep is not None else cyc[0]
            path = []
        else:
            path = [keep]
            p = self.parent[keep]
            while p not in cycset:
                path.append(p)
                p = self.parent[p]
            base = p
        path_set = set(path)

        def S_of(v):
            s = None
            for p_ in parts.pop(v):
                s = p_ if s is None else s + p_
            return jnp.broadcast_to(s, (s.shape[0], B, NB, s.shape[-1]))

        # 1) eliminate pure tree nodes into their parents, deepest first
        def dist_to_cycle(v):
            d, p = 0, v
            while p not in cycset:
                p = self.parent[p]
                d += 1
            return d

        tree_nodes = [v for v in comp if v not in cycset and v not in path_set]
        for v in sorted(tree_nodes, key=lambda v: -dist_to_cycle(v)):
            u = self.parent[v]
            msg = self._lse_contract(
                pair_logliks[v], S_of(v), *self.support_classes[v]
            )
            parts[u].append(msg)

        # 2) contract the cycle into base (keeping g_base)
        i0 = cyc.index(base)
        order = cyc[i0:] + cyc[:i0]  # order[0]=base, parent(order[i])=order[i+1]
        k = len(order)
        F0 = pair_logliks[order[0]]  # [L,B,G_base,G_b1]
        T = jnp.swapaxes(F0, -1, -2)[:, :, None] + S_of(order[1])[..., None]
        # T: [L,B,NB,G_b1,G_base]
        for i in range(1, k - 1):
            Fi = pair_logliks[order[i]]  # [L,B,G_bi,G_bi+1]
            T = _lse(
                T[:, :, :, :, None, :] + Fi[:, :, None, :, :, None], axis=3
            )  # [L,B,NB,G_bi+1,G_base]
            if i + 1 < k:
                T = T + S_of(order[i + 1])[..., None]
        Fk = pair_logliks[order[-1]]  # [L,B,G_bk-1,G_base]
        M = _lse(T + Fk[:, :, None, :, :], axis=-2)  # [L,B,NB,G_base]
        parts[base].append(M)

        # 3) walk the keep path: eliminate base down toward keep
        cur = base
        for v in reversed(path):
            F = jnp.swapaxes(pair_logliks[v], -1, -2)  # [L,B,G_cur,G_v]
            msg = self._lse_contract(F, S_of(cur), *self.support_classes[cur])
            parts[v].append(msg)
            cur = v

        out = None
        for p_ in parts[cur]:
            out = p_ if out is None else out + p_
        out = jnp.broadcast_to(out, (out.shape[0], B, NB, out.shape[-1]))
        if keep is not None:
            return out
        return _lse(out, axis=-1)

    def _lfc_group_joint(
        self, constraints, nodes, loglik, pair_logliks, w_list, bi,
        comp_of_sample,
    ):
        """Generic l2fc fallback: jointly enumerate the union of the
        contamination components touched by a constraint cluster under all
        pairwise l2fc masks.

        Covers the shapes the structured paths cannot: cyclic constraint
        graphs, chains over contaminated samples, and arbitrary
        contamination topologies.  The reference composes these freely
        inside the vaftree recursion (log2_fold_change.rs:10-134, the
        nested integration simply enumerates the joint); here the product
        space is enumerated with a lax.scan over all but the two largest
        grid axes, so memory stays at one [L,B,Gx,Gy] slab.
        Returns ([L,B] integral, [L,B] all-zero-point value).
        """
        union = sorted({s for n in nodes for s in comp_of_sample[n]})
        joint_cells = int(
            np.prod([len(self.values_s[s]) for s in union])
        )
        if joint_cells > 2_000_000:
            raise ValueError(
                f"l2fc constraint cluster spans a joint grid of "
                f"{joint_cells} cells over samples {union}; coarsen "
                "per-sample `resolution:` in the scenario"
            )
        L = w_list[0].shape[0]
        B = (
            next(iter(pair_logliks.values())).shape[1]
            if pair_logliks
            else next(iter(loglik.values())).shape[1]
        )
        d = {}
        for s in union:
            ds = w_list[s][:, bi][:, None, :]  # [L,1,Gs]
            if self.parent[s] is None:
                ds = ds + loglik[s]
            d[s] = jnp.broadcast_to(ds, (L, B, ds.shape[-1]))
        factors = []  # (x, y, tensor broadcastable to [L,B,Gx,Gy])
        for s in union:
            p = self.parent[s]
            if p is not None:
                factors.append((s, p, pair_logliks[s]))
        for a, b, m in constraints:
            factors.append(
                (a, b, jnp.where(jnp.asarray(m), 0.0, NEG_INF)[None, None])
            )

        z = jnp.zeros((L, B))
        for s in union:
            z = z + d[s][..., self.zero_s[s]]
        for x2, y2, Fxy in factors:
            z = z + Fxy[..., self.zero_s[x2], self.zero_s[y2]]

        order = sorted(union, key=lambda s: d[s].shape[-1])
        x, y = order[-2], order[-1]
        lead = order[:-2]
        slab_base = d[x][:, :, :, None] + d[y][:, :, None, :]
        lead_factors = []
        for a2, b2, Fab in factors:
            if {a2, b2} <= {x, y}:
                t = Fab if (a2, b2) == (x, y) else jnp.swapaxes(Fab, -1, -2)
                slab_base = slab_base + t
            else:
                lead_factors.append((a2, b2, Fab))
        if not lead:
            return _lse(slab_base, axis=(-2, -1)), z

        lead_sizes = tuple(d[s].shape[-1] for s in lead)
        lead_pos = {s: i for i, s in enumerate(lead)}

        def step(carry, t):
            coords = jnp.unravel_index(t, lead_sizes)
            slab = slab_base
            for s in lead:
                gi = coords[lead_pos[s]]
                slab = slab + jnp.take(d[s], gi, axis=-1)[:, :, None, None]
            for a2, b2, Fab in lead_factors:
                if a2 in lead_pos and b2 in lead_pos:
                    v = jnp.take(
                        jnp.take(Fab, coords[lead_pos[a2]], axis=2),
                        coords[lead_pos[b2]],
                        axis=2,
                    )
                    slab = slab + v[:, :, None, None]
                elif a2 in lead_pos:
                    v = jnp.take(Fab, coords[lead_pos[a2]], axis=2)
                    slab = slab + (
                        v[:, :, :, None] if b2 == x else v[:, :, None, :]
                    )
                else:
                    v = jnp.take(Fab, coords[lead_pos[b2]], axis=3)
                    slab = slab + (
                        v[:, :, :, None] if a2 == x else v[:, :, None, :]
                    )
            val = _lse(slab, axis=(-2, -1))
            return jnp.logaddexp(carry, val), None

        init = jnp.full((L, B), NEG_INF)
        total, _ = jax.lax.scan(
            step, init, jnp.arange(int(np.prod(lead_sizes)))
        )
        return total, z

    def _lfc_tree_eliminate(self, group, nodes, loglik, w_list, bi):
        """Chained l2fc over singleton samples: eliminate the acyclic
        constraint graph leaf-to-root with pairwise mask contractions.
        Returns ([L,B] integral, [L,B] all-zero-point value)."""
        from collections import deque

        adj = {s: [] for s in nodes}
        for a, b, m in group:
            adj[a].append((b, m, True))  # mask oriented (a, b)
            adj[b].append((a, m, False))
        root = nodes[0]
        depth = {root: 0}
        order = []
        dq = deque([root])
        while dq:
            u = dq.popleft()
            order.append(u)
            for v, _, _ in adj[u]:
                if v not in depth:
                    depth[v] = depth[u] + 1
                    dq.append(v)
        d = {
            s: loglik[s] + w_list[s][:, bi][:, None, :]  # [L,B,Gs]
            for s in nodes
        }
        z = None
        for s in nodes:
            zv = d[s][:, :, self.zero_s[s]]
            z = zv if z is None else z + zv
        for a, b, m in group:
            z = z + jnp.where(
                jnp.asarray(m[self.zero_s[a], self.zero_s[b]]), 0.0, NEG_INF
            )
        done = set()
        for v in sorted(nodes, key=lambda s: -depth[s]):
            if v == root:
                continue
            # unique parent = the neighbor closer to the root
            for u, m, oriented_vu in adj[v]:
                if depth[u] == depth[v] - 1 and (v, u) not in done:
                    lm = jnp.where(jnp.asarray(m if oriented_vu else m.T), 0.0, NEG_INF)
                    # lse over v's axis against the mask -> message to u
                    msg = _lse(
                        d[v][:, :, :, None] + lm[None, None], axis=2
                    )  # [L,B,Gu]
                    d[u] = d[u] + msg
                    done.add((v, u))
                    break
        return _lse(d[root], axis=-1), z

    def _unit_terms(self, loglik, pair_logliks, w_list, B):
        """Per-unit branch integrals.

        Returns:
          U: dict[unit_key] -> [L,B,NB] unit integral
          Uzero: dict[unit_key] -> [L,B,NB] unit value at all-zero point
        """
        U = {}
        Uzero = {}
        NB = self.n_branches
        for comp in self.components:
            key = ("c",) + tuple(comp)
            U[key] = self._component_reduce(comp, loglik, pair_logliks, w_list)
            zval = None
            for si in comp:
                zi = self.zero_s[si]
                tz = w_list[si][:, :, zi][:, None]  # [L,1,NB]
                if self.parent[si] is None:
                    tz = tz + loglik[si][:, :, zi][:, :, None]
                else:
                    zp = self.zero_s[self.parent[si]]
                    tz = tz + pair_logliks[si][:, :, zi, zp][:, :, None]
                zval = tz if zval is None else zval + tz
            Uzero[key] = jnp.broadcast_to(
                zval, (zval.shape[0], B, NB)
            )
        return U, Uzero

    def _pair_logliks(self, feats, mask, bias_alt, bias_ref, bias_any):
        """Materialize [L,B,Gc,Gp] contaminated likelihoods via the unique
        (nu, kappa) class gather."""
        out = {}
        for si, by, frac in self.pairs:
            nu_u, kappa_u, inv = self.pair_class[si]
            ll_u = _pair_loglik_classes(
                feats[:, si],
                mask[:, si],
                bias_alt[:, si],
                bias_ref[:, si],
                bias_any[:, si],
                jnp.asarray(nu_u),
                jnp.asarray(kappa_u),
            )  # [L,B,U]
            out[si] = ll_u[:, :, jnp.asarray(inv)]  # [L,B,Gc,Gp]
        return out

    def _run_impl(
        self,
        feats,
        mask,
        bias_alt,
        bias_ref,
        bias_any,
        combo_active,
        branch_gates,
        ln_prior_absent,
        ln_prior_joint=None,
        n_artifact_active=None,
    ):
        L, S, D, _ = feats.shape
        B = bias_alt.shape[2]
        NB = self.n_branches

        n_obs = jnp.sum(mask, axis=-1).astype(jnp.float32)  # [L,S]

        # own-likelihood grids only for contamination roots, each on its
        # active subgrid
        loglik = {}
        for si in self.root_samples:
            vals = jnp.asarray(self.values_s[si])
            loglik[si] = sample_loglik_grid(
                feats[:, si : si + 1],
                mask[:, si : si + 1],
                bias_alt[:, si : si + 1],
                bias_ref[:, si : si + 1],
                bias_any[:, si : si + 1],
                vals,
            )[:, 0]  # [L,B,Gi]

        pair_logliks = self._pair_logliks(
            feats, mask, bias_alt, bias_ref, bias_any
        )

        # clear-ref shortcut (generic.rs:270-300)
        p_ref = feats[..., F["prob_ref"]]
        p_alt = feats[..., F["prob_alt"]]
        positive_ref = (p_ref - p_alt) > LN_32
        clear_ref = (n_obs > 10) & jnp.all(positive_ref | ~mask, axis=-1)  # [L,S]

        w_list = self._weights_list(n_obs)  # per sample [L,NB,Gi]
        excl0 = jnp.asarray(self.spectrum_excludes_zero)  # [NB,S]
        w_list = [
            jnp.where(
                (clear_ref[:, si][:, None] & excl0[:, si][None])[..., None],
                NEG_INF,
                w_list[si],
            )
            for si in range(S)
        ]

        U, Uzero = self._unit_terms(loglik, pair_logliks, w_list, B)

        T = jnp.zeros((L, B, NB))
        Z = jnp.zeros((L, B, NB))
        for key, val in U.items():
            T = T + val
            Z = Z + Uzero[key]

        # branches with l2fc constraints: re-contract the constrained sample
        # pairs jointly under the pairwise grid mask
        if self.branch_lfc_masks:
            comp_of_sample = {}
            for comp in self.components:
                for s in comp:
                    comp_of_sample[s] = tuple(comp)
            for bi, lfc_list in self.branch_lfc_masks.items():
                coupled = {s for (a, b, _) in lfc_list for s in (a, b)}
                coupled_comps = {comp_of_sample[s] for s in coupled}
                t_bi = jnp.zeros((L, B))
                z_bi = jnp.zeros((L, B))
                for key, val in U.items():
                    if tuple(key[1:]) in coupled_comps:
                        continue
                    t_bi = t_bi + val[:, :, bi]
                    z_bi = z_bi + Uzero[key][:, :, bi]
                # group constraints into connected components of the
                # constraint graph; chained constraints (shared samples)
                # are eliminated along the tree (log2_fold_change.rs
                # composes freely inside the vaftree recursion).  Groups
                # that touch the SAME contamination component must merge
                # into one cluster — their integrals share grid axes and
                # may only be counted once.
                lfc_groups = [
                    list(g) for g in _lfc_components(lfc_list)
                ]
                merged = True
                while merged:
                    merged = False
                    for i in range(len(lfc_groups)):
                        ci = {
                            comp_of_sample[s]
                            for (a, b, _) in lfc_groups[i]
                            for s in (a, b)
                            if len(comp_of_sample[s]) > 1
                        }
                        for j in range(i + 1, len(lfc_groups)):
                            cj = {
                                comp_of_sample[s]
                                for (a, b, _) in lfc_groups[j]
                                for s in (a, b)
                                if len(comp_of_sample[s]) > 1
                            }
                            if ci & cj:
                                lfc_groups[i].extend(lfc_groups.pop(j))
                                merged = True
                                break
                        if merged:
                            break
                for group in lfc_groups:
                    nodes = sorted({s for (a, b, _) in group for s in (a, b)})
                    all_singleton = all(s in self.singletons for s in nodes)
                    acyclic = len(group) == len(nodes) - 1
                    if len(group) > 1:
                        if all_singleton and acyclic:
                            t_c, z_c = self._lfc_tree_eliminate(
                                group, nodes, loglik, w_list, bi
                            )
                        else:
                            # cyclic graphs / chains over contaminated
                            # samples: generic joint enumeration
                            t_c, z_c = self._lfc_group_joint(
                                group, nodes, loglik, pair_logliks,
                                w_list, bi, comp_of_sample,
                            )
                        t_bi = t_bi + t_c
                        z_bi = z_bi + z_c
                        continue
                    a, b, mask_np = group[0]
                    za, zb = self.zero_s[a], self.zero_s[b]
                    lfc_mask = jnp.where(jnp.asarray(mask_np), 0.0, NEG_INF)
                    if a in self.singletons and b in self.singletons:
                        da = loglik[a] + w_list[a][:, bi][:, None, :]  # [L,B,Ga]
                        db = loglik[b] + w_list[b][:, bi][:, None, :]
                        joint_ab = (
                            da[:, :, :, None]
                            + db[:, :, None, :]
                            + lfc_mask[None, None]
                        )
                        t_bi = t_bi + _lse(joint_ab, axis=(-2, -1))
                        z00 = da[:, :, za] + db[:, :, zb] + lfc_mask[za, zb]
                        z_bi = z_bi + z00
                        continue
                    # both contaminated by the same parent (star component,
                    # e.g. tumor_pre/tumor_post both contaminated by normal):
                    # contract lse over (ga, gb, gp) with a scan over the
                    # parent grid so memory stays at [L,B,Ga,Gb]
                    p = self.parent[a]
                    if (
                        p is None
                        or self.parent[b] != p
                        or self.parent[p] is not None
                        or comp_of_sample[a] != comp_of_sample[b]
                    ):
                        # any other shape (l2fc against one's own
                        # contaminant, deeper chains, ...): generic joint
                        # enumeration
                        t_c, z_c = self._lfc_group_joint(
                            group, nodes, loglik, pair_logliks, w_list,
                            bi, comp_of_sample,
                        )
                        t_bi = t_bi + t_c
                        z_bi = z_bi + z_c
                        continue
                    comp = comp_of_sample[a]
                    zp = self.zero_s[p]
                    fa = pair_logliks[a] + w_list[a][:, bi][:, None, :, None]
                    fb = pair_logliks[b] + w_list[b][:, bi][:, None, :, None]
                    rp = loglik[p] + w_list[p][:, bi][:, None, :]  # [L,B,Gp]
                    rp_zero = rp[..., zp]
                    for c in comp:
                        if c in (a, b, p):
                            continue
                        fc = pair_logliks[c] + w_list[c][:, bi][:, None, :, None]
                        rp = rp + _lse(fc, axis=-2)
                        rp_zero = rp_zero + fc[..., self.zero_s[c], zp]

                    def _gp_step(carry, xs):
                        fa_g, fb_g, rp_g = xs  # [L,B,Ga], [L,B,Gb], [L,B]
                        slab = (
                            fa_g[:, :, :, None]
                            + fb_g[:, :, None, :]
                            + lfc_mask[None, None]
                        )
                        val = _lse(slab, axis=(-2, -1)) + rp_g
                        return jnp.logaddexp(carry, val), None

                    init = jnp.full((L, B), NEG_INF)
                    xs = (
                        jnp.moveaxis(fa, -1, 0),
                        jnp.moveaxis(fb, -1, 0),
                        jnp.moveaxis(rp, -1, 0),
                    )
                    total, _ = jax.lax.scan(_gp_step, init, xs)
                    t_bi = t_bi + total
                    z00 = (
                        fa[..., za, zp]
                        + fb[..., zb, zp]
                        + lfc_mask[za, zb]
                        + rp_zero
                    )
                    z_bi = z_bi + z00
                T = T.at[:, :, bi].set(t_bi)
                Z = Z.at[:, :, bi].set(z_bi)

        # full-prior mode (--full-prior): evaluate the prior pointwise on
        # the joint grid instead of the absent-only split.  ln_prior_joint
        # comes in on each sample's ACTIVE subgrid
        # ((L,) + tuple(len(values_s[si]))) — call.py builds it from
        # engine.values_s; no subsetting happens here.
        if ln_prior_joint is not None:
            # l2fc constraints under --full-prior: fold the per-branch
            # pairwise masks into the joint evaluation (the absent-split
            # path above is bypassed in full-prior mode, so the masks must
            # enter here or they would be silently dropped)
            lfc_by_pair = {}
            if self.branch_lfc_masks:
                NB_ = self.n_branches
                for bi, lfc_list in self.branch_lfc_masks.items():
                    for a, b, m in lfc_list:
                        key = (a, b)
                        if key not in lfc_by_pair:
                            lfc_by_pair[key] = np.zeros(
                                (NB_,) + m.shape, dtype=np.float32
                            )
                        lfc_by_pair[key][bi] += np.where(m, 0.0, -np.inf)
                lfc_by_pair = {
                    k: jnp.asarray(v) for k, v in lfc_by_pair.items()
                }
            if S == 1:
                P = ln_prior_joint  # [L,G0] on the active subgrid
                d0 = loglik[0][:, :, None, :] + w_list[0][:, None]  # [L,B,NB,G0]
                T = _lse(d0 + P[:, None, None, :], axis=-1)
            elif S == 2 and self.pairs:
                si, by, _ = self.pairs[0]
                pl = pair_logliks[si]  # [L,B,Gc,Gp]
                wp = w_list[si][:, None, :, :, None]  # [L,1,NB,Gc,1]
                wc = w_list[by][:, None, :, None, :]  # [L,1,NB,1,Gp]
                if self.parent[by] is not None:
                    # mutual contamination (2-cycle): BOTH samples carry a
                    # two-axis pair likelihood; neither has an own-axis term
                    pl = pl + jnp.swapaxes(pair_logliks[by], -1, -2)
                    lc = jnp.zeros((1, 1, 1, 1, 1))
                else:
                    lc = loglik[by][:, :, None, None, :]
                P01 = ln_prior_joint  # [L,G0,G1] on the active subgrids
                P = (
                    P01
                    if si < by
                    else jnp.swapaxes(P01, -1, -2)
                )[:, None, None, :, :]
                joint = pl[:, :, None, :, :] + wp + wc + lc + P
                # joint axes are (si, by); masks stored as (0, 1)
                for (a, b), M in lfc_by_pair.items():
                    Mo = M if (a, b) == (si, by) else jnp.swapaxes(M, -1, -2)
                    joint = joint + Mo[None, None, :, :, :]
                T = _lse(joint, axis=(-2, -1))
            elif S == 2:
                d0 = loglik[0][:, :, None, :] + w_list[0][:, None]
                d1 = loglik[1][:, :, None, :] + w_list[1][:, None]
                P01 = ln_prior_joint
                joint = (
                    d0[..., :, None]
                    + d1[..., None, :]
                    + P01[:, None, None, :, :]
                )
                for (a, b), M in lfc_by_pair.items():  # canonical (0, 1)
                    joint = joint + M[None, None, :, :, :]
                T = _lse(joint, axis=(-2, -1))
            elif S == 3 and not self.pairs:
                # trio full-prior (mendelian, prior.rs:718-761 with
                # is_absent_only=false): scan over the first sample's grid
                # axis so memory stays at [L,B,NB,G,G] per step
                d0 = loglik[0][:, :, None, :] + w_list[0][:, None]
                d1 = loglik[1][:, :, None, :] + w_list[1][:, None]
                d2 = loglik[2][:, :, None, :] + w_list[2][:, None]
                P = ln_prior_joint

                M12 = lfc_by_pair.get((1, 2))

                def _g0_step(carry, xs):
                    d0_g, P_g, g0 = xs  # [L,B,NB], [L,G1,G2], scalar
                    slab = (
                        d1[..., :, None]
                        + d2[..., None, :]
                        + P_g[:, None, None]
                    )
                    if M12 is not None:
                        slab = slab + M12[None, None]
                    for (a, b), M in lfc_by_pair.items():
                        if a != 0:
                            continue
                        row = jnp.take(M, g0, axis=1)  # [NB, G_b]
                        slab = slab + (
                            row[None, None, :, :, None]
                            if b == 1
                            else row[None, None, :, None, :]
                        )
                    val = _lse(slab, axis=(-2, -1)) + d0_g
                    return jnp.logaddexp(carry, val), None

                init = jnp.full((L, B, NB), NEG_INF)
                xs = (
                    jnp.moveaxis(d0, -1, 0),
                    jnp.moveaxis(P, 1, 0),
                    jnp.arange(d0.shape[-1]),
                )
                T, _ = jax.lax.scan(_g0_step, init, xs)
            else:
                # generic full-prior for any S and any contamination digraph
                # (incl. cycles), prior.rs:298-438 composed with the
                # contaminated likelihood likelihood.rs:63-158 without the
                # reference's 2-sample limit: enumerate the joint subgrid
                # product with a scan over the flattened leading S-2 axes;
                # per-step memory is one [L,B,NB,G_{S-2},G_{S-1}] slab.
                # Feasibility is governed by the scenario's per-sample
                # `resolution:` (the caller guards the joint size).
                x_s, y_s = S - 2, S - 1
                lead_sizes = tuple(
                    len(self.values_s[s]) for s in range(S - 2)
                )
                contaminated = {si for si, _by, _f in self.pairs}
                # single-axis factors: branch weight per sample, plus the
                # own likelihood for samples without a contaminant factor
                singles = []  # (axis, arr [L,{1|B},NB,Gs])
                for s in range(S):
                    w = w_list[s][:, None]  # [L,1,NB,Gs]
                    if s in contaminated:
                        singles.append((s, w))
                    else:
                        singles.append((s, loglik[s][:, :, None, :] + w))
                # two-axis contaminant factors: one per contaminated sample
                # (a mutual 2-cycle simply contributes both orientations)
                pair_fs = [
                    (si, by, pair_logliks[si][:, :, None])  # [L,B,1,Gsi,Gby]
                    for si, by, _f in self.pairs
                ]

                def _lead_step(carry, t2):
                    coords = jnp.unravel_index(t2, lead_sizes)
                    Pt = ln_prior_joint
                    for s in range(S - 2):
                        Pt = jnp.take(Pt, coords[s], axis=1)
                    slab = Pt[:, None, None]  # [L,1,1,Gx,Gy]
                    for s, arr in singles:
                        if s < x_s:
                            slab = slab + jnp.take(arr, coords[s], axis=-1)[
                                ..., None, None
                            ]
                        elif s == x_s:
                            slab = slab + arr[..., :, None]
                        else:
                            slab = slab + arr[..., None, :]
                    for si, by, arr in pair_fs:
                        if si < x_s and by < x_s:
                            v = jnp.take(
                                jnp.take(arr, coords[si], axis=3),
                                coords[by],
                                axis=3,
                            )  # [L,B,1]
                            slab = slab + v[..., None, None]
                        elif si < x_s:  # by on a tail axis
                            row = jnp.take(arr, coords[si], axis=3)  # [L,B,1,Gby]
                            slab = slab + (
                                row[..., :, None]
                                if by == x_s
                                else row[..., None, :]
                            )
                        elif by < x_s:  # si on a tail axis
                            col = jnp.take(arr, coords[by], axis=4)  # [L,B,1,Gsi]
                            slab = slab + (
                                col[..., :, None]
                                if si == x_s
                                else col[..., None, :]
                            )
                        else:  # both tail axes
                            slab = slab + (
                                arr
                                if (si, by) == (x_s, y_s)
                                else jnp.swapaxes(arr, -1, -2)
                            )
                    for (a3, b3), M in lfc_by_pair.items():
                        if (a3, b3) == (x_s, y_s):
                            slab = slab + M[None, None]
                        elif b3 < x_s:  # both on lead axes
                            v3 = jnp.take(
                                jnp.take(M, coords[a3], axis=1),
                                coords[b3],
                                axis=1,
                            )  # [NB]
                            slab = slab + v3[None, None, :, None, None]
                        else:  # a3 on lead, b3 in {x_s, y_s} (a3 < b3)
                            row = jnp.take(M, coords[a3], axis=1)  # [NB,Gb]
                            slab = slab + (
                                row[None, None, :, :, None]
                                if b3 == x_s
                                else row[None, None, :, None, :]
                            )
                    val = _lse(slab, axis=(-2, -1))
                    return jnp.logaddexp(carry, val), None

                init = jnp.full((L, B, NB), NEG_INF)
                T, _ = jax.lax.scan(
                    _lead_step,
                    init,
                    jnp.arange(int(np.prod(lead_sizes))),
                )
            T = jnp.where(branch_gates[:, None, :], T, NEG_INF)
            branch_val = jnp.where(combo_active[:, :, None], T, NEG_INF)
            return self._assemble(
                branch_val, loglik, pair_logliks, w_list, branch_gates,
                n_artifact_active,
            )

        z0 = jnp.asarray(self.branch_has_zero_point)
        T = jnp.where(branch_gates[:, None, :], T, NEG_INF)
        Z = jnp.where(branch_gates[:, None, :] & z0[None, None], Z, NEG_INF)

        # absent-only prior split (prior.rs:718-761)
        if self.all_uniform_prior:
            branch_val = T
        else:
            pa = ln_prior_absent[:, None, None]
            ln_not_absent = _ln1mexp(pa)
            nonzero_part = jnp.where(z0[None, None], _ln_sub_exp(T, Z), T)
            zero_part = jnp.where(z0[None, None], Z, NEG_INF)
            branch_val = _ln_add_exp(ln_not_absent + nonzero_part, pa + zero_part)

        branch_val = jnp.where(combo_active[:, :, None], branch_val, NEG_INF)
        return self._assemble(
            branch_val, loglik, pair_logliks, w_list, branch_gates,
            n_artifact_active,
        )

    def _assemble(
        self, branch_val, loglik, pair_logliks, w_list, branch_gates,
        n_artifact_active=None,
    ):
        L, B = branch_val.shape[0], branch_val.shape[1]
        S = self.n_samples
        G = self.grid.size
        NB = self.n_branches
        n_events = len(self.events)
        n_artifact_combos = self.n_artifact_combos or max(1, B - 1)
        # METHOD: the artifact event splits a 0.5 prior uniformly over the
        # bias combinations CONSIDERED at each locus (event.biases.len(),
        # generic.rs:437-441) - a per-locus count driven by the variant
        # class and pileup (check_* flags, calling.rs:559-566), NOT the
        # global combo-set size.  Using the global size under-weights the
        # artifact hypothesis whenever fewer dimensions are considered
        # (e.g. indels: no read-orientation/read-position/softclip dims).
        if n_artifact_active is not None:
            ln_n_art = jnp.log(jnp.maximum(n_artifact_active, 1.0))  # [L]
        else:
            ln_n_art = jnp.full((L,), math.log(n_artifact_combos))
        event_vals = []
        for ei in range(n_events):
            idxs = tuple(self.event_branch_idx[ei])
            if not idxs:
                # event compiled to False (e.g. impossible on this contig)
                event_vals.append(jnp.full((L,), NEG_INF))
                continue
            bv = branch_val[:, :, idxs]  # [L,B,nb_e]
            ev_b = _lse(bv, axis=-1)  # [L,B]
            if self.event_is_artifact[ei]:
                if B == 1:  # no artifact combo slot active in this batch
                    val = jnp.full((L,), NEG_INF)
                else:
                    bias_prior = PROB_05 - ln_n_art  # [L]
                    val = bias_prior + _lse(ev_b[:, 1:], axis=-1)
            else:
                val = PROB_05 + ev_b[:, 0]
            event_vals.append(val)
        joint = jnp.stack(event_vals, axis=-1)  # [L,E]
        marginal = _lse(joint, axis=-1)
        posteriors = joint - marginal[:, None]

        # per-combo artifact mass (for MAP artifact-combination reporting)
        artifact_idxs = tuple(
            bi
            for ei in range(n_events)
            if self.event_is_artifact[ei]
            for bi in self.event_branch_idx[ei]
        )
        if artifact_idxs:
            combo_joint = _lse(branch_val[:, :, artifact_idxs], axis=-1)  # [L,B]
            # slot 0 (no-artifact) never carries artifact-event mass
            # (artifact events reduce over slots 1.. only) — exclude it from
            # the MAP-artifact-combination argmax
            combo_joint = combo_joint.at[:, 0].set(NEG_INF)
        else:
            combo_joint = jnp.full((L, B), NEG_INF)

        # per-sample marginal densities over the grid (MAP / AFD) for the
        # per-locus MAP non-artifact event, at the no-artifact bias slot.
        # The reference's MAP scan compares unweighted joint densities at
        # grid points (calling.rs:844-937), so the scanned sample's axis uses
        # the spectrum indicator mask, not the trapezoid dx weights.
        nonart = jnp.asarray(
            np.array([not a for a in self.event_is_artifact], dtype=bool)
        )
        masked_joint = jnp.where(nonart[None, :], joint, NEG_INF)
        best_ev = jnp.argmax(masked_joint, axis=-1)  # [L]
        sel = (
            jnp.asarray(self.branch_event)[None, :] == best_ev[:, None]
        ) & branch_gates  # [L,NB]

        wsel_list = []
        for si in range(S):
            wmask = jnp.where(w_list[si] > NEG_INF / 2, 0.0, NEG_INF)  # [L,NB,Gi]
            wsel_list.append(
                wmask + jnp.where(sel[:, :, None], 0.0, NEG_INF)
            )
        loglik0 = {si: t[:, :1] for si, t in loglik.items()}
        pair0 = {si: t[:, :1] for si, t in pair_logliks.items()}

        U0 = {}
        keep_units = {}
        for comp in self.components:
            key = ("c",) + tuple(comp)
            U0[key] = self._component_reduce(comp, loglik0, pair0, wsel_list)
            for si in comp:
                keep_units[si] = (key, comp)

        # MAP AF with quadratic (log-parabola) off-grid refinement, computed
        # on device (the reference's adaptive integration reports off-grid
        # MAP VAFs; a parabola through the grid peak recovers them).  The
        # AFD is returned marginal-normalized as deci-PHRED int16, which
        # cuts the device->host bytes of the density cube 2x against f32.  Per-sample densities live
        # on that sample's active subgrid and are scattered back to the
        # shared-grid slots (sentinel 32767 = -inf / not evaluated).
        af_cols = []
        dphred_blocks = []
        afd_idx_blocks = []
        for si in range(S):
            key, comp = keep_units[si]
            d_own = self._component_reduce(
                comp, loglik0, pair0, wsel_list, keep=si
            )  # [L,1,NB,Gi]
            rest = jnp.zeros((L, 1, NB))
            for k2, val in U0.items():
                if k2 != key:
                    rest = rest + val
            d = d_own + rest[..., None]  # [L,1,NB,Gi]
            dens = _lse(d[:, 0], axis=1)  # [L,Gi]

            vals = jnp.asarray(self.values_s[si])
            Gi = dens.shape[-1]
            gi = jnp.argmax(dens, axis=-1)  # [L]
            if Gi >= 3:
                gi_c = jnp.clip(gi, 1, Gi - 2)
                dm = jnp.take_along_axis(dens, (gi_c - 1)[:, None], -1)[:, 0]
                d0 = jnp.take_along_axis(dens, gi_c[:, None], -1)[:, 0]
                dp = jnp.take_along_axis(dens, (gi_c + 1)[:, None], -1)[:, 0]
                g_at = vals[gi_c]
                left = g_at - vals[gi_c - 1]
                right = vals[gi_c + 1] - g_at
                # unequal-spacing parabola vertex through the three points
                # (subgrids have irregular gaps: resolution lattice + set
                # points + refinement ladders); reduces to the classic
                # 0.5*(dm-dp)/(dm-2*d0+dp) step for uniform spacing
                num = (dm - d0) * right * right - (dp - d0) * left * left
                den = (dm - d0) * right + (dp - d0) * left
                off = jnp.where(den < -1e-12, 0.5 * num / den, 0.0)
                af_ref = jnp.clip(
                    g_at + off, vals[gi_c - 1], vals[gi_c + 1]
                )
                ok = (
                    (gi >= 1)
                    & (gi <= Gi - 2)
                    & jnp.isfinite(dm)
                    & jnp.isfinite(dp)
                    & (jnp.abs(off) <= jnp.maximum(left, right))
                    & (den < -1e-12)
                )
                af_cols.append(jnp.where(ok, af_ref, vals[gi]))
            else:
                af_cols.append(vals[gi])

            rel = dens - marginal[:, None]
            dphred = -10.0 / math.log(10.0) * rel * 10.0
            dphred_i16 = jnp.where(
                jnp.isfinite(rel),
                jnp.clip(jnp.round(dphred), -32767.0, 32766.0),
                32767.0,  # sentinel: dropped by the AFD writer
            ).astype(jnp.int16)
            # top-K + backbone AFD points per (locus, sample): the
            # reference's adaptive integration reports the VAF points it
            # visited (a coarse full-range sweep refined near the peak,
            # calling.rs:891+), and fetching the full-grid AFD was the
            # single biggest transfer of run().  Ship the
            # K densest points + a static strided backbone + their subgrid
            # indices; run() scatters back to shared-grid slots host-side.
            K = min(AFD_TOP_K, dens.shape[-1])
            _, top_idx = jax.lax.top_k(dens, K)  # [L,K] distinct
            bb = jnp.broadcast_to(
                jnp.asarray(self._afd_backbone(si))[None, :],
                (dens.shape[0], len(self._afd_backbone(si))),
            )
            idx_all = jnp.concatenate([top_idx, bb], axis=-1)
            dphred_blocks.append(
                jnp.take_along_axis(dphred_i16, idx_all, axis=-1)
            )
            # the backbone indices are STATIC per sample — only the top-K
            # indices travel to the host; run()/expand_afd re-append the
            # backbone host-side
            afd_idx_blocks.append(top_idx.astype(jnp.int16))
        af = jnp.stack(af_cols, axis=1)  # [L,S]
        dphred_cat = jnp.concatenate(dphred_blocks, axis=1)  # [L, sum Ki]
        afd_idx_cat = jnp.concatenate(afd_idx_blocks, axis=1)  # [L, sum Ki]

        return {
            "joint": joint,
            "marginal": marginal,
            "posteriors": posteriors,
            "densities_dphred": dphred_cat,
            "afd_idx": afd_idx_cat,
            "af": af,
            "combo_joint": combo_joint,
            "best_nonartifact": best_ev,
        }

    # ------------------------------------------------------------------
    def _afd_backbone(self, si):
        """Static strided backbone indices over sample si's subgrid
        (np int32, includes both endpoints)."""
        gi = len(self.active_idx[si])
        k = min(AFD_BACKBONE_K, gi)
        return np.unique(np.round(np.linspace(0, gi - 1, k)).astype(np.int32))

    @property
    def afd_k(self):
        """Per-sample shipped-AFD value widths (top-K + static backbone;
        duplicates between the two sets scatter the same value twice,
        harmlessly)."""
        return [
            min(AFD_TOP_K, len(self.active_idx[si]))
            + len(self._afd_backbone(si))
            for si in range(self.n_samples)
        ]

    @property
    def afd_idx_k(self):
        """Per-sample shipped index widths (top-K only; the backbone
        indices are static and re-appended host-side)."""
        return [
            min(AFD_TOP_K, len(self.active_idx[si]))
            for si in range(self.n_samples)
        ]

    def expand_afd(self, vals_cat, idx_cat):
        """Scatter compact per-sample AFD blocks back into the shared-grid
        layout [N, S, G] host-side (sentinel 32767 on unshipped slots,
        dropped by the AFD writer).

        vals_cat [N, sum (Ktop_i + Kbb_i)] int16 deci-PHRED (_run's
        ``densities_dphred``); idx_cat [N, sum Ktop_i] subgrid indices of
        the top-K values (_run's ``afd_idx``) — backbone indices are
        static per sample."""
        vals_cat = np.asarray(vals_cat)
        idx_cat = np.asarray(idx_cat).astype(np.int64)
        N = vals_cat.shape[0]
        S = self.n_samples
        full = np.full((N, S, self.grid.size), 32767, dtype=np.int16)
        vpos = 0
        ipos = 0
        for si in range(S):
            ktop = self.afd_idx_k[si]
            bb = self._afd_backbone(si).astype(np.int64)
            k = ktop + len(bb)
            idx_full = np.concatenate(
                [
                    idx_cat[:, ipos : ipos + ktop],
                    np.broadcast_to(bb[None, :], (N, len(bb))),
                ],
                axis=1,
            )
            shared_idx = np.asarray(self.active_idx[si])[idx_full]
            np.put_along_axis(
                full[:, si, :], shared_idx, vals_cat[:, vpos : vpos + k], axis=1
            )
            vpos += k
            ipos += ktop
        return full

    # ------------------------------------------------------------------
    def run(
        self,
        feats,
        mask,
        bias_alt,
        bias_ref,
        bias_any,
        combo_active,
        branch_gates,
        ln_prior_absent,
        ln_prior_joint=None,
        n_artifact_active=None,
        fetch=True,
    ):
        """Evaluate posteriors for a locus batch.

        feats [L,S,D,Fe] f32; mask [L,S,D] bool; bias_* [L,S,B,D] f32;
        combo_active [L,B] bool; branch_gates [L,NB] bool;
        ln_prior_absent [L] f32; ln_prior_joint [L, G,...] optional full
        prior on the joint of the per-sample ACTIVE subgrids
        ((L,) + tuple(len(values_s[si])); --full-prior, any S without
        contamination, <= 2 samples with).
        Returns dict: joint [L,E], posteriors [L,E], marginal [L],
        densities_dphred [L,S,G] (MAP non-artifact event; 32767 sentinel on
        inactive subgrid slots), af [L,S], best_nonartifact [L],
        map_slot [L] (argmax artifact-combo slot), n_obs [L,S] (numpy).

        fetch=False: return the packed DEVICE buffer handles without
        synchronizing (dispatch-ahead pipelining: the device computes the
        next window while the host unpacks this one); materialize with
        :meth:`fetch_run`.
        """
        args = [
            jnp.asarray(feats, dtype=jnp.float32),
            jnp.asarray(mask),
            jnp.asarray(bias_alt, dtype=jnp.float32),
            jnp.asarray(bias_ref, dtype=jnp.float32),
            jnp.asarray(bias_any, dtype=jnp.float32),
            jnp.asarray(combo_active),
            jnp.asarray(branch_gates),
            jnp.asarray(ln_prior_absent, dtype=jnp.float32),
        ]
        L = args[0].shape[0]
        if n_artifact_active is None:
            n_art = jnp.full(
                (L,),
                float(self.n_artifact_combos or 1),
                dtype=jnp.float32,
            )
        else:
            n_art = jnp.asarray(n_artifact_active, dtype=jnp.float32)
        if ln_prior_joint is not None:
            wire = self._run_packed(
                *args, jnp.asarray(ln_prior_joint, dtype=jnp.float32), n_art
            )
        else:
            wire = self._run_packed(*args, None, n_art)
        if not fetch:
            return wire, L
        return self._unpack_host(np.asarray(wire), L)

    def fetch_run(self, handles):
        """Materialize + unpack a ``run(..., fetch=False)`` result."""
        wire, L = handles
        return self._unpack_host(np.asarray(wire), L)

    # ------------------------------------------------------------------
    def _compact_core(self, obs_f16, obs_u8, hil, mask, slot_map,
                      combo_active, branch_gates, ln_prior_absent, fwd_rate,
                      has_alt, ln_prior_joint, n_art):
        """Feature expansion + device bias factors + posterior, traced
        inside one jit (ops.compact_obs wire encoding)."""
        from .compact_obs import bias_factors, expand_features

        feats = expand_features(obs_f16, obs_u8, hil)
        ba, br_, bn = bias_factors(
            obs_f16, obs_u8, slot_map, fwd_rate, has_alt
        )
        return self._run_impl(
            feats, mask, ba, br_, bn, combo_active, branch_gates,
            ln_prior_absent, ln_prior_joint=ln_prior_joint,
            n_artifact_active=n_art,
        )

    def run_compact_unpacked(self):
        """Jitted compact-input engine returning the UNPACKED output dict
        (device arrays) — the sharded path needs per-output arrays because
        the packed flat buffer does not shard along the locus axis."""
        if getattr(self, "_run_compact_unpacked", None) is None:
            self._run_compact_unpacked = jax.jit(self._compact_core)
        return self._run_compact_unpacked

    # ------------------------------------------------------------------
    def run_compact(
        self,
        obs_f16,
        obs_u8,
        hil,
        mask,
        slot_map,
        combo_active,
        branch_gates,
        ln_prior_absent,
        fwd_rate,
        has_alt_loci,
        ln_prior_joint=None,
        n_artifact_active=None,
        fetch=True,
    ):
        """Like :meth:`run`, but from the compact wire encoding
        (ops.compact_obs): feature expansion AND per-combo bias factors run
        inside the jit, so the host ships ~24 B/obs instead of the f32
        feature tensor + three host-built bias tensors (~16x less).

        obs_f16 [L,S,D,9] f16; obs_u8 [L,S,D,4] u8; hil [L,S,D] i8;
        mask [L,S,D] bool; slot_map [L,Bc] int32 (FULL_COMBOS indices per
        active combo slot, 0-padded); combo_active [L,Bc] bool;
        fwd_rate [L] f32; has_alt_loci [L] bool; others as in run().

        fetch=False: return the packed DEVICE buffer without synchronizing
        — the dispatch-ahead pipeline formats the previous window while
        this one computes; finish with :meth:`fetch_compact`.
        """
        if self._run_packed_compact is None:
            def _impl(*args):
                return self._pack_out(self._compact_core(*args), args[3])

            self._run_packed_compact = jax.jit(_impl)

        L = obs_f16.shape[0]
        args = [
            jnp.asarray(obs_f16, dtype=jnp.float16),
            jnp.asarray(obs_u8, dtype=jnp.uint8),
            jnp.asarray(hil, dtype=jnp.int8),
            jnp.asarray(mask),
            jnp.asarray(slot_map, dtype=jnp.int32),
            jnp.asarray(combo_active),
            jnp.asarray(branch_gates),
            jnp.asarray(ln_prior_absent, dtype=jnp.float32),
            jnp.asarray(fwd_rate, dtype=jnp.float32),
            jnp.asarray(has_alt_loci),
        ]
        if n_artifact_active is None:
            n_art = jnp.full(
                (L,), float(self.n_artifact_combos or 1), dtype=jnp.float32
            )
        else:
            n_art = jnp.asarray(n_artifact_active, dtype=jnp.float32)
        pj = (
            jnp.asarray(ln_prior_joint, dtype=jnp.float32)
            if ln_prior_joint is not None
            else None
        )
        wire = self._run_packed_compact(*args, pj, n_art)
        if not fetch:
            return wire, L
        return self._unpack_host(np.asarray(wire), L)

    def fetch_compact(self, handles):
        """Materialize + unpack a ``run_compact(..., fetch=False)`` result."""
        wire, L = handles
        return self._unpack_host(np.asarray(wire), L)

    # ------------------------------------------------------------------
    def run_flat(
        self,
        obs_f16,      # [N, N_CF] f16 — observations of the window, flat
        obs_u8,       # [N, N_CU] u8
        hil,          # [N] i8
        row_idx,      # [N] i32 = (locus*S + sample)*D + slot; L*S*D = pad
        L,
        D,
        slot_map,
        combo_active,
        branch_gates,
        ln_prior_absent,
        fwd_rate,
        has_alt_loci,
        ln_prior_joint=None,
        n_artifact_active=None,
        fetch=True,
    ):
        """Like :meth:`run_compact`, but the observation panels arrive FLAT
        (one row per real observation + a row index) and are scattered into
        the padded [L,S,D,*] panels ON DEVICE.  The wire then carries
        ~27 B/obs instead of ~24 B/(padded slot) — at mean depth ``d`` and
        panel depth ``D`` that is a ``D/d``-fold cut of the host->device
        transfer.

        Padding rows carry ``row_idx == L*S*D`` and are dropped by the
        scatter (XLA ``mode=drop``).  fetch=False returns the packed device
        wire buffer for the dispatch-ahead pipeline (see fetch_compact).
        """
        from ..evidence.observation import HOMOPOLYMER_NONE as _HN
        from .compact_obs import N_CF, N_CU

        S = self.n_samples
        key = (int(L), int(D))
        cache = getattr(self, "_run_flat_cache", None)
        if cache is None:
            cache = self._run_flat_cache = {}
        fn = cache.get(key)
        if fn is None:
            Ls, Ds = int(L), int(D)

            def _impl(f16f, u8f, hilf, rowf, sm, ca, bg, pa, fr, hal,
                      pj, n_art):
                rows = Ls * S * Ds
                f16 = (
                    jnp.zeros((rows, N_CF), jnp.float16)
                    .at[rowf]
                    .set(f16f, mode="drop")
                )
                u8 = (
                    jnp.zeros((rows, N_CU), jnp.uint8)
                    .at[rowf]
                    .set(u8f, mode="drop")
                )
                hil_p = (
                    jnp.full((rows,), _HN, jnp.int8)
                    .at[rowf]
                    .set(hilf, mode="drop")
                )
                mask = (
                    jnp.zeros((rows,), jnp.bool_)
                    .at[rowf]
                    .set(True, mode="drop")
                )
                out = self._compact_core(
                    f16.reshape(Ls, S, Ds, N_CF),
                    u8.reshape(Ls, S, Ds, N_CU),
                    hil_p.reshape(Ls, S, Ds),
                    mask.reshape(Ls, S, Ds),
                    sm, ca, bg, pa, fr, hal, pj, n_art,
                )
                return self._pack_out(out, mask.reshape(Ls, S, Ds))

            fn = cache[key] = jax.jit(_impl)

        if n_artifact_active is None:
            n_art = jnp.full(
                (L,), float(self.n_artifact_combos or 1), dtype=jnp.float32
            )
        else:
            n_art = jnp.asarray(n_artifact_active, dtype=jnp.float32)
        pj = (
            jnp.asarray(ln_prior_joint, dtype=jnp.float32)
            if ln_prior_joint is not None
            else None
        )
        wire = fn(
            jnp.asarray(obs_f16, dtype=jnp.float16),
            jnp.asarray(obs_u8, dtype=jnp.uint8),
            jnp.asarray(hil, dtype=jnp.int8),
            jnp.asarray(row_idx, dtype=jnp.int32),
            jnp.asarray(slot_map, dtype=jnp.int32),
            jnp.asarray(combo_active),
            jnp.asarray(branch_gates),
            jnp.asarray(ln_prior_absent, dtype=jnp.float32),
            jnp.asarray(fwd_rate, dtype=jnp.float32),
            jnp.asarray(has_alt_loci),
            pj,
            n_art,
        )
        if not fetch:
            return wire, L
        return self._unpack_host(np.asarray(wire), L)

    # ------------------------------------------------------------------
    def _in_wire_spec(self, Np, L, D, Bc, pj_shape):
        """Section layout of the SINGLE input wire buffer (uint8).

        Every host->device transfer pays a fixed latency; shipping the
        engine's ~12 inputs separately made dispatch latency-bound.  One
        buffer = one transfer.  Sections are 4-byte aligned so the device can bitcast
        static slices."""
        from .compact_obs import N_CF, N_CU

        S = self.n_samples
        spec = [
            ("f16f", np.float16, (Np, N_CF)),
            ("u8f", np.uint8, (Np, N_CU)),
            ("hilf", np.int8, (Np,)),
            ("counts", np.int32, (L, S)),
            ("sm", np.int32, (L, Bc)),
            ("sa", np.uint8, (L, Bc)),
            ("bg", np.uint8, (L, self.n_branches)),
            ("pa", np.float32, (L,)),
            ("fr", np.float32, (L,)),
            ("hal", np.uint8, (L,)),
            ("n_art", np.float32, (L,)),
        ]
        if pj_shape is not None:
            spec.append(("pj", np.float32, (L,) + tuple(pj_shape)))
        return spec

    @staticmethod
    def pack_in_wire(spec, arrays):
        """Host side: assemble the input wire buffer from named arrays."""
        parts = []
        for name, dtype, shape in spec:
            a = np.ascontiguousarray(
                np.asarray(arrays[name]).astype(dtype, copy=False)
            ).reshape(-1)
            b = a.view(np.uint8)
            pad = (-b.size) % 4
            parts.append(b)
            if pad:
                parts.append(np.zeros(pad, np.uint8))
        return np.concatenate(parts)

    def run_wire(
        self,
        wire_in,  # uint8 host buffer from pack_in_wire
        Np,
        L,
        D,
        Bc,
        pj_shape=None,
        fetch=True,
    ):
        """Single-transfer engine dispatch: ONE uint8 input buffer carrying
        the flat observation rows + all per-locus metadata; panels are
        reconstructed on device by GATHER (segment offsets from the shipped
        counts — gathers vectorize where scatters may serialize).  Output is the
        packed wire of :meth:`run_compact` (fetch_compact to unpack)."""
        from ..evidence.observation import HOMOPOLYMER_NONE as _HN
        from .compact_obs import N_CF, N_CU

        S = self.n_samples
        key = (int(Np), int(L), int(D), int(Bc), pj_shape)
        cache = getattr(self, "_run_wire_cache", None)
        if cache is None:
            cache = self._run_wire_cache = {}
        fn = cache.get(key)
        if fn is None:
            spec = self._in_wire_spec(Np, L, D, Bc, pj_shape)
            Ls, Ds, Bcs = int(L), int(D), int(Bc)
            NB = self.n_branches

            def _impl(buf):
                sec = {}
                off = 0
                for name, dtype, shape in spec:
                    jd = np.dtype(dtype)
                    nbytes = int(np.prod(shape)) * jd.itemsize
                    raw = jax.lax.slice(buf, [off], [off + nbytes])
                    off_pad = (-nbytes) % 4
                    if jd.itemsize == 1:
                        a = (
                            raw
                            if jd == np.dtype(np.uint8)
                            else jax.lax.bitcast_convert_type(raw, jd)
                        )
                    else:
                        a = jax.lax.bitcast_convert_type(
                            raw.reshape(-1, jd.itemsize), jd
                        )
                    sec[name] = a.reshape(shape)
                    off = off + nbytes + off_pad
                counts = jnp.minimum(sec["counts"].reshape(-1), Ds)
                seg_off = jnp.cumsum(counts) - counts  # exclusive
                rows = Ls * S * Ds
                ls = jnp.arange(rows, dtype=jnp.int32) // Ds
                slot = jnp.arange(rows, dtype=jnp.int32) % Ds
                src = seg_off[ls] + slot
                valid = slot < counts[ls]
                srcc = jnp.where(valid, src, Np)
                f16 = jnp.take(
                    sec["f16f"], srcc, axis=0, mode="fill", fill_value=0
                )
                u8 = jnp.take(
                    sec["u8f"], srcc, axis=0, mode="fill", fill_value=0
                )
                hil = jnp.take(
                    sec["hilf"], srcc, axis=0, mode="fill", fill_value=_HN
                )
                mask = valid.reshape(Ls, S, Ds)
                out = self._compact_core(
                    f16.reshape(Ls, S, Ds, N_CF),
                    u8.reshape(Ls, S, Ds, N_CU),
                    hil.reshape(Ls, S, Ds),
                    mask,
                    sec["sm"],
                    sec["sa"] != 0,
                    sec["bg"] != 0,
                    sec["pa"],
                    sec["fr"],
                    sec["hal"] != 0,
                    sec.get("pj"),
                    sec["n_art"],
                )
                return self._pack_out(out, mask)

            fn = cache[key] = jax.jit(_impl)

        wire = fn(jnp.asarray(wire_in))
        if not fetch:
            return wire, L
        return self._unpack_host(np.asarray(wire), L)

    def wire_bytes(self, L):
        """Size in bytes of the packed wire buffer for an L-locus window
        (roofline reporting)."""
        S = self.n_samples
        E = len(self.events)
        n_f32 = L * (E + 1 + S)
        n_i16 = L * (sum(self.afd_k) + 2 + S)
        if not self._afd_idx_u8:
            n_i16 += L * sum(self.afd_idx_k)
        n_i16 += n_i16 % 2
        total = n_f32 * 4 + n_i16 * 2
        if self._afd_idx_u8:
            n_u8 = L * sum(self.afd_idx_k)
            total += n_u8 + ((-n_u8) % 4)
        return total

    def _unpack_host(self, wire, L):
        """Split the packed wire buffer back into the host result dict."""
        S = self.n_samples
        E = len(self.events)
        host = {}
        pos = 0
        for k, shape in (
            ("posteriors", (L, E)),
            ("marginal", (L,)),
            ("af", (L, S)),
        ):
            n = int(np.prod(shape))
            host[k] = wire[pos : pos + n].reshape(shape)
            pos += n
        host["joint"] = host["posteriors"] + host["marginal"][:, None]
        sum_k = sum(self.afd_k)
        sum_ki = sum(self.afd_idx_k)
        n_i16 = L * (sum_k + 2 + S)
        if not self._afd_idx_u8:
            n_i16 += L * sum_ki
        n_words16 = (n_i16 + 1) // 2
        i16_flat = (
            wire[pos : pos + n_words16].view(np.int16)[:n_i16]
        )
        pos += n_words16
        nv = L * sum_k
        if self._afd_idx_u8:
            n_u8 = L * sum_ki
            n_words8 = (n_u8 + 3) // 4
            afd_idx = (
                wire[pos : pos + n_words8]
                .view(np.uint8)[:n_u8]
                .reshape(L, sum_ki)
            )
        else:
            afd_idx = i16_flat[n_i16 - L * sum_ki :].reshape(L, sum_ki)
        host["densities_dphred"] = self.expand_afd(
            i16_flat[:nv].reshape(L, sum_k), afd_idx
        )
        host["best_nonartifact"] = i16_flat[nv : nv + L].astype(np.int64)
        host["map_slot"] = i16_flat[nv + L : nv + 2 * L].astype(np.int64)
        host["n_obs"] = (
            i16_flat[nv + 2 * L : nv + 2 * L + L * S]
            .reshape(L, S)
            .astype(np.int64)
        )
        return host
