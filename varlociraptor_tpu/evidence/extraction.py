"""Pileup extraction: fragments -> evidence -> observations.

Re-implements the reference's ``Observable`` blanket machinery
(``/root/reference/src/variants/types/mod.rs:251-408``) and the
``Sample::extract_observations`` driver
(``/root/reference/src/variants/sample.rs:290-331``):

- fetch windows around the variant loci (single-read window =
  ``max_read_len + max_del_cigar_len + 10``; read-pair window =
  ``isize.mean + 6 sd``; ``sample.rs:259-268``),
- fragment pairing by qname keeping leftmost/rightmost alignment
  (deterministic via sorted dict; ``types/mod.rs:294-340``),
- MAPQ -> log-prob with the conservative pair-max rule
  (``types/mod.rs:255-272``),
- depth-capped subsampling (``types/mod.rs:386-389``): bit-exact port of
  the reference's SubsampleCandidates with its fixed seed 48074578,
  RESTARTED per locus — simultaneously reference-identical draw
  sequences and shard-boundary-invariant kept sets,
- observation construction (``read_observation.rs:626-701``).
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from ..io.bam import BamRecord, OP_S
from ..utils.logprob import LOG_ZERO, np_ln_one_minus_exp
from .observation import (
    RO_NONE,
    RO_BY_NAME,
    STRAND_BOTH,
    ReadObservation,
    Pileup,
    set_prob_mapping,
    set_prob_overlap,
    adjust_prob_mapping,
    process_observations,
)

# Overlap classification (types/mod.rs:530-545)
OVERLAP_NONE = 0
OVERLAP_ENCLOSING = 1
OVERLAP_LEFT = 2
OVERLAP_RIGHT = 3
OVERLAP_ENCLOSED = 4


def locus_overlap(
    record: BamRecord,
    start: int,
    end: int,
    consider_clips: bool = False,
    start_offset: int = 0,
    end_offset: int = 0,
) -> int:
    """SingleLocus::overlap (types/mod.rs:440-473)."""
    pos = record.pos
    end_pos = record.end_pos
    if consider_clips:
        pos = max(0, pos - record.leading_softclips())
        end_pos += record.trailing_softclips()
    range_start = start + start_offset
    range_end = end + end_offset
    if pos <= range_start:
        if end_pos >= range_end:
            return OVERLAP_ENCLOSING
        elif end_pos >= range_start:
            return OVERLAP_LEFT
    elif end_pos >= range_end and pos < range_end:
        return OVERLAP_RIGHT
    elif pos >= range_start and end_pos <= range_end:
        return OVERLAP_ENCLOSED
    return OVERLAP_NONE


def read_pair_orientation(record: BamRecord) -> int:
    """SequenceReadPairOrientation from flags/positions (bio_types semantics,
    used via ``record.read_pair_orientation()`` in read_observation.rs:157).
    Cached on the record: the same record is evaluated by every overlapping
    locus."""
    cached = getattr(record, "_vlt_rpo", None)
    if cached is not None:
        return cached
    out = _read_pair_orientation(record)
    object.__setattr__(record, "_vlt_rpo", out)
    return out


def _read_pair_orientation(record: BamRecord) -> int:
    ro = record.tags.get("RO")
    if isinstance(ro, str):
        parts = ro.split(",")
        if len(parts) != 1:
            return RO_NONE
        return RO_BY_NAME.get(parts[0], RO_NONE)
    if (
        not record.is_paired
        or record.is_unmapped
        or record.is_mate_unmapped
        or record.tid != record.mtid
    ):
        return RO_NONE
    # leftmost read determines the first letter
    if record.pos < record.mpos:
        first_strand = "R" if record.is_reverse else "F"
        second_strand = "R" if record.is_mate_reverse else "F"
        first_read = "1" if record.is_first_in_pair else "2"
        second_read = "2" if record.is_first_in_pair else "1"
    else:
        first_strand = "R" if record.is_mate_reverse else "F"
        second_strand = "R" if record.is_reverse else "F"
        first_read = "2" if record.is_first_in_pair else "1"
        second_read = "1" if record.is_first_in_pair else "2"
    name = f"{first_strand}{first_read}{second_strand}{second_read}"
    return RO_BY_NAME.get(name, RO_NONE)


def parse_alt_loci(record: BamRecord) -> list:
    """XA-tag alternative mapping loci (read_observation.rs:167-210).
    Cached on the record (treated as immutable by all callers)."""
    cached = getattr(record, "_vlt_xa", None)
    if cached is not None:
        return cached
    out = _parse_alt_loci(record)
    object.__setattr__(record, "_vlt_xa", out)
    return out


def _parse_alt_loci(record: BamRecord) -> list:
    xa = record.tags.get("XA")
    loci = []
    if isinstance(xa, str):
        for item in xa.split(";"):
            if not item:
                continue
            parts = item.split(",")
            if len(parts) == 4:
                contig, pos = parts[0], parts[1].lstrip("-")
                try:
                    loci.append((contig, int(pos)))
                except ValueError:
                    pass
    return loci


class Evidence:
    """A single-end read or a read pair (read_observation.rs:734-820).

    Evidence objects are REUSED across overlapping locus windows (the
    fragment index), so every per-fragment invariant below is lazily
    cached: with ~8-20 loci sharing each fragment the scalar log/flag
    work amortizes away."""

    __slots__ = (
        "left", "right", "_bounds", "_pm", "_ro", "_tl", "_mq", "_al",
    )

    def __init__(self, left: BamRecord, right: BamRecord | None = None):
        self.left = left
        self.right = right
        self._bounds = None
        self._pm = None
        self._ro = None
        self._tl = None
        self._mq = None
        self._al = None

    def bounds(self):
        """Cached [(pos, end_pos), ...] of the unclipped record spans.
        Evidence objects are reused across overlapping locus windows (the
        fragment index), so enclosing-overlap checks collapse to two int
        comparisons per record."""
        b = self._bounds
        if b is None:
            b = [(r.pos, r.end_pos) for r in self.records()]
            self._bounds = b
        return b

    @property
    def is_paired_evidence(self) -> bool:
        return self.right is not None

    def records(self):
        return [self.left] if self.right is None else [self.left, self.right]

    def qname(self) -> str:
        return self.left.qname

    def is_paired(self) -> bool:
        return self.left.is_paired

    def softclipped(self) -> bool:
        out = False
        for r in self.records():
            sc = getattr(r, "_vlt_sc", None)
            if sc is None:
                sc = any(op == OP_S for op, _ in r.cigar)
                object.__setattr__(r, "_vlt_sc", sc)
            out = out or sc
        return out

    def total_len(self) -> int:
        if self._tl is None:
            self._tl = sum(r.read_len for r in self.records())
        return self._tl

    def read_orientation(self) -> int:
        if self._ro is None:
            ros = [read_pair_orientation(r) for r in self.records()]
            self._ro = (
                RO_NONE if len(ros) == 2 and ros[0] != ros[1] else ros[0]
            )
        return self._ro

    def alt_loci(self) -> list:
        if self._al is None:
            out = []
            for r in self.records():
                out.extend(parse_alt_loci(r))
            self._al = out
        return self._al

    def prob_mapping(self) -> float:
        """MAPQ -> P(mapped); pair-max rule (types/mod.rs:255-272)."""
        if self._pm is None:
            ln10_10 = math.log(10.0) / 10.0
            p = -self.left.mapq * ln10_10
            if self.right is not None:
                p = max(p, -self.right.mapq * ln10_10)
            self._pm = np_ln_one_minus_exp(p)
        return self._pm

    def min_mapq(self) -> int:
        if self._mq is None:
            self._mq = min(r.mapq for r in self.records())
        return self._mq


class _ContigFragments:
    """Incremental per-contig fragment index.

    ``collect_fragments`` is called once per locus with a window that spans
    ~2x the insert size; consecutive candidate loci therefore re-fetch and
    re-classify ~95% of the same reads.  This index streams each record off
    the BAM ONCE (monotonically extending coverage ``[b0, b1)``), interns
    qnames to ints, and answers each per-locus query with a binary search +
    a pairing pass over ints — Evidence objects are cached and REUSED
    across loci, which also makes their lazily-cached ``bounds()`` free.

    Query semantics are bit-identical to the legacy scan (same fetch-merge
    rule, start-based retention, pair-slot overwrite rule, mapq==0 pair
    drop, qname sort); falls back to the legacy path (returns None) for
    non-monotonic queries (e.g. breakend mate intervals left of coverage).
    """

    MAX_RECORDS = 400_000  # compaction threshold (records kept in memory)

    def __init__(self, bam, contig):
        self.bam = bam
        self.contig = contig
        self.recs: list = []
        self.pos: list = []  # int list, kept sorted (fetch order)
        self.b0 = None
        self.b1 = None
        self._ev_cache: dict = {}

    GAP_JUMP = 1 << 16  # sparse candidates: restart the scan past gaps

    def _extend(self, fe):
        """Grow coverage to [b0, fe) with records from the forward scan
        (bulk sequential BGZF streaming; the per-locus fetch path
        re-parsed WGS-scale BAMs at ~23 us/record)."""
        slack = 8192
        target = fe + slack
        scan = getattr(self, "_scan", None)
        if scan is None:
            scan = self.bam.scan_records(self.contig, self.b1)
            self._scan = scan
            self._pending_rec = None
            if scan is None:
                # unsupported reader (CRAM): legacy windowed fetch
                for rec in self.bam.fetch(self.contig, self.b1, target):
                    if rec.pos < self.b1 or rec.pos >= target:
                        continue
                    self._ingest(rec)
                self._scan = None
                self.b1 = target
                return
        pend = self._pending_rec
        if pend is not None:
            if pend.pos >= target:
                self.b1 = target
                return
            self._pending_rec = None
            if pend.pos >= self.b1:
                self._ingest(pend)
        for rec in scan:
            if rec.pos < self.b1:
                continue
            if rec.pos >= target:
                self._pending_rec = rec
                break
            self._ingest(rec)
        self.b1 = target

    def _ingest(self, rec):
        if getattr(rec, "_vlt_skip", None) is None:
            object.__setattr__(rec, "_vlt_skip", bool(rec.flag & 0x704))
        self.recs.append(rec)
        self.pos.append(rec.pos)

    def _compact(self, min_pos):
        import bisect

        cut = bisect.bisect_left(self.pos, min_pos)
        if cut:
            self.recs = self.recs[cut:]
            self.pos = self.pos[cut:]
            self.b0 = min_pos
            self._ev_cache.clear()

    def query(self, fetch_intervals, window, props=None):
        import bisect

        # identical merge rule to the legacy scan
        windows = []
        seen = []
        for start, end in fetch_intervals:
            fs, fe = max(0, start - window), end + window
            if seen and fs <= seen[-1][1]:
                fs = max(fs, seen[-1][1])
                if fs >= fe:
                    continue
            seen.append((fs, fe))
            windows.append((fs, fe))
        if not windows:
            return []
        lo_all = min(fs for fs, _ in windows)
        hi_all = max(fe for _, fe in windows)
        if self.b0 is None or lo_all < self.b0:
            if self.b0 is not None and lo_all < self.b0:
                return None  # non-monotonic query: legacy fallback
            self.b0 = lo_all
            self.b1 = lo_all
        elif lo_all >= self.b1 + self.GAP_JUMP:
            # sparse candidates: restart the stream past the gap instead
            # of ingesting every record in between
            self.recs = []
            self.pos = []
            self._ev_cache.clear()
            self._scan = None
            self._pending_rec = None
            self.b0 = lo_all
            self.b1 = lo_all
        if hi_all > self.b1:
            self._extend(hi_all)
        if len(self.recs) > self.MAX_RECORDS:
            self._compact(lo_all)

        # pairing pass over the in-window records, in interval order
        candidates: dict = {}
        order: list = []
        ratchet = props is not None
        for fs, fe in windows:
            i0 = bisect.bisect_left(self.pos, fs)
            i1 = bisect.bisect_left(self.pos, fe)
            for i in range(i0, i1):
                rec = self.recs[i]
                if rec._vlt_skip:
                    continue
                if ratchet and getattr(rec, "_cig_maxes", None) is None:
                    cg = rec.cigar
                    if len(cg) == 1 and cg[0][0] in (0, 7, 8):
                        # single match-op read: nothing to ratchet; mark it
                        # with exactly the tuple update_max_cigar_ops_len
                        # caches (allow_hardclips=False, regular, no clip)
                        object.__setattr__(
                            rec, "_cig_maxes", (False, True, False)
                        )
                    else:
                        props.update_max_cigar_ops_len(rec)
                slot = candidates.get(rec.qname)
                if slot is None:
                    candidates[rec.qname] = [rec, None]
                    order.append(rec.qname)
                else:
                    prev_left = slot[0]
                    if (
                        prev_left.is_first_in_pair
                        and rec.is_first_in_pair
                        and prev_left.is_last_in_pair
                        and rec.is_last_in_pair
                    ):
                        continue
                    slot[1] = rec
        evidence = []
        cache = self._ev_cache
        for qname in sorted(candidates):
            left, right = candidates[qname]
            if right is not None:
                if left.mapq == 0 or right.mapq == 0:
                    continue
                key = (id(left), id(right))
            else:
                key = (id(left), 0)
            ev = cache.get(key)
            if ev is None:
                ev = Evidence(left, right)
                cache[key] = ev
            evidence.append(ev)
        return evidence


def _fragment_index(bam, contig) -> _ContigFragments:
    cache = getattr(bam, "_vlt_fragidx", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(bam, "_vlt_fragidx", cache)
        except AttributeError:
            bam._vlt_fragidx = cache
    idx = cache.get(contig)
    if idx is None:
        # one live contig index per reader bounds memory on WGS runs
        cache.clear()
        idx = cache[contig] = _ContigFragments(bam, contig)
    return idx


def collect_fragments(bam, contig: str, fetch_intervals, window: int, props=None):
    """Fetch + fragment pairing (types/mod.rs:283-340).

    Returns Evidence objects keyed/sorted by qname (deterministic order, as
    the reference's BTreeMap guarantees).  When ``props`` is given, cigar
    maxima are tracked for EVERY streamed record (types/mod.rs:309 updates
    before pairing/mapq filters — records later dropped by those filters
    still raise max_del/ins_cigar_len in the reference).

    Served from the per-contig ``_ContigFragments`` index when the query is
    coverage-monotonic (the common sorted-candidates case); the legacy
    direct scan below is the fallback and the semantic ground truth.
    """
    idx = _fragment_index(bam, contig)
    ev = idx.query(fetch_intervals, window, props=props)
    if ev is not None:
        return ev
    candidates: dict[str, list] = {}
    seen_windows = []
    for start, end in fetch_intervals:
        fs, fe = max(0, start - window), end + window
        # merge overlapping fetches (reference: fetches cannot overlap)
        if seen_windows and fs <= seen_windows[-1][1]:
            fs = max(fs, seen_windows[-1][1])
            if fs >= fe:
                continue
        seen_windows.append((fs, fe))
        for rec in bam.fetch(contig, fs, fe):
            if rec.pos < fs:
                # rust-htslib bam::RecordBuffer retention is START-based:
                # the buffer holds records with pos in [start, end), so a
                # read that merely overlaps the window start from the left
                # is NOT part of the reference's candidate set (this decides
                # single- vs pair-evidence classification at window edges)
                continue
            skip = getattr(rec, "_vlt_skip", None)
            if skip is None:
                skip = bool(
                    rec.flag & 0x704  # secondary|duplicate|unmapped|qcfail
                )
                object.__setattr__(rec, "_vlt_skip", skip)
            if skip:
                continue
            # cigar-maxima ratchet: idempotent per record; inline the
            # seen-marker check (this loop runs ~depth x loci x samples)
            if props is not None and getattr(rec, "_cig_maxes", None) is None:
                props.update_max_cigar_ops_len(rec)
            slot = candidates.get(rec.qname)
            if slot is None:
                candidates[rec.qname] = [rec, None]
            else:
                prev_left = slot[0]
                if (
                    prev_left.is_first_in_pair
                    and rec.is_first_in_pair
                    and prev_left.is_last_in_pair
                    and rec.is_last_in_pair
                ):
                    # another partial alignment right of the first: ignore
                    continue
                slot[1] = rec
    evidence = []
    for qname in sorted(candidates):
        left, right = candidates[qname]
        if right is not None:
            if left.mapq == 0 or right.mapq == 0:
                # ambiguous pair alignments are ignored (types/mod.rs:357-360)
                continue
            evidence.append(Evidence(left, right))
        else:
            evidence.append(Evidence(left))
    return evidence


def subsample_keep_mask(n: int, max_depth: int) -> np.ndarray:
    """Deterministic, shard-invariant subsampling decision per candidate.

    Bit-exact port of the reference's SubsampleCandidates
    (sample.rs:180-212): ChaCha12 StdRng seeded 48074578, one
    Uniform(0,1) draw per candidate in BTreeMap (qname-sorted) order.
    The RNG restarts per locus, so decisions are independent of
    batch/shard boundaries (required for shard-count-invariant output
    on a device mesh) while matching the reference's kept sets exactly.
    """
    if n <= max_depth:
        return np.ones(n, dtype=bool)
    from ..utils.rust_rand import SubsampleCandidates

    sub = SubsampleCandidates(max_depth, n)
    return np.array([sub.keep() for _ in range(n)], dtype=bool)


class FragmentIdFactory:
    """Stable per-contig fragment-name -> integer ids for downstream
    phasing (--report-fragment-ids, fragment_id_factory.rs:6-25)."""

    def __init__(self):
        self._ids: dict[str, int] = {}

    def get(self, qname: str) -> int:
        if qname not in self._ids:
            self._ids[qname] = len(self._ids)
        return self._ids[qname]

    def reset(self):
        self._ids.clear()


class PendingPileup:
    """Phase-1 state of a locus whose pair-HMM forwards have been queued
    but not yet executed (cross-locus chunked device execution)."""

    __slots__ = (
        "variant",
        "candidates",
        "raw_depth",
        "keep",
        "hpem",
        "alt_variants",
        "props",
        "do_adjust",
        "fragment_id_factory",
        "realigners",
        "fast_obs",
    )


def extract_observations(
    variant,
    bam,
    alignment_properties,
    max_depth: int = 200,
    alt_variants=(),
    do_adjust_prob_mapping: bool = True,
    fragment_id_factory: FragmentIdFactory | None = None,
) -> Pileup:
    """Full per-locus pileup extraction for one sample.

    ``variant`` implements the Variant protocol (see evidence.variants):
    ``contig``, ``fetch_intervals()``, ``is_valid_evidence(evidence)``,
    ``allele_support(evidence, alignment_properties, alt_variants)``,
    ``prob_sample_alt(evidence, alignment_properties)``,
    ``is_imprecise``, ``homopolymer_error_model``.
    """
    pending = extract_observations_begin(
        variant,
        bam,
        alignment_properties,
        max_depth=max_depth,
        alt_variants=alt_variants,
        do_adjust_prob_mapping=do_adjust_prob_mapping,
        fragment_id_factory=fragment_id_factory,
    )
    for r in pending.realigners:
        r.run_batch()
    return extract_observations_finish(pending)


def extract_observations_begin(
    variant,
    bam,
    alignment_properties,
    max_depth: int = 200,
    alt_variants=(),
    do_adjust_prob_mapping: bool = True,
    fragment_id_factory: FragmentIdFactory | None = None,
) -> PendingPileup:
    """Phase 1: fetch + pair + subsample + scout + record.  Leaves every
    realigner with its pending forward requests; the caller either runs
    them per locus (extract_observations) or concatenates requests across
    a chunk of loci into one device call (calling/preprocess.py)."""
    props = alignment_properties
    # The reference fetches every variant type in read-pair mode
    # (types/mod.rs:298-304 passes true unconditionally), so mates far from
    # the locus — e.g. across a duplication — are paired into the evidence.
    single_read_window = (
        props.max_read_len + (props.max_del_cigar_len or 0) + 10
    )
    if props.insert_size is not None:
        window = int(props.insert_size.mean + props.insert_size.sd * 6.0)
    else:
        window = single_read_window

    fragments = collect_fragments(
        bam, variant.contig, variant.fetch_intervals(), window, props=props
    )

    candidates = []
    locus_depths: dict[int, int] = {}
    for ev in fragments:
        idx = variant.is_valid_evidence(ev, props)
        if idx is not None:
            candidates.append(ev)
            for i in idx:
                locus_depths[i] = locus_depths.get(i, 0) + 1

    # subsample only when all loci exceed max depth (types/mod.rs:386-389)
    subsample = bool(locus_depths) and all(
        d > max_depth for d in locus_depths.values()
    )
    if subsample:
        keep = subsample_keep_mask(len(candidates), max_depth)
    else:
        keep = np.ones(len(candidates), dtype=bool)

    hpem = variant.homopolymer_error_model(props)

    # vectorized SNV fast path: pileups of simple-cigar reads compute their
    # observations in one numpy pass (per-read scalar prob math dominated
    # the clean-library SNV workload); bail indices fall through to the
    # scalar scout/replay machinery unchanged
    fast_obs = None
    import os as _os

    if (
        _os.environ.get("VLT_FAST_SNV") != "0"
        and type(variant).__name__ == "Snv"
        and not alt_variants
        and hpem is None
        and not variant.is_imprecise
        and fragment_id_factory is None
    ):
        from .variants import snv_vector_observations

        kept_idx = [i for i in range(len(candidates)) if keep[i]]
        obs_map, bail = snv_vector_observations(
            variant, [candidates[i] for i in kept_idx], props
        )
        fast_obs = {kept_idx[j]: o for j, o in obs_map.items()}

    # Batched realignment: run the pileup once in record mode (host-only,
    # queuing every pair-HMM request), execute ONE padded device forward
    # per realigner, then replay. Cuts device dispatches per locus from
    # O(reads) to O(1) — the per-call overhead dominates on a device.
    realigners = []
    seen_r = set()

    def _add_realigner(v):
        r = getattr(v, "realigner", None)
        if r is not None and id(r) not in seen_r:
            seen_r.add(id(r))
            realigners.append(r)
        for sub in getattr(v, "variants", None) or []:
            _add_realigner(sub)

    _add_realigner(variant)

    try:
        if realigners:
            # single scout pass: enumerate every (allele, read-window)
            # pair, queue SYMBOLIC forward requests, then compute all edit
            # hits of the pileup in one native batch; run_batch /
            # collect_requests materializes the shrunk windows + bands +
            # patched-allele forwards from the memoized hits, and the
            # replay pass (extract_observations_finish) consumes results
            # in the identical order
            for r in realigners:
                r.begin_scout()
            scout_relevant = variant.scout_relevant
            for ev, k in zip(candidates, keep):
                if k and scout_relevant(ev):
                    variant.allele_support(ev, props, alt_variants)
            for r in realigners:
                r.flush_scout()
    except BaseException:
        for r in realigners:
            r.end_batch()
        raise

    pending = PendingPileup()
    pending.variant = variant
    pending.candidates = candidates
    pending.raw_depth = len(candidates)
    pending.keep = keep
    pending.hpem = hpem
    pending.alt_variants = alt_variants
    pending.props = props
    pending.do_adjust = do_adjust_prob_mapping
    pending.fragment_id_factory = fragment_id_factory
    pending.realigners = realigners
    pending.fast_obs = fast_obs
    return pending


def extract_observations_finish(pending: PendingPileup) -> Pileup:
    """Phase 2: replay (consume the executed forward results in identical
    call order), then observation post-processing."""
    variant = pending.variant
    props = pending.props
    observations = []
    fast = pending.fast_obs
    try:
        for i, (ev, k) in enumerate(zip(pending.candidates, pending.keep)):
            if not k:
                continue
            if fast is not None and i in fast:
                obs = fast[i]
            else:
                obs = evidence_to_observation(
                    variant, ev, props, pending.hpem, pending.alt_variants
                )
            if obs is not None:
                if pending.fragment_id_factory is not None:
                    obs.fragment_id = pending.fragment_id_factory.get(ev.qname())
                observations.append(obs)
    finally:
        for r in pending.realigners:
            r.end_batch()

    process_observations(observations, props.max_read_len)
    if pending.do_adjust:
        adjust_prob_mapping(observations, props.max_mapq)
    return Pileup(read_observations=observations, raw_depth=pending.raw_depth)


def evidence_to_observation(
    variant, ev: Evidence, props, homopolymer_error_model, alt_variants
) -> ReadObservation | None:
    """read_observation.rs:626-701."""
    support = variant.allele_support(ev, props, alt_variants)
    if support is None:
        return None
    from .observation import STRAND_NONE

    if support.strand == STRAND_NONE and not variant.is_imprecise:
        return None

    obs = ReadObservation(name=ev.qname())
    set_prob_mapping(obs, ev.prob_mapping())
    obs.prob_alt = support.prob_alt_allele()
    obs.prob_ref = support.prob_ref_allele()
    obs.prob_missed_allele = support.prob_missed_allele()
    obs.prob_sample_alt = variant.prob_sample_alt(ev, props)
    set_prob_overlap(obs, 0.0 if support.strand == STRAND_BOTH else LOG_ZERO)
    obs.strand = support.strand
    obs.read_orientation = ev.read_orientation()
    obs.softclipped = ev.softclipped()
    obs.read_position_raw = support.read_position
    obs.paired = ev.is_paired()
    obs.prob_hit_base = -math.log(ev.total_len()) if ev.total_len() > 0 else LOG_ZERO
    obs.is_max_mapq = ev.min_mapq() == props.max_mapq
    obs.alt_loci_raw = ev.alt_loci()
    obs.third_allele_evidence = support.third_allele_evidence

    alt_indel_len = support.homopolymer_indel_len or 0
    if homopolymer_error_model is not None:
        ref_indel_len = alt_indel_len + homopolymer_error_model.variant_homopolymer_indel_len
        obs.homopolymer_indel_len = ref_indel_len
        if ref_indel_len == 0 or alt_indel_len == 0:
            obs.prob_observable_at_homopolymer_artifact = None
            obs.prob_observable_at_homopolymer_variant = None
        else:
            obs.prob_observable_at_homopolymer_variant = (
                homopolymer_error_model.prob_observable(alt_indel_len)
            )
            obs.prob_observable_at_homopolymer_artifact = (
                homopolymer_error_model.prob_observable(ref_indel_len)
            )
    else:
        obs.homopolymer_indel_len = None
        obs.prob_observable_at_homopolymer_artifact = None
        obs.prob_observable_at_homopolymer_variant = None
    return obs
