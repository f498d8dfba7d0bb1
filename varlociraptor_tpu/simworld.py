"""Seeded tumor-normal worlds with planted truth, for end-to-end runs.

A world is one contig of random sequence and two haplotypes per sample:
germline variants sit on haplotype 1 of both samples, somatic ones on
haplotype 1 of the tumor only. Paired-end libraries are simulated from the
haplotypes with substitution errors and a low rate of short indel errors
(so that alignment-property estimation finds finite gap extensions),
aligned by construction (the CIGAR follows each read's path through its
haplotype) and written as coordinate-sorted, indexed BAMs. The candidate
VCF holds every planted site plus evenly spaced background SNVs.

Everything derives from ``WorldConfig.seed``.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SNV, DEL, INS = 0, 1, 2
# planted sites sit one per SLOT bases, so no read spans two of them
# closely and a 10 bp deletion never reaches the next site
SLOT = 400


@dataclass(frozen=True)
class WorldConfig:
    contig: str = "sim1"
    length: int = 2_000_000
    coverage: float = 30.0  # per sample
    read_len: int = 150
    insert_mean: float = 350.0
    insert_sd: float = 50.0
    germline_snvs: int = 1000
    somatic_snvs: int = 500
    germline_indels: int = 300
    somatic_indels: int = 200
    max_indel_len: int = 10
    n_candidates: int = 10_000
    sub_error: float = 0.003  # per base
    indel_error_reads: float = 0.02  # share of reads with one indel error
    seed: int = 20261016


def _plant(rng, ref, cfg):
    """Planted variants as a structured list, sorted by position:
    (pos, kind, length, alt bytes, somatic). pos is the 0-based anchor:
    the substituted base of an SNV, the base before a deletion or an
    insertion (VCF convention)."""
    n_snv = cfg.germline_snvs + cfg.somatic_snvs
    n_indel = cfg.germline_indels + cfg.somatic_indels
    n = n_snv + n_indel
    n_slots = (cfg.length - 2 * SLOT) // SLOT
    if n > n_slots:
        raise ValueError(f"{n} planted sites do not fit {n_slots} slots")
    slots = np.sort(rng.choice(n_slots, size=n, replace=False))
    pos = SLOT + slots * SLOT + rng.integers(0, SLOT - 4 * cfg.max_indel_len, n)
    kinds = np.full(n, SNV)
    is_indel = np.zeros(n, dtype=bool)
    is_indel[rng.choice(n, size=n_indel, replace=False)] = True
    kinds[is_indel] = np.where(rng.random(n_indel) < 0.5, DEL, INS)
    somatic = np.zeros(n, dtype=bool)
    snv_idx = np.nonzero(~is_indel)[0]
    indel_idx = np.nonzero(is_indel)[0]
    somatic[rng.choice(snv_idx, cfg.somatic_snvs, replace=False)] = True
    somatic[rng.choice(indel_idx, cfg.somatic_indels, replace=False)] = True
    lengths = rng.integers(1, cfg.max_indel_len + 1, n)
    out = []
    for p, k, ln, s in zip(pos.tolist(), kinds.tolist(), lengths.tolist(),
                           somatic.tolist()):
        if k == SNV:
            alt = bytes([int(rng.choice(BASES[BASES != ref[p]]))])
            ln = 1
        elif k == INS:
            alt = rng.choice(BASES, ln).tobytes()
        else:
            alt = b""
        out.append((p, k, ln, alt, s))
    return out


def _haplotype(ref, variants):
    """Apply sorted, non-overlapping variants. Returns (seq, ref_of): the
    haplotype's bases and, per base, its reference position (-1 for
    inserted bases)."""
    seqs, maps = [], []
    cur = 0
    for p, k, ln, alt, _s in variants:
        if k == SNV:
            seqs += [ref[cur:p], np.frombuffer(alt, np.uint8)]
            maps += [np.arange(cur, p + 1)]
            cur = p + 1
        elif k == DEL:
            seqs.append(ref[cur : p + 1])
            maps.append(np.arange(cur, p + 1))
            cur = p + 1 + ln
        else:
            seqs += [ref[cur : p + 1], np.frombuffer(alt, np.uint8)]
            maps += [np.arange(cur, p + 1), np.full(ln, -1)]
            cur = p + 1
    seqs.append(ref[cur:])
    maps.append(np.arange(cur, len(ref)))
    return np.concatenate(seqs), np.concatenate(maps).astype(np.int64)


def _cigar(ref_of):
    """CIGAR of a read from its bases' reference positions (-1 =
    inserted). Inserted bases at either end become soft clips. Returns
    (pos, end, [(op, len)])."""
    mapped = np.nonzero(ref_of >= 0)[0]
    a, b = int(mapped[0]), int(mapped[-1])
    ops = []

    def add(op, n):
        if n:
            if ops and ops[-1][0] == op:
                ops[-1] = (op, ops[-1][1] + n)
            else:
                ops.append((op, n))

    add(4, a)
    prev = None
    for r in ref_of[a : b + 1].tolist():
        if r < 0:
            add(1, 1)
            continue
        if prev is not None and r > prev + 1:
            add(2, r - prev - 1)
        add(0, 1)
        prev = r
    add(4, len(ref_of) - 1 - b)
    return int(ref_of[a]), int(ref_of[b]) + 1, ops


def _library(rng, haps, cfg):
    """Simulate one sample's read pairs from its two haplotypes. Returns a
    dict of per-read arrays (ref pos, flag, mate pos, tlen, pair id,
    cigar list, seq [N, L], qual [N, L])."""
    L = cfg.read_len
    n_pairs = int(cfg.length * cfg.coverage / (2 * L))
    hsel = rng.integers(0, 2, n_pairs)
    isize = np.clip(
        rng.normal(cfg.insert_mean, cfg.insert_sd, n_pairs), 2 * L + 10,
        cfg.insert_mean + 4 * cfg.insert_sd,
    ).astype(np.int64)
    n_reads = 2 * n_pairs
    seq = np.empty((n_reads, L), np.uint8)
    start = np.empty(n_reads, np.int64)  # haplotype coordinate
    hap_of = np.repeat(hsel, 2)
    pad = L + 16  # room past the fragment end for deletion errors
    for h in (0, 1):
        sel = np.nonzero(hsel == h)[0]
        hlen = len(haps[h][0])
        f = rng.integers(0, hlen - int(isize.max()) - pad, len(sel))
        start[2 * sel] = f
        start[2 * sel + 1] = f + isize[sel] - L
    # indel sequencing errors: one per affected read, 1-3 bp, away from ends
    err = rng.random(n_reads) < cfg.indel_error_reads
    err_len = np.minimum(rng.geometric(0.5, n_reads), 3)
    err_del = rng.random(n_reads) < 0.5
    err_at = rng.integers(20, L - 20, n_reads)

    ref_pos = np.empty(n_reads, np.int64)
    ref_end = np.empty(n_reads, np.int64)
    cigars = [None] * n_reads
    simple_cigar = [(0, L)]
    offs = np.arange(L)
    for h in (0, 1):
        hseq, ref_of = haps[h]
        ins_cum = np.concatenate(([0], np.cumsum(ref_of < 0)))
        idx = np.nonzero((hap_of == h) & ~err)[0]
        s = start[idx]
        seq[idx] = hseq[s[:, None] + offs]
        simple = (
            (ins_cum[s + L] - ins_cum[s] == 0)
            & (ref_of[s + L - 1] - ref_of[s] == L - 1)
        )
        ref_pos[idx] = ref_of[s]
        ref_end[idx] = ref_of[s] + L
        for k in idx[simple].tolist():
            cigars[k] = simple_cigar
        complex_idx = idx[~simple].tolist() + np.nonzero(
            (hap_of == h) & err
        )[0].tolist()
        for k in complex_idx:
            s0 = int(start[k])
            if err[k] and err_del[k]:
                g, q = int(err_len[k]), int(err_at[k])
                win = np.r_[s0 : s0 + q, s0 + q + g : s0 + L + g]
                bases, rmap = hseq[win], ref_of[win]
            elif err[k]:
                g, q = int(err_len[k]), int(err_at[k])
                win = np.arange(s0, s0 + L - g)
                bases = np.insert(hseq[win], q, rng.choice(BASES, g))
                rmap = np.insert(ref_of[win], q, np.full(g, -1))
            else:
                win = np.arange(s0, s0 + L)
                bases, rmap = hseq[win], ref_of[win]
            seq[k] = bases
            ref_pos[k], ref_end[k], cigars[k] = _cigar(rmap)
    # substitution errors on top
    nerr = rng.binomial(L, cfg.sub_error, n_reads)
    rows = np.repeat(np.arange(n_reads), nerr)
    seq[rows, rng.integers(0, L, len(rows))] = rng.choice(BASES, len(rows))

    first = np.zeros(n_reads, dtype=bool)
    first[0::2] = True
    mate = np.arange(n_reads) ^ 1
    frag_lo = np.minimum(ref_pos, ref_pos[mate])
    frag_hi = np.maximum(ref_end, ref_end[mate])
    tlen = np.where(first, frag_hi - frag_lo, -(frag_hi - frag_lo))
    flag = 0x1 | 0x2 | np.where(first, 0x20 | 0x40, 0x10 | 0x80)
    qual_pool = np.clip(rng.normal(36, 3, (256, L)), 10, 41).astype(np.uint8)
    pair = np.arange(n_reads) // 2
    return {
        "pos": ref_pos, "flag": flag, "mpos": ref_pos[mate],
        "tlen": tlen, "pair": pair, "cigar": cigars, "seq": seq,
        "qual": qual_pool[pair % 256],
    }


def _write_bam(path, lib, cfg):
    from .io.bam import BamRecord, BamWriter

    order = np.argsort(lib["pos"], kind="stable")
    w = BamWriter(path, [cfg.contig], [cfg.length])
    seq, qual, cigar = lib["seq"], lib["qual"], lib["cigar"]
    for k, pos, flag, mpos, tlen, pair in zip(
        order.tolist(), *(lib[f][order].tolist()
                          for f in ("pos", "flag", "mpos", "tlen", "pair"))
    ):
        w.write_record(BamRecord(
            qname=f"frag{pair}", flag=flag, tid=0, pos=pos, mapq=60,
            cigar=cigar[k], mtid=0, mpos=mpos, tlen=tlen, seq=seq[k],
            qual=qual[k],
        ))
    w.close(index=True)


def _vcf_row(ref, cfg, p, k, ln, alt):
    anchor = chr(ref[p])
    if k == SNV:
        return f"{cfg.contig}\t{p + 1}\t.\t{anchor}\t{alt.decode()}"
    if k == DEL:
        return f"{cfg.contig}\t{p + 1}\t.\t{ref[p : p + ln + 1].tobytes().decode()}\t{anchor}"
    return f"{cfg.contig}\t{p + 1}\t.\t{anchor}\t{anchor}{alt.decode()}"


def write_candidates(path, world, kinds=("snv", "indel"), background=True):
    """Candidate VCF: planted sites of the given kinds, plus (optionally)
    evenly spaced background SNVs up to ``n_candidates`` in all."""
    cfg = WorldConfig(**world["config"])
    ref = np.frombuffer(Path(world["ref_seq"]).read_bytes(), np.uint8)
    want = {"snv": {SNV}, "indel": {DEL, INS}}
    keep = set().union(*(want[k] for k in kinds))
    rows = [
        (v["pos"], _vcf_row(ref, cfg, v["pos"], v["kind"], v["len"],
                            v["alt"].encode()))
        for v in world["planted"]
        if v["kind"] in keep
    ]
    if background:
        planted = {v["pos"] for v in world["planted"]}
        n_bg = max(0, cfg.n_candidates - len(rows))
        alt_of = {65: b"G", 67: b"T", 71: b"A", 84: b"C"}
        step = max(1, (cfg.length - 2 * SLOT) // max(n_bg, 1))
        for p in range(SLOT + step // 2, cfg.length - SLOT, step)[:n_bg]:
            if p not in planted:
                rows.append((p, _vcf_row(ref, cfg, p, SNV, 1, alt_of[int(ref[p])])))
    rows.sort()
    with open(path, "w") as f:
        f.write(
            "##fileformat=VCFv4.2\n"
            f"##contig=<ID={cfg.contig},length={cfg.length}>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        )
        for _p, row in rows:
            f.write(row + "\t.\t.\t.\n")
    return len(rows)


def simulate_world(out_dir, cfg: WorldConfig = WorldConfig()):
    """Write ref.fa, normal.bam, tumor.bam (+ .bai) and world.json under
    ``out_dir``; returns the world description (paths, planted truth,
    seconds taken)."""
    t0 = time.perf_counter()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    ref = rng.choice(BASES, size=cfg.length)
    planted = _plant(rng, ref, cfg)
    germline = [v for v in planted if not v[4]]
    hap_ref = (ref, np.arange(cfg.length, dtype=np.int64))
    hap_germ = _haplotype(ref, germline)
    hap_tumor = _haplotype(ref, planted)

    fa = out / "ref.fa"
    s = ref.tobytes().decode("latin1")
    fa.write_text(
        f">{cfg.contig}\n"
        + "".join(s[i : i + 80] + "\n" for i in range(0, cfg.length, 80))
    )
    (out / "ref.seq").write_bytes(ref.tobytes())
    for name, haps in (("normal", (hap_ref, hap_germ)),
                       ("tumor", (hap_ref, hap_tumor))):
        _write_bam(out / f"{name}.bam", _library(rng, haps, cfg), cfg)
    world = {
        "config": asdict(cfg),
        "fa": str(fa),
        "ref_seq": str(out / "ref.seq"),
        "normal": str(out / "normal.bam"),
        "tumor": str(out / "tumor.bam"),
        "planted": [
            {"pos": p, "kind": k, "len": ln, "alt": alt.decode(), "somatic": s}
            for p, k, ln, alt, s in planted
        ],
        "seconds": time.perf_counter() - t0,
    }
    (out / "world.json").write_text(json.dumps(world))
    return world
