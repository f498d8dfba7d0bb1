"""BAM alignment reader (pure Python + numpy; no htslib dependency).

Host-side substrate replacing the reference's use of ``rust-htslib`` BAM
readers (``/root/reference/src/variants/sample.rs:37-154`` RecordBuffer).
BGZF is a sequence of standard gzip members, so the whole file decodes with
zlib per block; records are parsed into lightweight ``BamRecord`` objects.

Test-scale files are read eagerly and indexed in memory by contig; region
fetches are binary searches over sorted starts. A C++ htslib-style streaming
decoder can replace the block decode for pod-scale input without changing the
interface.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# 4-bit encoded bases per BAM spec
SEQ_CODE_TO_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
# [256, 2] nibble-pair decode table: one fancy-index turns packed 4-bit
# bases into ASCII pairs (the per-record strided unpack cost ~2x this)
SEQ_PAIR_LUT = np.empty((256, 2), dtype=np.uint8)
for _b in range(256):
    SEQ_PAIR_LUT[_b, 0] = SEQ_CODE_TO_ASCII[_b >> 4]
    SEQ_PAIR_LUT[_b, 1] = SEQ_CODE_TO_ASCII[_b & 0xF]
CIGAR_OPS = "MIDNSHP=X"

# CIGAR op indices
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
_CONSUMES_QUERY = {OP_M, OP_I, OP_S, OP_EQ, OP_X}
_CONSUMES_REF = {OP_M, OP_D, OP_N, OP_EQ, OP_X}

# FLAG bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST_IN_PAIR = 0x40
FLAG_LAST_IN_PAIR = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800


def _decode_bgzf(data: bytes) -> bytes:
    """Decompress a BGZF (concatenated gzip members) byte string."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {pos}")
        # parse the gzip member header to find BSIZE (BC extra subfield)
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        epos = 0
        while epos + 4 <= len(extra):
            si1, si2, slen = extra[epos], extra[epos + 1], struct.unpack_from("<H", extra, epos + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
                break
            epos += 4 + slen
        if bsize is None:
            # plain gzip member: decompress the rest in one go
            d = zlib.decompressobj(wbits=31)
            out.append(d.decompress(data[pos:]))
            pos = n - len(d.unused_data)
            continue
        cdata = data[pos + 12 + xlen : pos + bsize - 8]
        out.append(zlib.decompress(cdata, wbits=-15))
        pos += bsize
    return b"".join(out)


@dataclass
class BamRecord:
    qname: str
    flag: int
    tid: int
    pos: int  # 0-based leftmost
    mapq: int
    cigar: list  # [(op, len)] int tuples
    mtid: int
    mpos: int
    tlen: int
    seq: np.ndarray  # uint8 ASCII
    qual: np.ndarray  # uint8 phred (0xff -> missing)
    tags: dict = field(default_factory=dict)

    # -- flags ------------------------------------------------------------
    @property
    def is_paired(self):
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_unmapped(self):
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_mate_unmapped(self):
        return bool(self.flag & FLAG_MATE_UNMAPPED)

    @property
    def is_reverse(self):
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_mate_reverse(self):
        return bool(self.flag & FLAG_MATE_REVERSE)

    @property
    def is_first_in_pair(self):
        return bool(self.flag & FLAG_FIRST_IN_PAIR)

    @property
    def is_last_in_pair(self):
        return bool(self.flag & FLAG_LAST_IN_PAIR)

    @property
    def is_secondary(self):
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_duplicate(self):
        return bool(self.flag & FLAG_DUPLICATE)

    @property
    def is_qc_fail(self):
        return bool(self.flag & FLAG_QCFAIL)

    # -- geometry ---------------------------------------------------------
    @property
    def read_len(self) -> int:
        return len(self.seq)

    def cigar_ref_len(self) -> int:
        return int(sum(l for op, l in self.cigar if op in _CONSUMES_REF))

    @property
    def end_pos(self) -> int:
        """0-based exclusive reference end (cigar_end); cached (records are
        shared across overlapping locus fetches)."""
        cached = getattr(self, "_end_pos", None)
        if cached is None:
            cached = self.pos + self.cigar_ref_len()
            object.__setattr__(self, "_end_pos", cached)
        return cached

    def leading_softclips(self) -> int:
        for op, l in self.cigar:
            if op == OP_S:
                return int(l)
            if op != OP_H:
                return 0
        return 0

    def trailing_softclips(self) -> int:
        for op, l in self.cigar[::-1]:
            if op == OP_S:
                return int(l)
            if op != OP_H:
                return 0
        return 0

    def read_pos(self, ref_pos: int) -> int | None:
        """Query index aligned to reference position ``ref_pos`` (match ops
        only), or None if the position falls into a deletion/skip or outside
        the alignment. Mirrors htslib cigar().read_pos(pos, false, false)."""
        q = 0
        r = self.pos
        for op, l in self.cigar:
            l = int(l)
            if op in (OP_M, OP_EQ, OP_X):
                if r <= ref_pos < r + l:
                    return q + (ref_pos - r)
                q += l
                r += l
            elif op == OP_I:
                q += l
            elif op in (OP_D, OP_N):
                if r <= ref_pos < r + l:
                    return None
                r += l
            elif op == OP_S:
                q += l
            # H and P consume nothing
        return None

    def has_indel_operations(self) -> bool:
        # cached: queried per (variant, pass) in the evidence hot loop
        hio = getattr(self, "_vlt_hio", None)
        if hio is None:
            hio = any(op in (OP_I, OP_D) for op, _ in self.cigar)
            object.__setattr__(self, "_vlt_hio", hio)
        return hio

    def cigar_string(self) -> str:
        return "".join(f"{int(l)}{CIGAR_OPS[int(op)]}" for op, l in self.cigar)


def _parse_tags(buf: bytes) -> dict:
    try:
        return _parse_tags_inner(buf)
    except Exception as e:  # noqa: BLE001 - struct/index internals
        from ..errors import MalformedBamError

        raise MalformedBamError(f"aux tag block: {e}") from e


def _parse_tags_inner(buf: bytes) -> dict:
    tags = {}
    pos = 0
    n = len(buf)
    while pos + 3 <= n:
        tag = buf[pos : pos + 2].decode("latin1")
        typ = chr(buf[pos + 2])
        pos += 3
        if typ == "A":
            tags[tag] = chr(buf[pos])
            pos += 1
        elif typ in "cC":
            tags[tag] = struct.unpack_from("<b" if typ == "c" else "<B", buf, pos)[0]
            pos += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", buf, pos)[0]
            pos += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", buf, pos)[0]
            pos += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", pos)
            tags[tag] = buf[pos:end].decode("latin1")
            pos = end + 1
        elif typ == "B":
            sub = chr(buf[pos])
            cnt = struct.unpack_from("<i", buf, pos + 1)[0]
            pos += 5
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            size = struct.calcsize(fmt)
            tags[tag] = np.frombuffer(buf[pos : pos + cnt * size], dtype=np.dtype(fmt))
            pos += cnt * size
        else:
            break
    return tags


LAZY_THRESHOLD_BYTES = 32 << 20  # files above this with an index stream lazily


class BamReader:
    """BAM reader.

    Small / unindexed files are decoded eagerly in memory (fast for the
    testcase-scale mini-BAMs).  Files with a .bai/.csi index above
    ``LAZY_THRESHOLD_BYTES`` (or with ``lazy=True``) stream: region fetches
    resolve index chunks to BGZF virtual offsets and only the touched
    blocks are ever decompressed (LRU block cache), so memory stays bounded
    on multi-GB WGS BAMs (sample.rs:96-139 RecordBuffer semantics)."""

    def __init__(self, path, lazy: bool | None = None, reference=None):
        self.path = Path(path)
        from .bam_index import BamIndex

        # CRAM input is accepted transparently wherever a BAM path is
        # (rust-htslib behavior, Cargo.toml:65); reference-based containers
        # need the FASTA passed as `reference` (FastaBuffer or dict)
        try:
            with open(self.path, "rb") as _f:
                _magic = _f.read(4)
        except OSError:
            _magic = b""
        if _magic == b"CRAM":
            self._init_cram(reference, lazy)
            return

        self._index = BamIndex.load(self.path)
        size = self.path.stat().st_size
        self._lazy = (
            lazy
            if lazy is not None
            else (self._index is not None and size >= LAZY_THRESHOLD_BYTES)
        )
        if self._lazy:
            if self._index is None:
                raise ValueError(f"lazy BAM access requires a .bai/.csi index for {path}")
            self._init_lazy()
            return
        from ..errors import MalformedBamError

        raw = self.path.read_bytes()
        # native parallel BGZF inflate when available (io/native.py)
        from . import native

        if str(self.path).endswith(".sam") or (
            raw[:1] == b"@" and raw[:2] != b"\x1f\x8b"
        ):
            # SAM text input (the reference reads SAM transparently through
            # htslib; preprocess accepts it the same way here)
            self._init_sam(raw.decode("latin1", errors="replace"))
            self._finish_columnar_index()
            return
        try:
            data = native.bgzf_decompress(raw) if raw[:2] == b"\x1f\x8b" else None
            if data is None:
                data = _decode_bgzf(raw)
        except Exception as e:  # noqa: BLE001 - zlib/struct internals
            raise MalformedBamError(f"BGZF stream of {path}: {e}") from e
        if data[:4] != b"BAM\x01":
            raise MalformedBamError(f"{path} lacks the BAM\\1 magic")
        try:
            l_text = struct.unpack_from("<i", data, 4)[0]
            self.header_text = data[8 : 8 + l_text].rstrip(b"\x00").decode("latin1")
            pos = 8 + l_text
            n_ref = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            self.ref_names: list[str] = []
            self.ref_lengths: list[int] = []
            for _ in range(n_ref):
                l_name = struct.unpack_from("<i", data, pos)[0]
                name = data[pos + 4 : pos + 4 + l_name - 1].decode("latin1")
                l_ref = struct.unpack_from("<i", data, pos + 4 + l_name)[0]
                self.ref_names.append(name)
                self.ref_lengths.append(l_ref)
                pos += 8 + l_name
        except (struct.error, IndexError, UnicodeDecodeError) as e:
            raise MalformedBamError(f"header of {path}: {e}") from e
        self._tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
        self._data = data
        self._rec_cache: dict[int, BamRecord] = {}
        self._rec_list = None

        # columnar record index: native single-pass scan when available,
        # python fallback otherwise; records parse lazily on access
        idx = native.bam_scan(data, pos)
        if idx is not None:
            (
                self._offsets,
                self._tids,
                self._positions,
                self._ends,
                _flags,
                _mapqs,
            ) = idx
        else:
            offsets, tids, positions, ends = [], [], [], []
            n = len(data)
            p = pos
            while p + 4 <= n:
                block_size = struct.unpack_from("<i", data, p)[0]
                if block_size < 32 or p + 4 + block_size > n:
                    raise MalformedBamError(
                        f"record block_size {block_size} at offset {p} in {path}"
                    )
                rec = self._parse_record(data, p + 4, block_size)
                self._rec_cache[p] = rec
                offsets.append(p)
                tids.append(rec.tid)
                positions.append(rec.pos)
                ends.append(rec.end_pos)
                p += 4 + block_size
            self._offsets = np.array(offsets, dtype=np.int64)
            self._tids = np.array(tids, dtype=np.int32)
            self._positions = np.array(positions, dtype=np.int32)
            self._ends = np.array(ends, dtype=np.int32)

        self._finish_columnar_index()

    def _finish_columnar_index(self):
        # per-tid sorted-by-start views
        self._tid_order: dict[int, np.ndarray] = {}
        self._tid_starts: dict[int, np.ndarray] = {}
        self._max_span: dict[int, int] = {}
        for tid in np.unique(self._tids):
            sel = np.nonzero(self._tids == tid)[0]
            order = sel[np.argsort(self._positions[sel], kind="stable")]
            self._tid_order[int(tid)] = order
            self._tid_starts[int(tid)] = self._positions[order].astype(np.int64)
            spans = self._ends[order] - self._positions[order]
            self._max_span[int(tid)] = int(spans.max()) if len(spans) else 0

    # -- CRAM input -------------------------------------------------------
    def _init_cram(self, reference, lazy=None):
        """CRAM input.  Small files decode eagerly into the same columnar
        index the small-BAM path builds; at/above LAZY_THRESHOLD_BYTES (or
        with lazy=True) the container-granular streaming decoder takes
        over (CRAI-aware; io/cram.py CramDecoder(lazy=True)) and fetch()
        inflates only overlapping containers."""
        from .cram import CramDecoder

        self._lazy = False
        self._index = None
        self._cram = None
        size = self.path.stat().st_size
        use_lazy = lazy if lazy is not None else size >= LAZY_THRESHOLD_BYTES
        if use_lazy:
            dec = CramDecoder(self.path, reference=reference, lazy=True)
            self._cram = dec
            self.header_text = dec.header_text
            self.ref_names = dec.ref_names
            self.ref_lengths = dec.ref_lengths
            self._tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
            return
        dec = CramDecoder(self.path, reference=reference)
        self.header_text = dec.header_text
        self.ref_names = dec.ref_names
        self.ref_lengths = dec.ref_lengths
        self._tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
        self._data = b""
        self._rec_cache = {}
        self._rec_list = None
        offsets, tids, positions, ends = [], [], [], []
        for rec in dec.records:
            off = len(offsets)
            self._rec_cache[off] = rec
            offsets.append(off)
            tids.append(rec.tid)
            positions.append(rec.pos)
            ends.append(rec.end_pos)
        self._offsets = np.array(offsets, dtype=np.int64)
        self._tids = np.array(tids, dtype=np.int32)
        self._positions = np.array(positions, dtype=np.int32)
        self._ends = np.array(ends, dtype=np.int32)
        self._finish_columnar_index()

    # -- SAM text input -------------------------------------------------
    def _init_sam(self, text: str):
        """Plain-text SAM (SAMv1): parsed eagerly into the same columnar
        index the BAM path builds (CRAM likewise, via _init_cram)."""
        import re as _re

        from ..errors import MalformedBamError

        self.header_text = ""
        self.ref_names = []
        self.ref_lengths = []
        self._rec_cache = {}
        self._rec_list = None
        self._data = b""
        header_lines = []
        offsets, tids, positions, ends = [], [], [], []
        cig_re = _re.compile(r"(\d+)([MIDNSHP=X])")
        op_of = {c: i for i, c in enumerate("MIDNSHP=X")}
        tid_by_name: dict[str, int] = {}
        for ln, line in enumerate(text.splitlines()):
            if not line:
                continue
            if line.startswith("@"):
                header_lines.append(line)
                if line.startswith("@SQ"):
                    fields = dict(
                        f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                    )
                    if "SN" in fields:
                        tid_by_name[fields["SN"]] = len(self.ref_names)
                        self.ref_names.append(fields["SN"])
                        self.ref_lengths.append(int(fields.get("LN", 0)))
                continue
            cols = line.split("\t")
            if len(cols) < 11:
                raise MalformedBamError(f"SAM line {ln + 1}: <11 columns")
            try:
                flag = int(cols[1])
                tid = tid_by_name.get(cols[2], -1)
                pos0 = int(cols[3]) - 1
                mapq = int(cols[4])
                cigar = [
                    (op_of[m.group(2)], int(m.group(1)))
                    for m in cig_re.finditer(cols[5])
                ] if cols[5] != "*" else []
                mtid = (
                    tid
                    if cols[6] == "="
                    else tid_by_name.get(cols[6], -1)
                )
                mpos = int(cols[7]) - 1
                tlen = int(cols[8])
                seq = (
                    np.frombuffer(cols[9].encode("latin1"), dtype=np.uint8)
                    if cols[9] != "*"
                    else np.zeros(0, np.uint8)
                )
                # soft-masked lowercase bases: the BAM 4-bit decoder can only
                # produce uppercase; normalize letters (htslib seq_nt16
                # behavior), leaving '=' and friends untouched
                low = (seq >= 97) & (seq <= 122)
                if low.any():
                    seq = np.where(low, seq & ~np.uint8(0x20), seq)
                qual = (
                    np.frombuffer(cols[10].encode("latin1"), dtype=np.uint8) - 33
                    if cols[10] != "*"
                    else np.full(len(seq), 255, np.uint8)
                )
                tags = {}
                for t in cols[11:]:
                    name, typ, val = t.split(":", 2)
                    if typ in "iI":
                        tags[name] = int(val)
                    elif typ == "f":
                        tags[name] = float(val)
                    elif typ == "B":
                        sub, *vals = val.split(",")
                        conv = float if sub == "f" else int
                        tags[name] = np.array([conv(v) for v in vals])
                    else:
                        tags[name] = val
            except (ValueError, KeyError) as e:
                raise MalformedBamError(f"SAM line {ln + 1}: {e}") from e
            rec = BamRecord(
                qname=cols[0],
                flag=flag,
                tid=tid,
                pos=pos0,
                mapq=mapq,
                cigar=cigar,
                mtid=mtid,
                mpos=mpos,
                tlen=tlen,
                seq=np.ascontiguousarray(seq),
                qual=qual.astype(np.uint8),
                tags=tags,
            )
            off = len(offsets)
            self._rec_cache[off] = rec
            offsets.append(off)
            tids.append(tid)
            positions.append(pos0)
            ends.append(rec.end_pos)
        self.header_text = "\n".join(header_lines)
        self._tid_by_name = tid_by_name
        self._offsets = np.array(offsets, dtype=np.int64)
        self._tids = np.array(tids, dtype=np.int32)
        self._positions = np.array(positions, dtype=np.int32)
        self._ends = np.array(ends, dtype=np.int32)

    # -- lazy (indexed, streaming) mode --------------------------------
    def _init_lazy(self):
        from collections import OrderedDict

        self._fh = open(self.path, "rb")
        self._block_cache: "OrderedDict[int, tuple[bytes, int]]" = OrderedDict()
        self._block_cache_cap = 512  # ~32MB of decompressed blocks
        self._lazy_rec_cache: "OrderedDict[int, BamRecord]" = OrderedDict()
        self._lazy_rec_cap = 50000
        # parse the BAM header by streaming blocks from the start
        co, uo = 0, 0
        magic, co, uo = self._vread(co, uo, 4)
        if magic != b"BAM\x01":
            raise ValueError(f"{self.path} is not BAM")
        raw, co, uo = self._vread(co, uo, 4)
        l_text = struct.unpack("<i", raw)[0]
        text, co, uo = self._vread(co, uo, l_text)
        self.header_text = text.rstrip(b"\x00").decode("latin1")
        raw, co, uo = self._vread(co, uo, 4)
        n_ref = struct.unpack("<i", raw)[0]
        self.ref_names = []
        self.ref_lengths = []
        for _ in range(n_ref):
            raw, co, uo = self._vread(co, uo, 4)
            l_name = struct.unpack("<i", raw)[0]
            raw, co, uo = self._vread(co, uo, l_name + 4)
            self.ref_names.append(raw[: l_name - 1].decode("latin1"))
            self.ref_lengths.append(struct.unpack_from("<i", raw, l_name)[0])
        self._tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
        self._first_record_voffset = (co << 16) | uo

    def _block(self, coffset: int):
        """Decompressed block at compressed offset -> (data, next_coffset)."""
        hit = self._block_cache.get(coffset)
        if hit is not None:
            self._block_cache.move_to_end(coffset)
            return hit
        self._fh.seek(coffset)
        head = self._fh.read(18)
        if len(head) < 18 or head[:2] != b"\x1f\x8b":
            return (b"", coffset)  # EOF / trailer
        xlen = struct.unpack_from("<H", head, 10)[0]
        extra = head[12:18]
        if xlen > 6:
            extra += self._fh.read(xlen - 6)
        bsize = None
        epos = 0
        while epos + 4 <= len(extra):
            si1, si2, slen = extra[epos], extra[epos + 1], struct.unpack_from(
                "<H", extra, epos + 2
            )[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
                break
            epos += 4 + slen
        if bsize is None:
            raise ValueError("non-BGZF gzip member in indexed BAM")
        cdata = self._fh.read(bsize - 12 - xlen - 8)
        data = zlib.decompress(cdata, wbits=-15)
        entry = (data, coffset + bsize)
        self._block_cache[coffset] = entry
        if len(self._block_cache) > self._block_cache_cap:
            self._block_cache.popitem(last=False)
        return entry

    def _vread(self, coffset: int, uoffset: int, n: int):
        """Read n bytes at virtual position -> (bytes|None, coffset', uoffset')."""
        parts = []
        need = n
        while need > 0:
            data, nxt = self._block(coffset)
            if not data:
                return (None, coffset, uoffset) if parts or need == n else (
                    None, coffset, uoffset
                )
            take = data[uoffset : uoffset + need]
            parts.append(take)
            need -= len(take)
            uoffset += len(take)
            if uoffset >= len(data) and need > 0:
                coffset, uoffset = nxt, 0
            elif uoffset >= len(data) and need == 0:
                # normalize to the start of the next block so voffset
                # comparisons against chunk ends behave
                coffset, uoffset = nxt, 0
        out = b"".join(parts)
        return (out if len(out) == n else None), coffset, uoffset

    def _lazy_record_at(self, voffset: int):
        rec = self._lazy_rec_cache.get(voffset)
        if rec is not None:
            self._lazy_rec_cache.move_to_end(voffset)
            return rec
        co, uo = voffset >> 16, voffset & 0xFFFF
        raw, co, uo = self._vread(co, uo, 4)
        if raw is None:
            return None
        (bs,) = struct.unpack("<i", raw)
        body, co, uo = self._vread(co, uo, bs)
        if body is None:
            return None
        rec = self._parse_record(body, 0, bs)
        self._lazy_rec_cache[voffset] = rec
        if len(self._lazy_rec_cache) > self._lazy_rec_cap:
            self._lazy_rec_cache.popitem(last=False)
        return rec

    def scan_records(self, contig: str, start_pos: int):
        """Forward-only, position-ordered record stream for ``contig``
        starting at the first record with ``pos >= start_pos``-ish (callers
        must skip leading records below their own threshold).  The lazy
        path streams BGZF blocks SEQUENTIALLY into a rolling buffer and
        parses records in one tight loop — none of the per-record
        virtual-offset bookkeeping of ``_lazy_stream`` (which dominated
        WGS-scale preprocess profiles at ~23 us/record).  Returns None when
        unsupported (CRAM container streaming has its own fetch path)."""
        if getattr(self, "_cram", None) is not None:
            return None
        tid = self._tid_by_name.get(contig)
        if tid is None:
            return iter(())
        if not self._lazy:
            order = self._tid_order.get(int(tid))
            if order is None:
                return iter(())
            starts = self._tid_starts[int(tid)]
            lo = int(np.searchsorted(starts, start_pos, side="left"))

            def _eager():
                for i in order[lo:].tolist():
                    yield self._record_at(i)

            return _eager()
        if self._index is None:
            return None
        end = (
            self.ref_lengths[tid]
            if tid < len(self.ref_lengths) and self.ref_lengths[tid]
            else (1 << 40)
        )
        chunks = self._index.chunks(tid, max(start_pos, 0), end)
        if not chunks:
            return iter(())
        vbeg = chunks[0][0]

        def _lazy_scan():
            co, uo = vbeg >> 16, vbeg & 0xFFFF
            data, nxt = self._block(co)
            if not data:
                return
            buf = data[uo:]
            co = nxt
            cursor = 0
            parse = self._parse_record
            while True:
                n = len(buf)
                while n - cursor >= 4:
                    bs = int.from_bytes(buf[cursor : cursor + 4], "little")
                    if n - cursor - 4 < bs:
                        break
                    rec = parse(buf, cursor + 4, bs)
                    cursor += 4 + bs
                    if rec.tid != tid:
                        return  # sorted: past this contig (or unmapped tail)
                    yield rec
                data, nxt = self._block(co)
                if not data:
                    return
                buf = buf[cursor:] + data
                cursor = 0
                co = nxt

        return _lazy_scan()

    def _lazy_stream(self, voffset: int):
        """Yield (voffset, record, next_voffset) from a virtual offset."""
        co, uo = voffset >> 16, voffset & 0xFFFF
        while True:
            start_v = (co << 16) | uo
            raw, co2, uo2 = self._vread(co, uo, 4)
            if raw is None:
                return
            (bs,) = struct.unpack("<i", raw)
            cached = self._lazy_rec_cache.get(start_v)
            if cached is not None:
                self._lazy_rec_cache.move_to_end(start_v)
                # still need to advance past the body
                _, co, uo = self._vread(co2, uo2, bs)
                yield start_v, cached, (co << 16) | uo
                continue
            body, co, uo = self._vread(co2, uo2, bs)
            if body is None:
                return
            rec = self._parse_record(body, 0, bs)
            self._lazy_rec_cache[start_v] = rec
            if len(self._lazy_rec_cache) > self._lazy_rec_cap:
                self._lazy_rec_cache.popitem(last=False)
            yield start_v, rec, (co << 16) | uo

    def _record_at(self, index: int) -> BamRecord:
        off = int(self._offsets[index])
        rec = self._rec_cache.get(off)
        if rec is None:
            block_size = struct.unpack_from("<i", self._data, off)[0]
            rec = self._parse_record(self._data, off + 4, block_size)
            self._rec_cache[off] = rec
        return rec

    @property
    def records(self) -> list[BamRecord]:
        if self._lazy or getattr(self, "_cram", None) is not None:
            # materializes the whole file; prefer iteration / fetch
            return list(self)
        return [self._record_at(i) for i in range(len(self._offsets))]

    @staticmethod
    def _parse_record(data: bytes, pos: int, block_size: int) -> BamRecord:
        from ..errors import MalformedBamError

        if block_size < 32 or pos + block_size > len(data):
            raise MalformedBamError(
                f"record block_size {block_size} at offset {pos} exceeds "
                "the decompressed stream"
            )
        (
            tid,
            p,
            l_read_name,
            mapq,
            _bin,
            n_cigar_op,
            flag,
            l_seq,
            mtid,
            mpos,
            tlen,
        ) = struct.unpack_from("<iiBBHHHiiii", data, pos)
        if l_seq < 0 or 32 + l_read_name + 4 * n_cigar_op + (l_seq + 1) // 2 + l_seq > block_size:
            raise MalformedBamError(
                f"record at offset {pos}: field lengths (name {l_read_name}, "
                f"cigar {n_cigar_op}, seq {l_seq}) exceed block size {block_size}"
            )
        off = pos + 32
        qname = data[off : off + l_read_name - 1].decode("latin1")
        off += l_read_name
        # plain python tuples: every consumer iterates the cigar in scalar
        # loops, where numpy row indexing costs ~20x a tuple unpack; short
        # cigars (the overwhelming majority) skip numpy entirely
        if n_cigar_op <= 3:
            cigar = []
            for _k in range(n_cigar_op):
                (cv,) = struct.unpack_from("<I", data, off + 4 * _k)
                cigar.append((cv & 0xF, cv >> 4))
        else:
            cigar_raw = np.frombuffer(
                data[off : off + 4 * n_cigar_op], dtype="<u4"
            )
            cigar = list(
                zip(
                    (cigar_raw & 0xF).tolist(),
                    (cigar_raw >> 4).tolist(),
                )
            )
        off += 4 * n_cigar_op
        nseq_bytes = (l_seq + 1) // 2
        packed = np.frombuffer(data[off : off + nseq_bytes], dtype=np.uint8)
        seq = SEQ_PAIR_LUT[packed].reshape(-1)[:l_seq]
        off += nseq_bytes
        qual = np.frombuffer(data[off : off + l_seq], dtype=np.uint8).copy()
        off += l_seq
        tag_raw = data[off : pos + block_size]
        tags = _parse_tags(tag_raw) if tag_raw else {}
        # CG-tag long CIGAR (htslib SAMv1 §4.2.2: reads with >65535 ops are
        # stored with a kSmN placeholder CIGAR and the real one in CG:B,I)
        if (
            n_cigar_op == 2
            and cigar[0][0] == OP_S
            and cigar[0][1] == l_seq
            and cigar[1][0] == OP_N
        ):
            cg = tags.pop("CG", None)
            if cg is not None and not isinstance(cg, (int, float, str)):
                cg = np.asarray(cg).astype(np.uint32)
                cigar = list(zip((cg & 0xF).tolist(), (cg >> 4).tolist()))
        return BamRecord(
            qname=qname,
            flag=flag,
            tid=tid,
            pos=p,
            mapq=mapq,
            cigar=cigar,
            mtid=mtid,
            mpos=mpos,
            tlen=tlen,
            seq=seq,
            qual=qual,
            tags=tags,
        )

    # -- queries -----------------------------------------------------------
    def tid(self, contig: str) -> int:
        return self._tid_by_name[contig]

    def fetch(self, contig: str, start: int, end: int) -> list[BamRecord]:
        """Records overlapping [start, end) on contig, in start order."""
        tid = self._tid_by_name.get(contig)
        if getattr(self, "_cram", None) is not None:
            return [] if tid is None else self._cram.fetch(tid, start, end)
        if self._lazy:
            if tid is None:
                return []
            out = []
            for vbeg, vend in self._index.chunks(tid, start, end):
                for _, rec, nxt in self._lazy_stream(vbeg):
                    if rec.tid > tid or (rec.tid == tid and rec.pos >= end):
                        break
                    if rec.tid == tid and rec.end_pos > start and rec.pos < end:
                        out.append(rec)
                    if nxt >= vend:
                        break
            out.sort(key=lambda r: r.pos)
            return out
        if tid is None or tid not in self._tid_order:
            return []
        order = self._tid_order[tid]
        starts = self._tid_starts[tid]
        lo = int(np.searchsorted(starts, start - self._max_span[tid], side="left"))
        hi = int(np.searchsorted(starts, end, side="left"))
        cand = order[lo:hi]
        cand = cand[(self._ends[cand] > start) & (self._positions[cand] < end)]
        # flat record list (parse-once): overlapping locus fetches touch the
        # same records thousands of times; a list index beats the
        # offset-dict + method call per record
        rl = self._rec_list
        if rl is None:
            rl = self._rec_list = [None] * len(self._offsets)
        out = []
        for i in cand.tolist():
            rec = rl[i]
            if rec is None:
                rec = rl[i] = self._record_at(i)
            out.append(rec)
        return out

    def __iter__(self):
        if getattr(self, "_cram", None) is not None:
            yield from self._cram.iter_records()
            return
        if self._lazy:
            for _, rec, _ in self._lazy_stream(self._first_record_voffset):
                yield rec
            return
        for i in range(len(self._offsets)):
            yield self._record_at(i)

    def __len__(self):
        if getattr(self, "_cram", None) is not None:
            return self._cram.count_records()
        if self._lazy:
            n = getattr(self, "_lazy_len", None)
            if n is None:
                n = sum(1 for _ in self)
                self._lazy_len = n
            return n
        return len(self._offsets)


# ---------------------------------------------------------------------------
# BAM writing (testcase capture; SAMv1 spec section 4)
# ---------------------------------------------------------------------------

_ASCII_TO_SEQ_CODE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(SEQ_CODE_TO_ASCII):
    _ASCII_TO_SEQ_CODE[_b] = _i
    _ASCII_TO_SEQ_CODE[_b | 0x20] = _i

_CIGAR_OP_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}


def _pack_seq(seq: np.ndarray) -> np.ndarray:
    """[L] ASCII bases -> [ceil(L/2)] BAM 4-bit codes, high nibble first
    (SAMv1 4.2)."""
    codes = _ASCII_TO_SEQ_CODE[seq]
    if len(codes) % 2:
        codes = np.append(codes, np.uint8(0))
    return (codes[0::2] << 4) | codes[1::2]


def _encode_bgzf_blocks(data: bytes, block_size: int = 65000):
    """Compress to BGZF; returns (bytes, per-member compressed sizes).

    The size list (one entry per member, EOF marker excluded) lets the
    index writer map uncompressed offsets to virtual file offsets."""
    out = []
    sizes = []
    for off in range(0, len(data), block_size):
        chunk = data[off : off + block_size]
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = comp.compress(chunk) + comp.flush()
        bsize = len(cdata) + 25 + 1  # header(12)+extra(6)+payload+crc(4)+isize(4)
        member = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<HH", 2, bsize - 1)
            + cdata
            + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
        )
        out.append(member)
        sizes.append(len(member))
    # standard BGZF EOF marker
    out.append(
        bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"
        )
    )
    return b"".join(out), sizes


def _encode_bgzf(data: bytes, block_size: int = 65000) -> bytes:
    """Compress to BGZF (gzip members with BC extra field + EOF marker)."""
    return _encode_bgzf_blocks(data, block_size)[0]


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAMv1 4.2.1)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for tag, val in tags.items():
        t = tag.encode("latin1")[:2]
        if isinstance(val, bool):
            val = int(val)
        if isinstance(val, (int, np.integer)):
            out += t + b"i" + struct.pack("<i", int(val))
        elif isinstance(val, (float, np.floating)):
            out += t + b"f" + struct.pack("<f", float(val))
        elif isinstance(val, str):
            if len(val) == 1 and tag in ("RO",):
                out += t + b"A" + val.encode("latin1")
            else:
                out += t + b"Z" + val.encode("latin1") + b"\x00"
        elif isinstance(val, np.ndarray):
            sub = {"b": "c", "B": "C", "h": "s", "H": "S", "i": "i", "I": "I", "f": "f"}[
                val.dtype.char
            ]
            out += (
                t
                + b"B"
                + sub.encode()
                + struct.pack("<i", len(val))
                + val.astype(f"<{val.dtype.char}").tobytes()
            )
    return bytes(out)


class BamWriter:
    """Minimal coordinate-preserving BAM writer (testcase capture side;
    reference testcase/builder.rs:310-505 slices BAMs the same way)."""

    def __init__(self, path, ref_names: list, ref_lengths: list, header_text: str = ""):
        self.path = Path(path)
        self.ref_names = list(ref_names)
        self._tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
        body = bytearray()
        text = header_text
        if not text:
            lines = ["@HD\tVN:1.6\tSO:coordinate"]
            for n, l in zip(ref_names, ref_lengths):
                lines.append(f"@SQ\tSN:{n}\tLN:{int(l)}")
            text = "\n".join(lines) + "\n"
        tb = text.encode("latin1")
        body += b"BAM\x01" + struct.pack("<i", len(tb)) + tb
        body += struct.pack("<i", len(self.ref_names))
        for n, l in zip(ref_names, ref_lengths):
            nb = n.encode("latin1") + b"\x00"
            body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
        self._body = body
        self._ref_lengths = [int(l) for l in ref_lengths]
        self._rec_meta = []  # (tid, pos, end, body_start, body_end)

    def tid(self, contig: str) -> int:
        return self._tid_by_name.get(contig, -1)

    def write_record(self, rec: BamRecord, tid=None, mtid=None):
        tid = rec.tid if tid is None else tid
        mtid = rec.mtid if mtid is None else mtid
        name = rec.qname.encode("latin1") + b"\x00"
        cig = b"".join(
            struct.pack("<I", (int(l) << 4) | int(op)) for op, l in rec.cigar
        )
        l_seq = len(rec.seq)
        packed = _pack_seq(np.asarray(rec.seq, dtype=np.uint8))
        qual = rec.qual.astype(np.uint8).tobytes() if l_seq else b""
        tags = _encode_tags(rec.tags)
        end = rec.end_pos if len(rec.cigar) else rec.pos + 1
        data = (
            struct.pack(
                "<iiBBHHHiiii",
                tid,
                rec.pos,
                len(name),
                rec.mapq,
                _reg2bin(max(rec.pos, 0), max(end, rec.pos + 1)),
                len(rec.cigar),
                rec.flag,
                l_seq,
                mtid,
                rec.mpos,
                rec.tlen,
            )
            + name
            + cig
            + packed.tobytes()
            + qual
            + tags
        )
        start = len(self._body)
        self._body += struct.pack("<i", len(data)) + data
        self._rec_meta.append((tid, rec.pos, end, start, len(self._body)))

    def close(self, index: bool | str = False):
        """Write the BAM; with index=True/'bai'/'csi' also write the
        matching index (.bai by default; .csi for contigs >= 2^29, the
        BAI coordinate ceiling — SAM spec §5.2/§5.4)."""
        data, sizes = _encode_bgzf_blocks(bytes(self._body))
        with open(self.path, "wb") as f:
            f.write(data)
        if not index:
            return
        comp_start = [0]
        for s in sizes:
            comp_start.append(comp_start[-1] + s)

        def voff(o, block=65000):
            return (comp_start[o // block] << 16) | (o % block)

        meta = [
            (tid, pos, end, voff(s0), voff(s1))
            for (tid, pos, end, s0, s1) in self._rec_meta
        ]
        from .bam_index import write_bai, write_csi

        kind = index if isinstance(index, str) else (
            "csi" if max(self._ref_lengths, default=0) >= (1 << 29) else "bai"
        )
        if kind == "csi":
            write_csi(str(self.path) + ".csi", meta, len(self.ref_names))
        else:
            write_bai(str(self.path) + ".bai", meta, len(self.ref_names))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
