"""Columnar (SoA) data model for PAF records.

This is the device-friendly replacement for the reference's per-record heap structs
(``Paf``/``Cigar`` in ``inc/paf.h:52-109``).  Instead of a linked structure per
record, a whole batch of PAF records is held as parallel numpy arrays plus a
single CSR (compressed sparse row) cigar store: all cigar operations of all
records live in two flat arrays (``op code`` and ``run length``) addressed by a
per-record offset table.  That layout is what device kernels consume directly —
a batch converts to JAX arrays without any per-record work.

Field semantics mirror the reference exactly:
  * 12 mandatory PAF columns                      (inc/paf.h:12-28)
  * supported tags tp/AS/cg/tl/cn/s1, all other tags dropped (inc/paf.h:30-50)
  * score defaults to 0 and is omitted on output only when == INT_MAX
    (impl/paf.c:349; the struct is calloc'd at impl/paf.c:138)
  * tile_level / chain_id / chain_score default to -1 (impl/paf.c:175-177)
  * cigar op codes use the reference enum values    (inc/paf.h:52-58)
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
import numpy as np

# Cigar op codes — numerically identical to the reference enum (inc/paf.h:52-58)
MATCH = 0            # 'M'
QUERY_INSERT = 1     # 'I'  (substring in the query, not the target)
QUERY_DELETE = 2     # 'D'  (substring in the target, not the query)
SEQ_MATCH = 3        # '='
SEQ_MISMATCH = 4     # 'X'

OP_CHARS = np.array([ord("M"), ord("I"), ord("D"), ord("="), ord("X")], dtype=np.uint8)
OP_TO_CHAR = "MID=X"
CHAR_TO_OP = {"M": MATCH, "I": QUERY_INSERT, "D": QUERY_DELETE,
              "=": SEQ_MATCH, "X": SEQ_MISMATCH}

# Mask helpers: ops that consume query / target / are "aligned" columns.
# M, = and X consume both; I consumes query only; D consumes target only
# (coordinate walk convention of impl/paf.c:441-451).
ALIGNED_OPS = (MATCH, SEQ_MATCH, SEQ_MISMATCH)

INT_MAX = 2147483647  # C INT_MAX: the reference's "no score" sentinel (impl/paf.c:349)


def _as_obj_array(values) -> np.ndarray:
    a = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        a[i] = v
    return a


@dataclass
class PafTable:
    """A batch of PAF records in columnar form.

    All arrays have length N (number of records).  The cigar store is CSR:
    record i's ops are ``ops[off[i]:off[i+1]]`` / ``lens[off[i]:off[i+1]]``.
    ``has_cigar[i]`` distinguishes "no cg tag" from an empty cigar.
    """

    qname: np.ndarray   # object (str)
    qlen: np.ndarray    # int64
    qstart: np.ndarray  # int64
    qend: np.ndarray    # int64
    strand: np.ndarray  # bool — True iff '+' (same_strand)
    tname: np.ndarray   # object (str)
    tlen: np.ndarray    # int64
    tstart: np.ndarray  # int64
    tend: np.ndarray    # int64
    num_matches: np.ndarray  # int64
    num_bases: np.ndarray    # int64
    mapq: np.ndarray         # int64
    score: np.ndarray        # int64, default 0 (AS tag)
    tile_level: np.ndarray   # int64, default -1 (tl tag)
    chain_id: np.ndarray     # int64, default -1 (cn tag)
    chain_score: np.ndarray  # int64, default -1 (s1 tag)
    type: np.ndarray         # uint8, 0 = unset, else ord('P'/'S'/'I') (tp tag)
    has_cigar: np.ndarray    # bool
    ops: np.ndarray          # uint8  [T] — op codes
    lens: np.ndarray         # int64  [T] — run lengths
    off: np.ndarray          # int64  [N+1] — CSR offsets into ops/lens
    # raw-cigar mode (the reference's read_pafs(parse_cigar=0),
    # impl/paf_chain.c:128): (input_buffer: bytes, cg_start[N], cg_len[N])
    # byte ranges of each unparsed cg tag; ops/lens are EMPTY and off is
    # all-zero.  Only record-level transforms (tagging, reordering,
    # serialization, coordinate edits) are valid on a raw table — anything
    # reading per-op data must use a parsed table.
    raw_cg: tuple | None = None

    # ---------------------------------------------------------------- basics
    def __len__(self) -> int:
        return len(self.qlen)

    @property
    def n_ops(self) -> np.ndarray:
        return self.off[1:] - self.off[:-1]

    @staticmethod
    def empty() -> "PafTable":
        z = np.zeros(0, dtype=np.int64)
        return PafTable(
            qname=np.empty(0, dtype=object), qlen=z.copy(), qstart=z.copy(),
            qend=z.copy(), strand=np.zeros(0, dtype=bool),
            tname=np.empty(0, dtype=object), tlen=z.copy(), tstart=z.copy(),
            tend=z.copy(), num_matches=z.copy(), num_bases=z.copy(),
            mapq=z.copy(), score=z.copy(), tile_level=z.copy(),
            chain_id=z.copy(), chain_score=z.copy(),
            type=np.zeros(0, dtype=np.uint8), has_cigar=np.zeros(0, dtype=bool),
            ops=np.zeros(0, dtype=np.uint8), lens=z.copy(),
            off=np.zeros(1, dtype=np.int64))

    @staticmethod
    def build(rows: list[dict]) -> "PafTable":
        """Build from a list of per-record dicts (test/fixture helper).

        Each dict carries the mandatory fields plus optional
        score/tile_level/chain_id/chain_score/type/cigar (a list of
        ``(op, length)`` pairs, or None).
        """
        n = len(rows)
        t = PafTable.empty()
        if n == 0:
            return t
        ops_all, lens_all, off = [], [], [0]
        has_cigar = np.zeros(n, dtype=bool)
        for i, r in enumerate(rows):
            cg = r.get("cigar")
            if cg is not None and len(cg) > 0:
                has_cigar[i] = True
                for op, ln in cg:
                    ops_all.append(op)
                    lens_all.append(ln)
            off.append(len(ops_all))
        def col(name, default, dtype=np.int64):
            return np.array([r.get(name, default) for r in rows], dtype=dtype)
        return PafTable(
            qname=_as_obj_array([r["qname"] for r in rows]),
            qlen=col("qlen", 0), qstart=col("qstart", 0), qend=col("qend", 0),
            strand=np.array([bool(r.get("strand", True)) for r in rows]),
            tname=_as_obj_array([r["tname"] for r in rows]),
            tlen=col("tlen", 0), tstart=col("tstart", 0), tend=col("tend", 0),
            num_matches=col("num_matches", 0), num_bases=col("num_bases", 0),
            mapq=col("mapq", 255), score=col("score", 0),
            tile_level=col("tile_level", -1), chain_id=col("chain_id", -1),
            chain_score=col("chain_score", -1),
            type=np.array([ord(r["type"]) if r.get("type") else 0 for r in rows],
                          dtype=np.uint8),
            has_cigar=has_cigar,
            ops=np.array(ops_all, dtype=np.uint8),
            lens=np.array(lens_all, dtype=np.int64),
            off=np.array(off, dtype=np.int64))

    # ------------------------------------------------------------- selection
    def take(self, idx) -> "PafTable":
        """Row-subset (and/or reorder) by integer indices or boolean mask."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            if idx.all():
                return self  # keep-everything shortcut (common in filter)
            idx = np.nonzero(idx)[0]
        counts = (self.off[1:] - self.off[:-1])[idx]
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=new_off[1:])
        starts = self.off[:-1][idx]
        # gather the flat op ranges: native threaded memcpy per record when
        # available, else the vectorized repeat+ramp form
        new_ops = new_lens = None
        try:
            from paffy_tpu import native
            res = native.copy_op_ranges(starts, starts + counts, new_off,
                                        self.ops, self.lens)
            if res is not None:
                new_ops, new_lens = res
        except ImportError:
            pass
        if new_ops is None:
            gather = _range_gather(starts, counts)
            new_ops = self.ops[gather]
            new_lens = self.lens[gather]
        return PafTable(
            qname=self.qname[idx], qlen=self.qlen[idx], qstart=self.qstart[idx],
            qend=self.qend[idx], strand=self.strand[idx], tname=self.tname[idx],
            tlen=self.tlen[idx], tstart=self.tstart[idx], tend=self.tend[idx],
            num_matches=self.num_matches[idx], num_bases=self.num_bases[idx],
            mapq=self.mapq[idx], score=self.score[idx],
            tile_level=self.tile_level[idx], chain_id=self.chain_id[idx],
            chain_score=self.chain_score[idx], type=self.type[idx],
            has_cigar=self.has_cigar[idx],
            ops=new_ops, lens=new_lens, off=new_off,
            raw_cg=(None if self.raw_cg is None else
                    (self.raw_cg[0], self.raw_cg[1][idx],
                     self.raw_cg[2][idx])))

    def copy(self) -> "PafTable":
        return PafTable(**{
            k: (v if k == "raw_cg" and v is None else
                (v[0], v[1].copy(), v[2].copy()) if k == "raw_cg" else
                v.copy())
            for k, v in self.__dict__.items()})

    def record_ops(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(ops, lens) slice views for record i."""
        s, e = self.off[i], self.off[i + 1]
        return self.ops[s:e], self.lens[s:e]

    def with_cigars(self, ops: np.ndarray, lens: np.ndarray, off: np.ndarray,
                    has_cigar: np.ndarray | None = None) -> "PafTable":
        # copy=False: callers hand in freshly built arrays; a forced copy
        # measured ~1 s on a 24M-op encode output
        return replace(self, ops=ops.astype(np.uint8, copy=False),
                       lens=lens.astype(np.int64, copy=False),
                       off=off.astype(np.int64, copy=False),
                       has_cigar=self.has_cigar if has_cigar is None else has_cigar)

    # -------------------------------------------------------------- grouping
    def name_ids(self) -> tuple[np.ndarray, np.ndarray, list[str]]:
        """Factorize (qname, tname) into integer ids over a shared name list."""
        names: dict[str, int] = {}
        qid = np.empty(len(self), dtype=np.int64)
        tid = np.empty(len(self), dtype=np.int64)
        for i in range(len(self)):
            qid[i] = names.setdefault(self.qname[i], len(names))
            tid[i] = names.setdefault(self.tname[i], len(names))
        return qid, tid, list(names)


def _range_gather(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Indices covering [starts[i], starts[i]+counts[i]) concatenated,
    vectorized: repeat each range's (start - running offset) delta and add
    a flat ramp (O(total); the earlier searchsorted form paid an extra
    log-factor pass over the 13.6M-op shattered workload)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out_off = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=out_off[1:])
    idx = np.arange(total, dtype=np.int64)
    idx += np.repeat(starts - out_off, counts)
    return idx
