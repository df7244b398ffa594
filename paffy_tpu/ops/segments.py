"""Device-side batch preparation: flat cigar-op tensors and column expansion.

The single primitive that replaces every per-base C walk in the reference
(mismatch encode impl/paf.c:754-768, coverage impl/paf.c:690-709, pretty
print impl/paf.c:288-303): expand cigar runs into per-alignment-column index
tensors with segmented prefix sums, then express the per-base work as gathers
+ elementwise compare + segment reductions — all batched, static-shaped, and
jit-compiled.

Shapes are padded to buckets (powers of two) so XLA compiles one kernel per
bucket size rather than per batch.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from paffy_tpu.core.model import (PafTable, MATCH, QUERY_INSERT, QUERY_DELETE,
                                  SEQ_MATCH, SEQ_MISMATCH)
from paffy_tpu.core.segsum import segment_ids_from_offsets


# Sequence-pool layout constants shared by the compare kernels: W-column
# chunking (tiled kernel row width) and guard bytes at BOTH ends of every
# pool, so the row-aligned chunk windows (which can start before a
# sequence and overhang its end) never index outside the pool.
POOL_W = 512
POOL_GUARD = 4096


def bucket_size(n: int, minimum: int = 256) -> int:
    """Next power-of-two >= n (>= minimum) — bounds recompilation count."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_to(a: np.ndarray, size: int, fill=0) -> np.ndarray:
    out = np.full(size, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


@dataclass
class MColumnBatch:
    """Host-side description of all alignment columns of the M runs of a batch,
    ready to ship to the device.

    Per M-op arrays (padded to ``n_mops_pad``):
      lens, rec      — run length, owning record index
      qpos0, tpos0   — absolute position (into the packed sequence pool) of the
                       run's first column on query/target
      rev            — True iff query walks backward (opposite strand)
      col_off        — exclusive cumsum of lens (length n_mops_pad+1)
    ``rec_col_off`` maps record -> first column index ([n_records+1]): columns
    are laid out in record order, so per-record column reductions are a cumsum
    + boundary gather, with no scatter.
    ``n_cols`` is the true column count; device tensors use ``n_cols_pad``.
    """

    lens: np.ndarray
    rec: np.ndarray
    qpos0: np.ndarray
    tpos0: np.ndarray
    rev: np.ndarray
    col_off: np.ndarray
    rec_col_off: np.ndarray
    flat_idx: np.ndarray  # index of each M op in the batch's flat op arrays
    n_mops: int
    n_cols: int
    n_cols_pad: int


def build_m_column_batch(t: PafTable, qpool_off: np.ndarray, tpool_off: np.ndarray,
                         col_bucket: int | None = None) -> MColumnBatch:
    """Prepare the M-run column expansion for a batch.

    qpool_off/tpool_off: per-record offset of the record's query/target
    sequence inside the packed pool (see fasta.pack_sequences).

    The native single-pass builder is used when available (measured 10x the
    numpy path at golden scale); the numpy path below is the no-toolchain
    fallback and the oracle (test_segments_native_builder_matches).
    """
    nb = _build_m_column_batch_native(t, qpool_off, tpool_off, col_bucket)
    if nb is not None:
        return nb
    ops, lens, off = t.ops, t.lens, t.off
    total = len(ops)
    seg = segment_ids_from_offsets(off, total)
    q_consuming = ops != QUERY_DELETE
    t_consuming = ops != QUERY_INSERT
    qc = np.cumsum(np.where(q_consuming, lens, 0))
    tc = np.cumsum(np.where(t_consuming, lens, 0))
    qbase = np.concatenate([[0], qc])[off[:-1]]
    tbase = np.concatenate([[0], tc])[off[:-1]]
    q_excl = qc - np.where(q_consuming, lens, 0) - qbase[seg]
    t_excl = tc - np.where(t_consuming, lens, 0) - tbase[seg]

    m = np.nonzero(ops == MATCH)[0]
    rec = seg[m]
    mlens = lens[m]
    strand = t.strand[rec]
    # first-column absolute positions (paf_encode_mismatches walk,
    # impl/paf.c:750-757): query walks forward from qstart for '+', backward
    # from qend-1 for '-'; target always forward from tstart.
    qpos0 = np.where(strand,
                     qpool_off[rec] + t.qstart[rec] + q_excl[m],
                     qpool_off[rec] + t.qend[rec] - 1 - q_excl[m])
    tpos0 = tpool_off[rec] + t.tstart[rec] + t_excl[m]

    n_mops = len(m)
    n_cols = int(mlens.sum())
    mop_pad = bucket_size(max(n_mops, 1))
    col_pad = col_bucket or bucket_size(max(n_cols, 1))

    col_off = np.zeros(mop_pad + 1, dtype=np.int64)
    np.cumsum(pad_to(mlens, mop_pad), out=col_off[1:])
    # record -> first column index (records' M ops are contiguous and in
    # record order; empty records inherit the next record's boundary)
    first_mop = np.searchsorted(rec, np.arange(len(t) + 1), side="left")
    rec_col_off = col_off[np.minimum(first_mop, mop_pad)]
    rec_col_off[-1] = n_cols
    return MColumnBatch(
        lens=pad_to(mlens, mop_pad),
        rec=pad_to(rec.astype(np.int64), mop_pad, fill=max(len(t) - 1, 0)),
        qpos0=pad_to(qpos0, mop_pad),
        tpos0=pad_to(tpos0, mop_pad),
        rev=pad_to(~strand, mop_pad, fill=False),
        col_off=col_off,
        rec_col_off=rec_col_off,
        flat_idx=m,
        n_mops=n_mops, n_cols=n_cols, n_cols_pad=col_pad)


def _build_m_column_batch_native(t: PafTable, qpool_off, tpool_off,
                                 col_bucket):
    """Single C pass over the cigar store filling the padded arrays in
    place; byte-identical to the numpy path."""
    from paffy_tpu import native
    if native.get_lib() is None:
        return None
    n_mops = int(np.count_nonzero(t.ops == MATCH))
    mop_pad = bucket_size(max(n_mops, 1))
    n = len(t)
    outs = dict(
        mlens=np.zeros(mop_pad, dtype=np.int64),
        recs=np.full(mop_pad, max(n - 1, 0), dtype=np.int64),
        qpos0=np.zeros(mop_pad, dtype=np.int64),
        tpos0=np.zeros(mop_pad, dtype=np.int64),
        rev=np.zeros(mop_pad, dtype=np.uint8),
        col_off=np.zeros(mop_pad + 1, dtype=np.int64),
        rec_col_off=np.zeros(n + 1, dtype=np.int64),
        flat_idx=np.zeros(max(n_mops, 1), dtype=np.int64),
    )
    n_cols = native.build_mop_batch(
        n, t.ops, t.lens, t.off, t.strand, t.qstart, t.qend, t.tstart,
        qpool_off, tpool_off, n_mops, outs)
    if n_cols is None:
        return None
    outs["col_off"][n_mops + 1:] = n_cols
    return MColumnBatch(
        lens=outs["mlens"], rec=outs["recs"], qpos0=outs["qpos0"],
        tpos0=outs["tpos0"], rev=outs["rev"].view(bool),
        col_off=outs["col_off"], rec_col_off=outs["rec_col_off"],
        flat_idx=outs["flat_idx"][:n_mops],
        n_mops=n_mops, n_cols=n_cols,
        n_cols_pad=col_bucket or bucket_size(max(n_cols, 1)))


_device = None


def _dev():
    """Lazy device-helper module (keeps this batch builder JAX-free for
    host-only commands; see paffy_tpu/jaxconf.py)."""
    global _device
    if _device is None:
        from paffy_tpu.jaxconf import ensure_jax
        ensure_jax()
        import jax
        import jax.numpy as jnp
        from functools import partial

        class _D:
            @staticmethod
            @partial(jax.jit, static_argnames=("c_pad",))
            def columns_to_ops(col_off, c_pad):
                marks = jnp.zeros(c_pad, dtype=jnp.int32)
                starts = col_off[1:-1]
                marks = marks.at[starts].add(
                    jnp.ones(starts.shape[0], jnp.int32), mode="drop")
                return jnp.cumsum(marks)

            @staticmethod
            def segment_sum(values, seg_ids, num_segments):
                return jax.ops.segment_sum(values, seg_ids,
                                           num_segments=num_segments)
        _device = _D
    return _device


def columns_to_ops(col_off, c_pad):
    """Map each column index -> owning M-op index via scatter + cumsum.

    col_off: [n_mops+1] exclusive column offsets. Returns int32 [c_pad].
    (Columns past the true count map past the last real op; callers mask.)
    """
    return _dev().columns_to_ops(col_off, c_pad=c_pad)


def segment_sum(values, seg_ids, num_segments):
    return _dev().segment_sum(values, seg_ids, num_segments)
