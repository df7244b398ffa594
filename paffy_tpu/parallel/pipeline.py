"""Multi-chip sharded execution of the per-column pipeline.

The reference's parallelism is shell-level: split per contig, run pipelines
per shard, cat the results (SURVEY.md section 2.6).  The JAX equivalent is
a device mesh with two axes:

  * ``data`` — record shards (the split_file axis): each group of records
    gets its own chunk-grid expansion; groups are laid out on the leading
    axis.
  * ``seq``  — chunk sharding within a record group (the chunk/overlap axis
    analog, SURVEY.md P4): the chunk-grid tensors are sharded along their
    chunk axis.

The step is written as plain jit + NamedSharding constraints: XLA inserts the
all-reduces for the cross-shard segment sums (per-record counts) and the
global stat reduction — the scaling-book recipe (mesh -> annotate ->
let XLA place collectives).  No model-parallel machinery is invented: a PAF
engine has no tensors to TP/PP/EP-shard (SURVEY.md section 2.6 P7); DP over
records + column sharding is the complete story.

The per-group compare kernel is the same row-aligned tiled formulation as
the single-device path (ops/tiled.py): pool-row-aligned chunks, row
gathers from the extended pool, phase-view query windows — batched over a
leading group axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
from paffy_tpu.jaxconf import ensure_jax

ensure_jax()

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paffy_tpu.core.model import PafTable
from paffy_tpu.ops.mismatch import SequencePool
from paffy_tpu.ops.segments import build_m_column_batch, bucket_size, pad_to
from paffy_tpu.ops.tiled import (N_PHASE, PHASE_STEP, LOG_STEP, LOGW, W,
                                 build_chunk_batch, build_ext_phase_views,
                                 grid_pad)


def make_mesh(devices=None, dp: int | None = None, sp: int | None = None) -> Mesh:
    """Build a (data, seq) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        # favor data parallelism; seq axis takes what divides evenly
        sp = sp or (2 if n % 2 == 0 and n > 1 else 1)
        dp = n // sp
    else:
        sp = sp or n // dp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    return Mesh(np.asarray(devices).reshape(dp, sp), ("data", "seq"))


@dataclass
class ShardedChunkBatch:
    """Per-record-group aligned-chunk tensors stacked on a ``data`` axis.

    All groups share the same padded grid size so the stack is rectangular:
    trow/qwin_lo/lane_a/lane_b are [G, u_pad]; rec_chunk_off is
    [G, rec_pad+1] (record ids LOCAL to the group); padding chunks have
    lane_a == lane_b == 0 so they contribute nothing.
    """

    trow: np.ndarray
    qwin_lo: np.ndarray
    lane_a: np.ndarray
    lane_b: np.ndarray
    rec_chunk_off: np.ndarray
    n_cols: np.ndarray            # [G] valid columns per group
    group_of_record: np.ndarray   # [N] original record -> group
    index_in_group: np.ndarray    # [N] original record -> local slot
    u_pad: int
    rec_pad: int


def shard_records(t: PafTable, pool: SequencePool,
                  n_groups: int) -> ShardedChunkBatch:
    """Split a batch into ``n_groups`` contiguous record groups and build a
    rectangular stacked chunk grid (the host-side sharding step; on several
    hosts each builds only its own groups)."""
    n = len(t)
    pool_len = int(pool.pool.shape[0])
    bounds = np.linspace(0, n, n_groups + 1).astype(np.int64)
    group_of_record = np.zeros(n, dtype=np.int64)
    index_in_group = np.zeros(n, dtype=np.int64)
    batches = []
    for g in range(n_groups):
        lo, hi = int(bounds[g]), int(bounds[g + 1])
        group_of_record[lo:hi] = g
        index_in_group[lo:hi] = np.arange(hi - lo)
        sub = t.take(np.arange(lo, hi))
        qoff = pool.offsets_for(sub.qname, "query")
        toff = pool.offsets_for(sub.tname, "target")
        mcb = build_m_column_batch(sub, qoff, toff)
        batches.append(build_chunk_batch(mcb, hi - lo, pool_len=pool_len))
    u_pad = grid_pad(max(b.n_chunks for b in batches))
    rec_pad = bucket_size(max(int(bounds[g + 1] - bounds[g])
                              for g in range(n_groups)), minimum=8)

    def stack(field):
        return np.stack([pad_to(getattr(b, field)[: b.n_chunks], u_pad)
                         for b in batches])

    rec_chunk_off = np.stack(
        [pad_to(b.rec_chunk_off, rec_pad + 1, fill=b.rec_chunk_off[-1])
         for b in batches])
    return ShardedChunkBatch(
        trow=stack("trow"), qwin_lo=stack("qwin_lo"), lane_a=stack("lane_a"),
        lane_b=stack("lane_b"), rec_chunk_off=rec_chunk_off,
        n_cols=np.array([b.n_cols for b in batches], dtype=np.int64),
        group_of_record=group_of_record, index_in_group=index_in_group,
        u_pad=u_pad, rec_pad=rec_pad)


def _batched_group_tiled_stats(ext2d, views, trow, qwin_lo, lane_a, lane_b,
                               rec_chunk_off, col_spec=None):
    """Aligned-chunk compare + per-record reduction for G groups at once.

    The group tensors carry a leading axis (sharded over ``data``); the chunk
    axis additionally carries the ``seq`` sharding (col_spec), so the
    per-base work splits across both mesh axes and XLA inserts the cross-seq
    reductions for the group cumsums and the global totals.  Per-record
    reduction is a per-group cumsum + gather at record chunk boundaries
    (no scatter over the chunk axis).
    """
    def constrain(x):
        return x if col_spec is None else \
            jax.lax.with_sharding_constraint(x, col_spec)

    g = trow.shape[0]
    r_v = views.shape[0] // N_PHASE
    tb = constrain(ext2d[trow])                       # [G, U, W] aligned rows
    phase = qwin_lo & (W - 1)
    c = phase >> LOG_STEP
    res = qwin_lo & (PHASE_STEP - 1)
    r = jnp.clip(qwin_lo >> LOGW, 0, r_v - 1)
    win = constrain(views[c * r_v + r])               # [G, U, PHASE_W]
    for bpow in range(LOG_STEP):                      # residual alignment
        s = 1 << bpow
        win = jnp.where((res & s).astype(bool)[..., None],
                        jnp.roll(win, -s, axis=-1), win)
    is_match = tb == win[..., :W]

    lane = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    vmask = (lane >= lane_a[..., None]) & (lane < lane_b[..., None])
    m_chunk = jnp.sum((is_match & vmask).astype(jnp.int32), axis=2,
                      dtype=jnp.int32)
    v_chunk = (lane_b - lane_a).astype(jnp.int32)
    zero = jnp.zeros((g, 1), dtype=jnp.int32)
    cm = jnp.concatenate([zero, jnp.cumsum(m_chunk, axis=1)], axis=1)
    cv = jnp.concatenate([zero, jnp.cumsum(v_chunk, axis=1)], axis=1)
    bounds = jnp.clip(rec_chunk_off, 0, m_chunk.shape[1]).astype(jnp.int32)
    m = (jnp.take_along_axis(cm, bounds[:, 1:], axis=1)
         - jnp.take_along_axis(cm, bounds[:, :-1], axis=1)).astype(jnp.int64)
    tot = (jnp.take_along_axis(cv, bounds[:, 1:], axis=1)
           - jnp.take_along_axis(cv, bounds[:, :-1], axis=1)).astype(jnp.int64)
    return m, tot - m


def sharded_view_stats(mesh: Mesh, ext_arr, b: ShardedChunkBatch):
    """Jit the data+seq sharded stats step over ``mesh`` and run it.

    ``ext_arr`` is the extended pool (SequencePool.ext), replicated over the
    mesh.  Returns (per-record matches [G, rec_pad], mismatches, aggregate
    totals).
    """
    data = NamedSharding(mesh, P("data"))
    data_seq = NamedSharding(mesh, P("data", "seq"))
    repl = NamedSharding(mesh, P())
    col3d = NamedSharding(mesh, P("data", "seq", None))

    @partial(jax.jit,
             in_shardings=(repl, data_seq, data_seq, data_seq, data_seq, data),
             out_shardings=(data, data, repl))
    def step(ext, trow, qwin_lo, lane_a, lane_b, rec_chunk_off):
        ext2d = ext.reshape(-1, W)
        views = build_ext_phase_views(ext)
        m, x = _batched_group_tiled_stats(ext2d, views, trow, qwin_lo,
                                          lane_a, lane_b, rec_chunk_off,
                                          col_spec=col3d)
        totals = jnp.stack([jnp.sum(m), jnp.sum(x)])
        return m, x, totals

    return step(ext_arr, jnp.asarray(b.trow), jnp.asarray(b.qwin_lo),
                jnp.asarray(b.lane_a), jnp.asarray(b.lane_b),
                jnp.asarray(b.rec_chunk_off))


def column_counts_multichip(t: PafTable, pool: SequencePool, mesh: Mesh):
    """Data-parallel per-record column match counts over a mesh; results are
    gathered back to original record order (deterministic output)."""
    n_groups = mesh.shape["data"]
    b = shard_records(t, pool, n_groups)
    m, x, totals = sharded_view_stats(mesh, pool.ext, b)
    m = np.asarray(m)[b.group_of_record, b.index_in_group]
    x = np.asarray(x)[b.group_of_record, b.index_in_group]
    return m, x, np.asarray(totals)
