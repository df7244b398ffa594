"""Tiled (row-aligned) column-compare kernels — the device path for large
batches.

The per-column formulation (mismatch_device._column_compare) gathers two
bytes per column with 1-D element gathers.  These kernels instead read
whole pool rows, and keep the elementwise passes over the gathered bytes
few:

  * both sides read the EXTENDED pool (mismatch.build_ext_pool): both halves
    pre-uppercased, the mirror half reverse-complemented.  The kernel is a
    pure byte equality: no case-fold, no complement, no flip — a
    reverse-strand run's descending query walk from pool position s is an
    ascending read at ext[2L-1-s], so reverse runs use the forward path.
  * chunks are ALIGNED to the W-byte row grid of the pool on the TARGET
    side: each chunk is one pool row, fetched with a single direct row
    gather and no shifting.  Partial first and last rows of a run are
    handled with lane bounds, not shifts.
  * the QUERY side walks at a per-run phase offset, so it fetches a
    (W//4)-quantized overlapped window per chunk from one of 4 phase-shifted
    row views (build_ext_phase_views) and aligns the residual (< W//4) with
    a 7-step variable shift (static rolls).
  * per-record reductions are cumsums over the chunk grid + gathers at
    record chunk boundaries (no scatter).
  * int32 positions and counts (the pool-size limits below).
  * chunk-grid padding is linear (16k steps) above 16k chunks — power-of-two
    bucketing would waste up to 2x kernel work on real batch sizes.

The grid layout (chunks in record->op->column order, valid lanes contiguous
in [lane_a, lane_b) per chunk) also serves the =/X run extraction:
boundaries are computed per lane with a cross-chunk carry (two extra element
gathers per chunk) and compacted by binary search, so host transfers stay
O(runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
from paffy_tpu.jaxconf import ensure_jax

ensure_jax()

import jax
import jax.numpy as jnp

from paffy_tpu.ops.segments import MColumnBatch, bucket_size, pad_to, POOL_W

W = POOL_W
LOGW = POOL_W.bit_length() - 1

_LINEAR_STEP = 1 << 14   # chunk-grid padding granularity above 16k chunks

# query phase views: 4 copies of the ext pool's row grid shifted by
# PHASE_STEP bytes, each row PHASE_W wide (so any byte phase needs only a
# < PHASE_STEP residual shift)
N_PHASE = 4
PHASE_STEP = W // N_PHASE            # 128
PHASE_W = W + PHASE_STEP             # 640 (multiple of 128 lanes)
LOG_STEP = PHASE_STEP.bit_length() - 1


def grid_pad(n: int) -> int:
    """Padding size for the chunk grid: power-of-two buckets while small
    (bounds compile count), 16k-linear above (bounds padding waste)."""
    if n <= _LINEAR_STEP:
        return bucket_size(max(n, 1), minimum=64)
    return -(-n // _LINEAR_STEP) * _LINEAR_STEP


# --- int32 addressing limits -------------------------------------------------
# Every kernel indexes its pool with int32 positions (half the index bytes
# of int64).  Callers must check these BEFORE choosing a kernel;
# the builders raise (a real exception — asserts vanish under `python -O`)
# so oversized pools can never silently wrap to wrong counts.

def ext_addressable(pool_len: int) -> bool:
    """Unpacked ext kernel: positions range over the 2*pool_len ext array."""
    return 2 * pool_len + 2 * W < 2**31


def packed4_addressable(pool_len: int) -> bool:
    """4-bit packed kernel: positions range over pool_len packed bytes."""
    return pool_len + 2 * W < 2**31


def packed2_addressable(pool_len: int) -> bool:
    """2-bit packed kernel: positions range over pool_len//2 packed bytes."""
    return pool_len // 2 + 2 * W2 < 2**31


def _require(ok: bool, kernel: str, pool_len: int) -> None:
    if not ok:
        raise ValueError(
            f"sequence pool too large for int32 addressing in the {kernel} "
            f"kernel (pool_len={pool_len}); route this pool to the native "
            f"host path (64-bit positions)")


@dataclass
class AlignedChunkBatch:
    """Pool-row-aligned chunk decomposition of a batch's M runs (host side).

    One chunk per pool row touched by a run's target range.  Arrays are
    padded to ``u_pad`` rows; padding chunks have lane_a == lane_b == 0.
    All positions are EXTENDED-pool coordinates (reverse-strand query
    positions pre-mirrored into the reverse-complement half).

      trow        — target pool row index (chunk target bytes = that row)
      qwin_lo     — start of the ascending W-byte query window (ext coords)
      lane_a/b    — valid lane range [lane_a, lane_b) within the row
      first_of_op — chunk is the first of its run
      tprev/qprev — ext positions of the previous column's bytes (run-
                    boundary carry for =/X extraction; 0 on first chunks)
      rec_chunk_off — record -> first chunk row [n_records+1]
    """

    trow: np.ndarray
    qwin_lo: np.ndarray
    lane_a: np.ndarray
    lane_b: np.ndarray
    first_of_op: np.ndarray
    tprev: np.ndarray
    qprev: np.ndarray
    rec_chunk_off: np.ndarray
    n_chunks: int
    n_cols: int
    u_pad: int


def build_chunk_batch(b: MColumnBatch, n_records: int,
                      pool_len: int) -> AlignedChunkBatch:
    """Decompose the M runs of a column batch into pool-row-aligned chunks.

    pool_len — length L of the unextended pool; reverse-strand query
    positions are mirrored to 2L-1-s (the ext pool's RC half).
    """
    lens = b.lens[: b.n_mops].astype(np.int64)
    tpos0 = b.tpos0[: b.n_mops].astype(np.int64)
    qpos0 = b.qpos0[: b.n_mops].astype(np.int64)
    rev_op = b.rev[: b.n_mops]
    # mirror reverse-strand query walks into the ext pool's RC half: the
    # descending complemented walk from qpos0 becomes ascending and plain
    qpos0e = np.where(rev_op, 2 * pool_len - 1 - qpos0, qpos0)

    row_lo = tpos0 >> LOGW
    row_hi = (tpos0 + lens - 1) >> LOGW
    n_chunks_per_op = row_hi - row_lo + 1
    u = int(n_chunks_per_op.sum())
    u_pad = grid_pad(u)

    chunk_off = np.zeros(b.n_mops + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_op, out=chunk_off[1:])
    mop = np.searchsorted(chunk_off[1:], np.arange(u), side="right")
    c_in_op = np.arange(u) - chunk_off[mop]

    trow = row_lo[mop] + c_in_op
    first = c_in_op == 0
    last = c_in_op == (n_chunks_per_op[mop] - 1)
    lane_a = np.where(first, tpos0[mop] & (W - 1), 0).astype(np.int32)
    lane_b = np.where(last, ((tpos0[mop] + lens[mop] - 1) & (W - 1)) + 1,
                      W).astype(np.int32)

    # query window: valid lane l corresponds to run column
    # col = trow*W + l - tpos0; the query byte sits at qpos0e + col.
    qwin_lo = qpos0e[mop] - tpos0[mop] + trow * W

    # previous-column carry bytes (used only when not first_of_op)
    col_a = trow * W + lane_a - tpos0[mop]
    tprev = np.where(first, 0, tpos0[mop] + col_a - 1)
    qprev = np.where(first, 0, qpos0e[mop] + (col_a - 1))

    rec_of_mop = b.rec[: b.n_mops]
    first_mop = np.searchsorted(rec_of_mop, np.arange(n_records + 1),
                                side="left")
    rec_chunk_off = chunk_off[np.minimum(first_mop, b.n_mops)]
    rec_chunk_off[-1] = u

    n_cols = int(lens.sum())
    if u != 0:
        _require(ext_addressable(pool_len), "unpacked ext", pool_len)
    pos_t = np.int32
    return AlignedChunkBatch(
        trow=pad_to(trow.astype(pos_t), u_pad),
        qwin_lo=pad_to(np.maximum(qwin_lo, 0).astype(pos_t), u_pad),
        lane_a=pad_to(lane_a, u_pad),
        lane_b=pad_to(lane_b.astype(np.int32), u_pad),
        first_of_op=pad_to(first, u_pad, fill=False),
        tprev=pad_to(tprev.astype(pos_t), u_pad),
        qprev=pad_to(qprev.astype(pos_t), u_pad),
        rec_chunk_off=rec_chunk_off.astype(np.int32),
        n_chunks=u, n_cols=n_cols, u_pad=u_pad)


@jax.jit
def build_ext_phase_views(ext):
    """ext pool -> stacked phase row views [N_PHASE * R_v, PHASE_W].

    View c, row r covers ext[W*r + PHASE_STEP*c : ... + PHASE_W], so a query
    window at any byte offset q is inside view row (c, r) with
    c = (q % W) // PHASE_STEP, r = q // W, at residual offset q % PHASE_STEP
    — dense slicing to build (no gathers), one row gather + a < PHASE_STEP
    shift to use.
    """
    n = ext.shape[0]
    r_v = (n - PHASE_W) // W      # last rows dropped: covered by pool guards
    views = []
    for c in range(N_PHASE):
        base = PHASE_STEP * c
        a = jax.lax.dynamic_slice(ext, (base,), (r_v * W,)).reshape(-1, W)
        b = jax.lax.dynamic_slice(ext, (base + W,),
                                  (r_v * W,)).reshape(-1, W)[:, :PHASE_STEP]
        views.append(jnp.concatenate([a, b], axis=1))
    return jnp.concatenate(views, axis=0)


def _var_shift(win, off):
    """Per-row left-rotate of [U, PHASE_W] windows by off in [0, PHASE_STEP)."""
    for bpow in range(LOG_STEP):
        s = 1 << bpow
        win = jnp.where((off & s).astype(bool)[:, None],
                        jnp.roll(win, -s, axis=1), win)
    return win


def _chunk_is_match(ext2d, views, trow, qwin_lo):
    """[U, W] match grid: aligned target rows vs shifted query windows.

    Pure byte equality — both operands come pre-folded from the ext pool.
    """
    tb = ext2d[trow]                                # aligned: no shift
    r_v = views.shape[0] // N_PHASE
    phase = qwin_lo & (W - 1)
    c = phase >> LOG_STEP
    res = qwin_lo & (PHASE_STEP - 1)
    r = jnp.clip(qwin_lo >> LOGW, 0, r_v - 1)
    q_win = _var_shift(views[c * r_v + r], res)[:, :W]
    return tb == q_win


def _lane_mask(lane_a, lane_b):
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    return (lane >= lane_a[:, None]) & (lane < lane_b[:, None])


@jax.jit
def _tiled_match_counts(ext2d, views, trow, qwin_lo, lane_a, lane_b,
                        rec_chunk_off):
    """Per-record (match, mismatch) counts over the aligned chunk grid."""
    is_match = _chunk_is_match(ext2d, views, trow, qwin_lo)
    vmask = _lane_mask(lane_a, lane_b)
    # dtype pinned: under x64, jnp.sum(int32) promotes to int64
    m_chunk = jnp.sum((is_match & vmask).astype(jnp.int32), axis=1,
                      dtype=jnp.int32)
    v_chunk = (lane_b - lane_a).astype(jnp.int32)
    zero = jnp.zeros(1, dtype=jnp.int32)
    cm = jnp.concatenate([zero, jnp.cumsum(m_chunk)])
    cv = jnp.concatenate([zero, jnp.cumsum(v_chunk)])
    bounds = jnp.clip(rec_chunk_off, 0, m_chunk.shape[0])
    m = cm[bounds[1:]] - cm[bounds[:-1]]
    tot = cv[bounds[1:]] - cv[bounds[:-1]]
    return m, tot - m


@jax.jit
def _tiled_boundaries(ext2d, views, ext, trow, qwin_lo, lane_a,
                      lane_b, first_of_op, tprev, qprev):
    """Run-boundary grid for =/X re-encoding.

    Returns (boundary [U, W] bool, is_match [U, W] bool).  A boundary lane is
    the first column of an output run: the first valid lane of an op's first
    chunk, any later valid lane whose match state differs from the previous
    lane, and the first valid lane of continuation chunks whose state
    differs from the previous chunk's last column (recomputed with two
    element gathers per chunk via tprev/qprev).
    """
    is_match = _chunk_is_match(ext2d, views, trow, qwin_lo)
    vmask = _lane_mask(lane_a, lane_b)
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    flip = jnp.concatenate(
        [jnp.zeros((is_match.shape[0], 1), dtype=bool),
         is_match[:, 1:] != is_match[:, :-1]], axis=1)
    limit = ext.shape[0] - 1
    prev_match = (ext[jnp.clip(tprev, 0, limit)]
                  == ext[jnp.clip(qprev, 0, limit)])
    im_at_a = jnp.take_along_axis(is_match, lane_a[:, None].astype(jnp.int32),
                                  axis=1)[:, 0]
    firstlane_bound = jnp.where(first_of_op, True, im_at_a != prev_match)
    boundary = jnp.where(lane == lane_a[:, None], firstlane_bound[:, None],
                         flip) & vmask
    return boundary, is_match


@jax.jit
def _count_runs_tiled(boundary):
    return jnp.sum(boundary.astype(jnp.int32))


@partial(jax.jit, static_argnames=("r_pad",))
def _extract_runs_tiled(boundary, is_match, lane_a, lane_b, r_pad):
    """Compact run starts from the boundary grid (gather-side compaction).

    Returns (start_cols [r_pad], vals [r_pad]): run-start COLUMN indices
    (invalid lanes excluded from the numbering) and match states.
    """
    u, w = boundary.shape
    flat_b = boundary.reshape(-1)
    flat_m = is_match.reshape(-1)
    flat_v = _lane_mask(lane_a, lane_b).reshape(-1)
    cs = jnp.cumsum(flat_b.astype(jnp.int32))
    col_of = jnp.cumsum(flat_v.astype(jnp.int32)) - 1  # grid pos -> column
    ranks = jnp.arange(1, r_pad + 1, dtype=jnp.int32)
    g = jnp.clip(jnp.searchsorted(cs, ranks, side="left"), 0, u * w - 1)
    return col_of[g], flat_m[g]


# --------------------------------------------------------------- public API

def _ext2d(ext):
    return ext.reshape(-1, W)


def tiled_match_counts(ext, b: MColumnBatch, n_records: int):
    """Per-record column match/mismatch counts via the tiled kernel.

    ``ext`` must be the extended pool (mismatch.build_ext_pool / pool.ext).
    """
    cb = build_chunk_batch(b, n_records, pool_len=ext.shape[0] // 2)
    m, x = _tiled_match_counts(
        _ext2d(ext), build_ext_phase_views(ext), jnp.asarray(cb.trow),
        jnp.asarray(cb.qwin_lo), jnp.asarray(cb.lane_a),
        jnp.asarray(cb.lane_b), jnp.asarray(cb.rec_chunk_off))
    return np.asarray(m).astype(np.int64), np.asarray(x).astype(np.int64)


def tiled_runs(ext, b: MColumnBatch, n_records: int):
    """Compact =/X run decomposition via the tiled kernel.

    Returns (start_cols [n_runs], match_at_start [n_runs]).
    ``ext`` must be the extended pool (mismatch.build_ext_pool / pool.ext).
    """
    cb = build_chunk_batch(b, n_records, pool_len=ext.shape[0] // 2)
    boundary, is_match = _tiled_boundaries(
        _ext2d(ext), build_ext_phase_views(ext), ext, jnp.asarray(cb.trow),
        jnp.asarray(cb.qwin_lo), jnp.asarray(cb.lane_a),
        jnp.asarray(cb.lane_b), jnp.asarray(cb.first_of_op),
        jnp.asarray(cb.tprev), jnp.asarray(cb.qprev))
    n_runs = int(_count_runs_tiled(boundary))
    r_pad = bucket_size(max(n_runs, 1))
    starts, vals = _extract_runs_tiled(boundary, is_match,
                                       jnp.asarray(cb.lane_a),
                                       jnp.asarray(cb.lane_b), r_pad=r_pad)
    return np.asarray(starts[:n_runs]), np.asarray(vals[:n_runs])


# ---------------------------------------------------------------- 4-bit path
#
# Counts-only fast path: both pools re-encoded at 4 bits/base (2 columns per
# byte), halving gathered bytes AND shift-chain bytes.  Exact for sequences
# whose bases are in the 15-char IUPAC set below (case folding already
# applied by the ext pool); pools containing any other byte fall back to the
# unpacked kernel (SequencePool.has_exotic).
#
# Layout: for parity p in {0,1}, packed pool P_p[i] = code(ext[2i+p]) |
# code(ext[2i+p+1]) << 4.  A run whose target starts at unpacked position
# t sits at nibble 0 of packed byte (t - t%2)/2 of parity t%2 — so chunks
# stay row-aligned on the target side, and the query window picks ITS OWN
# parity so that even local columns are low nibbles on both sides (the
# parity choice absorbs the odd/even misalignment; the byte-level residual
# uses the same phase views + roll chain as the unpacked kernel, on half
# the bytes).

_IUPAC15 = b"ACGTNMKRYVBHDWS"          # code = index; anything else -> 15
PACK_COLS = 2 * W                       # columns per packed chunk row


@jax.jit
def _code4(ext):
    codes = jnp.full(ext.shape, 15, jnp.uint8)
    for i, ch in enumerate(_IUPAC15):
        codes = jnp.where(ext == ch, jnp.uint8(i), codes)
    return codes


@jax.jit
def build_packed_pools(ext):
    """ext [2L] -> (packed2d [2*Rp, W], pviews [2*N_PHASE*Rv, PHASE_W]).

    packed2d stacks the parity-0 and parity-1 packed pools' row grids
    (target gather: row = parity*Rp + packed_row); pviews stacks each
    parity's phase views (query gather: row = parity*N_PHASE*Rv + c*Rv + r).
    """
    n = ext.shape[0]
    codes = jnp.concatenate([_code4(ext), jnp.full(2, 15, jnp.uint8)])
    packed = []
    for par in (0, 1):
        lo = jax.lax.dynamic_slice(codes, (par,), (n,))[0::2]
        hi = jax.lax.dynamic_slice(codes, (par + 1,), (n,))[0::2]
        packed.append(lo | (hi * jnp.uint8(16)))
    packed2d = jnp.concatenate([p.reshape(-1, W) for p in packed])
    pviews = jnp.concatenate([build_ext_phase_views(p) for p in packed])
    return packed2d, pviews


@dataclass
class PackedChunkBatch:
    """Packed-row-aligned chunk decomposition (4-bit counts path).

    trow     — row into the stacked packed2d (parity pre-folded)
    qwin     — packed-byte offset of the query window in its parity pool
    qpar     — query parity (selects the pviews half)
    col_a/b  — valid COLUMN range [col_a, col_b) within the 2W-column chunk
    rec_chunk_off — record -> first chunk row [n_records+1]
    """

    trow: np.ndarray
    qwin: np.ndarray
    qpar: np.ndarray
    col_a: np.ndarray
    col_b: np.ndarray
    rec_chunk_off: np.ndarray
    n_chunks: int
    n_cols: int
    u_pad: int


def build_packed_chunk_batch(b: MColumnBatch, n_records: int,
                             pool_len: int) -> PackedChunkBatch:
    lens = b.lens[: b.n_mops].astype(np.int64)
    tpos0 = b.tpos0[: b.n_mops].astype(np.int64)
    qpos0 = b.qpos0[: b.n_mops].astype(np.int64)
    rev_op = b.rev[: b.n_mops]
    qpos0e = np.where(rev_op, 2 * pool_len - 1 - qpos0, qpos0)

    tpar = (tpos0 & 1).astype(np.int64)
    base_t = (tpos0 - tpar) >> 1            # packed byte of column 0
    last_b = base_t + ((lens - 1) >> 1)     # packed byte of last column
    row_lo = base_t >> LOGW
    row_hi = last_b >> LOGW
    n_chunks_per_op = row_hi - row_lo + 1
    u = int(n_chunks_per_op.sum())
    u_pad = grid_pad(u)

    chunk_off = np.zeros(b.n_mops + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_op, out=chunk_off[1:])
    mop = np.searchsorted(chunk_off[1:], np.arange(u), side="right")
    c_in_op = np.arange(u) - chunk_off[mop]
    prow = row_lo[mop] + c_in_op            # packed row within parity pool

    # local column of packed-lane 0 relative to the run: c_base (<=0 on the
    # first chunk); valid local columns are [col_a, col_b)
    c_base = 2 * (prow * W - base_t[mop])
    col_a = np.maximum(-c_base, 0).astype(np.int32)
    col_b = np.clip(lens[mop] - c_base, 0, PACK_COLS).astype(np.int32)

    rp = pool_len // W                      # rows per parity pool
    trow = tpar[mop] * rp + prow

    # query window: unpacked query position of local column 0
    qj = qpos0e[mop] + c_base
    qpar = (qj & 1).astype(np.int32)
    qwin = (qj - qpar) >> 1                 # packed byte offset, own parity

    rec_of_mop = b.rec[: b.n_mops]
    first_mop = np.searchsorted(rec_of_mop, np.arange(n_records + 1),
                                side="left")
    rec_chunk_off = chunk_off[np.minimum(first_mop, b.n_mops)]
    rec_chunk_off[-1] = u

    _require(packed4_addressable(pool_len), "4-bit packed", pool_len)
    return PackedChunkBatch(
        trow=pad_to(trow.astype(np.int32), u_pad),
        qwin=pad_to(np.maximum(qwin, 0).astype(np.int32), u_pad),
        qpar=pad_to(qpar, u_pad),
        col_a=pad_to(col_a, u_pad),
        col_b=pad_to(col_b, u_pad),
        rec_chunk_off=rec_chunk_off.astype(np.int32),
        n_chunks=u, n_cols=int(lens.sum()), u_pad=u_pad)


@jax.jit
def _packed_match_counts(packed2d, pviews, trow, qwin, qpar, col_a, col_b,
                         rec_chunk_off):
    """Per-record (match, mismatch) counts over the packed chunk grid."""
    tb = packed2d[trow]                                   # (U, W) u8
    r_v = pviews.shape[0] // (2 * N_PHASE)
    c = (qwin & (W - 1)) >> LOG_STEP
    res = qwin & (PHASE_STEP - 1)
    r = jnp.clip(qwin >> LOGW, 0, r_v - 1)
    qw = pviews[qpar * (N_PHASE * r_v) + c * r_v + r]     # (U, PHASE_W)
    qb = _var_shift(qw, res)[:, :W]
    x = tb ^ qb
    lo_eq = (x & jnp.uint8(0x0F)) == 0
    hi_eq = (x & jnp.uint8(0xF0)) == 0
    lane2 = 2 * jnp.arange(W, dtype=jnp.int32)[None, :]
    a, bb = col_a[:, None], col_b[:, None]
    mlo = lo_eq & (lane2 >= a) & (lane2 < bb)
    mhi = hi_eq & (lane2 + 1 >= a) & (lane2 + 1 < bb)
    m_chunk = jnp.sum(mlo.astype(jnp.int32) + mhi.astype(jnp.int32), axis=1,
                      dtype=jnp.int32)
    v_chunk = jnp.maximum(col_b - col_a, 0)
    zero = jnp.zeros(1, dtype=jnp.int32)
    cm = jnp.concatenate([zero, jnp.cumsum(m_chunk)])
    cv = jnp.concatenate([zero, jnp.cumsum(v_chunk)])
    bounds = jnp.clip(rec_chunk_off, 0, m_chunk.shape[0])
    m = cm[bounds[1:]] - cm[bounds[:-1]]
    tot = cv[bounds[1:]] - cv[bounds[:-1]]
    return m, tot - m


def packed_match_counts(packed2d, pviews, b: MColumnBatch, n_records: int,
                        pool_len: int):
    """Per-record counts via the 4-bit packed kernel.

    Caller must ensure the pool has no bytes outside _IUPAC15 (after case
    folding) — use SequencePool.has_exotic / the unpacked kernel otherwise.
    """
    cb = build_packed_chunk_batch(b, n_records, pool_len)
    m, x = _packed_match_counts(
        packed2d, pviews, jnp.asarray(cb.trow), jnp.asarray(cb.qwin),
        jnp.asarray(cb.qpar), jnp.asarray(cb.col_a), jnp.asarray(cb.col_b),
        jnp.asarray(cb.rec_chunk_off))
    return np.asarray(m).astype(np.int64), np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------- 2-bit path
#
# Counts-only path for pure-ACGT pools (after case folding; gate on
# SequencePool.has_exotic2): 4 bases/byte, 4 parity pools (one per start
# offset mod 4), narrower W2=256 rows.  vs the 4-bit kernel this halves the
# gathered bytes per column AND the roll-chain traffic per column at the
# same chunk count.
#
# Layout: parity pool p packs ext positions p, p+1, ... as consecutive
# 2-bit crumbs, little-endian within the byte: byte i = code(ext[4i+p]) |
# code(ext[4i+p+1])<<2 | ... | code(ext[4i+p+3])<<6.  A run starting at ext
# position t has parity t&3 and its column k lives at byte base_t + (k>>2),
# crumb k&3, so chunks stay row-aligned on the target side and the query
# window picks ITS OWN parity to absorb the crumb misalignment (the byte
# residual uses 4 phase views + a 6-step roll chain over [U, 320]).

W2 = 256                    # 2-bit row width (bytes) = 1024 columns
LOGW2 = W2.bit_length() - 1
N_PHASE2 = 4
STEP2 = W2 // N_PHASE2      # 64
PW2 = W2 + STEP2            # 320
LOG_STEP2 = STEP2.bit_length() - 1
PACK2_COLS = 4 * W2


@jax.jit
def _code2(x):
    c = jnp.zeros(x.shape, jnp.uint8)
    for i, ch in enumerate(b"ACGT"):
        c = jnp.where(x == ch, jnp.uint8(i), c)
    return c


@jax.jit
def build_packed2_pools(ext):
    """ext [2L] -> (packed2d [4*Rp, W2], pviews [4*N_PHASE2*Rv, PW2]).

    packed2d stacks the 4 parity pools' row grids (target gather: row =
    parity*Rp + packed_row); pviews stacks each parity's phase views (query
    gather: row = (parity*N_PHASE2 + c)*Rv + r).
    """
    n = ext.shape[0]
    codes = jnp.concatenate([_code2(ext), jnp.zeros(4, jnp.uint8)])
    n_p = n // 4
    r_v = (n_p - PW2) // W2
    pools, views = [], []
    for p in range(4):
        acc = jnp.zeros(n_p, jnp.uint8)
        for k in range(4):
            sl = jax.lax.dynamic_slice(codes, (p + k,), (4 * n_p - 3,))[::4]
            acc = acc | (sl << jnp.uint8(2 * k))
        pools.append(acc)
        for c in range(N_PHASE2):
            base = STEP2 * c
            a = jax.lax.dynamic_slice(acc, (base,), (r_v * W2,)).reshape(-1, W2)
            bb = jax.lax.dynamic_slice(acc, (base + W2,),
                                       (r_v * W2,)).reshape(-1, W2)[:, :STEP2]
            views.append(jnp.concatenate([a, bb], axis=1))
    packed2d = jnp.concatenate([p.reshape(-1, W2) for p in pools])
    pviews = jnp.concatenate(views, axis=0)
    return packed2d, pviews


def build_packed2_chunk_batch(b: MColumnBatch, n_records: int,
                              pool_len: int) -> PackedChunkBatch:
    """Chunk decomposition over the 2-bit pools (4*W2 columns per row).

    Uses the native single-pass builder when available; the numpy path below
    is the no-toolchain fallback and the oracle
    (test_tiled_native_grid_matches)."""
    _require(packed2_addressable(pool_len), "2-bit packed", pool_len)
    nb = _build_packed2_grid_native(b, n_records, pool_len)
    if nb is not None:
        return nb
    lens = b.lens[: b.n_mops].astype(np.int64)
    tpos0 = b.tpos0[: b.n_mops].astype(np.int64)
    qpos0 = b.qpos0[: b.n_mops].astype(np.int64)
    rev_op = b.rev[: b.n_mops]
    qpos0e = np.where(rev_op, 2 * pool_len - 1 - qpos0, qpos0)

    tpar = (tpos0 & 3).astype(np.int64)
    base_t = (tpos0 - tpar) >> 2            # packed byte of column 0
    last_b = base_t + ((lens - 1) >> 2)     # packed byte of the last column
    row_lo = base_t >> LOGW2
    row_hi = last_b >> LOGW2
    n_chunks_per_op = row_hi - row_lo + 1
    u = int(n_chunks_per_op.sum())
    u_pad = grid_pad(u)

    chunk_off = np.zeros(b.n_mops + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_op, out=chunk_off[1:])
    mop = np.searchsorted(chunk_off[1:], np.arange(u), side="right")
    c_in_op = np.arange(u) - chunk_off[mop]
    prow = row_lo[mop] + c_in_op            # packed row within parity pool

    c_base = 4 * (prow * W2 - base_t[mop])  # local column of byte-lane 0
    # int16/int8 lane metadata (col values <= 4*W2, parity 0..3): halves the
    # host->device grid upload; the kernel widens to int32 on entry
    col_a = np.maximum(-c_base, 0).astype(np.int16)
    col_b = np.clip(lens[mop] - c_base, 0, PACK2_COLS).astype(np.int16)

    rp = (2 * pool_len) // 4 // W2          # rows per parity pool
    trow = tpar[mop] * rp + prow

    qj = qpos0e[mop] + c_base               # unpacked pos of local column 0
    qpar = (qj & 3).astype(np.int8)
    qwin = (qj - qpar) >> 2                 # packed byte offset, own parity

    rec_of_mop = b.rec[: b.n_mops]
    first_mop = np.searchsorted(rec_of_mop, np.arange(n_records + 1),
                                side="left")
    rec_chunk_off = chunk_off[np.minimum(first_mop, b.n_mops)]
    rec_chunk_off[-1] = u

    return PackedChunkBatch(
        trow=pad_to(trow.astype(np.int32), u_pad),
        qwin=pad_to(np.maximum(qwin, 0).astype(np.int32), u_pad),
        qpar=pad_to(qpar, u_pad),
        col_a=pad_to(col_a, u_pad),
        col_b=pad_to(col_b, u_pad),
        rec_chunk_off=rec_chunk_off.astype(np.int32),
        n_chunks=u, n_cols=int(lens.sum()), u_pad=u_pad)


def _build_packed2_grid_native(b: MColumnBatch, n_records: int,
                               pool_len: int) -> PackedChunkBatch | None:
    from paffy_tpu import native
    if native.get_lib() is None:
        return None
    lens = b.lens[: b.n_mops]
    qpos0 = b.qpos0[: b.n_mops]
    tpos0 = b.tpos0[: b.n_mops]
    rev = b.rev[: b.n_mops]
    recs = b.rec[: b.n_mops]
    u = native.build_packed2_grid(lens, qpos0, tpos0, rev, recs, n_records,
                                  pool_len, W2, None)
    if u is None:
        return None
    u_pad = grid_pad(u)
    outs = dict(trow=np.zeros(u_pad, dtype=np.int32),
                qwin=np.zeros(u_pad, dtype=np.int32),
                qpar=np.zeros(u_pad, dtype=np.int8),
                col_a=np.zeros(u_pad, dtype=np.int16),
                col_b=np.zeros(u_pad, dtype=np.int16),
                rec_chunk_off=np.zeros(n_records + 1, dtype=np.int32))
    u2 = native.build_packed2_grid(lens, qpos0, tpos0, rev, recs, n_records,
                                   pool_len, W2, outs)
    assert u2 == u
    return PackedChunkBatch(n_chunks=u, n_cols=int(lens.sum()), u_pad=u_pad,
                            **outs)


@jax.jit
def _packed2_match_counts(packed2d, pviews, trow, qwin, qpar, col_a, col_b,
                          rec_chunk_off):
    """Per-record (match, mismatch) counts over the 2-bit chunk grid."""
    # lane metadata ships narrow (int8/int16) and widens on device
    qpar = qpar.astype(jnp.int32)
    col_a = col_a.astype(jnp.int32)
    col_b = col_b.astype(jnp.int32)
    tb = packed2d[trow]                                   # (U, W2) u8
    r_v = pviews.shape[0] // (4 * N_PHASE2)
    c = (qwin & (W2 - 1)) >> LOG_STEP2
    res = qwin & (STEP2 - 1)
    r = jnp.clip(qwin >> LOGW2, 0, r_v - 1)
    win = pviews[(qpar * N_PHASE2 + c) * r_v + r]         # (U, PW2)
    for bpow in range(LOG_STEP2):
        s = 1 << bpow
        win = jnp.where((res & s).astype(bool)[:, None],
                        jnp.roll(win, -s, axis=1), win)
    x = tb ^ win[:, :W2]
    lane4 = 4 * jnp.arange(W2, dtype=jnp.int32)[None, :]
    a, bb = col_a[:, None], col_b[:, None]
    m_ = jnp.zeros(x.shape, jnp.int32)
    for j in range(4):
        eq = (x & jnp.uint8(0x03 << (2 * j))) == 0
        m_ = m_ + (eq & (lane4 + j >= a) & (lane4 + j < bb)).astype(jnp.int32)
    m_chunk = jnp.sum(m_, axis=1, dtype=jnp.int32)
    v_chunk = jnp.maximum(col_b - col_a, 0)
    zero = jnp.zeros(1, dtype=jnp.int32)
    cm = jnp.concatenate([zero, jnp.cumsum(m_chunk)])
    cv = jnp.concatenate([zero, jnp.cumsum(v_chunk)])
    bounds = jnp.clip(rec_chunk_off, 0, m_chunk.shape[0])
    m = cm[bounds[1:]] - cm[bounds[:-1]]
    tot = cv[bounds[1:]] - cv[bounds[:-1]]
    return m, tot - m


def packed2_match_counts(packed2d, pviews, b: MColumnBatch, n_records: int,
                         pool_len: int):
    """Per-record counts via the 2-bit packed kernel.

    Caller must ensure the pool is pure ACGT after case folding — use
    SequencePool.has_exotic2 / the 4-bit or unpacked kernels otherwise.
    """
    cb = build_packed2_chunk_batch(b, n_records, pool_len)
    m, x = _packed2_match_counts(
        packed2d, pviews, jnp.asarray(cb.trow), jnp.asarray(cb.qwin),
        jnp.asarray(cb.qpar), jnp.asarray(cb.col_a), jnp.asarray(cb.col_b),
        jnp.asarray(cb.rec_chunk_off))
    return np.asarray(m).astype(np.int64), np.asarray(x).astype(np.int64)
