"""Device kernels of the mismatch/stats hot path (split from ops/mismatch so
host-routed commands never import JAX — see paffy_tpu/jaxconf.py).

Reference walks these replace: paf_encode_mismatches per-base compare
(impl/paf.c:754-768) and the view-stats aggregation (impl/paf_view.c:167-197).
"""

from __future__ import annotations

from functools import partial

from paffy_tpu.jaxconf import ensure_jax

ensure_jax()

import jax            # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paffy_tpu.ops.segments import columns_to_ops  # noqa: E402


def device_upper(c):
    """toupper as arithmetic: one fused elementwise select instead of a
    256-entry table gather per byte."""
    return jnp.where((c >= 97) & (c <= 122), c - 32, c)


# complement pairs over UPPERCASED bases (IUPAC; W/S/N/X are self-complement)
_COMP_PAIRS = ((65, 84), (67, 71), (77, 75), (82, 89), (86, 66), (72, 68))


def device_comp_upper(cu):
    """Complement of an uppercased base as a select chain (table-free).

    Equivalent to toupper(stString_reverseComplementChar(c)) because the
    complement table is case-symmetric; characters outside the IUPAC set map
    to themselves in both formulations.
    """
    out = cu
    for a, b in _COMP_PAIRS:
        out = jnp.where(cu == a, jnp.uint8(b),
                        jnp.where(cu == b, jnp.uint8(a), out))
    return out


@jax.jit
def build_ext_pool(pool):
    """pool u8 [L] -> extended pool [2L]: upper(pool) ++ comp(upper(flip(pool))).

    One dense XLA pass.  The compare kernels read both sides from this array
    and reduce to a PURE byte equality: case folding is pre-applied to both
    halves, and a reverse-complement query walk from pool position s is an
    ascending plain read at ext[2L-1-s] — eliminating the flip, complement,
    and case-fold elementwise passes from every compare.
    """
    up = device_upper(pool)
    return jnp.concatenate([up, device_comp_upper(jnp.flip(up))])


@partial(jax.jit, static_argnames=("c_pad",))
def _column_compare(pool, lens, qpos0, tpos0, rev, col_off, n_cols, c_pad):
    """Per-column match/boundary flags for all M runs of a batch.

    Returns (is_match[c_pad] bool, col_op[c_pad] int32, valid[c_pad] bool).
    """
    col_op = columns_to_ops(col_off, c_pad=c_pad)
    cols = jnp.arange(c_pad, dtype=col_off.dtype)
    i = cols - col_off[col_op]
    valid = cols < n_cols
    tpos = tpos0[col_op] + i
    qpos = qpos0[col_op] + jnp.where(rev[col_op], -i, i)
    # clamp for padded columns (gathers must stay in-bounds)
    limit = pool.shape[0] - 1
    tb = device_upper(pool[jnp.clip(tpos, 0, limit)])
    qb = device_upper(pool[jnp.clip(qpos, 0, limit)])
    qb = jnp.where(rev[col_op], device_comp_upper(qb), qb)
    is_match = tb == qb
    return is_match, col_op, valid


@partial(jax.jit, static_argnames=("c_pad",))
def _column_match_counts(pool, lens, qpos0, tpos0, rev, col_off, rec_col_off,
                         n_cols, c_pad):
    """Fused: per-record (match, mismatch) column counts over all M runs.

    Columns are laid out in record order, so the per-record reduction is a
    cumsum + gather at the record column boundaries (rec_col_off), with no
    scatter.
    """
    is_match, col_op, valid = _column_compare(
        pool, lens, qpos0, tpos0, rev, col_off, n_cols, c_pad)
    cm = jnp.cumsum((is_match & valid).astype(jnp.int32))
    cv = jnp.cumsum(valid.astype(jnp.int32))
    zero = jnp.zeros(1, dtype=jnp.int32)
    cm0 = jnp.concatenate([zero, cm])
    cv0 = jnp.concatenate([zero, cv])
    bounds = jnp.clip(rec_col_off, 0, c_pad)
    m = (cm0[bounds[1:]] - cm0[bounds[:-1]]).astype(jnp.int64)
    tot = (cv0[bounds[1:]] - cv0[bounds[:-1]]).astype(jnp.int64)
    return m, tot - m


@partial(jax.jit, static_argnames=("c_pad",))
def _column_runs(pool, lens, qpos0, tpos0, rev, col_off, n_cols, c_pad):
    """Fused: run decomposition of the match/mismatch column sequence.

    Returns (boundary[c_pad] bool, is_match[c_pad] bool, valid[c_pad] bool):
    boundary marks the first column of each output =/X run (run starts at
    every M-op start and at every match-state flip).
    """
    is_match, col_op, valid = _column_compare(
        pool, lens, qpos0, tpos0, rev, col_off, n_cols, c_pad)
    cols = jnp.arange(c_pad, dtype=col_off.dtype)
    op_start = cols == col_off[col_op]
    flip = jnp.concatenate([jnp.ones(1, dtype=bool), is_match[1:] != is_match[:-1]])
    boundary = (op_start | flip) & valid
    return boundary, is_match, valid
