"""Device scan kernels of the greedy tile sweep (split from ops/tile so
host-routed tiling never imports JAX; see paffy_tpu/jaxconf.py).

Semantics: impl/paf_tile.c:36-93,164-175 — see ops/tile's module docstring.
"""

from __future__ import annotations

from functools import partial

from paffy_tpu.jaxconf import ensure_jax

ensure_jax()

import jax            # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paffy_tpu.ops.coverage import SATURATION, EMPTY_TILE_LEVEL  # noqa: E402
from paffy_tpu.ops.tile import _level_bits  # noqa: E402


@partial(jax.jit, static_argnames=("span", "lmax", "total"))
def _tile_scan(starts, iv_start, iv_end, span, lmax, total):
    """Run the greedy tile sweep over one coverage segment.

    starts:   int64 [N]       segment-local base offset of each record's window
    iv_start: int64 [N, K]    run starts relative to the window (K padded;
                              padding marked by iv_start == iv_end)
    iv_end:   int64 [N, K]
    Returns tile levels int64 [N].
    """
    counts0 = jnp.zeros(total + span, dtype=jnp.uint16)

    def step(counts, x):
        start, ivs, ive = x
        window = jax.lax.dynamic_slice(counts, (start,), (span,))
        # aligned-base mask of this record via interval diff + cumsum
        diff = jnp.zeros(span + 1, dtype=jnp.int32)
        ones = jnp.ones(ivs.shape[0], dtype=jnp.int32)
        diff = diff.at[ivs].add(ones, mode="drop")
        diff = diff.at[ive].add(-ones, mode="drop")
        mask = jnp.cumsum(diff, dtype=jnp.int32)[:span]
        new_window = jnp.minimum(
            window + mask.astype(jnp.uint16),
            jnp.uint16(SATURATION))
        matches = jnp.sum(mask, dtype=jnp.int32)
        # median: smallest level L with |{masked bases with count <= L}| >=
        # matches/2.0 (impl/paf_tile.c:81-89, float compare as in C).
        # Binary search over the level range: a few dense passes instead of
        # a scatter histogram over the window.
        half = matches.astype(jnp.float64) / 2.0
        mask_b = mask > 0

        def probe(L):
            return jnp.sum((mask_b & (new_window <= L)).astype(jnp.int32),
                           dtype=jnp.int32)

        def bisect(carry, bit):
            lo = carry
            mid = lo + jnp.left_shift(jnp.uint16(1), bit)
            # f(mid-1) < half  ->  median > mid-1  ->  keep the bit
            lo = jnp.where(probe(mid - 1).astype(jnp.float64) < half, mid, lo)
            return lo, None

        bits = jnp.arange(_level_bits(lmax) - 1, -1, -1, dtype=jnp.uint16)
        median, _ = jax.lax.scan(bisect, jnp.uint16(0), bits)
        level = jnp.where(matches == 0, jnp.int64(EMPTY_TILE_LEVEL),
                          median.astype(jnp.int64))
        counts = jax.lax.dynamic_update_slice(counts, new_window, (start,))
        return counts, level

    _, levels = jax.lax.scan(step, counts0, (starts, iv_start, iv_end))
    return levels



@partial(jax.jit, static_argnames=("span", "lmax", "total"))
def _tile_scan_groups(starts, iv_start, iv_end, span, lmax, total):
    """The tile sweep vmapped over a leading segment axis — segments are
    independent coverage spaces (distinct query sequences commute), so the
    segment axis is the natural ``data`` sharding axis of the multichip
    pipeline."""
    def one(s, a, b):
        return _tile_scan.__wrapped__(s, a, b, span, lmax, total)
    return jax.vmap(one)(starts, iv_start, iv_end)


