"""Greedy tile-level assignment.

Reference: paffy tile (impl/paf_tile.c:36-93,156-178): records sorted
best-first by (chain_score, score); per record, increment per-base coverage
counts of its aligned query bases, then set tile_level to the MEDIAN
post-increment count over those bases (levels start at 1 because the record's
own increment is counted); records with no aligned bases get INT16_MAX.

The sweep is sequential across records (counts mutate between records).
Single-device tiling runs it on the host (_assign_tile_levels_host, a
native C pass): as a device ``lax.scan`` each record is one step of a few
dependent kernels, and on an NVIDIA H100 (400 W limit) the scan took
31.0 s for the 185k-record shattered golden workload against 0.50 s for
the native sweep (chip_smoke.py).

The device scan (ops/tile_device) serves the sharded pipeline, where
coverage SEGMENTS ride the mesh's data axis:

  carry  = one uint16 count array (the reference's SequenceCountArray dtype,
           inc/paf.h:218) over a SEGMENT of query sequences
  step i = dynamic-slice the record's span window, build the record's
           aligned-base mask from its run intervals (scatter +/-1, cumsum),
           add, binary-search the masked-count median, write back.

Records only interact through same-sequence counts, so distinct query
sequences commute and the coverage space is bin-packed into carry SEGMENTS
of at most TILE_SEGMENT_BASES (2 bytes/base on device), all padded to one
shared shape (one compile).  A sequence longer than the segment target gets
its own segment sized to the sequence — the same footprint the reference's
per-sequence calloc pays (impl/paf.c:675-688).  Batches whose [N, K]
run-interval tensor would blow up on one pathological record (K >
TILE_K_CAP runs), or whose predicted scan work exceeds TILE_DEVICE_WORK_CAP,
take the host sweep instead.
"""

from __future__ import annotations

import numpy as np

from paffy_tpu.core.model import PafTable
from paffy_tpu.ops.coverage import match_intervals, SATURATION, EMPTY_TILE_LEVEL
from paffy_tpu.ops.segments import bucket_size

TILE_SEGMENT_BASES = 1 << 26   # carry bin target: 64M bases = 128 MB uint16
TILE_K_CAP = 2048              # device cap on padded runs-per-record
# Device budget of the sharded scan in element-passes (~steps x span_b x
# passes-per-step): one whole-chromosome-span record inflates EVERY step's
# dynamic slice and each median probe scans the full window, so a batch
# whose predicted work exceeds this takes the host sweep instead (same
# semantics).
TILE_DEVICE_WORK_CAP = 1 << 36
# test hook: force the numpy reference sweep in _assign_tile_levels_host
FORCE_HOST_NUMPY = False


def _scan_work(n_records: int, span_b: int, lmax: int) -> int:
    """Predicted element-passes of a segment scan: mask build + add +
    median bisect probes, each a pass over the span window."""
    return n_records * span_b * (4 + _level_bits(lmax))


def _level_bits(lmax: int) -> int:
    b = 0
    while (1 << b) < lmax:
        b += 1
    return max(b, 1)


def __getattr__(name):
    # device scans live in ops/tile_device (lazy; paffy_tpu/jaxconf.py)
    if name in ("_tile_scan", "_tile_scan_groups"):
        from paffy_tpu.ops import tile_device
        return getattr(tile_device, name)
    raise AttributeError(name)


def _sequence_offsets(t: PafTable):
    """First-seen (name -> (offset, length)) over the query names, with the
    offsets assigned within bin-packed coverage segments.

    Returns (seg_of_name, off_in_seg, seg_sizes): dicts keyed by name plus the
    per-segment total sizes.  Sequences are packed first-fit in first-seen
    order; a sequence larger than TILE_SEGMENT_BASES gets its own segment.
    """
    seg_of: dict[str, int] = {}
    off_in: dict[str, int] = {}
    seg_sizes: list[int] = []
    lengths: dict[str, int] = {}
    n = len(t)
    for i in range(n):
        nm = t.qname[i]
        ln = int(t.qlen[i])
        if nm in seg_of:
            if lengths[nm] != ln:
                raise ValueError(f"query {nm!r} has inconsistent lengths")
            continue
        lengths[nm] = ln
        if seg_sizes and seg_sizes[-1] + ln <= TILE_SEGMENT_BASES:
            s = len(seg_sizes) - 1
        else:
            s = len(seg_sizes)
            seg_sizes.append(0)
        seg_of[nm] = s
        off_in[nm] = seg_sizes[s]
        seg_sizes[s] += ln
    return seg_of, off_in, seg_sizes


def _pack_intervals(sub: np.ndarray, n: int, rec, istart, iend, qstart,
                    span_b, k_b):
    """[N_sub, K] relative run-interval tensors for the records ``sub``
    (global indices into the n-record batch, in processing order).  Padding
    entries have start == end == span_b (scatter-dropped in the kernel)."""
    n_sub = len(sub)
    iv_s = np.full((n_sub, k_b), span_b, dtype=np.int64)
    iv_e = np.full((n_sub, k_b), span_b, dtype=np.int64)
    if len(rec) == 0 or n_sub == 0:
        return iv_s, iv_e
    rank = np.full(n, -1, dtype=np.int64)
    rank[sub] = np.arange(n_sub)
    rr = rank[rec]
    keep = rr >= 0
    rr = rr[keep]
    rel_s = (istart - qstart[rec])[keep]
    rel_e = (iend - qstart[rec])[keep]
    # slot index of each run within its record (rec is op-ordered, so runs of
    # one record are contiguous and in order)
    srt = np.argsort(rr, kind="stable")
    rr_s = rr[srt]
    first = np.searchsorted(rr_s, rr_s, side="left")
    slot = np.empty(len(rr), dtype=np.int64)
    slot[srt] = np.arange(len(rr)) - first
    iv_s[rr, slot] = rel_s
    iv_e[rr, slot] = rel_e
    return iv_s, iv_e


def assign_tile_levels(t: PafTable, order: np.ndarray) -> np.ndarray:
    """Compute tile levels for records processed in ``order`` (best-first).

    Returns levels aligned to the original record indexing of ``t``.
    """
    n = len(t)
    if n == 0:
        return np.full(n, EMPTY_TILE_LEVEL, dtype=np.int64)
    rec, istart, iend = match_intervals(t)
    return _assign_tile_levels_host(t, order, rec, istart, iend)


def assign_tile_levels_sharded(t: PafTable, order: np.ndarray,
                               mesh=None) -> np.ndarray:
    """assign_tile_levels as one device scan with all coverage segments
    stacked ([S, N, ...]), optionally sharded over ``mesh``'s ``data`` axis.
    Identical levels to the host sweep (tested)."""
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = len(t)
    levels = np.full(n, EMPTY_TILE_LEVEL, dtype=np.int64)
    if n == 0:
        return levels
    rec, istart, iend = match_intervals(t)
    runs_per_rec = np.zeros(n, dtype=np.int64)
    np.add.at(runs_per_rec, rec, 1)
    k_b = bucket_size(max(int(runs_per_rec.max(initial=0)), 1), minimum=8)
    if k_b > TILE_K_CAP:
        return _assign_tile_levels_host(t, order, rec, istart, iend)

    seg_of, off_in, seg_sizes = _sequence_offsets(t)
    span = int(np.max(t.qend - t.qstart)) if n else 1
    span_b = bucket_size(max(span, 1), minimum=128)
    total_b = max(-(-max(seg_sizes) // (1 << 20)) * (1 << 20), 1 << 16)
    seg_of_rec = np.array([seg_of[t.qname[i]] for i in range(n)],
                          dtype=np.int64)
    lmax = min(bucket_size(n + 2, minimum=64), 32768)
    # the stacked scan shares one (batch-global) span across segments; when
    # a long-span record would blow the work budget, take the host sweep
    # (identical levels either way)
    seg_counts = np.bincount(seg_of_rec, minlength=len(seg_sizes))
    if _scan_work(int(seg_counts.max(initial=0)), span_b,
                  lmax) > TILE_DEVICE_WORK_CAP:
        return _assign_tile_levels_host(t, order, rec, istart, iend)
    qoff = np.array([off_in[t.qname[i]] for i in range(n)], dtype=np.int64)
    starts_all = qoff + t.qstart

    n_seg = len(seg_sizes)
    if mesh is not None:
        dp = mesh.shape["data"]
        n_seg = -(-n_seg // dp) * dp          # pad to the data axis
    subs = [order[seg_of_rec[order] == s] for s in range(len(seg_sizes))]
    n_max = bucket_size(max((len(s) for s in subs), default=1) or 1,
                        minimum=8)
    starts_b = np.zeros((n_seg, n_max), dtype=np.int64)
    iv_s_b = np.full((n_seg, n_max, k_b), span_b, dtype=np.int64)
    iv_e_b = np.full((n_seg, n_max, k_b), span_b, dtype=np.int64)
    for s, sub in enumerate(subs):
        starts_b[s, : len(sub)] = starts_all[sub]
        iv_s, iv_e = _pack_intervals(sub, n, rec, istart, iend, t.qstart,
                                     span_b, k_b)
        iv_s_b[s, : len(sub)] = iv_s
        iv_e_b[s, : len(sub)] = iv_e

    from paffy_tpu.ops.tile_device import _tile_scan_groups
    import jax.numpy as jnp
    args = (starts_b, iv_s_b, iv_e_b)
    if mesh is not None:
        sh = NamedSharding(mesh, P("data"))
        args = tuple(_jax.device_put(a, sh) for a in args)
    else:
        args = tuple(map(jnp.asarray, args))
    lv = np.asarray(_tile_scan_groups(*args, span=span_b, lmax=lmax,
                                      total=total_b))
    for s, sub in enumerate(subs):
        levels[sub] = lv[s, : len(sub)]
    return levels


def _assign_tile_levels_host(t: PafTable, order: np.ndarray,
                             rec, istart, iend) -> np.ndarray:
    """Exact host sweep — the single-device route, and the sharded route's
    fallback for batches over TILE_K_CAP or the device work budget.

    Counts are stored saturated (uint16, as the reference does); the median
    is the (total+1)//2-th smallest masked count, equal to the smallest L
    with |{count <= L}| >= total/2.0 for integer counts.  Production runs
    the native C sweep over a packed coverage arena (measured 6.9 s ->
    ~0.3 s on the 185k-record shattered golden); the per-record numpy loop
    below is the oracle + no-toolchain fallback."""
    n = len(t)
    levels = np.full(n, EMPTY_TILE_LEVEL, dtype=np.int64)
    run_off = np.searchsorted(rec, np.arange(n + 1))

    from paffy_tpu import native
    if native.get_lib() is not None and not FORCE_HOST_NUMPY:
        # pack each distinct query sequence (validated consistent-length)
        # into one uint16 arena — the same per-sequence calloc set the
        # reference makes (impl/paf.c:675-688), laid end to end
        off_of: dict[str, int] = {}
        total = 0
        for i in range(n):
            nm = t.qname[i]
            prev = off_of.get(nm)
            if prev is None:
                off_of[nm] = total
                total += int(t.qlen[i])
            # consistency enforced by _sequence_offsets on device paths;
            # re-check here since this entry is also used standalone
        lengths_chk: dict[str, int] = {}
        for i in range(n):
            nm = t.qname[i]
            if nm in lengths_chk:
                if lengths_chk[nm] != int(t.qlen[i]):
                    raise ValueError(f"query {nm!r} has inconsistent lengths")
            else:
                lengths_chk[nm] = int(t.qlen[i])
        arena = np.zeros(max(total, 1), dtype=np.uint16)
        arena_off = np.array([off_of[t.qname[i]] for i in range(n)],
                             dtype=np.int64)
        if native.tile_sweep(order, arena_off, run_off, istart, iend,
                             arena, SATURATION, levels):
            return levels

    counts: dict[str, np.ndarray] = {}
    lengths: dict[str, int] = {}
    for i in order:
        i = int(i)
        nm = t.qname[i]
        arr = counts.get(nm)
        if arr is None:
            arr = counts[nm] = np.zeros(int(t.qlen[i]), dtype=np.uint16)
            lengths[nm] = int(t.qlen[i])
        elif lengths[nm] != int(t.qlen[i]):
            raise ValueError(f"query {nm!r} has inconsistent lengths")
        lo, hi = run_off[i], run_off[i + 1]
        if lo == hi:
            continue
        qs, qe = int(t.qstart[i]), int(t.qend[i])
        span = qe - qs
        diff = np.zeros(span + 1, dtype=np.int32)
        np.add.at(diff, istart[lo:hi] - qs, 1)
        np.add.at(diff, iend[lo:hi] - qs, -1)
        mask = np.cumsum(diff[:span])
        window = arr[qs:qe]
        new_window = np.minimum(window + mask.astype(np.uint16),
                                np.uint16(SATURATION))
        arr[qs:qe] = new_window
        vals = new_window[mask > 0]
        if len(vals) == 0:
            continue
        k = (len(vals) + 1) // 2
        levels[i] = int(np.partition(vals, k - 1)[k - 1])
    return levels


def tile_sort_order(t: PafTable) -> np.ndarray:
    """Best-first processing order: descending (chain_score, score), ties in
    input order (paf_cmp_by_descending_score, impl/paf_tile.c:28-34)."""
    return np.lexsort((np.arange(len(t)), -t.score, -t.chain_score))
