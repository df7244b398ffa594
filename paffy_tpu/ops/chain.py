"""Sparse chaining of PAF alignments.

Reference: impl/chaining.c (whole file).  The reference sweeps records in
ascending query_start order, keeping an AVL set of "active" chain heads and,
for each record, iterating candidate predecessors backward with prune/evict
rules.  Every prune rule is monotone (SURVEY.md section 7 "hard parts" #2):

  * the query-gap eviction (impl/chaining.c:180-183) only removes candidates
    whose query gap can never shrink for later records (records are processed
    in ascending query_start), and
  * the target-gap break (impl/chaining.c:188-190) only skips candidates with
    still-larger target gaps,

so the stateful sweep is equivalent to the clean recurrence

  chain_score[i] = max(score[i],
                       max_j { score[i] + chain_score[j] - gap(i,j) })
  over j with  qend_j <= qstart_i,  tend_j <= tstart_i,
               qstart_i - qend_j <= max_gap,  tstart_i - tend_j <= max_gap,
               gap(i,j) < score[i]           (impl/chaining.c:192-199)

with ties between equal-scoring predecessors resolved toward the candidate
visited first in the reference's backward iteration: largest
(target_end, query_end, processing index).

Greedy chain extraction (impl/chaining.c:216-233) takes chains best-score
first (ties: latest-processed first, the reference's pointer tiebreak),
walking predecessor links and truncating at already-claimed records; members
are emitted head-first, chain ids assigned in extraction order and the chain
total recomputed along the surviving links (get_chain_score,
impl/chaining.c:88-113).

Strand handling (impl/chaining.c:266-343): records are coordinate-trimmed by
percentage_to_trim, '-' strand query coordinates mirrored to negative space,
each strand set chained separately (chain_id counter shared), then mirrored
back, un-trimmed, checked, and stably sorted by descending score.

The per-group DP runs as a native windowed sweep (numpy oracle without a
toolchain); under a mesh it runs as a ``lax.scan`` on device (vector
candidate masks per step) — identical semantics, verified against each
other in tests.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import numpy as np

from paffy_tpu.core.model import PafTable
from paffy_tpu.core.pafio import paf_check
from paffy_tpu.ops.segments import bucket_size

_NEG = np.int64(-(1 << 62))

# Group size at which the device lax.scan DP would take over from the host
# windowed sweep: "never", by measurement.  On an NVIDIA H100 (400 W limit)
# the shattered golden workload's two groups (128,472 and 56,481 records)
# took 2.49 s + 1.25 s as device-resident int64 scans (2.17 s + 1.08 s in
# int32) against 0.31 s for the native DP over both (chip_smoke.py): each
# scan step is a few dependent kernels over a w_pad-wide window, while the
# host sweep does O(actual window) work per record.  The scan kernel
# remains the sharded pipeline's route (group-per-device under a mesh).
DEVICE_GROUP_THRESHOLD = 1 << 40


def _window_bounds(qs, qe, max_gap):
    """Candidate windows in qend-sorted order.

    A predecessor j of record i must satisfy qend_j in
    [qstart_i - max_gap, qstart_i] (the reference's query-gap skip + evict
    rules, impl/chaining.c:174-183) — a contiguous slice of the records
    sorted by qend.  Everything below the slice is permanently evicted for
    all later records (qstart is non-decreasing), exactly the reference's
    eviction argument.

    Returns (qe_order, lo, hi): the qend-sort permutation and, per record,
    the [lo, hi) candidate slice of that order.
    """
    n = len(qs)
    qe_order = np.lexsort((np.arange(n), qe))
    qes = qe[qe_order]
    lo = np.searchsorted(qes, qs - max_gap, side="left")
    hi = np.searchsorted(qes, qs, side="right")
    return qe_order, lo, np.maximum(hi, lo)


def _dp_numpy(qs, qe, ts, te, score, gap_open, gap_extend, max_gap):
    """Windowed chain DP over one (qname,tname,strand) group in processing
    order: O(sum of window sizes) instead of O(N^2).  Returns
    (chain_score, pred) with pred -1 for chain starts."""
    n = len(qs)
    cs = score.astype(np.int64).copy()
    pred = np.full(n, -1, dtype=np.int64)
    qe_order, lo, hi = _window_bounds(qs, qe, max_gap)
    for i in range(n):
        c = qe_order[lo[i]: hi[i]]
        c = c[c < i]                    # processed before i
        if len(c) == 0:
            continue
        # window guarantees 0 <= qgap <= max_gap
        qgap = qs[i] - qe[c]
        tgap = ts[i] - te[c]
        ok = (tgap >= 0) & (tgap <= max_gap)
        g = np.where(qgap + tgap == 0, 0, gap_open + gap_extend * (qgap + tgap))
        ok &= g < score[i]
        if not ok.any():
            continue
        val = np.where(ok, score[i] + cs[c] - g, _NEG)
        best = val.max()
        if best <= score[i]:
            continue
        # tiebreak: largest (target_end, query_end, index) among best values
        cand = c[val == best]
        j = cand[np.lexsort((cand, qe[cand], te[cand]))[-1]]
        cs[i] = best
        pred[i] = j
    return cs, pred


def _group_dp(qs, qe, ts, te, score, gap_open, gap_extend, max_gap):
    n = len(qs)
    if n < DEVICE_GROUP_THRESHOLD:
        # host production path: the native windowed sweep (the numpy
        # per-record loop below is the oracle + no-toolchain fallback;
        # measured 7.3 s -> ~0.1 s on the 185k-record shattered golden)
        from paffy_tpu import native
        qe_order, lo, hi = _window_bounds(qs, qe, max_gap)
        res = native.chain_dp(qs, qe, ts, te, score, qe_order, lo, hi,
                              gap_open, gap_extend, max_gap)
        if res is not None:
            return res
        return _dp_numpy(qs, qe, ts, te, score, gap_open, gap_extend, max_gap)
    qe_order, lo, hi = _window_bounds(qs, qe, max_gap)
    n_pad = bucket_size(n)
    w_pad = bucket_size(max(int((hi - lo).max(initial=0)), 1), minimum=8)
    pos = np.full(n_pad, n_pad + w_pad, dtype=np.int64)   # pads: drop scatter
    pos[qe_order] = np.arange(n)

    import jax.numpy as jnp

    def pad(a, size, fill=0):
        out = np.full(size, fill, dtype=np.int64)
        out[: len(a)] = a
        return jnp.asarray(out)

    from paffy_tpu.ops.chain_device import _dp_scan
    cs, pred = _dp_scan(
        pad(qs, n_pad), pad(ts, n_pad), pad(score, n_pad),
        pad(qe[qe_order], n_pad + w_pad), pad(te[qe_order], n_pad + w_pad),
        pad(qe_order, n_pad + w_pad, fill=n_pad),   # pads never "before"
        pad(lo, n_pad), pad(hi - lo, n_pad), jnp.asarray(pos),
        np.int64(gap_open), np.int64(gap_extend), np.int64(max_gap),
        n_pad=n_pad, w_pad=w_pad)
    return np.asarray(cs)[:n], np.asarray(pred)[:n]


_DEVICE_NAMES = ("_dp_scan", "_dp_scan_groups", "chain_groups_device",
                 "_chain_groups_device_bucket")


def __getattr__(name):
    # device scans live in ops/chain_device (lazy: host-routed chain never
    # imports JAX; see paffy_tpu/jaxconf.py)
    if name in _DEVICE_NAMES:
        from paffy_tpu.ops import chain_device
        return getattr(chain_device, name)
    raise AttributeError(name)


def _gap_cost(qgap, tgap, gap_open, gap_extend):
    return 0 if qgap + tgap == 0 else gap_open + gap_extend * (qgap + tgap)


def _chain_strand_set(t: PafTable, sel: np.ndarray, qs, qe, ts, te,
                      gap_open, gap_extend, max_gap, chain_id_start: int,
                      dp_many=None):
    """Chain the records at indices ``sel`` (one strand, mirrored coords).

    ``dp_many`` optionally overrides the per-group DP with a batched solver
    taking a list of (qs, qe, ts, te, score) group tuples and returning a
    list of (chain_score, pred) — e.g. chain_groups_device for the batched
    (and mesh-shardable) device route.

    Returns (output order over sel, chain_id, chain_score arrays aligned to
    that order, next chain id).
    """
    n = len(sel)
    if n == 0:
        return (np.zeros(0, dtype=np.int64),) * 3 + (chain_id_start,)
    # processing order: ascending query_start, ties by input order
    # (paf_cmp_by_query_location pointer tiebreak, impl/chaining.c:14-21)
    order = np.lexsort((sel, qs[sel]))
    sqs, sqe = qs[sel][order], qe[sel][order]
    sts, ste = ts[sel][order], te[sel][order]
    sscore = t.score[sel][order]

    # group by (qname, tname); strand is homogeneous here
    keys = {}
    gid = np.empty(n, dtype=np.int64)
    for k, i in enumerate(sel[order]):
        key = (t.qname[i], t.tname[i])
        gid[k] = keys.setdefault(key, len(keys))

    members = [np.nonzero(gid == g)[0] for g in range(len(keys))]
    groups = [(sqs[m], sqe[m], sts[m], ste[m], sscore[m]) for m in members]
    if dp_many is None:
        results = [_group_dp(*g, gap_open, gap_extend, max_gap)
                   for g in groups]
    else:
        results = dp_many(groups, gap_open, gap_extend, max_gap)
    cs = np.empty(n, dtype=np.int64)
    pred = np.full(n, -1, dtype=np.int64)
    for m, (gcs, gpred) in zip(members, results):
        cs[m] = gcs
        pred[m] = np.where(gpred >= 0, m[np.clip(gpred, 0, None)], -1)

    # ---- greedy extraction, best chain-score first (ties: latest processed)
    extract = np.lexsort((-np.arange(n), -cs))
    claimed = np.zeros(n, dtype=bool)
    out_members: list[int] = []
    out_chain_id: list[int] = []
    out_chain_score: list[int] = []
    next_id = chain_id_start
    for r in extract:
        if claimed[r]:
            continue
        members = [r]
        claimed[r] = True
        cur = r
        while True:
            p = pred[cur]
            if p < 0 or claimed[p]:
                break
            claimed[p] = True
            members.append(int(p))
            cur = int(p)
        # total score along surviving links (get_chain_score)
        total = int(sscore[members[0]])
        for a, b in zip(members[:-1], members[1:]):
            g = _gap_cost(int(sqs[a] - sqe[b]), int(sts[a] - ste[b]),
                          gap_open, gap_extend)
            total += int(sscore[b]) - g
        for mmb in members:
            out_members.append(mmb)
            out_chain_id.append(next_id)
            out_chain_score.append(total)
        next_id += 1

    out = np.array(out_members, dtype=np.int64)
    return (sel[order[out]],
            np.array(out_chain_id, dtype=np.int64),
            np.array(out_chain_score, dtype=np.int64), next_id)


def paf_chain(t: PafTable, gap_open: int = 5000, gap_extend: int = 1,
              max_gap: int = 1000000, pct_trim: float = 1.0,
              check: bool = True, dp_many=None) -> PafTable:
    """Chain a batch of records (paf_chain, impl/chaining.c:266-343).

    Default costs match paffy chain (impl/paf_chain.c:17-20,36-45).
    ``dp_many`` optionally replaces the per-group DP with a batched solver
    (see _chain_strand_set) — identical results, one device dispatch for all
    groups.
    """
    tagged, perm = paf_chain_order(t, gap_open=gap_open,
                                   gap_extend=gap_extend, max_gap=max_gap,
                                   pct_trim=pct_trim, check=check,
                                   dp_many=dp_many)
    return tagged.take(perm) if perm is not None else tagged


def paf_chain_order(t: PafTable, gap_open: int = 5000, gap_extend: int = 1,
                    max_gap: int = 1000000, pct_trim: float = 1.0,
                    check: bool = True, dp_many=None):
    """paf_chain without materializing the reordered table: returns
    (tagged, perm) where ``tagged`` is the input table with cn/s1 tags set
    in INPUT order and ``perm`` is the output permutation (descending
    score, stable — impl/chaining.c:337).  Serializing tagged with
    order=perm is byte-identical to paf_chain's output while never copying
    the cigar store (the reference reorders stList pointers)."""
    assert 0.0 <= pct_trim <= 1.0
    n = len(t)
    if n == 0:
        return t, None
    # per-record coordinate trim for chaining (impl/chaining.c:274-289);
    # C computes each span*pct in float32 then truncates, then min/2
    q_span = (t.qend - t.qstart).astype(np.float32)
    t_span = (t.tend - t.tstart).astype(np.float32)
    maxq = np.trunc(q_span * np.float32(pct_trim)).astype(np.int64)
    maxt = np.trunc(t_span * np.float32(pct_trim)).astype(np.int64)
    trim = np.minimum(maxq, maxt) // 2

    qs = t.qstart + trim
    qe = t.qend - trim
    ts = t.tstart + trim
    te = t.tend - trim
    # mirror '-' strand query coords (invert_query_strand, impl/chaining.c:255-259)
    neg = ~t.strand
    qs_m = np.where(neg, -(t.qend - trim), qs)
    qe_m = np.where(neg, -(t.qstart + trim), qe)

    pos_sel = np.nonzero(t.strand)[0]
    neg_sel = np.nonzero(neg)[0]
    o1, id1, cs1, nxt = _chain_strand_set(t, pos_sel, qs_m, qe_m, ts, te,
                                          gap_open, gap_extend, max_gap, 0,
                                          dp_many=dp_many)
    o2, id2, cs2, _ = _chain_strand_set(t, neg_sel, qs_m, qe_m, ts, te,
                                        gap_open, gap_extend, max_gap, nxt,
                                        dp_many=dp_many)

    order = np.concatenate([o1, o2])
    # scatter tags back to input positions (tags are per-record; the
    # reference mutates the records in place, chain_to_pafs :115-131)
    cid = np.full(n, -1, dtype=np.int64)
    cscore = np.full(n, -1, dtype=np.int64)
    cid[order] = np.concatenate([id1, id2])
    cscore[order] = np.concatenate([cs1, cs2])
    tagged = replace(t, chain_id=cid, chain_score=cscore)
    if check:
        paf_check(tagged)
    # final sort: descending score, stable over the strand-set
    # concatenation order (impl/chaining.c:337)
    final = np.argsort(-tagged.score[order], kind="stable")
    return tagged, order[final]
