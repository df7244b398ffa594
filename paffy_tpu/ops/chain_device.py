"""Device scan kernels of the chain DP (split from ops/chain so host-routed
chaining never imports JAX; see paffy_tpu/jaxconf.py).

The windowed recurrence and tiebreaks mirror ops/chain._dp_numpy exactly
(impl/chaining.c:150-214); cross-checked in tests/test_chain.py.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from paffy_tpu.jaxconf import ensure_jax

ensure_jax()

import jax            # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paffy_tpu.ops.chain import _NEG, _window_bounds  # noqa: E402
from paffy_tpu.ops.segments import bucket_size  # noqa: E402


@partial(jax.jit, static_argnames=("n_pad", "w_pad"))
def _dp_scan(qs, ts, score, qe_s, te_s, idx_s, lo, w, pos,
             gap_open, gap_extend, max_gap, n_pad, w_pad):
    """Device chain DP: scan over records in processing order; each step
    reads one w_pad-wide dynamic slice of the qend-sorted candidate arrays
    (the window of _window_bounds) instead of the whole group.

    qs/ts/score are [n_pad] in processing order; qe_s/te_s/idx_s are the
    qend-sorted coordinate/processing-index arrays padded to n_pad + w_pad;
    lo/w/pos are per-step window start, window width, and the record's own
    slot in qend order (where its chain score is scattered).

    The DP dtype follows qs.dtype: int32 inputs run the whole recurrence in
    int32 (half the bytes per step).  Values must fit: coords, scores, and
    chain totals < 2^31.
    """
    dt = qs.dtype
    neg = _NEG if dt == jnp.int64 else jnp.asarray(
        np.iinfo(np.dtype(dt.name)).min // 4, dt)
    lane = jnp.arange(w_pad, dtype=dt)

    def step(cs_sorted, x):
        i, lo_i, w_i, pos_i = x
        qe_w = jax.lax.dynamic_slice(qe_s, (lo_i,), (w_pad,))
        te_w = jax.lax.dynamic_slice(te_s, (lo_i,), (w_pad,))
        idx_w = jax.lax.dynamic_slice(idx_s, (lo_i,), (w_pad,))
        cs_w = jax.lax.dynamic_slice(cs_sorted, (lo_i,), (w_pad,))
        tgap = ts[i] - te_w
        ok = ((lane < w_i) & (idx_w < i)        # in window, processed before
              & (tgap >= 0) & (tgap <= max_gap))
        qgap = qs[i] - qe_w
        g = jnp.where(qgap + tgap == 0, 0, gap_open + gap_extend * (qgap + tgap))
        ok &= g < score[i]
        val = jnp.where(ok, score[i] + cs_w - g, neg)
        best = jnp.max(val)
        tie = val == best
        # argmax of (te, qe, idx) among ties — nested reductions
        t_best = jnp.max(jnp.where(tie, te_w, neg))
        tie &= te_w == t_best
        q_best = jnp.max(jnp.where(tie, qe_w, neg))
        tie &= qe_w == q_best
        j = jnp.max(jnp.where(tie, idx_w, -1))
        adopt = best > score[i]
        cs_i = jnp.where(adopt, best, score[i])
        pred_i = jnp.where(adopt, j, -1)
        cs_sorted = cs_sorted.at[pos_i].set(cs_i, mode="drop")
        return cs_sorted, (cs_i, pred_i)

    cs0 = jnp.full(n_pad + w_pad, neg, dtype=dt)
    steps = (jnp.arange(n_pad, dtype=dt), lo, w, pos)
    _, (cs, pred) = jax.lax.scan(step, cs0, steps)
    return cs, pred


@partial(jax.jit, static_argnames=("n_pad", "w_pad"))
def _dp_scan_groups(qs, ts, score, qe_s, te_s, idx_s, lo, w, pos,
                    gap_open, gap_extend, max_gap, n_pad, w_pad):
    """Batched device chain DP: the windowed scan vmapped over a leading
    group axis ([G, n_pad] / [G, n_pad + w_pad] arrays).  One compile serves
    every group of the same shape bucket; the group axis is the natural
    ``data`` sharding axis of the multichip pipeline."""
    def one(qs1, ts1, score1, qe1, te1, idx1, lo1, w1, pos1):
        return _dp_scan.__wrapped__(qs1, ts1, score1, qe1, te1, idx1,
                                    lo1, w1, pos1, gap_open, gap_extend,
                                    max_gap, n_pad=n_pad, w_pad=w_pad)
    return jax.vmap(one)(qs, ts, score, qe_s, te_s, idx_s, lo, w, pos)


def chain_groups_device(groups, gap_open, gap_extend, max_gap, mesh=None):
    """Run the chain DP for many groups in batched device calls.

    ``groups`` is a list of (qs, qe, ts, te, score) int64 arrays (one tuple
    per (qname,tname) group, records in processing order).  Returns a list
    of (chain_score, pred) matching _dp_numpy exactly (cross-checked in
    tests/test_chain.py).  With ``mesh``, the group axis is sharded over the
    mesh's ``data`` axis (groups are independent DPs).

    Groups are bucketed by power-of-two padded size with one batched scan
    per bucket: padding every group to the global max ([G, n_pad] x 6
    int64 arrays) made one large group among many small ones inflate host
    memory and link transfer multiplicatively; bucket count (and so compile
    count) stays <= log2(max n).
    """
    if not groups:
        return []
    buckets: dict[int, list[int]] = {}
    for gi, g in enumerate(groups):
        buckets.setdefault(bucket_size(len(g[0])), []).append(gi)
    if len(buckets) > 1:
        results = [None] * len(groups)
        for _, idxs in sorted(buckets.items()):
            sub = _chain_groups_device_bucket([groups[i] for i in idxs],
                                              gap_open, gap_extend, max_gap,
                                              mesh)
            for i, r in zip(idxs, sub):
                results[i] = r
        return results
    return _chain_groups_device_bucket(groups, gap_open, gap_extend,
                                       max_gap, mesh)


def build_bucket_args(groups, max_gap, dtype=np.int64):
    """Pad one size bucket of groups into the batched-scan argument arrays.

    Returns (args, n_pad, w_pad) with args the 9 [G, n_pad(+w_pad)] arrays
    of _dp_scan_groups in ``dtype``.  int32 is valid when every coordinate,
    score, and possible chain total fits in int31."""
    n_pad = bucket_size(max(len(g[0]) for g in groups))
    all_lo, all_w, all_orders = [], [], []
    for qs, qe, ts, te, score in groups:
        qe_order, lo, hi = _window_bounds(qs, qe, max_gap)
        all_orders.append(qe_order)
        all_lo.append(lo)
        all_w.append(hi - lo)
    w_pad = bucket_size(
        max(int(w.max(initial=0)) for w in all_w) or 1, minimum=8)

    g_count = len(groups)
    qs_b = np.zeros((g_count, n_pad), dtype=dtype)
    ts_b = np.zeros((g_count, n_pad), dtype=dtype)
    sc_b = np.zeros((g_count, n_pad), dtype=dtype)
    qe_s = np.zeros((g_count, n_pad + w_pad), dtype=dtype)
    te_s = np.zeros((g_count, n_pad + w_pad), dtype=dtype)
    idx_s = np.full((g_count, n_pad + w_pad), n_pad, dtype=dtype)
    lo_b = np.zeros((g_count, n_pad), dtype=dtype)
    w_b = np.zeros((g_count, n_pad), dtype=dtype)
    pos_b = np.full((g_count, n_pad), n_pad + w_pad, dtype=dtype)
    for gi, (qs, qe, ts, te, score) in enumerate(groups):
        n = len(qs)
        qe_order = all_orders[gi]
        qs_b[gi, :n] = qs
        ts_b[gi, :n] = ts
        sc_b[gi, :n] = score
        qe_s[gi, :n] = qe[qe_order]
        te_s[gi, :n] = te[qe_order]
        idx_s[gi, :n] = qe_order
        lo_b[gi, :n] = all_lo[gi]
        w_b[gi, :n] = all_w[gi]
        pos_b[gi][qe_order] = np.arange(n)
    return ((qs_b, ts_b, sc_b, qe_s, te_s, idx_s, lo_b, w_b, pos_b),
            n_pad, w_pad)


def _chain_groups_device_bucket(groups, gap_open, gap_extend, max_gap,
                                mesh=None):
    """One size bucket of chain_groups_device: every group pads to the
    bucket's n_pad / the bucket's own max window."""
    args, n_pad, w_pad = build_bucket_args(groups, max_gap)
    g_count = len(groups)
    if mesh is not None:
        # pad the group axis to the data axis and shard it: each device DPs
        # its own groups, no cross-group communication (padding groups have
        # w == 0 everywhere, so every step adopts nothing)
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        dp = mesh.shape["data"]
        g_pad = -(-g_count // dp) * dp
        sh = NamedSharding(mesh, P("data"))
        args = tuple(_jax.device_put(
            np.concatenate([a, np.zeros((g_pad - g_count,) + a.shape[1:],
                                        dtype=a.dtype)]) if g_pad > g_count
            else a, sh) for a in args)
    else:
        args = tuple(map(jnp.asarray, args))
    cs, pred = _dp_scan_groups(
        *args,
        np.int64(gap_open), np.int64(gap_extend), np.int64(max_gap),
        n_pad=n_pad, w_pad=w_pad)
    cs = np.asarray(cs)
    pred = np.asarray(pred)
    return [(cs[gi, : len(g[0])], pred[gi, : len(g[0])])
            for gi, g in enumerate(groups)]


