"""Tile-level assignment tests — semantics from impl/paf_tile.c with
hand-computed medians, plus a sequential-sweep oracle cross-check."""

import numpy as np

from paffy_tpu.core.model import MATCH, QUERY_INSERT, QUERY_DELETE
from paffy_tpu.core.pafio import parse_paf_text
from paffy_tpu.ops.tile import (assign_tile_levels, assign_tile_levels_sharded,
                                tile_sort_order)
from paffy_tpu.ops.coverage import EMPTY_TILE_LEVEL, CoverageMap, run_length_rows


def mk(records):
    """records: (qname, qs, qe, ts, te, score, chain_score, cigar)."""
    lines = []
    for qn, qs, qe, ts, te, sc, cs, cg in records:
        extra = f"\tAS:i:{sc}"
        if cs is not None:
            extra += f"\ts1:i:{cs}"
        lines.append(f"{qn}\t1000\t{qs}\t{qe}\t+\tt\t1000\t{ts}\t{te}"
                     f"\t{qe-qs}\t{qe-qs}\t60{extra}\tcg:Z:{cg}")
    return parse_paf_text("\n".join(lines) + "\n")


def run_tile(t):
    order = tile_sort_order(t)
    return assign_tile_levels(t, order)


def test_single_record_level_one():
    t = mk([("q", 0, 10, 0, 10, 100, None, "10M")])
    assert list(run_tile(t)) == [1]


def test_stacked_records_level_up():
    t = mk([("q", 0, 10, 0, 10, 100, None, "10M"),
            ("q", 0, 10, 50, 60, 50, None, "10M"),
            ("q", 0, 10, 100, 110, 25, None, "10M")])
    assert list(run_tile(t)) == [1, 2, 3]


def test_partial_overlap_median():
    # A covers [0,10) first; B covers [5,15): counts 2 on [5,10), 1 on [10,15)
    # median: hist {1:5, 2:5}, cum[1] = 5 >= 10/2 -> level 1
    t = mk([("q", 0, 10, 0, 10, 100, None, "10M"),
            ("q", 5, 15, 50, 60, 50, None, "10M")])
    assert list(run_tile(t)) == [1, 1]


def test_majority_overlap_median():
    # B covers [2,12): counts 2 on [2,10) (8 bases), 1 on [10,12) (2 bases)
    # hist {1:2, 2:8}; cum[1]=2 < 5 -> median 2
    t = mk([("q", 0, 10, 0, 10, 100, None, "10M"),
            ("q", 2, 12, 50, 60, 50, None, "10M")])
    assert list(run_tile(t)) == [1, 2]


def test_chain_score_orders_before_score():
    # lower score but higher chain_score processes first
    t = mk([("q", 0, 10, 0, 10, 100, 5, "10M"),
            ("q", 0, 10, 50, 60, 10, 99, "10M")])
    levels = run_tile(t)
    assert list(levels) == [2, 1]


def test_indels_do_not_cover():
    # record B's insert bases over A's region don't count as coverage
    t = mk([("q", 0, 10, 0, 10, 100, None, "10M"),
            ("q", 0, 13, 50, 58, 50, None, "3M5I5M")])
    # B aligned bases: [0,3) count 2 and [8,13): [8,10) count 2, [10,13) 1
    # hist {2:5, 1:3}; cum[1]=3 < 4 -> median 2
    assert list(run_tile(t)) == [1, 2]


def test_no_match_record_gets_sentinel():
    t = mk([("q", 0, 3, 0, 0, 100, None, "3I")])
    assert list(run_tile(t)) == [EMPTY_TILE_LEVEL]


def test_multiple_query_sequences_independent():
    t = mk([("q1", 0, 10, 0, 10, 100, None, "10M"),
            ("q2", 0, 10, 0, 10, 50, None, "10M"),
            ("q1", 0, 10, 50, 60, 25, None, "10M")])
    assert list(run_tile(t)) == [1, 1, 2]


def _oracle(t, order):
    counts = {}
    levels = np.zeros(len(t), dtype=np.int64)
    for i in order:
        nm = t.qname[i]
        arr = counts.setdefault(nm, np.zeros(int(t.qlen[i]), dtype=np.int64))
        pos = int(t.qstart[i])
        covered = []
        for op, ln in zip(*t.record_ops(i)):
            op, ln = int(op), int(ln)
            if op != QUERY_DELETE:
                if op != QUERY_INSERT:
                    for k in range(ln):
                        if arr[pos + k] < 32766:
                            arr[pos + k] += 1
                        covered.append(pos + k)
                pos += ln
        if not covered:
            levels[i] = EMPTY_TILE_LEVEL
            continue
        vals = arr[covered]
        hist = np.bincount(vals)
        cum = np.cumsum(hist)
        levels[i] = int(np.argmax(cum >= len(covered) / 2.0))
    return levels


def test_random_against_oracle():
    rng = np.random.default_rng(11)
    recs = []
    for i in range(40):
        qn = f"q{int(rng.integers(0, 3))}"
        qs = int(rng.integers(0, 60))
        parts, q, t_ = [], 0, 0
        for _ in range(int(rng.integers(1, 4))):
            ln = int(rng.integers(1, 15))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                parts.append(f"{ln}M"); q += ln; t_ += ln
            elif kind == 1:
                parts.append(f"{ln}I"); q += ln
            else:
                parts.append(f"{ln}D"); t_ += ln
        sc = int(rng.integers(0, 1000))
        cs = int(rng.integers(0, 1000)) if rng.random() < 0.5 else None
        recs.append((qn, qs, qs + q, 100, 100 + t_, sc, cs, "".join(parts)))
    t = mk(recs)
    order = tile_sort_order(t)
    got = assign_tile_levels(t, order)
    expect = _oracle(t, order)
    assert list(got) == list(expect)
    assert list(assign_tile_levels_sharded(t, order)) == list(expect)


def test_segmented_carries_match_single_segment(monkeypatch):
    # device scan, forced to one sequence per segment: identical levels to
    # the packed run
    import paffy_tpu.ops.tile as tile_mod
    rng = np.random.default_rng(5)
    recs = []
    for i in range(30):
        qn = f"q{int(rng.integers(0, 4))}"
        qs = int(rng.integers(0, 400))
        ln = int(rng.integers(5, 60))
        recs.append((qn, qs, qs + ln, 100, 100 + ln,
                     int(rng.integers(0, 500)), None, f"{ln}M"))
    t = mk(recs)
    order = tile_sort_order(t)
    packed = assign_tile_levels_sharded(t, order)
    monkeypatch.setattr(tile_mod, "TILE_SEGMENT_BASES", 1)  # 1 seq/segment
    split = assign_tile_levels_sharded(t, order)
    assert list(split) == list(packed)
    assert list(split) == list(_oracle(t, order))


def test_k_cap_host_fallback(monkeypatch):
    # device-scan batches over the runs-per-record cap take the host
    # sweep — identical
    import paffy_tpu.ops.tile as tile_mod
    rng = np.random.default_rng(7)
    recs = []
    for i in range(12):
        qn = f"q{int(rng.integers(0, 2))}"
        qs = int(rng.integers(0, 50))
        parts, q = [], 0
        for _ in range(int(rng.integers(2, 12))):   # many short runs
            ln = int(rng.integers(1, 5))
            if rng.random() < 0.6:
                parts.append(f"{ln}M"); q += ln
            else:
                parts.append(f"{ln}I"); q += ln
        if not any(p.endswith("M") for p in parts):
            parts.append("2M"); q += 2
        recs.append((qn, qs, qs + q, 100, 100 + sum(
            int(p[:-1]) for p in parts if p.endswith("M")),
            int(rng.integers(0, 500)), None, "".join(parts)))
    t = mk(recs)
    order = tile_sort_order(t)
    device = assign_tile_levels_sharded(t, order)
    monkeypatch.setattr(tile_mod, "TILE_K_CAP", 1)
    host = assign_tile_levels_sharded(t, order)
    assert list(host) == list(device)
    assert list(host) == list(_oracle(t, order))


def test_tile_carry_dtype_is_uint16():
    # the device carry matches the reference's SequenceCountArray dtype
    import jax
    from paffy_tpu.ops.tile import _tile_scan
    starts = np.zeros(1, dtype=np.int64)
    iv_s = np.zeros((1, 8), dtype=np.int64)
    iv_e = np.full((1, 8), 128, dtype=np.int64)
    jaxpr = jax.make_jaxpr(
        lambda a, b, c: _tile_scan(a, b, c, span=128, lmax=64,
                                   total=1 << 16))(starts, iv_s, iv_e)
    assert "u16[65664]" in str(jaxpr)


def test_coverage_map_and_rle():
    t = mk([("q", 0, 10, 0, 10, 100, None, "10M"),
            ("q", 5, 15, 50, 60, 50, None, "10M")])
    cm = CoverageMap()
    cm.add(t)
    counts = cm.counts("q")
    assert list(counts[:16]) == [1] * 5 + [2] * 5 + [1] * 5 + [0]
    starts, ends, vals = run_length_rows(counts, binary=False)
    assert list(starts) == [0, 5, 10, 15]
    assert list(ends) == [5, 10, 15, 1000]
    assert list(vals) == [1, 2, 1, 0]
    starts_b, ends_b, _ = run_length_rows(counts, binary=True)
    assert list(starts_b) == [0, 15]


def test_span_hazard_routes_to_host(monkeypatch):
    """A batch whose predicted device-scan work (one long-span record
    inflating every step's window) exceeds TILE_DEVICE_WORK_CAP takes the
    exact host sweep; under the cap the device scan runs.  Levels identical
    either way."""
    import paffy_tpu.ops.tile as tile_mod

    # seq A: one 50k-span record + small records; seq B: small records only
    lines = []
    qlen = 60_000
    lines.append(f"A\t{qlen}\t0\t50000\t+\tt\t60000\t0\t50000\t50000\t50000"
                 f"\t60\tAS:i:900\tcg:Z:50000M")
    for i in range(6):
        qs = 1000 * i
        lines.append(f"A\t{qlen}\t{qs}\t{qs+200}\t+\tt\t60000\t{qs}\t{qs+200}"
                     f"\t200\t200\t60\tAS:i:{500-i}\tcg:Z:200M")
        lines.append(f"B\t{qlen}\t{qs}\t{qs+200}\t+\tt\t60000\t{qs}\t{qs+200}"
                     f"\t200\t200\t60\tAS:i:{400-i}\tcg:Z:200M")
    t = parse_paf_text("\n".join(lines) + "\n")
    order = tile_sort_order(t)
    expected = assign_tile_levels(t, order)          # host sweep

    calls = {"host": 0}
    orig = tile_mod._assign_tile_levels_host

    def spy(*a, **k):
        calls["host"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tile_mod, "_assign_tile_levels_host", spy)
    assert list(assign_tile_levels_sharded(t, order)) == list(expected)
    assert calls["host"] == 0, "under the cap the device scan runs"
    # cap below the 50k-span batch's predicted work: host sweep
    monkeypatch.setattr(tile_mod, "TILE_DEVICE_WORK_CAP",
                        tile_mod._scan_work(7, 4096, 64))
    assert list(assign_tile_levels_sharded(t, order)) == list(expected)
    assert calls["host"] == 1, "the hazardous batch routes host"
