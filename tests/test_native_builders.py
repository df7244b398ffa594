"""Native batch-builder oracles: the C single-pass builders must produce
arrays byte-identical to the numpy fallback paths they replace."""

import numpy as np
import pytest

from paffy_tpu import native
from paffy_tpu.core import pafio
from paffy_tpu.ops import segments, tiled
from paffy_tpu.ops.mismatch import SequencePool
from synthdata import make_workload

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native toolchain unavailable")


@pytest.fixture(scope="module")
def workload():
    seqs, lines = make_workload(seed=3, length=120_000, n_windows=40,
                                window=9_000, step=2_700)
    t = pafio.parse_paf_text("\n".join(lines) + "\n")
    pool = SequencePool(seqs)
    qoff = pool.offsets_for(t.qname, "query")
    toff = pool.offsets_for(t.tname, "target")
    return t, pool, qoff, toff


def _numpy_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def test_mop_batch_native_matches_numpy(workload, monkeypatch):
    t, pool, qoff, toff = workload
    nat = segments.build_m_column_batch(t, qoff, toff)
    _numpy_only(monkeypatch)
    ref = segments.build_m_column_batch(t, qoff, toff)
    assert nat.n_mops == ref.n_mops and nat.n_cols == ref.n_cols
    assert nat.n_cols_pad == ref.n_cols_pad
    for f in ("lens", "rec", "qpos0", "tpos0", "rev", "col_off",
              "rec_col_off", "flat_idx"):
        a, b = getattr(nat, f), getattr(ref, f)
        assert a.dtype == b.dtype or f == "rev", f
        assert np.array_equal(a, b), f


def test_mop_batch_native_empty_and_cigarless(monkeypatch):
    """Records with no cigar and empty tables go through both paths."""
    text = ("q\t100\t0\t50\t+\tt\t200\t10\t60\t50\t50\t60\n"
            "q\t100\t0\t50\t-\tt\t200\t10\t60\t50\t50\t60\tcg:Z:20M5I25M\n")
    t = pafio.parse_paf_text(text)
    qoff = np.zeros(len(t), dtype=np.int64)
    toff = np.full(len(t), 100, dtype=np.int64)
    nat = segments.build_m_column_batch(t, qoff, toff)
    _numpy_only(monkeypatch)
    ref = segments.build_m_column_batch(t, qoff, toff)
    for f in ("lens", "rec", "qpos0", "tpos0", "rev", "col_off",
              "rec_col_off", "flat_idx"):
        assert np.array_equal(getattr(nat, f), getattr(ref, f)), f


def test_packed2_grid_native_matches_numpy(workload, monkeypatch):
    t, pool, qoff, toff = workload
    b = segments.build_m_column_batch(t, qoff, toff)
    pool_len = pool.pool.shape[0]
    nat = tiled.build_packed2_chunk_batch(b, len(t), pool_len)
    _numpy_only(monkeypatch)
    ref = tiled.build_packed2_chunk_batch(b, len(t), pool_len)
    assert nat.n_chunks == ref.n_chunks and nat.u_pad == ref.u_pad
    assert nat.n_cols == ref.n_cols
    for f in ("trow", "qwin", "qpar", "col_a", "col_b", "rec_chunk_off"):
        a, b_ = getattr(nat, f), getattr(ref, f)
        assert a.dtype == b_.dtype, f
        assert np.array_equal(a, b_), f


def test_cigar_stats_native_matches_numpy(workload):
    t, pool, qoff, toff = workload
    from paffy_tpu.ops import transforms
    from paffy_tpu.core.segsum import segment_sums_by_offsets
    from paffy_tpu.ops.mismatch import encode_mismatches
    te = encode_mismatches(t, pool)   # get =/X/I/D mix, not just M
    for table in (t, te):
        stats, m_only = transforms.stats_calc_with_m(table)
        ref = transforms._stats_calc_numpy(table)
        for k in ref:
            assert np.array_equal(stats[k], ref[k]), k
        ref_m = segment_sums_by_offsets(
            np.where(table.ops == 0, table.lens, 0), table.off)
        assert np.array_equal(m_only, ref_m)


def test_packed2_grid_zero_length_op(monkeypatch):
    """A 0M op contributes no chunks in either builder (the numpy path's
    (L-1)>>2 floor semantics are replicated with arithmetic shifts in C)."""
    text = ("q\t1000\t0\t100\t+\tt\t1000\t0\t100\t100\t100\t60"
            "\tcg:Z:0M50M0M50M\n")
    t = pafio.parse_paf_text(text)
    seqs = {"q": "A" * 1000, "t": "C" * 1000}
    pool = SequencePool(seqs)
    qoff = pool.offsets_for(t.qname, "query")
    toff = pool.offsets_for(t.tname, "target")
    b = segments.build_m_column_batch(t, qoff, toff)
    pool_len = pool.pool.shape[0]
    nat = tiled.build_packed2_chunk_batch(b, len(t), pool_len)
    _numpy_only(monkeypatch)
    ref = tiled.build_packed2_chunk_batch(b, len(t), pool_len)
    assert nat.n_chunks == ref.n_chunks
    for f in ("trow", "qwin", "qpar", "col_a", "col_b", "rec_chunk_off"):
        assert np.array_equal(getattr(nat, f), getattr(ref, f)), f


def test_threaded_counts_match_single_thread(workload):
    """column_compare_counts_mt (the production host counts route) must be
    identical to the single-threaded reference loop at every thread count."""
    t, pool, qoff, toff = workload
    b = segments.build_m_column_batch(t, qoff, toff)
    args = (pool.host_pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops],
            b.tpos0[: b.n_mops], b.rev[: b.n_mops], b.rec[: b.n_mops],
            len(t))
    m1, x1 = native.column_compare_counts(*args)
    for thr in (1, 2, 3, 8):
        m, x = native.column_compare_counts_mt(*args, n_threads=thr)
        assert (m == m1).all() and (x == x1).all(), f"n_threads={thr}"


def test_counts_routing_prediction(monkeypatch):
    """The e2e router follows the rates measured on an H100 host: at the
    16x golden size a fresh process stays native (the device set-up
    outweighs the per-batch gain), a process whose pool is already on the
    card takes the device, small batches stay native on dispatch cost, and
    without an accelerator the route is always native."""
    import os
    from types import SimpleNamespace
    from paffy_tpu.ops import mismatch

    monkeypatch.setattr(os, "cpu_count", lambda: 16)
    big = SimpleNamespace(n_cols=2_000_000_000, n_mops=3_000_000)
    # no accelerator (default in this test env): native regardless of rates
    assert not mismatch.device_counts_predicted_faster(big,
                                                       pool_on_device=True)

    def no_platform_query():
        raise AssertionError("platform queried although native wins")

    # rates favour native: decided without importing JAX
    monkeypatch.setattr(mismatch, "_compute_platform", no_platform_query)
    assert not mismatch.device_counts_predicted_faster(big)
    small = SimpleNamespace(n_cols=1_000_000, n_mops=2_000)
    assert not mismatch.device_counts_predicted_faster(small,
                                                       pool_on_device=True)
    monkeypatch.setattr(mismatch, "_compute_platform", lambda: "gpu")
    assert mismatch.device_counts_predicted_faster(big, pool_on_device=True)
    huge = SimpleNamespace(n_cols=100_000_000_000, n_mops=150_000_000)
    assert mismatch.device_counts_predicted_faster(huge)
    assert not mismatch.device_route_wins(big.n_cols)
    assert mismatch.device_route_wins(huge.n_cols)


def test_native_chain_dp_matches_numpy():
    """The native windowed chain DP must equal _dp_numpy exactly, including
    value ties resolved by the (target_end, query_end, index) rule."""
    from paffy_tpu.ops.chain import _dp_numpy, _window_bounds
    rng = np.random.default_rng(13)
    for trial in range(6):
        n = int(rng.integers(2, 400))
        qs = np.sort(rng.integers(0, 2000, n))
        qe = qs + rng.integers(1, 40, n)
        ts = rng.integers(0, 2000, n)
        te = ts + rng.integers(1, 40, n)
        # small score range forces frequent exact value ties
        sc = rng.integers(50, 60, n)
        args = (5000, 1, 500)
        ecs, epred = _dp_numpy(qs, qe, ts, te, sc, *args)
        qe_order, lo, hi = _window_bounds(qs, qe, args[2])
        cs, pred = native.chain_dp(qs, qe, ts, te, sc, qe_order, lo, hi,
                                   *args)
        assert np.array_equal(cs, ecs), f"trial {trial}"
        assert np.array_equal(pred, epred), f"trial {trial}"


def test_native_tile_sweep_matches_numpy(monkeypatch):
    """The native arena tile sweep must equal the numpy reference sweep,
    including uint16 saturation and the empty-match sentinel."""
    import paffy_tpu.ops.tile as tile_mod
    from paffy_tpu.ops.coverage import match_intervals
    from paffy_tpu.ops.tile import _assign_tile_levels_host, tile_sort_order
    from synthdata import make_workload

    seqs, lines = make_workload(seed=21, length=9000, n_windows=30,
                                window=1200, step=290)
    t = pafio.parse_paf_text("\n".join(lines) + "\n")
    order = tile_sort_order(t)
    rec, istart, iend = match_intervals(t)
    native_lv = _assign_tile_levels_host(t, order, rec, istart, iend)
    monkeypatch.setattr(tile_mod, "FORCE_HOST_NUMPY", True)
    numpy_lv = _assign_tile_levels_host(t, order, rec, istart, iend)
    assert list(native_lv) == list(numpy_lv)


def test_native_trim_counts_matches_numpy(monkeypatch):
    """Native trim_counts must equal the vectorized numpy form across a
    fuzzed workload (float32 identity comparisons, max_trim break, suffix
    re-inclusion)."""
    import paffy_tpu.ops.tailtrim as tt
    from synthdata import make_workload

    seqs, lines = make_workload(seed=31, length=20000, n_windows=24,
                                window=2500, step=900)
    t = pafio.parse_paf_text("\n".join(lines) + "\n")
    from paffy_tpu.ops.mismatch import SequencePool, encode_mismatches
    te = encode_mismatches(t, SequencePool(seqs))
    for frac, maxf in ((0.05, 1.0), (0.3, 0.25), (0.0, 1.0)):
        got = pafio.serialize_paf(tt.trim_unreliable_tails(te, frac, maxf))
        monkeypatch.setattr(tt, "FORCE_NUMPY", True)
        want = pafio.serialize_paf(tt.trim_unreliable_tails(te, frac, maxf))
        monkeypatch.setattr(tt, "FORCE_NUMPY", False)
        assert got == want, f"trim params {frac}/{maxf}"


def test_native_match_intervals_matches_numpy(monkeypatch):
    import paffy_tpu.ops.coverage as cov
    from synthdata import make_workload
    seqs, lines = make_workload(seed=41, length=9000, n_windows=24,
                                window=1100, step=310)
    t = pafio.parse_paf_text("\n".join(lines) + "\n")
    got = cov.match_intervals(t)
    monkeypatch.setattr(cov, "FORCE_NUMPY", True)
    want = cov.match_intervals(t)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_cigar_stats_raw_matches_parsed(workload):
    """Raw-text stats tokenizer must equal the parsed-CSR stats pass on
    the same bytes (the raw-streaming filter path depends on this)."""
    t, pool, _, _ = workload
    from paffy_tpu.ops import transforms
    from paffy_tpu.ops.mismatch import encode_mismatches
    te = encode_mismatches(t, pool)
    for table in (t, te):
        data = bytes(pafio.serialize_paf_bytes(table))
        t_raw = pafio.parse_paf_data(data, parse_cigars=False,
                                     validate_cigars=True)
        assert t_raw.raw_cg is not None
        raw = native.cigar_stats_raw(t_raw)
        full = native.cigar_stats(len(table), table.ops, table.lens,
                                  table.off)
        assert np.array_equal(raw, full)
        # and through the ops layer
        s_raw = transforms.stats_calc(t_raw)
        s_full = transforms.stats_calc(table)
        for k in s_full:
            assert np.array_equal(s_raw[k], s_full[k]), k


def test_paf_check_raw_spans():
    """check_raw_spans restores the reference's cigar-span checks over
    raw-cigar tables (dechunk parity, impl/paf_dechunk.c:114-116)."""
    good = b"q\t100\t0\t10\t+\tt\t100\t0\t10\t10\t10\t60\tcg:Z:10M\n"
    t = pafio.parse_paf_data(good, parse_cigars=False)
    pafio.paf_check(t, check_raw_spans=True)  # passes
    bad = good.replace(b"10M", b"9M")
    tb = pafio.parse_paf_data(bad, parse_cigars=False)
    pafio.paf_check(tb)  # raw default: span check skipped, like parse=0
    with pytest.raises(pafio.PafCheckError):
        pafio.paf_check(tb, check_raw_spans=True)


def test_fasta_headers_matches_pack():
    """Header-only FASTA read must agree with the packing reader on names
    and trimmed sequence lengths (upconvert's interval source)."""
    fa = (b">a desc\nACGT\nACG\n>b\n\n>c\nNNNN  \nACGT\n"
          b"leading junk ignored\n>d\n  GG TT \n")
    h = native.fasta_headers(fa)
    p = native.fasta_pack_bytes(fa)
    assert h == [(n, ln) for n, _off, ln in p[1]]


def test_trim_tails_raw_matches_parsed():
    """The raw-substring trim must serialize byte-identically to the
    parsed CSR trim across parameters, strands and pathological cigars."""
    from paffy_tpu.ops.tailtrim import trim_unreliable_tails
    from synthdata import make_workload
    _, lines = make_workload(seed=77, length=30000, n_windows=30,
                             window=3000, step=1100)
    # add cigarless + single-op + all-indel edge records
    lines = list(lines) + [
        "q0\t50\t0\t10\t+\tt0\t60\t5\t15\t10\t10\t0",
        "q1\t50\t0\t7\t-\tt1\t60\t5\t12\t7\t7\t0\tcg:Z:7M",
        "q2\t50\t0\t4\t+\tt2\t60\t5\t13\t4\t12\tcg:Z:4I8D"
        .replace("\t4\t12\t", "\t4\t12\t0\t"),
    ]
    data = ("\n".join(lines) + "\n").encode()
    for sf, mf in ((0.05, 1.0), (0.5, 0.5), (0.0, 0.1)):
        t_raw = pafio.parse_paf_data(data, parse_cigars=False,
                                     validate_cigars=True)
        assert t_raw.raw_cg is not None
        t_full = pafio.parse_paf_data(data)
        a = bytes(pafio.serialize_paf_bytes(
            trim_unreliable_tails(t_raw, sf, mf)))
        b = bytes(pafio.serialize_paf_bytes(
            trim_unreliable_tails(t_full, sf, mf)))
        assert a == b, (sf, mf)


def test_validators_native_match_numpy(workload):
    """Native walk validators must agree with their numpy oracles on
    clean and corrupted workloads."""
    from paffy_tpu.ops import transforms as tr
    t, _, _, _ = workload
    assert native.query_walk_violation(t) == tr._query_walk_violation_numpy(t)
    assert native.shatter_violation(t) == tr._shatter_violation_numpy(t)
    rng = np.random.default_rng(5)
    for _ in range(12):
        tb = t.copy() if hasattr(t, "copy") else t
        import dataclasses
        qe = t.qend.copy(); ts = t.tstart.copy(); lens = t.lens.copy()
        i = int(rng.integers(0, len(t)))
        what = rng.integers(0, 3)
        if what == 0:
            qe[i] += int(rng.integers(1, 5))
        elif what == 1:
            ts[i] -= int(rng.integers(1, 5)) * 1000
        else:
            k = int(t.off[i])
            if k < t.off[i + 1]:
                lens[k] = 0
        tb = dataclasses.replace(t, qend=qe, tstart=ts, lens=lens)
        assert (native.query_walk_violation(tb)
                == tr._query_walk_violation_numpy(tb)), what
        assert (native.shatter_violation(tb)
                == tr._shatter_violation_numpy(tb)), what
