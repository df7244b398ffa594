"""Mismatch-encoding kernel tests — port of tests/paf_unit_test.c section 11
plus strand/boundary cases, cross-checked against a direct per-base oracle."""

import numpy as np
import pytest

from paffy_tpu.core.model import (MATCH, QUERY_INSERT, QUERY_DELETE,
                                  SEQ_MATCH, SEQ_MISMATCH)
from paffy_tpu.core.pafio import parse_paf_text, paf_check
from paffy_tpu.core.fasta import reverse_complement_char
from paffy_tpu.ops.mismatch import SequencePool, encode_mismatches, column_match_counts


def parse_one(line):
    return parse_paf_text(line + "\n")


def oracle_encode(t, i, seqs):
    """Direct per-record, per-base re-implementation of the reference walk
    (impl/paf.c:748-777) used as the test oracle."""
    q = seqs[t.qname[i]]
    s = seqs[t.tname[i]]
    ops, lens = t.record_ops(i)
    out = []
    qi, tj = 0, int(t.tstart[i])
    for op, ln in zip(ops, lens):
        op, ln = int(op), int(ln)
        if op == MATCH:
            first = True
            prev = False
            for k in range(ln):
                if t.strand[i]:
                    qb = q[int(t.qstart[i]) + qi + k]
                else:
                    qb = reverse_complement_char(q[int(t.qend[i]) - 1 - qi - k])
                is_m = s[tj + k].upper() == qb.upper()
                if first or is_m != prev:
                    out.append([SEQ_MATCH if is_m else SEQ_MISMATCH, 1])
                    first = False
                else:
                    out[-1][1] += 1
                prev = is_m
            qi += ln
            tj += ln
        else:
            out.append([op, ln])
            if op == QUERY_INSERT:
                qi += ln
            elif op == QUERY_DELETE:
                tj += ln
            else:
                qi += ln
                tj += ln
    return [(o, l) for o, l in out]


def enc(line, seqs):
    t = parse_one(line)
    pool = SequencePool(seqs)
    t2 = encode_mismatches(t, pool)
    ops, lens = t2.record_ops(0)
    return t2, list(zip([int(o) for o in ops], [int(l) for l in lens]))


def test_all_match():
    _, cg = enc("q\t5\t0\t5\t+\tt\t5\t0\t5\t5\t5\t60\tcg:Z:5M",
                {"q": "AAAAA", "t": "AAAAA"})
    assert cg == [(SEQ_MATCH, 5)]


def test_all_mismatch():
    _, cg = enc("q\t5\t0\t5\t+\tt\t5\t0\t5\t0\t5\t60\tcg:Z:5M",
                {"q": "AAAAA", "t": "CCCCC"})
    assert cg == [(SEQ_MISMATCH, 5)]


def test_mixed():
    _, cg = enc("q\t4\t0\t4\t+\tt\t4\t0\t4\t2\t4\t60\tcg:Z:4M",
                {"q": "AATT", "t": "AACC"})
    assert cg == [(SEQ_MATCH, 2), (SEQ_MISMATCH, 2)]


def test_case_insensitive():
    _, cg = enc("q\t4\t0\t4\t+\tt\t4\t0\t4\t4\t4\t60\tcg:Z:4M",
                {"q": "aAtT", "t": "AaTt"})
    assert cg == [(SEQ_MATCH, 4)]


def test_reverse_strand():
    # '-' strand: query walks backward from qend-1, reverse-complemented.
    # target=ACGT, revcomp(query[3..0]): query= ACGT -> walk T,G,C,A -> comp A,C,G,T
    _, cg = enc("q\t4\t0\t4\t-\tt\t4\t0\t4\t4\t4\t60\tcg:Z:4M",
                {"q": "ACGT", "t": "ACGT"})
    assert cg == [(SEQ_MATCH, 4)]  # ACGT is its own reverse complement


def test_runs_do_not_merge_across_op_boundaries():
    # two adjacent M ops with the same match state still produce two runs
    # (the `first` reset per M op, impl/paf.c:753)
    _, cg = enc("q\t6\t0\t6\t+\tt\t6\t0\t6\t6\t6\t60\tcg:Z:3M3M",
                {"q": "AAAAAA", "t": "AAAAAA"})
    assert cg == [(SEQ_MATCH, 3), (SEQ_MATCH, 3)]


def test_indels_pass_through():
    t2, cg = enc("q\t8\t0\t7\t+\tt\t8\t0\t8\t4\t9\t60\tcg:Z:2M1I3M2D1M",
                 {"q": "AAGCCCTT", "t": "AACCCGGT"})
    # 2M: AA vs AA -> 2=; 1I; 3M: q CCC vs t CCC -> 3=; 2D; 1M: q T vs t T -> 1=
    assert cg == [(SEQ_MATCH, 2), (QUERY_INSERT, 1), (SEQ_MATCH, 3),
                  (QUERY_DELETE, 2), (SEQ_MATCH, 1)]
    paf_check(t2)


def test_existing_eq_x_ops_pass_through():
    _, cg = enc("q\t5\t0\t5\t+\tt\t5\t0\t5\t4\t5\t60\tcg:Z:2=1X2M",
                {"q": "AAATT", "t": "AACTT"})
    assert cg == [(SEQ_MATCH, 2), (SEQ_MISMATCH, 1), (SEQ_MATCH, 2)]


def test_random_against_oracle():
    rng = np.random.default_rng(42)
    bases = np.array(list("ACGTacgtN"))
    lines = []
    seqs = {}
    for r in range(30):
        qlen = int(rng.integers(20, 80))
        tlen = int(rng.integers(20, 80))
        qn, tn = f"q{r}", f"t{r}"
        seqs[qn] = "".join(rng.choice(bases, qlen))
        seqs[tn] = "".join(rng.choice(bases, tlen))
        # random cigar fitting the sequences
        ops, q, t = [], 0, 0
        while q < qlen - 6 and t < tlen - 6 and len(ops) < 8:
            kind = int(rng.integers(0, 3))
            ln = int(rng.integers(1, 5))
            if kind == 0:
                ln = min(ln, qlen - 6 - q, tlen - 6 - t)
                if ln <= 0:
                    break
                ops.append(f"{ln}M"); q += ln; t += ln
            elif kind == 1 and q < qlen - 7:
                ops.append(f"{ln if q+ln < qlen-6 else 1}I")
                q += ln if q + ln < qlen - 6 else 1
            elif t < tlen - 7:
                ops.append(f"{ln if t+ln < tlen-6 else 1}D")
                t += ln if t + ln < tlen - 6 else 1
        if not ops or not any(o.endswith("M") for o in ops):
            ops = ["3M"]; q, t = 3, 3
        strand = "+" if rng.random() < 0.5 else "-"
        qs = int(rng.integers(0, 3))
        ts = int(rng.integers(0, 3))
        lines.append(f"{qn}\t{qlen}\t{qs}\t{qs+q}\t{strand}\t{tn}\t{tlen}\t{ts}\t{ts+t}"
                     f"\t{q}\t{max(q,t)}\t60\tcg:Z:{''.join(ops)}")
    t = parse_paf_text("\n".join(lines) + "\n")
    pool = SequencePool(seqs)
    t2 = encode_mismatches(t, pool)
    paf_check(t2)
    for i in range(len(t)):
        expect = oracle_encode(t, i, seqs)
        ops, lens = t2.record_ops(i)
        got = list(zip([int(o) for o in ops], [int(l) for l in lens]))
        assert got == expect, f"record {i}: {got} != {expect}"


def test_column_match_counts_agree_with_encode():
    seqs = {"q": "AATTCCGG", "t": "AATACCGG"}
    t = parse_one("q\t8\t0\t8\t+\tt\t8\t0\t8\t7\t8\t60\tcg:Z:8M")
    pool = SequencePool(seqs)
    m, x = column_match_counts(t, pool)
    assert m[0] == 7 and x[0] == 1


def test_missing_sequence_raises():
    t = parse_one("q\t5\t0\t5\t+\tmissing\t5\t0\t5\t5\t5\t60\tcg:Z:5M")
    with pytest.raises(KeyError):
        encode_mismatches(t, SequencePool({"q": "AAAAA"}))


def test_compact_device_extraction_matches_full_path(monkeypatch):
    from paffy_tpu.ops import mismatch as mm
    monkeypatch.setattr(mm, "FORCE_DEVICE", True)
    seqs, lines = None, None
    import synthdata
    seqs, lines = synthdata.make_workload(seed=13, length=6000, n_windows=10,
                                          window=900, step=550)
    from paffy_tpu.core.pafio import parse_paf_text, serialize_paf
    t = parse_paf_text("\n".join(lines) + "\n")
    pool = mm.SequencePool(seqs)
    full = mm.encode_mismatches(t.copy(), pool)
    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
    tiled = mm.encode_mismatches(t.copy(), pool)
    assert serialize_paf(full) == serialize_paf(tiled)


def test_tiled_counts_match_naive(monkeypatch):
    from paffy_tpu.ops import mismatch as mm
    import synthdata
    seqs, lines = synthdata.make_workload(seed=21, length=9000, n_windows=14,
                                          window=1100, step=640)
    from paffy_tpu.core.pafio import parse_paf_text
    t = parse_paf_text("\n".join(lines) + "\n")
    pool = mm.SequencePool(seqs)
    m0, x0 = mm.column_match_counts(t, pool)
    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
    m1, x1 = mm.column_match_counts(t, pool)
    assert np.array_equal(m0, m1) and np.array_equal(x0, x1)


def test_tiled_random_against_oracle(monkeypatch):
    from paffy_tpu.ops import mismatch as mm
    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
    monkeypatch.setattr(mm, "FORCE_DEVICE", True)
    test_random_against_oracle()


def test_tiled_exact_chunk_boundaries(monkeypatch):
    # runs of exactly W and W+1 columns; both strands
    from paffy_tpu.ops import mismatch as mm
    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
    monkeypatch.setattr(mm, "FORCE_DEVICE", True)
    rng = np.random.default_rng(5)
    for ln in (127, 128, 129, 256, 257):
        for strand in "+-":
            q = "".join(rng.choice(list("ACGT"), ln + 10))
            t_ = "".join(rng.choice(list("ACGT"), ln + 10))
            line = (f"q\t{ln+10}\t3\t{3+ln}\t{strand}\tt\t{ln+10}\t5\t{5+ln}"
                    f"\t{ln}\t{ln}\t60\tcg:Z:{ln}M")
            t = parse_one(line)
            pool = mm.SequencePool({"q": q, "t": t_})
            t2 = mm.encode_mismatches(t, pool)
            expect = oracle_encode(t, 0, {"q": q, "t": t_})
            ops, lens = t2.record_ops(0)
            got = list(zip([int(o) for o in ops], [int(l) for l in lens]))
            assert got == expect, f"len {ln} strand {strand}"


def test_hot_kernels_trace_no_int64():
    # regression guard: under x64, an unpinned jnp.sum(int32) promotes to
    # int64 and doubles the bytes of every per-chunk reduction — assert the
    # hot kernels stay int32
    import jax
    import jax.numpy as jnp
    from paffy_tpu.ops import mismatch as mm
    from paffy_tpu.ops.segments import build_m_column_batch
    from paffy_tpu.ops.tiled import (build_chunk_batch, build_packed_chunk_batch,
                                     _tiled_match_counts, _packed_match_counts,
                                     build_ext_phase_views, build_packed_pools,
                                     _ext2d)
    import synthdata
    from paffy_tpu.core.pafio import parse_paf_text

    seqs, lines = synthdata.make_workload(seed=11, length=9000, n_windows=12,
                                          window=1500, step=700)
    t = parse_paf_text("\n".join(lines) + "\n")
    pool = mm.SequencePool(seqs)
    b = build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                             pool.offsets_for(t.tname, "target"))
    ext = pool.ext
    pool_len = int(pool.pool.shape[0])

    import re

    def assert_no_i64(jaxpr):
        # scalar i64[] clip bounds are benign; flag int64 ARRAYS only
        bad = re.findall(r"[su]64\[\d[^\]]*\]", str(jaxpr))
        assert not bad, f"int64 arrays leaked into a hot kernel trace: {bad[:4]}"

    cb = build_chunk_batch(b, len(t), pool_len=pool_len)
    views = build_ext_phase_views(ext)
    assert_no_i64(jax.make_jaxpr(_tiled_match_counts.__wrapped__)(
        _ext2d(ext), views, jnp.asarray(cb.trow), jnp.asarray(cb.qwin_lo),
        jnp.asarray(cb.lane_a), jnp.asarray(cb.lane_b),
        jnp.asarray(cb.rec_chunk_off)))

    pc = build_packed_chunk_batch(b, len(t), pool_len=pool_len)
    packed2d, pviews = build_packed_pools(ext)
    assert_no_i64(jax.make_jaxpr(_packed_match_counts.__wrapped__)(
        packed2d, pviews, jnp.asarray(pc.trow), jnp.asarray(pc.qwin),
        jnp.asarray(pc.qpar), jnp.asarray(pc.col_a), jnp.asarray(pc.col_b),
        jnp.asarray(pc.rec_chunk_off)))


def test_packed2_parity_and_boundary_edges(monkeypatch):
    # 2-bit kernel: all 4 target/query start parities, both strands, run
    # lengths straddling the 1024-column row size
    from paffy_tpu.ops import mismatch as mm
    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
    rng = np.random.default_rng(17)
    for ln in (1023, 1024, 1025, 7):
        for tshift in range(4):
            for qshift in range(4):
                for strand in "+-":
                    q = "".join(rng.choice(list("ACGT"), ln + 20))
                    t_ = "".join(rng.choice(list("ACGT"), ln + 20))
                    qs, ts = 3 + qshift, 5 + tshift
                    line = (f"q\t{ln+20}\t{qs}\t{qs+ln}\t{strand}\tt\t{ln+20}"
                            f"\t{ts}\t{ts+ln}\t{ln}\t{ln}\t60\tcg:Z:{ln}M")
                    t = parse_one(line)
                    pool = mm.SequencePool({"q": q, "t": t_})
                    assert not pool.has_exotic2
                    m1, x1 = mm.column_match_counts(t, pool)
                    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1 << 60)
                    m0, x0 = mm.column_match_counts(t, pool)
                    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
                    assert m0[0] == m1[0] and x0[0] == x1[0], \
                        f"len {ln} t%4={tshift} q%4={qshift} {strand}"


def test_alphabet_kernel_routing(monkeypatch):
    # N -> 2-bit inexact, 4-bit exact; '-' -> only the unpacked kernel
    from paffy_tpu.ops import mismatch as mm
    import synthdata
    from paffy_tpu.core.pafio import parse_paf_text
    seqs, lines = synthdata.make_workload(seed=23, length=8000, n_windows=10,
                                          window=1400, step=700)
    t = parse_paf_text("\n".join(lines) + "\n")
    for ch, exotic2, exotic in (("N", True, False), ("-", True, True)):
        mutated = dict(seqs)
        k = next(iter(mutated))
        s = list(mutated[k])
        for i in range(50, len(s), 97):
            s[i] = ch
        mutated[k] = "".join(s)
        pool = mm.SequencePool(mutated)
        assert pool.has_exotic2 == exotic2
        assert pool.has_exotic == exotic
        m0, x0 = mm.column_match_counts(t, pool)       # naive (small batch)
        monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)  # tiled dispatch
        m1, x1 = mm.column_match_counts(t, pool)
        monkeypatch.undo()
        assert np.array_equal(m0, m1) and np.array_equal(x0, x1), ch


def test_native_and_device_run_extraction_agree(monkeypatch):
    # threshold=1 routes large-path extraction to native C; FORCE_DEVICE
    # exercises the device tiled_runs fallback — all three must serialize
    # byte-identically
    from paffy_tpu.ops import mismatch as mm
    from paffy_tpu import native
    import synthdata
    from paffy_tpu.core.pafio import parse_paf_text, serialize_paf
    seqs, lines = synthdata.make_workload(seed=29, length=7000, n_windows=12,
                                          window=1000, step=560)
    t = parse_paf_text("\n".join(lines) + "\n")
    pool = mm.SequencePool(seqs)
    full = serialize_paf(mm.encode_mismatches(t.copy(), pool))
    monkeypatch.setattr(mm, "TILED_THRESHOLD", 1)
    assert native.get_lib() is not None
    nat = serialize_paf(mm.encode_mismatches(t.copy(), pool))
    monkeypatch.setattr(mm, "FORCE_DEVICE", True)
    dev = serialize_paf(mm.encode_mismatches(t.copy(), pool))
    assert nat == full and dev == full


def test_naive_device_counts_still_exact(monkeypatch):
    # keep the no-toolchain device fallback covered now that small batches
    # default to the native C loop
    from paffy_tpu.ops import mismatch as mm
    import synthdata
    from paffy_tpu.core.pafio import parse_paf_text
    seqs, lines = synthdata.make_workload(seed=37, length=6000, n_windows=8,
                                          window=900, step=620)
    t = parse_paf_text("\n".join(lines) + "\n")
    pool = mm.SequencePool(seqs)
    m0, x0 = mm.column_match_counts(t, pool)           # native C loop
    monkeypatch.setattr(mm, "FORCE_DEVICE", True)
    m1, x1 = mm.column_match_counts(t, pool)           # naive device kernel
    assert np.array_equal(m0, m1) and np.array_equal(x0, x1)
