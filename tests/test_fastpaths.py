"""Unit tests for the round-3 native fast paths: raw-cigar parse mode,
serializer-side output ordering, native take/rle/coverage scatter, and the
two-pass FASTA pool loader.

Each fast path's oracle is the pre-existing slow form (numpy fallback or
parsed mode); the reference-diff suite (test_reference_diff*.py) covers
end-to-end parity with the compiled reference binary.  The input is the
seeded golden-shaped workload of goldenwork.py.
"""

import io

import numpy as np
import pytest

from paffy_tpu import native
from paffy_tpu.core import pafio
from paffy_tpu.core.fasta import (fasta_pool_from_bytes, load_sequences,
                                  pack_sequences, read_fasta)
from paffy_tpu.ops import coverage

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="no native toolchain")


@pytest.fixture(scope="module")
def golden_bytes() -> bytes:
    """The seeded golden-shaped PAF (207 records) at 5% of its length."""
    from goldenwork import golden_paf
    return golden_paf(scale=0.05)


# ------------------------------------------------------------ raw-cigar mode

@needs_native
def test_raw_parse_serializes_byte_identical(golden_bytes):
    parsed = pafio.parse_paf_data(golden_bytes)
    raw = pafio.parse_paf_data(golden_bytes, parse_cigars=False)
    assert raw.raw_cg is not None and len(raw) == len(parsed)
    assert bytes(pafio.serialize_paf_bytes(raw)) \
        == bytes(pafio.serialize_paf_bytes(parsed))
    # scalar columns identical
    for col in ("qstart", "qend", "tstart", "tend", "score", "strand"):
        np.testing.assert_array_equal(getattr(raw, col), getattr(parsed, col))


@needs_native
def test_raw_mode_preserves_noncanonical_cigars():
    # the reference's parse_cigar=0 mode re-emits the string verbatim,
    # including leading zeros the parsed form would canonicalize
    line = ("q\t100\t0\t10\t+\tt\t100\t0\t10\t10\t10\t60"
            "\tAS:i:7\tcg:Z:05M5M\n")
    raw = pafio.parse_paf_data(line.encode(), parse_cigars=False)
    assert bytes(pafio.serialize_paf_bytes(raw)).decode() == line
    parsed = pafio.parse_paf_data(line.encode())
    assert "cg:Z:5M5M" in bytes(pafio.serialize_paf_bytes(parsed)).decode()


@needs_native
def test_raw_take_slices_ranges(golden_bytes):
    raw = pafio.parse_paf_data(golden_bytes, parse_cigars=False)
    idx = np.array([5, 3, 100], dtype=np.int64)
    sub = raw.take(idx)
    assert sub.raw_cg is not None
    full = bytes(pafio.serialize_paf_bytes(raw)).splitlines(keepends=True)
    got = bytes(pafio.serialize_paf_bytes(sub)).splitlines(keepends=True)
    assert got == [full[5], full[3], full[100]]


@needs_native
def test_raw_paf_check_skips_spans(golden_bytes):
    # break a cigar's span: parsed mode must raise, raw mode must pass
    # (the reference's paf_check has a cigar==NULL guard)
    line = "q\t100\t0\t10\t+\tt\t100\t0\t10\t10\t10\t60\tcg:Z:9M\n".encode()
    raw = pafio.parse_paf_data(line, parse_cigars=False)
    pafio.paf_check(raw)  # no error
    parsed = pafio.parse_paf_data(line)
    with pytest.raises(pafio.PafCheckError):
        pafio.paf_check(parsed)


# ------------------------------------------------------- serializer ordering

def test_serialize_order_matches_take(golden_bytes):
    t = pafio.parse_paf_data(golden_bytes)
    rng = np.random.default_rng(3)
    perm = rng.permutation(len(t)).astype(np.int64)
    a = bytes(pafio.serialize_paf_bytes(t, order=perm))
    b = bytes(pafio.serialize_paf_bytes(t.take(perm)))
    assert a == b


def test_take_all_true_mask_returns_same_table(golden_bytes):
    t = pafio.parse_paf_data(golden_bytes)
    assert t.take(np.ones(len(t), dtype=bool)) is t


# ------------------------------------------------------------- coverage fast

def test_rle_u16_matches_numpy():
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 4, size=10_001).astype(np.uint16)
    counts[5000:5100] = 0
    for binary in (False, True):
        s, e, v = coverage.run_length_rows(counts, binary)
        # numpy oracle
        key = (counts > 0).astype(np.int64) if binary \
            else counts.astype(np.int64)
        change = np.nonzero(key[1:] != key[:-1])[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(counts)]])
        np.testing.assert_array_equal(s, starts)
        np.testing.assert_array_equal(e, ends)
        np.testing.assert_array_equal(v, counts[starts])


@needs_native
def test_coverage_add_matches_add_at():
    rng = np.random.default_rng(12)
    n = 5000
    starts = rng.integers(0, 900, size=n)
    ends = starts + rng.integers(1, 100, size=n)
    d1 = np.zeros(1001, dtype=np.int32)
    assert native.coverage_add(d1, starts, ends)
    d2 = np.zeros(1001, dtype=np.int32)
    np.add.at(d2, starts, 1)
    np.add.at(d2, ends, -1)
    np.testing.assert_array_equal(d1, d2)


# ------------------------------------------------------------ FASTA fast path

@needs_native
def test_fasta_pool_matches_string_path():
    text = (">one extra words \nACGTacgt\nNNN\n"
            ">two\n\nGG  TT\n  AA\t\n"
            ">one\nCCCC\n")           # duplicate name: last wins
    res = fasta_pool_from_bytes([text.encode()])
    assert res is not None
    pool, index = res
    seqs = read_fasta(io.StringIO(text))
    pool2, index2 = pack_sequences(seqs)
    assert index.keys() == index2.keys()
    for k in index:
        o, l = index[k]
        o2, l2 = index2[k]
        assert bytes(pool[o:o + l]) == bytes(pool2[o2:o2 + l2])


@needs_native
def test_fasta_pool_multifile_order_and_offsets():
    a, b = b">x\nAAA\n", b">y\nCCGG\n"
    pool, index = fasta_pool_from_bytes([a, b])
    assert index == {"x": (0, 3), "y": (3, 4)}
    assert bytes(pool) == b"AAACCGG"


# ------------------------------------------------- no-toolchain equivalence

@needs_native
def test_fallback_paths_match_native(golden_bytes, monkeypatch):
    """Every new fast path's pure-Python/numpy fallback produces identical
    results with the native library disabled."""
    from paffy_tpu.ops import tailtrim, transforms

    t = pafio.parse_paf_data(golden_bytes)
    raw = pafio.parse_paf_data(golden_bytes, parse_cigars=False)
    rng = np.random.default_rng(7)
    perm = rng.permutation(len(t)).astype(np.int64)
    idx = np.array([9, 2, 2, 41], dtype=np.int64)
    counts = rng.integers(0, 3, size=4_001).astype(np.uint16)

    nat = {
        "plain": bytes(pafio.serialize_paf_bytes(t)),
        "order": bytes(pafio.serialize_paf_bytes(t, order=perm)),
        "raw": bytes(pafio.serialize_paf_bytes(raw)),
        "take": bytes(pafio.serialize_paf_bytes(t.take(idx))),
        "invert": bytes(pafio.serialize_paf_bytes(transforms.invert(t))),
        "shatter": bytes(pafio.serialize_paf_bytes(transforms.shatter(t))),
        "trim": bytes(pafio.serialize_paf_bytes(
            tailtrim.trim_unreliable_tails(t, 0.05, 1.0))),
        "rle": coverage.run_length_rows(counts, False),
    }

    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert bytes(pafio.serialize_paf_bytes(t)) == nat["plain"]
    assert bytes(pafio.serialize_paf_bytes(t, order=perm)) == nat["order"]
    assert bytes(pafio.serialize_paf_bytes(raw)) == nat["raw"]
    assert bytes(pafio.serialize_paf_bytes(t.take(idx))) == nat["take"]
    assert bytes(pafio.serialize_paf_bytes(
        transforms.invert(t))) == nat["invert"]
    assert bytes(pafio.serialize_paf_bytes(
        transforms.shatter(t))) == nat["shatter"]
    assert bytes(pafio.serialize_paf_bytes(
        tailtrim.trim_unreliable_tails(t, 0.05, 1.0))) == nat["trim"]
    s, e, v = coverage.run_length_rows(counts, False)
    np.testing.assert_array_equal(s, nat["rle"][0])
    np.testing.assert_array_equal(e, nat["rle"][1])
    np.testing.assert_array_equal(v, nat["rle"][2])


# -------------------------------------------------------- encode CSR rebuild

@needs_native
def test_encode_rebuild_offsets_matches_numpy(golden_bytes):
    t = pafio.parse_paf_data(golden_bytes)
    is_m = t.ops == 0
    n_m = int(is_m.sum())
    rng = np.random.default_rng(5)
    runs_per_mop = rng.integers(1, 5, size=n_m).astype(np.int64)
    total = int(runs_per_mop.sum()) + (len(t.ops) - n_m)
    out_off, m_off, new_ops, new_lens = native.encode_rebuild_offsets(
        t.ops, t.lens, runs_per_mop, total)
    # numpy oracle
    contrib = np.ones(len(t.ops), dtype=np.int64)
    contrib[is_m] = runs_per_mop
    exp_off = np.zeros(len(t.ops) + 1, dtype=np.int64)
    np.cumsum(contrib, out=exp_off[1:])
    np.testing.assert_array_equal(out_off, exp_off)
    np.testing.assert_array_equal(m_off, exp_off[:-1][is_m])
    non_m = ~is_m
    np.testing.assert_array_equal(new_ops[exp_off[:-1][non_m]],
                                  t.ops[non_m])
    np.testing.assert_array_equal(new_lens[exp_off[:-1][non_m]],
                                  t.lens[non_m])
