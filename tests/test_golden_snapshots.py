"""Golden-output snapshot gate: every paffy/faffy command run over the
seeded golden-shaped workload (goldenwork.write_workspace: the 207-record
chromosome-pair PAF at 2% of its length, plus sequences written through
it), with
output sha256 pinned in golden_hashes.json.

Any semantic drift — chain tiebreaks, tile ordering, trim arithmetic, tag
emission, BED compression, chunk packing — fails here even if the drifted
implementation stays self-consistent (complements the reference's own
byte-stability gate, tests/paf_test.c:11-47).  The pins are regression
pins of this implementation; parity with the reference binaries is the job
of tests/test_reference_diff*.py where those binaries exist.

Regenerate after an INTENDED behavior change with
``PAFFY_TPU_REGEN_GOLDEN=1 python -m pytest tests/test_golden_snapshots.py``
and review the diff of tests/golden_hashes.json like source.
"""

import contextlib
import hashlib
import io
import json
import os
import pathlib

import pytest

from paffy_tpu.cli import paffy_main, faffy_main
from goldenwork import write_workspace

HASHES = pathlib.Path(__file__).parent / "golden_hashes.json"
REGEN = bool(os.environ.get("PAFFY_TPU_REGEN_GOLDEN"))


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Shared workspace (goldenwork.write_workspace): golden.paf,
    normalized renamed.paf, synthesized seqs.fa."""
    ws = write_workspace(tmp_path_factory.mktemp("golden"))
    if ws is None:
        pytest.skip("native toolchain unavailable; cannot synthesize FASTA")
    return ws


@pytest.fixture(scope="module")
def recorded():
    cur = json.loads(HASHES.read_text()) if HASHES.exists() else {}
    yield cur
    if REGEN:
        HASHES.write_text(json.dumps(cur, indent=1, sort_keys=True) + "\n")


def check(recorded, key, data: bytes):
    entry = {"sha256": _sha(data), "bytes": len(data)}
    if REGEN:
        recorded[key] = entry
        return
    assert key in recorded, (
        f"no golden hash recorded for {key!r}; run with "
        f"PAFFY_TPU_REGEN_GOLDEN=1 to record")
    assert recorded[key] == entry, (
        f"golden output drift for {key!r}: recorded {recorded[key]}, "
        f"got {entry}")


def run(cmd, *argv) -> bytes:
    """Run a command in-process, return captured stdout bytes."""
    main = paffy_main if cmd == "paffy" else faffy_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    assert rc == 0, f"{cmd} {argv} -> rc {rc}"
    return buf.getvalue().encode()


def run_o(cmd, *argv, out: pathlib.Path) -> bytes:
    run(cmd, *argv, "-o", str(out))
    return out.read_bytes()


# ---------------------------------------------------------------- paffy ----

def test_view_snapshots(env, recorded, tmp_path):
    check(recorded, "view/per_record",
          run_o("paffy", "view", "-i", env["renamed"], env["fasta"],
                out=tmp_path / "v1"))
    check(recorded, "view/aggregate",
          run_o("paffy", "view", "-i", env["renamed"], env["fasta"],
                "-s", "-t", out=tmp_path / "v2"))
    # -a renders per-base rows: slice to the first 3 records to bound output
    head = tmp_path / "head3.paf"
    with open(env["renamed"]) as fh:
        head.write_text("".join(line for _, line in zip(range(3), fh)))
    check(recorded, "view/alignment_head3",
          run_o("paffy", "view", "-i", str(head), env["fasta"], "-a",
                out=tmp_path / "v3"))


def test_chain_snapshots(env, recorded, tmp_path):
    # whole records rarely link (neighbours overlap or sit far apart, and
    # overlapping predecessors are skipped, impl/chaining.c:174-178); the
    # real linking behavior is pinned on shattered input below, where
    # gapless fragments chain back along the diagonals
    check(recorded, "chain/default",
          run_o("paffy", "chain", "-i", env["golden"], out=tmp_path / "c1"))
    check(recorded, "chain/params",
          run_o("paffy", "chain", "-i", env["golden"], "-g", "100000",
                "-d", "1000", "-e", "2", "-t", "0.2", out=tmp_path / "c2"))
    shat = run_o("paffy", "shatter", "-i", env["golden"],
                 out=tmp_path / "sh.paf")
    head = tmp_path / "sh2000.paf"
    head.write_bytes(b"".join(shat.splitlines(keepends=True)[:2000]))
    linked = run_o("paffy", "chain", "-i", str(head), out=tmp_path / "c3")
    # sanity: real multi-member chains must form here
    cns = [f.split(":")[2] for line in linked.decode().splitlines()
           for f in line.split("\t")[12:] if f.startswith("cn:")]
    assert len(set(cns)) < len(cns), "expected multi-member chains"
    check(recorded, "chain/shatter2000_default", linked)
    check(recorded, "chain/shatter2000_params",
          run_o("paffy", "chain", "-i", str(head), "-g", "5000", "-d", "100",
                "-e", "2", out=tmp_path / "c4"))


def test_tile_snapshot(env, recorded, tmp_path):
    check(recorded, "tile/default",
          run_o("paffy", "tile", "-i", env["golden"], out=tmp_path / "t1"))


def test_to_bed_snapshots(env, recorded, tmp_path):
    # uses the renamed copy: -n needs distinct query/target names (both the
    # reference's stHash and our coverage map key count arrays by name)
    check(recorded, "to_bed/default",
          run_o("paffy", "to_bed", "-i", env["renamed"], out=tmp_path / "b1"))
    check(recorded, "to_bed/inverted_min100",
          run_o("paffy", "to_bed", "-i", env["renamed"], "-n", "-m", "100",
                out=tmp_path / "b2"))


def test_invert_snapshot(env, recorded, tmp_path):
    check(recorded, "invert/default",
          run_o("paffy", "invert", "-i", env["golden"], out=tmp_path / "i1"))


def test_shatter_snapshot(env, recorded, tmp_path):
    check(recorded, "shatter/default",
          run_o("paffy", "shatter", "-i", env["golden"], out=tmp_path / "s1"))


def test_dedupe_snapshots(env, recorded, tmp_path):
    dup = tmp_path / "dup.paf"
    g = pathlib.Path(env["golden"]).read_bytes()
    dup.write_bytes(g + g)
    out = run_o("paffy", "dedupe", "-i", str(dup), out=tmp_path / "d1")
    check(recorded, "dedupe/doubled", out)
    inv = run_o("paffy", "invert", "-i", env["golden"], out=tmp_path / "inv")
    both = tmp_path / "both.paf"
    both.write_bytes(g + inv)
    check(recorded, "dedupe/check_inverse",
          run_o("paffy", "dedupe", "-a", "-i", str(both),
                out=tmp_path / "d2"))


def test_trim_snapshots(env, recorded, tmp_path):
    check(recorded, "trim/identity_default",
          run_o("paffy", "trim", "-i", env["golden"], out=tmp_path / "tr1"))
    check(recorded, "trim/fixed_0.1",
          run_o("paffy", "trim", "-i", env["golden"], "-f", "-t", "0.1",
                out=tmp_path / "tr2"))


def test_filter_snapshots(env, recorded, tmp_path):
    chained = run_o("paffy", "chain", "-i", env["golden"],
                    out=tmp_path / "ch.paf")
    check(recorded, "filter/chain_score_20000",
          run_o("paffy", "filter", "-i", str(tmp_path / "ch.paf"),
                "-s", "20000", out=tmp_path / "f1"))
    check(recorded, "filter/chain_score_20000_x",
          run_o("paffy", "filter", "-i", str(tmp_path / "ch.paf"),
                "-s", "20000", "-x", out=tmp_path / "f2"))


def test_add_mismatches_snapshots(env, recorded, tmp_path):
    am = tmp_path / "am.paf"
    out = run_o("paffy", "add_mismatches", "-i", env["renamed"],
                env["fasta"], out=am)
    check(recorded, "add_mismatches/default", out)
    # removing the mismatches must round-trip to the all-M original exactly
    removed = run_o("paffy", "add_mismatches", "-a", "-i", str(am),
                    out=tmp_path / "am_r")
    assert removed == pathlib.Path(env["renamed"]).read_bytes()
    check(recorded, "add_mismatches/removed", removed)


def test_split_file_snapshots(env, recorded, tmp_path):
    pre = tmp_path / "sp" / "part_"
    pre.parent.mkdir()
    run("paffy", "split_file", "-i", env["golden"], "-p", str(pre))
    blob = b"".join(p.name.encode() + b"\0" + p.read_bytes()
                    for p in sorted(pre.parent.iterdir()))
    check(recorded, "split_file/by_target", blob)
    preq = tmp_path / "spq" / "part_"
    preq.parent.mkdir()
    run("paffy", "split_file", "-i", env["golden"], "-q", "-p", str(preq))
    blob = b"".join(p.name.encode() + b"\0" + p.read_bytes()
                    for p in sorted(preq.parent.iterdir()))
    check(recorded, "split_file/by_query", blob)


# ---------------------------------------------------------------- faffy ----

@pytest.fixture(scope="module")
def chunks(env, tmp_path_factory):
    d = tmp_path_factory.mktemp("chunks")
    listing = run("faffy", "chunk", env["fasta"], "-d", str(d / "out"),
                  "-c", "600000", "-o", "2000")
    files = [line for line in listing.decode().splitlines() if line.strip()]
    return {"dir": d, "files": files}


def test_faffy_chunk_snapshot(chunks, recorded):
    blob = b"".join(pathlib.Path(f).name.encode() + b"\0"
                    + pathlib.Path(f).read_bytes() for f in chunks["files"])
    check(recorded, "faffy_chunk/c600k_o2k", blob)


def test_faffy_merge_roundtrip(env, chunks, recorded, tmp_path):
    lst = tmp_path / "list"
    lst.write_text("\n".join(chunks["files"]) + "\n")
    merged = run_o("faffy", "merge", "-i", str(lst), out=tmp_path / "m.fa")
    check(recorded, "faffy_merge/roundtrip", merged)
    # merged sequence content must equal the original FASTA's sequences
    from paffy_tpu.core.fasta import load_sequences
    orig = load_sequences([env["fasta"]])
    got = load_sequences([str(tmp_path / "m.fa")])
    assert set(got) == set(orig)
    for nm in orig:
        assert got[nm] == orig[nm], f"merge round-trip mismatch for {nm}"


def test_upconvert_dechunk_roundtrip(env, recorded, tmp_path):
    # upconvert's real input is extracted-fragment FASTA (fragments always
    # contain their records — fixed-stride chunks need not, and both the
    # reference and we abort on a boundary-crossing record,
    # impl/paf_upconvert.c:46 assert)
    from paffy_tpu.core import pafio
    t = pafio.read_paf_file(env["renamed"])
    bed = tmp_path / "spans.bed"
    with open(bed, "w") as fh:
        for i in range(len(t)):
            fh.write(f"{t.qname[i]}\t{t.qstart[i]}\t{t.qend[i]}\n")
            fh.write(f"{t.tname[i]}\t{t.tstart[i]}\t{t.tend[i]}\n")
    frags = tmp_path / "frags.fa"
    run("faffy", "extract", env["fasta"], "-i", str(bed), "-f", "100",
        "-o", str(frags))
    up = run_o("paffy", "upconvert", "-i", env["renamed"], str(frags),
               out=tmp_path / "up.paf")
    check(recorded, "upconvert/golden_fragments", up)
    # dechunk must restore the original (normalized) file byte-for-byte
    de = run_o("paffy", "dechunk", "-i", str(tmp_path / "up.paf"),
               out=tmp_path / "de.paf")
    assert de == pathlib.Path(env["renamed"]).read_bytes()
    check(recorded, "dechunk/roundtrip", de)


def test_faffy_extract_snapshot(env, recorded, tmp_path):
    bed_src = run_o("paffy", "to_bed", "-i", env["renamed"], "-m", "5000",
                    out=tmp_path / "cov.bed")
    lines = [ln.split() for ln in bed_src.decode().splitlines()]
    bed = tmp_path / "sel.bed"
    bed.write_text("".join(f"{c[0]}\t{c[1]}\t{c[2]}\n"
                           for c in lines[::7] if int(c[3]) > 0))
    check(recorded, "faffy_extract/flank50",
          run_o("faffy", "extract", env["fasta"], "-i", str(bed),
                "-f", "50", "-m", "200", out=tmp_path / "ex.fa"))
