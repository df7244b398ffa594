"""Seeded golden-shaped workload: a chromosome-pair PAF with the shape of the
reference's human_chimp.paf test file, plus sequences written through it.

The golden file aligns chimp chr10 (query, 129,809,613 bp) to human chr10
(target, 133,797,422 bp): 207 records, ~370k cigar ops and ~1.25e8 M
columns, M runs with a median of ~421 bp separated by 1-8 bp indels.  The
generator reproduces that shape from a seed — record count, run-length
distribution, both strands (about a quarter reverse: assumed), collinear
placement with small overlaps between neighbouring records — with the
sequences renamed ``q_chr10``/``t_chr10`` so FASTA-consuming commands can
key them by name.  ``scale`` shrinks the chromosome lengths and column
count (the record count and the run-length distribution stay), so CPU tests
build a small instance of the same shape.

Sequences: uniform random target bases; query bases are written through the
alignment map by the native ``synth_query_pool`` pass, keeping the target
base with probability KEEP_PER_MILLE/1000 and drawing a random base
otherwise, so the column identity is ~0.965 (a random draw matches a
quarter of the time).
"""

from __future__ import annotations

import pathlib

import numpy as np

Q_NAME, T_NAME = "q_chr10", "t_chr10"
Q_LEN, T_LEN = 129_809_613, 133_797_422
N_RECORDS = 207
M_COLUMNS = 125_000_000
MEDIAN_M_RUN = 421
# lognormal M runs: median 421 and mean ~676 (1.25e8 columns / ~185k runs)
M_RUN_SIGMA = 0.973
REVERSE_FRACTION = 0.25
KEEP_PER_MILLE = 953            # identity 0.953 + 0.047/4 ~= 0.965
SEED = 7


def golden_paf(scale: float = 1.0, seed: int = SEED) -> bytes:
    """PAF bytes of the golden-shaped chromosome pair at ``scale``."""
    rng = np.random.default_rng(seed)
    qlen = max(int(Q_LEN * scale), 1 << 16)
    tlen = max(int(T_LEN * scale), 1 << 16)
    n = N_RECORDS
    w = rng.lognormal(0.0, 1.0, n)
    cols = w / w.sum() * (M_COLUMNS * scale)
    mean_run = MEDIAN_M_RUN * np.exp(M_RUN_SIGMA ** 2 / 2)
    n_runs = np.maximum(1, np.rint(cols / mean_run)).astype(np.int64)
    r = int(n_runs.sum())
    mlen = np.maximum(1, np.rint(rng.lognormal(np.log(MEDIAN_M_RUN),
                                               M_RUN_SIGMA, r))).astype(np.int64)
    glen = rng.integers(1, 9, r)
    is_ins = rng.random(r) < 0.5
    run_end = np.cumsum(n_runs)
    glen[run_end - 1] = 0                      # no gap after a record's last run
    rec = np.repeat(np.arange(n), n_runs)
    qspan = np.bincount(rec, mlen + np.where(is_ins, glen, 0), n)
    tspan = np.bincount(rec, mlen + np.where(is_ins, 0, glen), n)

    # collinear placement in a random order along both chromosomes: the
    # slack between records is spread at random, and about a third of the
    # records overlap their predecessor by up to 5% of the shorter span
    order = rng.permutation(n)

    def place(span, length):
        s = span[order]
        gaps = rng.random(n)
        gaps = gaps / gaps.sum() * max(length - int(s.sum()), 0) * 0.9
        start = np.concatenate([[0], np.cumsum(s)[:-1]]) + np.cumsum(gaps)
        prev = np.concatenate([[0], s[:-1]])
        lap = np.where(rng.random(n) < 0.33,
                       rng.random(n) * 0.05 * np.minimum(s, prev), 0)
        start = np.maximum(start - lap, 0).astype(np.int64)
        out = np.empty(n, dtype=np.int64)
        out[order] = start
        return out

    qstart = place(qspan, qlen)
    tstart = place(tspan, tlen)
    reverse = rng.random(n) < REVERSE_FRACTION
    mcols = np.bincount(rec, mlen, n).astype(np.int64)
    score = mcols - 30 * (n_runs - 1) - np.bincount(rec, glen, n).astype(np.int64)

    gap_op = np.where(is_ins, "I", "D")
    tokens = [f"{m}M{g}{o}" if g else f"{m}M"
              for m, g, o in zip(mlen.tolist(), glen.tolist(), gap_op.tolist())]
    bounds = np.concatenate([[0], run_end]).tolist()
    lines = []
    for i in range(n):
        cigar = "".join(tokens[bounds[i]: bounds[i + 1]])
        qs, ts = int(qstart[i]), int(tstart[i])
        lines.append(
            f"{Q_NAME}\t{qlen}\t{qs}\t{qs + int(qspan[i])}\t"
            f"{'-' if reverse[i] else '+'}\t{T_NAME}\t{tlen}\t{ts}\t"
            f"{ts + int(tspan[i])}\t{int(mcols[i])}\t"
            f"{int(qspan[i] + tspan[i] - mcols[i])}\t60\ttp:A:P\t"
            f"AS:i:{int(score[i])}\tcg:Z:{cigar}\n")
    return "".join(lines).encode()


def synth_pool(t, seed: int = SEED):
    """Sequences for table ``t`` (every name it uses, lengths from its
    qlen/tlen columns) as one uint8 pool with SequencePool's guards.

    Returns (pool, index) with index[name] = (offset into pool, length).
    Returns None without the native toolchain."""
    from paffy_tpu import native
    from paffy_tpu.ops.segments import (build_m_column_batch, POOL_GUARD,
                                        POOL_W)
    sizes: dict[str, int] = {}
    for nm, ln in zip(np.concatenate([t.qname, t.tname]).tolist(),
                      np.concatenate([t.qlen, t.tlen]).tolist()):
        sizes.setdefault(nm, int(ln))
    names = list(sizes)
    offs = np.concatenate([[0], np.cumsum([sizes[nm] for nm in names])])
    offs = offs + POOL_GUARD
    index = {nm: (int(offs[k]), sizes[nm]) for k, nm in enumerate(names)}
    qoff = np.array([index[nm][0] for nm in t.qname.tolist()], dtype=np.int64)
    toff = np.array([index[nm][0] for nm in t.tname.tolist()], dtype=np.int64)
    pool_size = -(-(int(offs[-1]) + POOL_GUARD + 2 * POOL_W) // POOL_W) * POOL_W
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=pool_size, dtype=np.uint8)]
    b = build_m_column_batch(t, qoff, toff)
    if not native.synth_query_pool(pool, b.lens[: b.n_mops],
                                   b.qpos0[: b.n_mops], b.tpos0[: b.n_mops],
                                   b.rev[: b.n_mops],
                                   keep_per_mille=KEEP_PER_MILLE, seed=seed):
        return None
    return pool, index


def pool_seqs(pool: np.ndarray, index) -> dict[str, str]:
    """{name: sequence} view of a synth_pool result (for SequencePool)."""
    return {nm: pool[o: o + ln].tobytes().decode("latin-1")
            for nm, (o, ln) in index.items()}


def write_fasta(path, pool: np.ndarray, index) -> None:
    """One unwrapped line per sequence, straight from the pool bytes."""
    with open(path, "wb") as fh:
        for nm, (o, ln) in index.items():
            fh.write(b">" + nm.encode() + b"\n")
            fh.write(memoryview(pool[o: o + ln]))
            fh.write(b"\n")


SNAPSHOT_SCALE = 0.02      # 207 records over a ~2.6 Mb + ~2.7 Mb pair


def write_workspace(d, scale: float = SNAPSHOT_SCALE):
    """The snapshot suites' shared files in directory ``d``: golden.paf (as
    generated), renamed.paf (its normalized parse -> serialize form, the
    target of round-trip comparisons) and seqs.fa.  Returns their paths,
    or None without the native toolchain."""
    from paffy_tpu.core import pafio
    d = pathlib.Path(d)
    data = golden_paf(scale=scale)
    t = pafio.parse_paf_data(data)
    res = synth_pool(t)
    if res is None:
        return None
    (d / "golden.paf").write_bytes(data)
    (d / "renamed.paf").write_text(pafio.serialize_paf(t))
    write_fasta(d / "seqs.fa", *res)
    return {"dir": d, "golden": str(d / "golden.paf"),
            "renamed": str(d / "renamed.paf"), "fasta": str(d / "seqs.fa")}
