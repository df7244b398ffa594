"""CLI audit: time every paffy/faffy subcommand against the compiled
reference binary on an N-fold golden workload, asserting byte-identical
output.

Methodology: a shared host's available bandwidth can swing minute to
minute, so the two binaries are timed INTERLEAVED (ref, ours, ref, ours,
...) and the min over iterations is reported for each.  Commands run with
PAFFY_TPU_PLATFORM=cpu (the host production routes; device routing is
bench.py's job).

All 16 commands are audited: the 13 paffy commands (dechunk/upconvert get
synthesized chunk-coordinate workloads, split_file a multi-contig demux
workload) and the 3 faffy commands.

Usage: python tools/cli_audit.py [--fold 16] [--iters 3] [--json]
                                 [--only cmd1,cmd2]
`--fold 64` is the startup-amortization row (see README): sub-second
commands are bounded below by ~0.3 s of interpreter+numpy startup at small
inputs; their ratios must approach/beat 1.0 as input grows.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools.refbuild.build import build_reference  # noqa: E402

def run_once(cmd, out_path, env) -> float:
    t0 = time.perf_counter()
    with open(out_path, "wb") as fh:
        subprocess.run(cmd, stdout=fh, stderr=subprocess.DEVNULL,
                       env=env, check=True)
    return time.perf_counter() - t0


def make_chunked_paf(text: str, fold: int, path: pathlib.Path) -> None:
    """Chunk-coordinate dechunk workload: each record becomes its own
    extracted fragment (name -> name|orig_len|start, coords rebased to the
    fragment), so dechunk must decode a distinct header per record and
    restore the original line (impl/paf_dechunk.c:24-38)."""
    out = []
    for ln in text.splitlines():
        f = ln.split("\t")
        qs, qe = int(f[2]), int(f[3])
        f[0] = f"{f[0]}|{f[1]}|{qs}"
        f[1], f[2], f[3] = str(qe - qs), "0", str(qe - qs)
        ts, te = int(f[7]), int(f[8])
        f[5] = f"{f[5]}|{f[6]}|{ts}"
        f[6], f[7], f[8] = str(te - ts), "0", str(te - ts)
        out.append("\t".join(f))
    blob = ("\n".join(out) + "\n").encode()
    path.write_bytes(blob * fold)


def make_fragment_fasta(text: str, seqs: dict[str, str],
                        path: pathlib.Path) -> None:
    """Extracted-fragment FASTA for the upconvert workload: each sequence is
    sliced into ~3 Mb fragments at cut points chosen OUTSIDE every record
    interval (a fragment-crossing alignment is an error on both sides), with
    name|seq_len|start headers (impl/paf_upconvert.c:27-33)."""
    busy: dict[str, list[tuple[int, int]]] = {nm: [] for nm in seqs}
    for ln in text.splitlines():
        f = ln.split("\t")
        if f[0] in busy:
            busy[f[0]].append((int(f[2]), int(f[3])))
        if f[5] in busy:
            busy[f[5]].append((int(f[7]), int(f[8])))
    with open(path, "w") as fh:
        for nm, s in seqs.items():
            ivs = sorted(busy[nm])
            merged: list[list[int]] = []
            for a, b in ivs:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            cuts = [0]
            want = 3_000_000
            while cuts[-1] + want < len(s):
                c = cuts[-1] + want
                for a, b in merged:
                    if a < c <= b:
                        c = b + 1
                        break
                if c >= len(s):
                    break
                cuts.append(c)
            cuts.append(len(s))
            for a, b in zip(cuts[:-1], cuts[1:]):
                fh.write(f">{nm}|{len(s)}|{a}\n{s[a:b]}\n")


def make_multicontig_paf(text: str, fold: int, path: pathlib.Path,
                         n_contigs: int = 24) -> None:
    """split_file demux workload: target names spread over n_contigs."""
    lines = text.splitlines()
    out = []
    for rep in range(fold):
        for i, ln in enumerate(lines):
            f = ln.split("\t")
            f[5] = f"{f[5]}_{(rep * len(lines) + i) % n_contigs}"
            out.append("\t".join(f))
    path.write_bytes(("\n".join(out) + "\n").encode())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fold", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of command names")
    ap.add_argument("--no-rss", action="store_true",
                    help="skip the peak-RSS measurement pass")
    args = ap.parse_args(argv)

    bins = build_reference()
    if bins is None:
        print("no toolchain / reference; cannot audit", file=sys.stderr)
        return 1
    repo = pathlib.Path(__file__).resolve().parent.parent
    ours = str(repo / "bin" / "paffy")

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cli_audit_"))
    # the seeded golden-shaped workload + its synthesized FASTA from
    # tests/goldenwork (the generator the snapshot/diff suites use)
    from paffy_tpu.core import pafio
    from tests.goldenwork import golden_paf, pool_seqs, synth_pool
    text = golden_paf().decode()
    work = tmp / f"g{args.fold}.paf"
    work.write_bytes(text.encode() * args.fold)
    seqs = pool_seqs(*synth_pool(pafio.parse_paf_text(text)))
    fa = tmp / "seqs.fa"
    with open(fa, "w") as fh:
        for nm, s in seqs.items():
            fh.write(f">{nm}\n{s}\n")
    chunked = tmp / "chunked.paf"
    make_chunked_paf(text, args.fold, chunked)
    frag_fa = tmp / "frags.fa"
    make_fragment_fasta(text, seqs, frag_fa)
    multic = tmp / "multic.paf"
    make_multicontig_paf(text, args.fold, multic)

    env = dict(os.environ, PAFFY_TPU_PLATFORM="cpu")
    empty = tmp / "empty.paf"
    empty.write_bytes(b"")
    # (label, subcommand, input file, extra argv) — every paffy command
    # that writes PAF/BED/text to stdout; the "startup" row (dedupe over
    # an empty file) isolates the fixed interpreter+import cost that every
    # sub-second ratio carries
    cases = [
        ("startup", "dedupe", empty, []),
        ("view", "view", work, ["-s", "-t", str(fa)]),
        # -s included: the reference's unconditional sanity assert
        # (impl/paf_view.c:196) divides 0/0 without -s and SIGABRTs on
        # EVERY plain view invocation (its own include.mk forces -UNDEBUG);
        # see README "Known divergences"
        ("view_a", "view", work, ["-a", "-s", str(fa)]),
        ("chain", "chain", work, []),
        ("tile", "tile", work, []),
        ("to_bed", "to_bed", work, []),
        ("invert", "invert", work, []),
        ("shatter", "shatter", work, []),
        ("dedupe", "dedupe", work, []),
        ("trim", "trim", work, []),
        ("filter", "filter", work, []),
        ("add_mismatches", "add_mismatches", work, [str(fa)]),
        ("dechunk", "dechunk", chunked, []),
        ("upconvert", "upconvert", work, [str(frag_fa)]),
    ]
    ours_f = str(repo / "bin" / "faffy")
    # faffy workloads: chunk the FASTA (dir compared), merge the reference's
    # own chunk list, extract a deterministic BED
    import random
    rnd = random.Random(4)
    bed = []
    for nm in ("q_chr10", "t_chr10"):
        p = 0
        while p < 8_000_000:
            p += rnd.randint(500, 5000)
            bed.append(f"{nm}\t{p}\t{p + rnd.randint(100, 1500)}")
    bedf = tmp / "ex.bed"
    bedf.write_text("\n".join(bed) + "\n")
    chunk_args = ["-c", "1000000", "-o", "10000", str(fa)]

    def run_chunk(binpath, who):
        d = tmp / f"chunk_{who}"
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        out = subprocess.run([binpath, "chunk", "-d", str(d)] + chunk_args,
                             capture_output=True, env=env, check=True)
        dt = time.perf_counter() - t0
        # filename-ordered concatenation: chunk dirs compare as one blob
        (tmp / f"{who}_faffy_chunk.out").write_bytes(
            b"".join(p.read_bytes() for p in sorted(d.iterdir())))
        if who == "ref":
            (tmp / "chunklist").write_bytes(out.stdout)
        return dt

    def run_split(binpath, who):
        d = tmp / f"split_{who}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
        t0 = time.perf_counter()
        subprocess.run([binpath, "split_file", "-i", str(multic),
                        "-p", str(d) + "/s_"],
                       capture_output=True, env=env, check=True)
        dt = time.perf_counter() - t0
        (tmp / f"{who}_split_file.out").write_bytes(
            b"".join(p.read_bytes() for p in sorted(d.iterdir())))
        return dt

    custom_cases = [("faffy_chunk", bins["faffy"], ours_f, run_chunk),
                    ("split_file", bins["paffy"], ours, run_split)]
    faffy_cases = [
        ("faffy_merge", lambda b: ["merge", "-i", str(tmp / "chunklist")]),
        ("faffy_extract", lambda b: ["extract", "-i", str(bedf), str(fa)]),
    ]
    only = set(args.only.split(",")) if args.only else None

    def want(name):
        return only is None or name in only
    rows = []
    results: dict[tuple[str, str], list[float]] = {}
    for it in range(args.iters):
        for name, sub, inp, extra in cases:
            if not want(name):
                continue
            for who, binpath in (("ref", bins["paffy"]), ("our", ours)):
                out = tmp / f"{who}_{name}.out"
                cmd = [binpath, sub, "-i", str(inp)] + extra
                results.setdefault((who, name), []).append(
                    run_once(cmd, out, env))
        for name, refbin, ourbin, fn in custom_cases:
            if not want(name):
                continue
            for who, binpath in (("ref", refbin), ("our", ourbin)):
                results.setdefault((who, name), []).append(fn(binpath, who))
        for name, argfn in faffy_cases:
            if not want(name):
                continue
            for who, binpath in (("ref", bins["faffy"]), ("our", ours_f)):
                out = tmp / f"{who}_{name}.out"
                results.setdefault((who, name), []).append(
                    run_once([binpath] + argfn(binpath), out, env))
    all_cases = ([n for n, _, _, _ in cases] + [n for n, *_ in custom_cases]
                 + [n for n, _ in faffy_cases])
    # peak-RSS pass (untimed): each side once under a rusage wrapper — the
    # streaming-memory claim (bounded batches vs the reference's whole-file
    # or whole-hash residency) measured, not asserted
    def peak_rss_mb(cmd) -> float:
        wrapper = ("import resource,subprocess,sys;"
                   "subprocess.run(sys.argv[1:],stdout=subprocess.DEVNULL,"
                   "stderr=subprocess.DEVNULL);"
                   "print(resource.getrusage(resource.RUSAGE_CHILDREN)"
                   ".ru_maxrss)")
        r = subprocess.run([sys.executable, "-S", "-c", wrapper] + cmd,
                           capture_output=True, env=env, text=True)
        try:
            return round(int(r.stdout.strip()) / 1024, 1)
        except ValueError:
            return -1.0
    rss: dict[tuple[str, str], float] = {}
    if not args.no_rss:
        for name, sub, inp, extra in cases:
            if not want(name):
                continue
            for who, binpath in (("ref", bins["paffy"]), ("our", ours)):
                rss[(who, name)] = peak_rss_mb(
                    [binpath, sub, "-i", str(inp)] + extra)
    for name in all_cases:
        if not want(name):
            continue
        r = min(results[("ref", name)])
        o = min(results[("our", name)])
        same = ((tmp / f"ref_{name}.out").read_bytes()
                == (tmp / f"our_{name}.out").read_bytes())
        row = {"cmd": name, "ref_s": round(r, 3),
               "ours_s": round(o, 3),
               "ratio": round(o / r, 2), "identical": same}
        if (("ref", name)) in rss:
            row["ref_rss_mb"] = rss[("ref", name)]
            row["ours_rss_mb"] = rss[("our", name)]
        rows.append(row)
    if args.json:
        print(json.dumps(rows))
    else:
        print(f"{'cmd':16s} {'ref':>7s} {'ours':>7s} {'ratio':>7s}  identical"
              f"  {'refMB':>7s} {'ourMB':>7s}")
        for row in rows:
            print(f"{row['cmd']:16s} {row['ref_s']:7.2f} {row['ours_s']:7.2f}"
                  f" {row['ratio']:6.2f}x  {str(row['identical']):5s}"
                  f" {row.get('ref_rss_mb', ''):>7} {row.get('ours_rss_mb', ''):>7}")
    bad = [r["cmd"] for r in rows if not r["identical"]]
    if bad:
        print(f"OUTPUT MISMATCH: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
