#!/usr/bin/env python3
"""Smoke run of paffy-tpu's device path on an NVIDIA GPU.

Drives the main path once at the golden chromosome-pair scale
(tests/goldenwork.py: 207 records, ~1.25e8 M columns over a 130 Mb + 134 Mb
pair; shattered, ~185k records) through the entry points a user calls, and
checks every result exactly against its host reference.  Phases:

  card      nvidia-smi name and power limit; JAX must report a GPU.
  cli       ``bin/paffy view -s -t`` and ``bin/paffy tile`` (shattered
            input) at 1x and 16x, byte-compared with the same command
            pinned to the CPU (PAFFY_TPU_PLATFORM=cpu); prints the counts
            router's route.  Runs before this process imports JAX, so one
            process holds the card at a time.
  kernels   every compare kernel, the tile scan and the chain scan as
            compiled for the card, each compared exactly with the native C
            result (integer counts: zero tolerance); prints compile time,
            steady time, memory analysis and peak device memory.
  pipeline  parallel.runner.pipeline_stage on the shattered input,
            byte-compared with the same stage in a CPU-pinned child.
  four      (``--four`` only, and then alone) sharded_pipeline_stage on
            4-card meshes (2,2) and (4,1), byte-equal to pipeline_stage,
            and column_counts_multichip at golden scale equal to the native
            counts, with each result spread over all four cards.

Usage: ``python chip_smoke.py [--four]``.  A failed phase ends the run with
a non-zero exit and no result line; so does a machine where JAX finds no
GPU.  The last stdout line is ``{"ok": true, "device": {...}}``;
measurements also go to ``chiprun_out/chip_smoke[_four].json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REP = 16                     # replication of the large CLI input
SEED = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The run's last stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def phases(four: bool) -> tuple[str, ...]:
    """Phases a run executes, in order (``card`` always comes first)."""
    return ("card", "four") if four else ("card", "cli", "kernels",
                                          "pipeline")


def card_info() -> list[str]:
    """nvidia-smi's name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi lists no GPU")
    return lines


# ----------------------------------------------------------------- workload

class Workload:
    """The golden-shaped input, its shattered form and their files."""

    def __init__(self, work: str, scale: float = 1.0):
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        sys.path.insert(0, ROOT)
        from goldenwork import golden_paf, synth_pool, write_fasta
        from paffy_tpu.core import pafio
        from paffy_tpu.ops.transforms import shatter
        t0 = time.perf_counter()
        data = golden_paf(scale, seed=SEED)
        self.t = pafio.parse_paf_data(data)
        self.s = shatter(self.t)
        shat = bytes(pafio.serialize_paf_bytes(self.s))
        self.pool, self.index = synth_pool(self.t, seed=SEED)
        self.files = {"golden": os.path.join(work, "golden.paf"),
                      "golden16": os.path.join(work, "golden16.paf"),
                      "shattered": os.path.join(work, "shattered.paf"),
                      "shattered16": os.path.join(work, "shattered16.paf"),
                      "fasta": os.path.join(work, "seqs.fa")}
        for key, blob in (("golden", data), ("golden16", data * REP),
                          ("shattered", shat), ("shattered16", shat * REP)):
            with open(self.files[key], "wb") as fh:
                fh.write(blob)
        write_fasta(self.files["fasta"], self.pool, self.index)
        n_cols = int(self.t.lens[self.t.ops == 0].sum())
        log(f"workload: {len(self.t)} records, {len(self.t.ops)} ops, "
            f"{n_cols} M columns; shattered {len(self.s)} records; "
            f"built in {time.perf_counter() - t0:.1f}s")

    def seqs(self, pool=None):
        from goldenwork import pool_seqs
        return pool_seqs(self.pool if pool is None else pool, self.index)


# ---------------------------------------------------------------------- cli

def _run_cli(argv: list[str], out: str, cpu: bool) -> tuple[float, str]:
    env = dict(os.environ)
    if cpu:
        env["PAFFY_TPU_PLATFORM"] = "cpu"
    t0 = time.perf_counter()
    r = subprocess.run([os.path.join(ROOT, "bin", "paffy"), *argv,
                        "-o", out, "-l", "debug"], env=env,
                       capture_output=True, text=True, timeout=900)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"paffy {' '.join(argv)} exited {r.returncode}:"
                           f"\n{r.stderr[-4000:]}")
    routes = [ln for ln in r.stderr.splitlines()
              if ln.startswith("counts route:")]
    return dt, "; ".join(routes)


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _launcher_backend() -> str:
    """JAX's default backend as seen through bin/paffy-py's own interpreter
    set-up (``python3 -S`` plus its site-directory search): the check that
    the launcher finds JAX's CUDA plug-in."""
    launcher = os.path.join(ROOT, "bin", "paffy-py")
    with open(launcher) as fh:
        setup = fh.read().split("from paffy_tpu.cli")[0]
    code = (f"__file__ = {launcher!r}\n" + setup
            + "import jax\nprint(jax.default_backend())\n")
    r = subprocess.run(["python3", "-S", "-c", code], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"launcher set-up cannot start JAX:\n"
                           f"{r.stderr[-2000:]}")
    return r.stdout.split()[-1]


def phase_cli(w: Workload, work: str, rec: dict) -> None:
    from paffy_tpu.ops.mismatch import device_route_wins
    backend = _launcher_backend()
    log(f"cli launcher (python3 -S) sees JAX backend {backend!r}")
    if backend != "gpu":
        raise RuntimeError("the -S launcher does not find the CUDA plug-in")
    n_cols = int(w.t.lens[w.t.ops == 0].sum())
    f = w.files
    runs = [("view", "1x", ["view", "-i", f["golden"], "-s", "-t",
                            f["fasta"]]),
            ("view", f"{REP}x", ["view", "-i", f["golden16"], "-s", "-t",
                                 f["fasta"]]),
            ("tile", "1x", ["tile", "-i", f["shattered"]]),
            ("tile", f"{REP}x", ["tile", "-i", f["shattered16"]])]
    for cmd, size, argv in runs:
        dev_out = os.path.join(work, f"{cmd}{size}.gpu")
        cpu_out = os.path.join(work, f"{cmd}{size}.cpu")
        dev_s, route = _run_cli(argv, dev_out, cpu=False)
        cpu_s, _ = _run_cli(argv, cpu_out, cpu=True)
        same = _digest(dev_out) == _digest(cpu_out)
        log(f"cli {cmd} {size}: {os.path.getsize(dev_out)} bytes, "
            f"gpu process {dev_s:.2f}s, cpu-pinned {cpu_s:.2f}s, "
            f"byte-identical={same}" + (f"; {route}" if route else ""))
        rec[f"cli_{cmd}_{size}"] = {"gpu_process_s": dev_s,
                                    "cpu_pinned_s": cpu_s, "route": route}
        if not same:
            raise RuntimeError(f"{cmd} {size}: GPU output differs from CPU")
        if cmd == "view":
            cols = n_cols * (REP if size != "1x" else 1)
            want = ("device_2bit" if device_route_wins(cols)
                    else "native_mt")
            if not route.startswith(f"counts route: {want} "):
                raise RuntimeError(f"view {size}: route {route!r}, the "
                                   f"measured rates predict {want}")


# ------------------------------------------------------------------ kernels

def _measure(name: str, jitted, args, statics=None, rec=None):
    """Compile ``jitted`` for ``args``, run it once to warm up and three
    times timed (host clock around block_until_ready); returns the output
    of the last run."""
    import jax
    statics = statics or {}
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **statics).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    ma = compiled.memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"  {name}: compile {compile_s:.2f}s, steady {min(times)*1e3:.2f} ms "
        f"(min of 3), memory_analysis {mem}, peak_bytes_in_use {peak}")
    if rec is not None:
        rec[name] = {"compile_s": compile_s, "steady_s": min(times),
                     "times_s": times, "memory": mem, "peak_bytes": peak}
    return out


def _expect_equal(name: str, got, want) -> None:
    import numpy as np
    for g, e in zip(got, want):
        g = np.asarray(g).astype(np.int64)[: len(e)]
        if not np.array_equal(g, e):
            bad = int(np.flatnonzero(g != e)[0])
            raise RuntimeError(f"{name}: record {bad}: {g[bad]} != {e[bad]}")
    log(f"  {name}: equal to the native counts")


def _best_of(fn, n=3) -> float:
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _compare_kernels(w: Workload, rec: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from paffy_tpu import native
    from paffy_tpu.ops import tiled
    from paffy_tpu.ops.mismatch import SequencePool
    from paffy_tpu.ops.segments import build_m_column_batch

    t = w.t
    n = len(t)

    def batch(pool, tb=t):
        b = build_m_column_batch(tb, pool.offsets_for(tb.qname, "query"),
                                 pool.offsets_for(tb.tname, "target"))
        args = (pool.host_pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops],
                b.tpos0[: b.n_mops], b.rev[: b.n_mops], b.rec[: b.n_mops],
                len(tb))
        return b, args

    # ---- 2-bit, on the ACGT pool
    pool = SequencePool(w.seqs())
    b, nargs = batch(pool)
    ref = native.column_compare_counts(*nargs)
    st = _best_of(lambda: native.column_compare_counts(*nargs), 1)
    mt = _best_of(lambda: native.column_compare_counts_mt(*nargs))
    rec["native_single_thread_s"] = st
    rec["native_threaded_s"] = mt
    rec["n_cols"] = b.n_cols
    rec["n_mops"] = b.n_mops
    log(f"  native counts ({b.n_cols} columns): single thread {st:.3f}s, "
        f"threaded ({native._default_threads(None)} threads) {mt:.3f}s")
    plen = pool.pool_len
    t0 = time.perf_counter()
    packed2d, pviews = jax.block_until_ready(pool.packed2)
    log(f"  pool upload + ext + 2-bit pools: "
        f"{time.perf_counter() - t0:.2f}s")
    cb = tiled.build_packed2_chunk_batch(b, n, plen)
    flat_args = tuple(jax.device_put(a) for a in (
        packed2d, pviews, cb.trow, cb.qwin, cb.qpar, cb.col_a, cb.col_b,
        cb.rec_chunk_off))
    got = _measure("2bit", tiled._packed2_match_counts, flat_args, rec=rec)
    _expect_equal("2bit", got, ref)
    # the counts router's rates: device route (host grid build + upload +
    # kernel + readback) against the threaded native pass, at 1x and 16x
    from paffy_tpu.core import pafio
    with open(w.files["golden16"], "rb") as fh:
        t16 = pafio.parse_paf_data(fh.read())
    for size, tb in (("1x", t), (f"{REP}x", t16)):
        bb, bargs = batch(pool, tb)
        tn = _best_of(lambda: native.column_compare_counts_mt(*bargs))
        tiled.packed2_match_counts(packed2d, pviews, bb, len(tb), plen)
        td = _best_of(lambda: tiled.packed2_match_counts(
            packed2d, pviews, bb, len(tb), plen))
        tg = _best_of(lambda: tiled.build_packed2_chunk_batch(
            bb, len(tb), plen))
        rec[f"router_{size}"] = {"n_cols": bb.n_cols, "native_mt_s": tn,
                                 "device_route_s": td, "grid_build_s": tg}
        log(f"  router rates {size} ({bb.n_cols} columns): native threaded "
            f"{tn*1e3:.1f} ms, device route {td*1e3:.1f} ms (of which "
            f"host grid build {tg*1e3:.1f} ms)")
    tiny = jax.jit(lambda v: v + 1)
    one = jnp.zeros(4, jnp.int32)
    np.asarray(tiny(one))
    rt = _best_of(lambda: np.asarray(tiny(one)), 20)
    rec["dispatch_roundtrip_s"] = rt
    log(f"  dispatch + fetch roundtrip {rt*1e6:.0f} us")
    pool.drop_device_caches("")
    del pool, flat_args

    # ---- 4-bit, on the same pool with N gaps injected
    rng = np.random.default_rng(SEED)
    pool_n = w.pool.copy()
    for nm, (o, ln) in w.index.items():
        for s0 in rng.integers(0, ln - 20_000, 100):
            pool_n[o + s0: o + s0 + int(rng.integers(100, 20_000))] = ord("N")
    pool = SequencePool(w.seqs(pool_n))
    del pool_n
    if pool.has_exotic or not pool.has_exotic2:
        raise RuntimeError("N-gapped pool did not select the 4-bit kernel")
    b, nargs = batch(pool)
    ref = native.column_compare_counts_mt(*nargs)
    packed2d, pviews = pool.packed
    cb = tiled.build_packed_chunk_batch(b, n, pool.pool_len)
    args = tuple(jax.device_put(a) for a in (
        packed2d, pviews, cb.trow, cb.qwin, cb.qpar, cb.col_a, cb.col_b,
        cb.rec_chunk_off))
    got = _measure("4bit", tiled._packed_match_counts, args, rec=rec)
    _expect_equal("4bit", got, ref)
    pool.drop_device_caches("")
    del pool, args

    # ---- unpacked ext, with one non-IUPAC byte injected
    pool_x = w.pool.copy()
    o, ln = w.index["q_chr10"]
    pool_x[o + ln // 2] = ord("X")
    pool = SequencePool(w.seqs(pool_x))
    del pool_x
    if not pool.has_exotic:
        raise RuntimeError("X-injected pool did not select the ext kernel")
    b, nargs = batch(pool)
    ref = native.column_compare_counts_mt(*nargs)
    ext = pool.ext
    cb = tiled.build_chunk_batch(b, n, pool_len=ext.shape[0] // 2)
    args = (tiled._ext2d(ext), tiled.build_ext_phase_views(ext)) + tuple(
        jax.device_put(a) for a in (cb.trow, cb.qwin_lo, cb.lane_a,
                                    cb.lane_b, cb.rec_chunk_off))
    got = _measure("ext", tiled._tiled_match_counts, args, rec=rec)
    _expect_equal("ext", got, ref)
    pool.drop_device_caches("")
    del pool, args, ext


def _tile_scan(w: Workload, rec: dict) -> None:
    import jax
    import numpy as np
    from paffy_tpu.ops import tile
    from paffy_tpu.ops.coverage import match_intervals
    from paffy_tpu.ops.segments import bucket_size
    from paffy_tpu.ops.tile_device import _tile_scan as scan

    s = w.s
    n = len(s)
    order = tile.tile_sort_order(s)
    rec_i, istart, iend = match_intervals(s)
    host = tile._assign_tile_levels_host(s, order, rec_i, istart, iend)
    host_s = _best_of(lambda: tile._assign_tile_levels_host(
        s, order, rec_i, istart, iend))
    seg_of, off_in, seg_sizes = tile._sequence_offsets(s)
    if len(seg_sizes) != 1 or set(off_in.values()) != {0}:
        raise RuntimeError("shattered golden input spans several segments")
    runs = np.bincount(rec_i, minlength=n)
    k_b = bucket_size(max(int(runs.max()), 1), minimum=8)
    span_b = bucket_size(int(np.max(s.qend - s.qstart)), minimum=128)
    lmax = min(bucket_size(n + 2, minimum=64), 32768)
    total_b = max(-(-seg_sizes[0] // (1 << 20)) * (1 << 20), 1 << 16)
    iv_s, iv_e = tile._pack_intervals(order, n, rec_i, istart, iend,
                                      s.qstart, span_b, k_b)
    args = tuple(jax.device_put(a) for a in (s.qstart[order], iv_s, iv_e))
    got = _measure("tile_scan", scan, args,
                   statics=dict(span=span_b, lmax=lmax, total=total_b),
                   rec=rec)
    if not np.array_equal(np.asarray(got), host[order]):
        raise RuntimeError("tile scan levels differ from the host sweep")
    rec["tile_host_s"] = host_s
    log(f"  tile_scan: {n} steps over span {span_b}: levels equal to the "
        f"host sweep ({host_s*1e3:.1f} ms); work "
        f"{tile._scan_work(n, span_b, lmax):.3g} element-passes")


def _chain_scan(w: Workload, rec: dict) -> None:
    import jax
    import numpy as np
    from paffy_tpu import native
    from paffy_tpu.ops.chain import _window_bounds, paf_chain
    from paffy_tpu.ops.chain_device import _dp_scan_groups, build_bucket_args

    groups = []

    def capture(gs, go, ge, mg):
        groups.extend(gs)
        return [(np.zeros(len(g[0]), np.int64), np.full(len(g[0]), -1))
                for g in gs]

    paf_chain(w.s, dp_many=capture, check=False)
    go, ge, mg = 5000, 1, 1_000_000
    wins = [_window_bounds(g[0], g[1], mg) for g in groups]

    def host_dp(gs):
        return [native.chain_dp(*g, *wb, go, ge, mg) for g, wb in zip(gs, wins)]

    host_s = _best_of(lambda: host_dp(groups))
    rec["chain_host_s"] = host_s
    log(f"  chain groups {[len(g[0]) for g in groups]}: native DP "
        f"{host_s*1e3:.1f} ms")
    # the int32 recurrence needs every chain total < 2^31; shattered
    # fragments inherit their record's score, so divide the scores until
    # the largest group total fits (both sides get the same inputs)
    div = max(1, -(-max(int(g[4].sum()) for g in groups) // (1 << 30)))
    for dt, label in ((np.int64, "int64"), (np.int32, "int32")):
        gs = groups if dt is np.int64 else [g[:4] + (g[4] // div,)
                                            for g in groups]
        host = host_dp(gs)
        for size in sorted({len(g[0]) for g in gs}):
            sub = [gi for gi, g in enumerate(gs) if len(g[0]) == size]
            args_np, n_pad, w_pad = build_bucket_args(
                [gs[gi] for gi in sub], mg, dtype=dt)
            args = tuple(jax.device_put(a) for a in args_np) + (
                dt(go), dt(ge), dt(mg))
            name = f"chain_scan_{label}_n{size}"
            cs, pred = _measure(name, _dp_scan_groups, args,
                                statics=dict(n_pad=n_pad, w_pad=w_pad),
                                rec=rec)
            cs, pred = np.asarray(cs), np.asarray(pred)
            for k, gi in enumerate(sub):
                hc, hp = host[gi]
                if not (np.array_equal(cs[k, :size], hc)
                        and np.array_equal(pred[k, :size], hp)):
                    raise RuntimeError(f"{name} differs from native.chain_dp")
            log(f"  {name}: equal to native.chain_dp (w_pad {w_pad}"
                + (f", scores / {div}" if dt is np.int32 else "") + ")")


def phase_kernels(w: Workload, work: str, rec: dict) -> None:
    _compare_kernels(w, rec)
    _tile_scan(w, rec)
    _chain_scan(w, rec)


# ----------------------------------------------------------------- pipeline

_STAGE_CHILD = """
import pathlib, sys
sys.path.insert(0, {root!r})
from paffy_tpu.core import pafio
from paffy_tpu.ops.mismatch import SequencePool
from paffy_tpu.parallel.runner import pipeline_stage
s = pafio.parse_paf_data(pathlib.Path({paf!r}).read_bytes())
pool = SequencePool.from_fasta_files([{fasta!r}])
pathlib.Path({out!r}).write_bytes(bytes(pafio.serialize_paf_bytes(
    pipeline_stage(s, pool))))
"""


def phase_pipeline(w: Workload, work: str, rec: dict) -> None:
    from paffy_tpu.core import pafio
    from paffy_tpu.ops.mismatch import SequencePool
    from paffy_tpu.parallel.runner import pipeline_stage
    pool = SequencePool.from_fasta_files([w.files["fasta"]])
    t0 = time.perf_counter()
    got = bytes(pafio.serialize_paf_bytes(pipeline_stage(w.s, pool)))
    dev_s = time.perf_counter() - t0
    out = os.path.join(work, "stage.cpu")
    env = dict(os.environ, PAFFY_TPU_PLATFORM="cpu")
    code = _STAGE_CHILD.format(root=ROOT, paf=w.files["shattered"],
                               fasta=w.files["fasta"], out=out)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=900)
    with open(out, "rb") as fh:
        same = fh.read() == got
    rec["pipeline_stage_s"] = dev_s
    log(f"pipeline_stage ({len(w.s)} shattered records): {dev_s:.2f}s, "
        f"{len(got)} bytes, equal to the CPU-pinned stage={same}")
    if not same:
        raise RuntimeError("pipeline_stage differs from the CPU-pinned run")


# --------------------------------------------------------------------- four

def phase_four(w: Workload, work: str, rec: dict) -> None:
    import jax
    import numpy as np
    from paffy_tpu import native
    from paffy_tpu.core import pafio
    from paffy_tpu.ops.mismatch import SequencePool
    from paffy_tpu.parallel.pipeline import (make_mesh, shard_records,
                                             sharded_view_stats)
    from paffy_tpu.parallel.runner import (pipeline_stage,
                                           sharded_pipeline_stage)
    from paffy_tpu.ops.segments import build_m_column_batch
    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    pool = SequencePool(w.seqs())
    t0 = time.perf_counter()
    ref = bytes(pafio.serialize_paf_bytes(pipeline_stage(w.s, pool)))
    log(f"pipeline_stage ({len(w.s)} records): "
        f"{time.perf_counter() - t0:.2f}s")
    for dp, sp in ((2, 2), (4, 1)):
        mesh = make_mesh(devs, dp=dp, sp=sp)
        t0 = time.perf_counter()
        got = bytes(pafio.serialize_paf_bytes(
            sharded_pipeline_stage(w.s, pool, mesh)))
        dt = time.perf_counter() - t0
        rec[f"sharded_pipeline_{dp}x{sp}_s"] = dt
        log(f"sharded_pipeline_stage mesh ({dp},{sp}): {dt:.2f}s, "
            f"byte-equal={got == ref}")
        if got != ref:
            raise RuntimeError(f"sharded pipeline ({dp},{sp}) differs")

        t = w.t
        b = shard_records(t, pool, mesh.shape["data"])
        t0 = time.perf_counter()
        m, x, totals = jax.block_until_ready(
            sharded_view_stats(mesh, pool.ext, b))
        dt = time.perf_counter() - t0
        spread = {len(a.sharding.device_set) for a in (m, x)}
        if spread != {4}:
            raise RuntimeError(f"mesh ({dp},{sp}): counts live on "
                               f"{spread} devices, not 4")
        b1 = build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                  pool.offsets_for(t.tname, "target"))
        want = native.column_compare_counts_mt(
            pool.host_pool, b1.lens[: b1.n_mops], b1.qpos0[: b1.n_mops],
            b1.tpos0[: b1.n_mops], b1.rev[: b1.n_mops],
            b1.rec[: b1.n_mops], len(t))
        got_m = np.asarray(m)[b.group_of_record, b.index_in_group]
        got_x = np.asarray(x)[b.group_of_record, b.index_in_group]
        if not (np.array_equal(got_m, want[0])
                and np.array_equal(got_x, want[1])):
            raise RuntimeError(f"multichip counts ({dp},{sp}) differ")
        rec[f"multichip_counts_{dp}x{sp}_first_call_s"] = dt
        log(f"column_counts_multichip mesh ({dp},{sp}): {int(b.n_cols.sum())}"
            f" columns over 4 devices, first call {dt:.2f}s, equal to the "
            f"native counts")


# --------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    a = ap.parse_args(argv)
    # this process, and every CLI child that is not pinned to the CPU, must
    # run on the card: a CUDA start-up failure is an error, not a CPU run
    os.environ["JAX_PLATFORMS"] = "cuda"
    plan = phases(a.four)
    cards = card_info()
    for line in cards:
        log(f"card: {line}")
    rec: dict = {"cards": cards, "phases": list(plan)}
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
        w = Workload(work)
        if "cli" in plan:
            t0 = time.perf_counter()
            phase_cli(w, work, rec)
            log(f"phase cli: {time.perf_counter() - t0:.1f}s")
        import jax
        from paffy_tpu.jaxconf import ensure_jax
        ensure_jax()
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise RuntimeError(f"JAX platform is {dev.platform}, not gpu")
        log(f"jax {jax.__version__}: {len(jax.devices())} x "
            f"{dev.device_kind}")
        for name, fn in (("kernels", phase_kernels),
                         ("pipeline", phase_pipeline),
                         ("four", phase_four)):
            if name in plan:
                t0 = time.perf_counter()
                fn(w, work, rec)
                log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_four.json" if a.four
                           else "chip_smoke.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
