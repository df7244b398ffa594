"""Actually-executed multi-process pipeline: 2 real processes under
``jax.distributed`` (localhost coordinator, CPU backend, 4 virtual devices
each) running ``run_pipeline_multihost`` over a multi-contig workload.

This is the JAX form of the reference's concurrently-running shard
processes (its tests/paf_pipeline_test.sh:50-71): shards are
executed round-robin over processes, each shard's output is an atomically
written file, and process 0 concatenates in deterministic group order.
Asserted here:

  * the gathered output is byte-identical to a single-process run_pipeline
    (the barrier, the cross-process file gather, and the ``s % pcount``
    shard skip all execute for real);
  * re-running after one shard file is corrupted (a killed process's
    half-written shard) reproduces the same bytes — the atomic-write
    idempotence claim of parallel/distributed.py.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from paffy_tpu.core import pafio
from paffy_tpu.parallel.runner import run_pipeline
from synthdata import make_workload

REPO = pathlib.Path(__file__).resolve().parent.parent
N_PROC = 2
N_SHARDS = 4


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _launch(pid: int, port: int, args: list[str], log_path: pathlib.Path,
            n_proc: int = N_PROC):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PAFFY_TPU_PLATFORM"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PAFFY_TPU_COORDINATOR"] = f"localhost:{port}"
    env["PAFFY_TPU_NUM_PROCESSES"] = str(n_proc)
    env["PAFFY_TPU_PROCESS_ID"] = str(pid)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paffy_tpu.parallel.distributed", *args],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    proc._log = log  # keep the handle alive
    return proc


def _run_world(port: int, args: list[str], tmp: pathlib.Path, tag: str,
               n_proc: int = N_PROC, kill_pid: int | None = None,
               allow_fail: bool = False):
    procs = [_launch(pid, port, args, tmp / f"proc{pid}.{tag}.log", n_proc)
             for pid in range(n_proc)]
    try:
        if kill_pid is not None:
            import time
            time.sleep(2.0)            # mid-startup/mid-work kill
            procs[kill_pid].kill()
        for p in procs:
            try:
                p.wait(timeout=120 if kill_pid is not None else 600)
            except subprocess.TimeoutExpired:
                if kill_pid is None and not allow_fail:
                    raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p._log.close()
    logs = [(tmp / f"proc{pid}.{tag}.log").read_text()
            for pid in range(n_proc)]
    if allow_fail:
        return logs
    if any(p.returncode != 0 for p in procs):
        joined = "\n".join(logs)
        if "Failed to connect" in joined or "Address already in use" in joined:
            pytest.skip("localhost coordinator unavailable in this sandbox")
        raise AssertionError(
            "multi-process run failed:\n" +
            "\n---\n".join(f"[proc {i} rc={p.returncode}]\n{l}"
                           for i, (p, l) in enumerate(zip(procs, logs))))
    return logs


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    seqs, lines = make_workload(seed=11, length=16000, n_windows=16,
                                window=1800, step=950)
    (tmp / "in.paf").write_text("\n".join(lines) + "\n")
    with open(tmp / "seqs.fa", "w") as fh:
        for n, s in seqs.items():
            fh.write(f">{n}\n{s}\n")
    t = pafio.parse_paf_text((tmp / "in.paf").read_text())
    expected = pafio.serialize_paf(run_pipeline(t, seqs, n_shards=N_SHARDS))
    return tmp, expected


def test_two_process_pipeline_matches_single_process(workload):
    tmp, expected = workload
    out = tmp / "out.paf"
    args = [str(tmp / "in.paf"), str(tmp / "seqs.fa"), str(out),
            "--shards", str(N_SHARDS), "--workdir", str(tmp / "shards")]
    _run_world(_free_port(), args, tmp, "run1")

    assert out.exists(), "process 0 did not write the gathered output"
    assert out.read_text() == expected
    # both processes really executed shards: round-robin over N_SHARDS=4
    # contiguous groups means each process wrote >= 1 group file
    shard_files = sorted((tmp / "shards").glob("shard_*.paf"))
    assert len(shard_files) >= 2
    # probe files prove the shared-workdir fail-fast ran multi-process
    for pid in range(N_PROC):
        assert (tmp / "shards" / f".reach_p{pid}").exists()


def test_rerun_after_corrupted_shard_is_idempotent(workload):
    tmp, expected = workload
    out = tmp / "out2.paf"
    args = [str(tmp / "in.paf"), str(tmp / "seqs.fa"), str(out),
            "--shards", str(N_SHARDS), "--workdir", str(tmp / "shards2")]
    _run_world(_free_port(), args, tmp, "run2")
    assert out.read_text() == expected

    # simulate a killed process's torn shard file, then re-run the world
    victim = sorted((tmp / "shards2").glob("shard_*.paf"))[0]
    victim.write_text("garbage\tnot-a-paf\n")
    out.unlink()
    _run_world(_free_port(), args, tmp, "run3")
    assert out.read_text() == expected


N_PROC4 = 4
N_SHARDS7 = 7          # uneven: 7 shards round-robin over 4 processes


@pytest.fixture(scope="module")
def workload7(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp4")
    seqs, lines = make_workload(seed=13, length=22000, n_windows=21,
                                window=1700, step=1000)
    # spread the records over 7 query contigs (renamed copies of the
    # derived sequence) so the contig sharder really creates 7 groups
    out_lines = []
    for k, ln in enumerate(lines):
        f = ln.split("\t")
        if f[0] == "der.chr1":
            nm = f"der.chr1_{k % N_SHARDS7}"
            seqs.setdefault(nm, seqs["der.chr1"])
            f[0] = nm
        out_lines.append("\t".join(f))
    lines = out_lines
    (tmp / "in.paf").write_text("\n".join(lines) + "\n")
    with open(tmp / "seqs.fa", "w") as fh:
        for n, s in seqs.items():
            fh.write(f">{n}\n{s}\n")
    t = pafio.parse_paf_text((tmp / "in.paf").read_text())
    expected = pafio.serialize_paf(run_pipeline(t, seqs, n_shards=N_SHARDS7))
    return tmp, expected


def test_four_process_uneven_shards(workload7):
    """4 real processes, 7 shards: the s % pcount round-robin leaves
    process 3 with one shard and the others with two — gathered output
    byte-identical to single-process, every process provably executed."""
    tmp, expected = workload7
    out = tmp / "out4.paf"
    args = [str(tmp / "in.paf"), str(tmp / "seqs.fa"), str(out),
            "--shards", str(N_SHARDS7), "--workdir", str(tmp / "shards4")]
    _run_world(_free_port(), args, tmp, "p4run1", n_proc=N_PROC4)
    assert out.read_text() == expected
    for pid in range(N_PROC4):
        assert (tmp / "shards4" / f".reach_p{pid}").exists()
    # one file per contig group (7 renamed + 2 rc contigs = 9): 9 over 4
    # processes round-robins 3/2/2/2 — genuinely uneven work
    n_files = len(sorted((tmp / "shards4").glob("shard_*.paf")))
    assert n_files > N_PROC4 and n_files % N_PROC4 != 0, n_files


def test_killed_process_world_rerun(workload7):
    """One process killed MID-RUN (not just a torn file): the surviving
    world cannot complete (the coordination barrier never clears), and a
    fresh rerun over the same workdir is idempotent — partial shard files
    from the dead world are either reused (valid) or rewritten."""
    tmp, expected = workload7
    out = tmp / "out5.paf"
    args = [str(tmp / "in.paf"), str(tmp / "seqs.fa"), str(out),
            "--shards", str(N_SHARDS7), "--workdir", str(tmp / "shards5")]
    _run_world(_free_port(), args, tmp, "p4kill", n_proc=N_PROC4,
               kill_pid=3, allow_fail=True)
    # the dead world must not have produced a (complete) gathered output
    # that we then trust blindly — rerun and require the exact bytes
    if out.exists():
        out.unlink()
    _run_world(_free_port(), args, tmp, "p4rerun", n_proc=N_PROC4)
    assert out.read_text() == expected
