"""Multi-host execution of the fused pipeline.

The reference's distributed form is shell-level: ``paffy split_file`` shards
per contig, each shard's ``add_mismatches | chain | tile | trim`` pipeline
runs as a background job, and the outputs ``cat`` together in shard order
(tests/paf_pipeline_test.sh:50-71 of the reference).  The JAX
equivalent keeps that file-grained failure/recovery model but replaces the
process pool with a JAX multi-host runtime:

  * ``initialize_from_env`` brings up ``jax.distributed`` (one process per
    host, env-gated — a no-op on single-host runs, so every entry point
    works unchanged on one machine).
  * ``run_pipeline_multihost`` assigns contig shards round-robin over
    processes, runs each local shard's fused stage over the host's local
    device mesh (sharded_pipeline_stage), writes one PAF per shard group,
    barriers, and has process 0 concatenate in deterministic group order —
    the ``cat`` step.

Within a host the shard's device dispatches ride the local (data, seq) mesh
(parallel/pipeline.make_mesh over ``jax.local_devices()``); across hosts the
only communication is the final file gather, mirroring the reference's
share-nothing shard model (SURVEY.md section 2.6 P6).

CLI: ``python -m paffy_tpu.parallel.distributed in.paf seqs.fa out.paf
[--shards N] [--workdir D]`` — run once per host with the PAFFY_TPU_* env
set (or standalone single-host with none).
"""

from __future__ import annotations

import os
import sys

from paffy_tpu.core.model import PafTable
from paffy_tpu.core import pafio
from paffy_tpu.ops.mismatch import SequencePool
from paffy_tpu.distenv import coordination_barrier, initialize_from_env  # noqa: F401
from paffy_tpu.parallel.runner import (assign_shards, pipeline_stage,
                                       sharded_pipeline_stage,
                                       split_by_contig)


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of the pipeline's backend (the one
    PAFFY_TPU_PLATFORM pins, else JAX's default)."""
    from paffy_tpu.jaxconf import ensure_jax
    ensure_jax()
    import jax
    return jax.process_index(), jax.process_count()


def _barrier(name: str) -> None:
    """Cross-process barrier (no-op single-process).  Uses the coordination
    service, not a device collective."""
    coordination_barrier(name)


def _local_shard_names(t: PafTable, groups, shards, pidx: int,
                       pcount: int) -> set[str]:
    """Sequence names touched by the shards process ``pidx`` executes —
    the per-host SequencePool is pruned to exactly these, mirroring the
    reference's per-shard processes reading only the sequences their
    records name (via the FASTA name->seq hash, impl/paf_view.c:127-134)."""
    names: set[str] = set()
    for s in range(pidx, len(shards), pcount):
        for gi in shards[s]:
            idx = groups[gi]
            names.update(t.qname[idx])
            names.update(t.tname[idx])
    return names


def run_pipeline_multihost(t: PafTable, seqs: dict[str, str],
                           workdir: str, n_shards: int | None = None,
                           by_query: bool = True,
                           use_mesh: bool = True) -> PafTable | None:
    """Run the fused pipeline with shards spread over processes.

    Every process calls this with the SAME inputs (each host parses the
    shared input files — the reference's shards read the same FASTA).  Shard
    ``s`` is executed by process ``s % process_count``; each executed shard
    writes ``workdir/shard_{gi:06d}.paf`` per contig group.  After a
    barrier, process 0 concatenates all group files in group order and
    returns the result table (other processes return None) — byte-identical
    to a single-process run_pipeline (tests/test_runner.py,
    tests/test_multiprocess.py).

    ``workdir`` MUST be on a filesystem shared by all processes (it is the
    interconnect, exactly as files+cat are the reference's,
    tests/paf_pipeline_test.sh:50-71).  Reachability is verified up front:
    every process drops a probe file and checks it can see every other
    process's probe after a barrier, failing fast (before any shard work)
    on non-shared storage.

    Each process builds its SequencePool from only the sequence names its
    own shards touch — pool bytes per host scale with shard content, not
    input size (the reference's per-shard processes likewise read only the
    names their records look up in the FASTA hash).
    """
    import jax

    pidx, pcount = process_info()
    groups = split_by_contig(t, by_query=by_query)
    if not groups:
        return t if pidx == 0 else None
    if n_shards is None:
        n_shards = max(pcount, 1)
    lengths = [int((t.qlen if by_query else t.tlen)[g[0]]) for g in groups]
    shards = assign_shards(groups, lengths, n_shards)

    local_names = _local_shard_names(t, groups, shards, pidx, pcount)
    # missing names fail at lookup time with the reference's error text
    # (SequencePool.offsets_for), not here
    pool = SequencePool({n: seqs[n] for n in sorted(local_names) if n in seqs})

    mesh = None
    if use_mesh:
        from paffy_tpu.parallel.pipeline import make_mesh
        local = jax.local_devices()
        if len(local) > 1 or pcount > 1:
            mesh = make_mesh(local)

    os.makedirs(workdir, exist_ok=True)
    if pcount > 1:  # fail fast on non-shared workdir
        with open(os.path.join(workdir, f".reach_p{pidx}"), "w") as fh:
            fh.write("ok\n")
        _barrier("paffy_workdir_probe")
        missing = [i for i in range(pcount) if not os.path.exists(
            os.path.join(workdir, f".reach_p{i}"))]
        if missing:
            raise RuntimeError(
                f"workdir {workdir!r} is not shared across processes "
                f"(process {pidx} cannot see probe files from processes "
                f"{missing}); the shard gather requires a shared filesystem")
    for s in range(pidx, len(shards), pcount):
        for gi in shards[s]:
            sub = t.take(groups[gi])
            out = (sharded_pipeline_stage(sub, pool, mesh)
                   if mesh is not None else pipeline_stage(sub, pool))
            path = os.path.join(workdir, f"shard_{gi:06d}.paf")
            tmp = path + f".tmp{pidx}"
            with open(tmp, "wb") as fh:
                fh.write(pafio.serialize_paf_bytes(out))
            os.replace(tmp, path)      # atomic: re-runs are idempotent

    _barrier("paffy_pipeline_shards")
    if pidx != 0:
        return None
    blobs = []
    for gi in range(len(groups)):
        with open(os.path.join(workdir, f"shard_{gi:06d}.paf"), "rb") as fh:
            blobs.append(fh.read())
    return pafio.parse_paf_data(b"".join(blobs))


def _main(argv=None) -> int:
    import argparse

    from paffy_tpu.core.fasta import read_fasta

    p = argparse.ArgumentParser(
        prog="paffy_tpu.parallel.distributed",
        description="multi-host fused pipeline (add_mismatches|chain|tile|"
                    "trim), one process per host")
    p.add_argument("paf")
    p.add_argument("fasta")
    p.add_argument("out")
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--by-target", action="store_true")
    a = p.parse_args(argv)

    initialize_from_env()
    with open(a.paf, "rb") as fh:
        t = pafio.parse_paf_data(fh.read())
    with open(a.fasta) as fh:
        seqs = read_fasta(fh)
    workdir = a.workdir or (a.out + ".shards")
    res = run_pipeline_multihost(t, seqs, workdir, n_shards=a.shards,
                                 by_query=not a.by_target)
    if res is not None:
        with open(a.out, "wb") as fh:
            fh.write(pafio.serialize_paf_bytes(res))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
