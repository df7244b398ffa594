"""Fused per-contig pipeline runner — the distributed form of the reference's
shell parallelism.

The reference parallelizes by splitting the PAF per contig (paffy split_file)
and running ``add_mismatches | chain | tile | trim`` per shard as background
processes (tests/paf_pipeline_test.sh:38-67).  Here the same decomposition
becomes a library call: records are grouped by contig, groups are assigned to
shards (contig-length-balanced, mirroring split_file's bin packing), each
shard runs the fused pipeline stages as pure functions over its batch, and
shard outputs concatenate in deterministic group order — byte-identical to a
sequential per-group run.

On several hosts each host executes its own shards (the data axis);
within a shard the per-column work runs on that host's devices.  The
stage-level contract (what each stage computes) is identical to the
single-process commands, so the shell tests' oracles apply unchanged.
"""

from __future__ import annotations

import os

import numpy as np

from paffy_tpu.core.model import PafTable
from paffy_tpu.core import pafio
from paffy_tpu.ops.mismatch import SequencePool, encode_mismatches
from paffy_tpu.ops.chain import paf_chain
from paffy_tpu.ops.tile import assign_tile_levels, tile_sort_order
from paffy_tpu.ops.tailtrim import trim_unreliable_tails


def split_by_contig(t: PafTable, by_query: bool = True) -> list[np.ndarray]:
    """Record index groups by contig name, in first-seen order
    (the split_file axis, impl/paf_split_file.c:142-170)."""
    names = t.qname if by_query else t.tname
    groups: dict[str, list[int]] = {}
    order: list[str] = []
    for i in range(len(t)):
        g = groups.get(names[i])
        if g is None:
            groups[names[i]] = [i]
            order.append(names[i])
        else:
            g.append(i)
    return [np.array(groups[n], dtype=np.int64) for n in order]


def assign_shards(groups: list[np.ndarray], lengths: list[int], n_shards: int) -> list[list[int]]:
    """Balance contig groups across shards by total contig length
    (greedy first-fit-decreasing — the load-balance role of split_file's
    bin packing)."""
    order = np.argsort([-l for l in lengths], kind="stable")
    loads = [0] * n_shards
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for gi in order:
        s = int(np.argmin(loads))
        shards[s].append(int(gi))
        loads[s] += lengths[gi]
    for s in shards:
        s.sort()  # deterministic processing order within a shard
    return shards


def pipeline_stage(t: PafTable, pool: SequencePool,
                   trim_identity: float = 0.05,
                   trim_fraction: float = 1.0) -> PafTable:
    """One shard's fused pipeline: add_mismatches | chain | tile | trim
    (the per-split-file stage chain of tests/paf_pipeline_test.sh:57-60)."""
    t = encode_mismatches(t, pool)
    pafio.paf_check(t)
    t = paf_chain(t)
    order = tile_sort_order(t)
    levels = assign_tile_levels(t, order)
    from dataclasses import replace
    t = replace(t, tile_level=levels)
    t = t.take(order)
    t = trim_unreliable_tails(t, trim_identity, trim_fraction)
    pafio.paf_check(t)
    return t


def sharded_pipeline_stage(t: PafTable, pool: SequencePool, mesh,
                           trim_identity: float = 0.05,
                           trim_fraction: float = 1.0) -> PafTable:
    """pipeline_stage with every device dispatch sharded over ``mesh``.

    The three device kernels of the fused stage ride the mesh's ``data``
    axis: the chain DP batches all (qname,tname) groups into one scan
    sharded group-per-device (ops/chain.chain_groups_device), the tile sweep
    stacks all coverage segments into one vmapped scan sharded
    segment-per-device (ops/tile.assign_tile_levels_sharded), and the column
    stats step is parallel/pipeline.sharded_view_stats (data x seq).  The
    mismatch run extraction stays on the host by measurement
    (docs/PERF_NOTES.md).  Output is byte-identical to pipeline_stage —
    asserted by dryrun_multichip and tests/test_runner.py.
    """
    from functools import partial
    from paffy_tpu.ops.chain import chain_groups_device
    from paffy_tpu.ops.tile import assign_tile_levels_sharded

    t = encode_mismatches(t, pool)
    pafio.paf_check(t)
    t = paf_chain(t, dp_many=partial(chain_groups_device, mesh=mesh))
    order = tile_sort_order(t)
    levels = assign_tile_levels_sharded(t, order, mesh=mesh)
    from dataclasses import replace
    t = replace(t, tile_level=levels)
    t = t.take(order)
    t = trim_unreliable_tails(t, trim_identity, trim_fraction)
    pafio.paf_check(t)
    return t


def run_pipeline(t: PafTable, seqs: dict[str, str], n_shards: int = 1,
                 by_query: bool = True, mesh=None) -> PafTable:
    """Run the fused pipeline sharded per contig and concatenate results in
    deterministic group order (the distributed cat step, SURVEY.md P6).

    With ``mesh``, each shard's device dispatches run mesh-sharded
    (sharded_pipeline_stage); identical output either way.
    """
    pool = SequencePool(seqs)
    groups = split_by_contig(t, by_query=by_query)
    if not groups:
        return t
    names = t.qname if by_query else t.tname
    lengths = [int((t.qlen if by_query else t.tlen)[g[0]]) for g in groups]
    shards = assign_shards(groups, lengths, n_shards)

    # process shards (on several hosts: one per host); keep outputs per group so the
    # final order is group order regardless of shard assignment
    out_by_group: dict[int, PafTable] = {}

    def run_group(gi: int) -> None:
        sub = t.take(groups[gi])
        out_by_group[gi] = (pipeline_stage(sub, pool) if mesh is None
                            else sharded_pipeline_stage(sub, pool, mesh))

    order = [gi for shard in shards for gi in shard]
    n_workers = min(len(order), int(os.environ.get(
        "PAFFY_TPU_PIPELINE_THREADS", min(os.cpu_count() or 1, 4))))
    if mesh is None and n_workers > 1:
        # host path: shards are independent and the hot sweeps are native
        # C (GIL released during ctypes calls), so shard-level threads give
        # real parallelism — the in-process analog of the reference's
        # background shard jobs (tests/paf_pipeline_test.sh:50-67); output
        # order is group order regardless of completion order
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            list(ex.map(run_group, order))
    else:
        for gi in order:
            run_group(gi)
    outs = [out_by_group[gi] for gi in range(len(groups))]
    return concat_tables(outs)


def concat_tables(tables: list[PafTable]) -> PafTable:
    """Concatenate PafTables (deterministic shard merge)."""
    if not tables:
        return PafTable.empty()
    import numpy as np
    from dataclasses import fields
    out = {}
    for f in fields(PafTable):
        arrs = [getattr(x, f.name) for x in tables]
        if f.name == "raw_cg":
            # raw-cigar tables are a CLI-local serialization mode; shard
            # merges operate on parsed tables only
            assert all(a is None for a in arrs), \
                "concat_tables requires parsed-cigar tables"
            continue
        if f.name == "off":
            off = [arrs[0]]
            base = arrs[0][-1]
            for a in arrs[1:]:
                off.append(a[1:] + base)
                base += a[-1]
            out[f.name] = np.concatenate(off)
        else:
            out[f.name] = np.concatenate(arrs)
    return PafTable(**out)
