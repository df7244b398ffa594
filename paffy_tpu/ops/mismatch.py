"""M -> =/X mismatch encoding and fused alignment stats — the per-column hot
path, run on device.

Replaces the reference's per-base C loops:
  * paf_encode_mismatches (impl/paf.c:739-784): compare query/target bases
    over every column of every M run (case-insensitive; reverse-complement
    walk for '-' strand) and re-encode as =/X runs.  Runs never merge across
    original op boundaries (the ``first`` flag reset, impl/paf.c:753).
  * the view-stats aggregation (impl/paf_view.c:167-197).

Device pipeline per batch: expand M runs to columns (segments.py), gather the
two base vectors from the packed sequence pool in HBM, translate through the
case-fold/complement tables, compare, and segment-reduce per record.  The
full re-encode additionally computes run boundaries on device and rebuilds
the CSR store on host from the compacted run arrays.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import numpy as np

from paffy_tpu.core.model import PafTable, MATCH, SEQ_MATCH, SEQ_MISMATCH
from paffy_tpu.core.fasta import COMPLEMENT_TABLE, UPPER_TABLE, pack_sequences
from paffy_tpu.core.segsum import segment_sums_by_offsets
from paffy_tpu.ops.segments import (build_m_column_batch, columns_to_ops,
                                    bucket_size, pad_to)

# Device kernels live in ops/mismatch_device (imported lazily so host-routed
# commands never pay the JAX import; see paffy_tpu/jaxconf.py).  The names
# below remain importable from this module for compatibility.
_DEVICE_NAMES = ("device_upper", "device_comp_upper", "build_ext_pool",
                 "_column_compare", "_column_match_counts", "_column_runs")


def __getattr__(name):
    if name in _DEVICE_NAMES:
        from paffy_tpu.ops import mismatch_device
        return getattr(mismatch_device, name)
    raise AttributeError(name)


# alphabet membership LUTs over UPPERCASED bytes (host-side routing flags;
# the device kernels' _code4/ACGT tests agree by construction)
_IUPAC15_OK = np.zeros(256, dtype=bool)
for _ch in b"ACGTNMKRYVBHDWS":
    _IUPAC15_OK[_ch] = True
_ACGT_OK = np.zeros(256, dtype=bool)
for _ch in b"ACGT":
    _ACGT_OK[_ch] = True


class SequencePool:
    """Device-resident packed FASTA: one guarded uint8 HBM array + name index.

    The pool carries POOL_GUARD zero bytes at the front and POOL_GUARD-plus-
    rounding at the back so neither the tiled kernel's chunk windows nor the
    Pallas kernel's full-piece DMAs can index out of bounds; all offsets
    include the guard.

    HBM footprint: the derived arrays are cached after first use — ``ext``
    (2L), ``packed`` (2L: packed2d L + 4 phase views L), ``packed2``
    (L: packed2d L/2 + views L/2) — so a caller that touches every route
    holds up to ~6x the pool bytes on device.  ``ext`` is an intermediate
    for the packed builders and the input of the unpacked fallback; once a
    packed route is chosen for a large pool, call :meth:`drop_device_caches`
    to release the routes not taken.
    """

    @classmethod
    def from_fasta_files(cls, paths) -> "SequencePool":
        """Build the pool straight from FASTA file bytes (no intermediate
        per-sequence Python strings — fasta_pool_from_bytes); falls back to
        the read_fasta string path for files needing whitespace handling."""
        datas = []
        for p in paths:
            with open(p, "rb") as fh:
                datas.append(fh.read())
        from paffy_tpu.core.fasta import fasta_pool_from_bytes, load_sequences
        res = fasta_pool_from_bytes(datas)
        if res is None:
            return cls(load_sequences(paths))
        pool_np, index = res
        self = cls.__new__(cls)
        self._init_from_pool(pool_np, index)
        return self

    def __init__(self, seqs: dict[str, str]):
        pool_np, index = pack_sequences(seqs)
        self._init_from_pool(pool_np, index)

    def _init_from_pool(self, pool_np, index):
        from paffy_tpu.ops.segments import POOL_W, POOL_GUARD
        self.index = index
        n = POOL_GUARD + len(pool_np)
        padded = -(-(n + POOL_GUARD + 2 * POOL_W) // POOL_W) * POOL_W
        buf = np.zeros(padded, dtype=np.uint8)
        buf[POOL_GUARD: POOL_GUARD + len(pool_np)] = pool_np
        self._guard = POOL_GUARD
        self._data_len = len(pool_np)
        self._pool_np = buf
        self._pool_dev = None
        self._ext = None
        self._packed = None
        self._packed2 = None
        self._has_exotic = None
        self._has_exotic2 = None

    def seq_bytes(self, name: str) -> np.ndarray:
        """One sequence's bytes as a host uint8 view into the pool."""
        off, ln = self.index[name]
        g = self._guard
        return self._pool_np[g + off: g + off + ln]

    @property
    def pool(self):
        """The guarded pool as a device array (uploaded lazily — host-routed
        commands never touch the device)."""
        if self._pool_dev is None:
            from paffy_tpu.ops import mismatch_device  # noqa: F401 (jax init)
            import jax.numpy as jnp
            self._pool_dev = jnp.asarray(self._pool_np)
        return self._pool_dev

    @property
    def on_device(self) -> bool:
        """True once the pool has been uploaded to the device."""
        return self._pool_dev is not None

    @property
    def pool_len(self) -> int:
        """Padded pool length (== pool.shape[0], without touching device)."""
        return len(self._pool_np)

    @property
    def ext(self):
        """Extended pool (build_ext_pool), built lazily and cached."""
        if self._ext is None:
            from paffy_tpu.ops.mismatch_device import build_ext_pool
            self._ext = build_ext_pool(self.pool)
        return self._ext

    @property
    def host_pool(self) -> np.ndarray:
        """The host copy of the guarded pool (for native C passes)."""
        return self._pool_np

    @property
    def has_exotic(self) -> bool:
        """True iff any sequence byte (case-folded) is outside the 15-char
        IUPAC set the 4-bit packed kernel can represent exactly."""
        if self._has_exotic is None:
            # host pass (one LUT gather + any) — routing must not force a
            # device upload; semantics match tiled._code4 == 15
            data = UPPER_TABLE[
                self._pool_np[self._guard: self._guard + self._data_len]]
            self._has_exotic = bool(np.any(~_IUPAC15_OK[data]))
        return self._has_exotic

    @property
    def packed(self):
        """(packed2d, pviews) for the 4-bit kernel, built lazily and cached."""
        if self._packed is None:
            from paffy_tpu.ops.tiled import build_packed_pools
            self._packed = build_packed_pools(self.ext)
        return self._packed

    @property
    def has_exotic2(self) -> bool:
        """True iff any sequence byte (case-folded) is outside ACGT — the
        set the 2-bit packed kernel can represent exactly."""
        if self._has_exotic2 is None:
            data = UPPER_TABLE[
                self._pool_np[self._guard: self._guard + self._data_len]]
            self._has_exotic2 = bool(np.any(~_ACGT_OK[data]))
        return self._has_exotic2

    @property
    def packed2(self):
        """(packed2d, pviews) for the 2-bit kernel, built lazily and cached."""
        if self._packed2 is None:
            from paffy_tpu.ops.tiled import build_packed2_pools
            self._packed2 = build_packed2_pools(self.ext)
        return self._packed2

    def drop_device_caches(self, keep: str = "packed2") -> None:
        """Release cached derived device arrays except ``keep`` (one of
        "ext", "packed", "packed2", or "" for none).  The alphabet flags
        stay cached, so kernel routing is unaffected; a dropped route is
        simply rebuilt (one dense device pass) if used again."""
        if keep != "ext":
            self._ext = None
        if keep != "packed":
            self._packed = None
        if keep != "packed2":
            self._packed2 = None

    def offsets_for(self, names: np.ndarray, role: str) -> np.ndarray:
        out = np.empty(len(names), dtype=np.int64)
        for i, n in enumerate(names):
            entry = self.index.get(n)
            if entry is None:
                raise KeyError(f"No {role} sequence named: {n} found")
            out[i] = entry[0] + self._guard
        return out


def _prepare(t: PafTable, pool: SequencePool):
    qoff = pool.offsets_for(t.qname, "query")
    toff = pool.offsets_for(t.tname, "target")
    return build_m_column_batch(t, qoff, toff)


# ------------------------------------------------ e2e counts routing model
# Route on PREDICTED END-TO-END TIME: the device route (host chunk-grid
# build + upload + 2-bit kernel + readback) plus, on a process's first
# device use, JAX start-up, the pool upload and packing and the kernel
# compile; against the threaded native compare.  Measured on the
# golden-shaped workload, NVIDIA H100 80GB HBM3 at a 400 W power limit,
# 16-core host (8 native threads), by chip_smoke.py:
#   device route   7.7 ms / 1.25e8 columns, 106.5 ms / 2.0e9 (18.8 Gcol/s;
#                  the host grid build is 87 ms of the latter)
#   native         20.4 ms / 1.25e8, 314.9 ms / 2.0e9 (0.79 Gcol/s/thread)
#   first use      1.7 s pool upload and packing, plus (separate probes)
#                  2.4 s JAX import and GPU start and 1.1 s kernel compile
# so a fresh process gains from the device only above ~5e10 columns.
DEVICE_COLS_PER_S = 18.8e9
NATIVE_COLS_PER_S = 0.79e9   # per native thread
DEVICE_DISPATCH_S = 0.001    # per batch: array uploads + result fetch
DEVICE_SETUP_S = 5.2         # first device use in a process


def _compute_platform() -> str:
    """Platform device batches dispatch to: the PAFFY_TPU_PLATFORM pin if
    set (known without importing JAX), else JAX's default backend."""
    import os
    if os.environ.get("PAFFY_TPU_PLATFORM"):
        return os.environ["PAFFY_TPU_PLATFORM"]
    from paffy_tpu.jaxconf import ensure_jax
    ensure_jax()
    import jax
    return jax.default_backend()


def device_route_wins(n_cols: int, pool_on_device: bool = False) -> bool:
    """True when the measured rates predict the device counts route beats
    the threaded native pass for ``n_cols`` columns (``pool_on_device``:
    the process has already paid the device set-up)."""
    import os
    t_dev = n_cols / DEVICE_COLS_PER_S + DEVICE_DISPATCH_S
    if not pool_on_device:
        t_dev += DEVICE_SETUP_S
    t_native = n_cols / (NATIVE_COLS_PER_S * min(os.cpu_count() or 1, 8))
    return t_dev < t_native


def device_counts_predicted_faster(b, pool_on_device: bool = False) -> bool:
    """True when the device counts route is predicted to beat the threaded
    native host pass end-to-end for this batch.  JAX is consulted (for the
    platform) only when the rates favour the device."""
    if not device_route_wins(b.n_cols, pool_on_device):
        return False
    return _compute_platform() != "cpu"   # no accelerator: C pass is host


def _native_counts(t: PafTable, pool: SequencePool, b, threaded: bool):
    from paffy_tpu import native
    fn = (native.column_compare_counts_mt if threaded
          else native.column_compare_counts)
    return fn(pool.host_pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops],
              b.tpos0[: b.n_mops], b.rev[: b.n_mops], b.rec[: b.n_mops],
              len(t))


def _log_route(route: str, b) -> None:
    from paffy_tpu.utils.logging import debug_enabled, log_debug
    if debug_enabled():
        device = "host" if route.startswith("native") else _compute_platform()
        log_debug("counts route: %s on %s (%d columns)", route, device,
                  b.n_cols)


def column_match_counts(t: PafTable, pool: SequencePool) -> tuple[np.ndarray, np.ndarray]:
    """Per-record counts of matching / mismatching columns within M runs."""
    b = _prepare(t, pool)
    if b.n_cols == 0:
        z = np.zeros(len(t), dtype=np.int64)
        return z, z.copy()
    plen = pool.pool_len
    if b.n_cols >= TILED_THRESHOLD:
        # end-to-end routing: big batches go native when the device route
        # is predicted slower (both routes byte-identical; FORCE_DEVICE
        # keeps the device kernels testable without a toolchain)
        if not FORCE_DEVICE and not device_counts_predicted_faster(
                b, pool.on_device):
            res = _native_counts(t, pool, b, threaded=True)
            if res is not None:
                _log_route("native_mt", b)
                return res
        # fastest exact kernel for the pool's alphabet: 2-bit (pure ACGT)
        # -> 4-bit (15-char IUPAC) -> unpacked ext (any byte); each kernel
        # requires int32-addressable positions (tiled.*_addressable) —
        # pools past the limit fall through to the native 64-bit host path
        from paffy_tpu.ops import tiled
        if not pool.has_exotic2 and tiled.packed2_addressable(plen):
            _log_route("device_2bit", b)
            packed2d, pviews = pool.packed2
            m, x = tiled.packed2_match_counts(packed2d, pviews, b, len(t),
                                              plen)
            return m.astype(np.int64), x.astype(np.int64)
        if not pool.has_exotic and tiled.packed4_addressable(plen):
            _log_route("device_4bit", b)
            packed2d, pviews = pool.packed
            m, x = tiled.packed_match_counts(packed2d, pviews, b, len(t),
                                             plen)
            return m.astype(np.int64), x.astype(np.int64)
        if tiled.ext_addressable(plen):
            _log_route("device_ext", b)
            m, x = tiled.tiled_match_counts(pool.ext, b, len(t))
            return m.astype(np.int64), x.astype(np.int64)
        # pool too large for any int32 device kernel: native only
        res = _native_counts(t, pool, b, threaded=False)
        if res is None:
            raise ValueError(
                f"pool too large for int32 device addressing "
                f"(pool_len={plen}) and the native toolchain is unavailable")
        _log_route("native_large_pool", b)
        return res
    # small batches: the native C loop beats a device dispatch outright
    if not FORCE_DEVICE:
        res = _native_counts(t, pool, b, threaded=False)
        if res is not None:
            _log_route("native_small", b)
            return res
    _log_route("device_columns", b)
    from paffy_tpu.ops import mismatch_device as dev
    import jax.numpy as jnp
    m, x = dev._column_match_counts(
        pool.pool, jnp.asarray(b.lens), jnp.asarray(b.qpos0), jnp.asarray(b.tpos0),
        jnp.asarray(b.rev), jnp.asarray(b.col_off), jnp.asarray(b.rec_col_off),
        b.n_cols, c_pad=b.n_cols_pad)
    return np.asarray(m), np.asarray(x)


TILED_THRESHOLD = 1 << 20  # columns; above this, use the tiled kernel
# test hook: skip BOTH native host paths (run extraction in
# encode_mismatches AND the small-batch counts in column_match_counts) so
# the device fallbacks stay exercised without a toolchain
FORCE_DEVICE = False


def encode_mismatches(t: PafTable, pool: SequencePool,
                      n_threads: int | None = None) -> PafTable:
    """paf_encode_mismatches over a whole batch: M runs become =/X runs; all
    other ops pass through unchanged in place.

    ``n_threads`` caps the native extraction's thread count (None = auto);
    the benchmark uses 1 for its single-threaded reference path.
    """
    b = _prepare(t, pool)
    if b.n_cols == 0:
        return t
    # Run extraction lands on the host for the CSR rebuild regardless, so
    # the native C pass over the host pool wins end-to-end AT EVERY SIZE:
    # the device path's run compaction (searchsorted over the flat chunk
    # grid) measured 4.8 s on the 125M-column golden workload vs 0.64 s for
    # the C pass, and small batches skip device dispatch entirely
    # (docs/PERF_NOTES.md).  The device kernels remain the fallback without
    # a native toolchain: tiled above TILED_THRESHOLD, naive below.
    if not FORCE_DEVICE:
        from paffy_tpu import native
        runs_per_mop = native.encode_runs_per_mop(
            pool.host_pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops],
            b.tpos0[: b.n_mops], b.rev[: b.n_mops], n_threads=n_threads)
        if runs_per_mop is not None:
            # Direct CSR rebuild: one native walk computes every op's
            # output offset and writes the non-M ops through
            # (encode_rebuild_offsets), then the C fill pass writes each M
            # op's =/X runs at its destination — no O(runs)
            # searchsorted/add.at middle and no numpy contrib/cumsum/
            # fancy-scatter chain (~6 full-array passes on a 24M-op
            # output).  flat_idx is ascending (build_mop_batch walks the
            # ops forward), so runs_per_mop is already in flat M-op order.
            total_out = (int(runs_per_mop.sum())
                         + (len(t.ops) - b.n_mops))
            out_off_per_op, m_out_off, new_ops, new_lens = (
                native.encode_rebuild_offsets(t.ops, t.lens, runs_per_mop,
                                              total_out))
            native.encode_runs_fill_cigar(
                pool.host_pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops],
                b.tpos0[: b.n_mops], b.rev[: b.n_mops],
                m_out_off, new_ops, new_lens,
                n_threads=n_threads)
            return t.with_cigars(new_ops, new_lens, out_off_per_op[t.off])

    if b.n_cols >= TILED_THRESHOLD:
        from paffy_tpu.ops.tiled import tiled_runs
        starts, match_at_start = tiled_runs(pool.ext, b, len(t))
    else:
        from paffy_tpu.ops import mismatch_device as dev
        import jax.numpy as jnp
        boundary, is_match, valid = dev._column_runs(
            pool.pool, jnp.asarray(b.lens), jnp.asarray(b.qpos0),
            jnp.asarray(b.tpos0), jnp.asarray(b.rev), jnp.asarray(b.col_off),
            b.n_cols, c_pad=b.n_cols_pad)
        boundary = np.asarray(boundary[: b.n_cols])
        starts = np.nonzero(boundary)[0]
        match_at_start = np.asarray(is_match[: b.n_cols])[starts]

    # --- host: rebuild the CSR store with M runs replaced by their =/X runs
    run_lens = np.diff(np.append(starts, b.n_cols))
    run_ops = np.where(match_at_start, np.uint8(SEQ_MATCH), np.uint8(SEQ_MISMATCH))
    # owning original flat-op index of each run
    col_to_mop = np.searchsorted(b.col_off[1: b.n_mops + 1], starts, side="right")
    run_flat = b.flat_idx[col_to_mop]

    # contributions per original flat op: 1 for non-M ops, #runs for M ops
    contrib = np.ones(len(t.ops), dtype=np.int64)
    runs_per_mop = np.zeros(len(t.ops), dtype=np.int64)
    np.add.at(runs_per_mop, run_flat, 1)
    is_m = t.ops == MATCH
    contrib[is_m] = runs_per_mop[is_m]
    out_off_per_op = np.zeros(len(t.ops) + 1, dtype=np.int64)
    np.cumsum(contrib, out=out_off_per_op[1:])
    total_out = int(out_off_per_op[-1])

    new_ops = np.empty(total_out, dtype=np.uint8)
    new_lens = np.empty(total_out, dtype=np.int64)
    # non-M ops copy through
    non_m = ~is_m
    new_ops[out_off_per_op[:-1][non_m]] = t.ops[non_m]
    new_lens[out_off_per_op[:-1][non_m]] = t.lens[non_m]
    # M runs scatter to their op's output range in run order (run_flat is
    # non-decreasing, so rank-in-group = index - first index of the group)
    first_of_group = np.searchsorted(run_flat, run_flat, side="left")
    run_rank = np.arange(len(run_flat)) - first_of_group
    dest = out_off_per_op[:-1][run_flat] + run_rank
    new_ops[dest] = run_ops
    new_lens[dest] = run_lens

    new_off = out_off_per_op[t.off]
    return t.with_cigars(new_ops, new_lens, new_off)
