"""Bring-up checks that run on the CPU — the seeded golden-shaped workload,
the JAX set-up helpers, chip_smoke.py's result line and phase plan — plus
the compare kernels on a GPU when one is visible (``gpu`` marker)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from paffy_tpu import native
from paffy_tpu.core import pafio

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


# ------------------------------------------------------ golden-shaped workload

@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_golden_workload_shape(scale):
    from goldenwork import (M_COLUMNS, MEDIAN_M_RUN, N_RECORDS, Q_LEN,
                            Q_NAME, T_LEN, T_NAME, golden_paf)
    data = golden_paf(scale=scale)
    assert golden_paf(scale=scale) == data            # seeded
    assert golden_paf(scale=scale, seed=8) != data
    t = pafio.parse_paf_data(data)
    pafio.paf_check(t)                                # spans fit the cigars
    assert len(t) == N_RECORDS
    assert set(t.qname) == {Q_NAME} and set(t.tname) == {T_NAME}
    assert int(t.qlen[0]) == int(Q_LEN * scale)
    assert int(t.tlen[0]) == int(T_LEN * scale)
    assert (t.qend <= t.qlen).all() and (t.tend <= t.tlen).all()
    assert 0.15 < float(np.mean(~t.strand)) < 0.35   # both strands
    m = t.lens[t.ops == 0]
    assert abs(float(np.median(m)) - MEDIAN_M_RUN) < 0.1 * MEDIAN_M_RUN
    assert abs(int(m.sum()) - M_COLUMNS * scale) < 0.15 * M_COLUMNS * scale
    gaps = t.lens[t.ops != 0]
    assert gaps.min() >= 1 and gaps.max() <= 8
    if scale == 1.0:                                  # golden: ~370k ops
        assert abs(len(t.ops) - 369_583) < 0.05 * 369_583


@pytest.mark.skipif(native.get_lib() is None, reason="no native toolchain")
def test_golden_workload_identity():
    from goldenwork import golden_paf, synth_pool
    from paffy_tpu.ops.segments import build_m_column_batch
    t = pafio.parse_paf_data(golden_paf(scale=0.02))
    pool, index = synth_pool(t)
    qoff = np.array([index[n][0] for n in t.qname], dtype=np.int64)
    toff = np.array([index[n][0] for n in t.tname], dtype=np.int64)
    b = build_m_column_batch(t, qoff, toff)
    m, x = native.column_compare_counts(
        pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops], b.tpos0[: b.n_mops],
        b.rev[: b.n_mops], b.rec[: b.n_mops], len(t))
    assert abs(m.sum() / (m.sum() + x.sum()) - 0.965) < 0.005


# ------------------------------------------------------------ JAX set-up

@pytest.mark.parametrize("env,expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({}, str(REPO / ".jax_cache")),
])
def test_compile_cache_dir(env, expect):
    from paffy_tpu.jaxconf import compile_cache_dir
    assert compile_cache_dir(env) == expect


@pytest.mark.parametrize("platform,ok", [("cpu", True),
                                         ("nosuchplatform", False)])
def test_platform_pin(platform, ok):
    """PAFFY_TPU_PLATFORM overrides JAX_PLATFORMS before any backend
    starts; a pinned platform that is absent raises."""
    env = dict(os.environ, PAFFY_TPU_PLATFORM=platform,
               JAX_PLATFORMS="nosuchbackend")
    code = ("from paffy_tpu.jaxconf import ensure_jax\nensure_jax()\n"
            "import jax\nprint(jax.default_backend())\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if ok:
        assert r.returncode == 0, r.stderr
        assert r.stdout.split()[-1] == platform
    else:
        assert r.returncode != 0
        assert f"PAFFY_TPU_PLATFORM={platform!r}" in r.stderr


# ------------------------------------------------------------ chip_smoke.py

def test_chip_smoke_result_line():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("four,expect", [
    (False, ("card", "cli", "kernels", "pipeline")),
    (True, ("card", "four")),
])
def test_chip_smoke_phase_plan(four, expect):
    assert chip_smoke.phases(four) == expect


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """No GPU (or no repository beside the script): a non-zero exit and no
    result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = dict(os.environ, PATH=str(tmp_path))     # no nvidia-smi
    r = subprocess.run([sys.executable, str(script)], env=env,
                       cwd=script.parent, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# --------------------------------------------------------------- on a GPU

@pytest.mark.gpu
def test_compare_kernels_on_gpu(gpu_device):
    """Every compare kernel, compiled for the GPU, equals the native counts
    (integer counts: zero tolerance)."""
    import jax
    from goldenwork import golden_paf, pool_seqs, synth_pool
    from paffy_tpu.ops import tiled
    from paffy_tpu.ops.mismatch import SequencePool
    from paffy_tpu.ops.segments import build_m_column_batch
    t = pafio.parse_paf_data(golden_paf(scale=0.02))
    base, index = synth_pool(t)
    n_pool = base.copy()
    o, ln = index["q_chr10"]
    n_pool[o + ln // 3: o + ln // 3 + 5000] = ord("N")
    x_pool = base.copy()
    x_pool[o + ln // 2] = ord("X")
    with jax.default_device(gpu_device):
        for raw, kernel in ((base, "2bit"), (n_pool, "4bit"),
                            (x_pool, "ext")):
            pool = SequencePool(pool_seqs(raw, index))
            b = build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                     pool.offsets_for(t.tname, "target"))
            want = native.column_compare_counts(
                pool.host_pool, b.lens[: b.n_mops], b.qpos0[: b.n_mops],
                b.tpos0[: b.n_mops], b.rev[: b.n_mops], b.rec[: b.n_mops],
                len(t))
            if kernel == "2bit":
                got = tiled.packed2_match_counts(*pool.packed2, b, len(t),
                                                 pool.pool_len)
            elif kernel == "4bit":
                got = tiled.packed_match_counts(*pool.packed, b, len(t),
                                                pool.pool_len)
            else:
                got = tiled.tiled_match_counts(pool.ext, b, len(t))
            assert pool.pool.devices() == {gpu_device}
            assert np.array_equal(got[0], want[0]), kernel
            assert np.array_equal(got[1], want[1]), kernel
