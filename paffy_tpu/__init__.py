"""paffy-tpu: a JAX PAF/FASTA processing engine.

A from-scratch JAX/XLA framework with the full capability surface of
ComparativeGenomicsToolkit/paffy (see SURVEY.md): batched PAF records are held
as SoA/CSR tensors, per-column work (mismatch encoding, coverage, stats,
trimming) runs as vectorized device kernels, and the chaining DP / tile sweep
run as scan kernels, data-parallel over a device mesh.

JAX is imported LAZILY (paffy_tpu/jaxconf.ensure_jax): host-only commands
never pay the >1 s accelerator import, and the CLI launchers run ``python
-S``.  Every module that defines device code calls ensure_jax() before
``import jax``.
"""

__version__ = "0.1.0"

# Multi-process bring-up must precede any backend init; a no-op unless
# PAFFY_TPU_COORDINATOR is set (and the full jax config runs via
# jaxconf.ensure_jax when device code first loads).
from paffy_tpu.distenv import initialize_from_env as _dist_init  # noqa: E402

_dist_init()

from paffy_tpu.core.model import PafTable  # noqa: E402,F401
from paffy_tpu.core import pafio, fasta    # noqa: E402,F401
