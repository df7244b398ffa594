"""Deferred JAX bring-up.

Importing JAX costs over a second, so host-only commands (invert, dedupe,
trim, filter, shatter, split_file, dechunk, upconvert, the faffy trio) never
import it: every module that defines device code calls :func:`ensure_jax`
before ``import jax``.  It

  * pins the platform: ``PAFFY_TPU_PLATFORM`` (e.g. ``cpu``) sets
    ``jax_platforms`` before any backend starts, so a CPU-pinned process
    never opens the accelerator; a pinned platform that is absent raises;
  * brings up ``jax.distributed`` from the env (must precede backend init);
  * enables x64 (PAF coordinates are int64);
  * points the persistent compile cache at ``<checkout>/.jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set, which JAX then reads itself.

Idempotent and cheap after the first call.
"""

from __future__ import annotations

import os

_DONE = False
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str | None:
    """The compile-cache directory this process must set in code, or None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX honours it unaided).
    The default is a fixed path: the path is part of the cache key, so a
    directory that moves would never hit."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def ensure_jax() -> None:
    global _DONE
    if _DONE:
        return
    import jax

    plat = os.environ.get("PAFFY_TPU_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)

    from paffy_tpu.distenv import initialize_from_env
    initialize_from_env()

    # Coordinates/scores are int64 in the PAF data model; enable 64-bit
    # types everywhere (per-column device tensors still use int32).
    jax.config.update("jax_enable_x64", True)

    cache = compile_cache_dir()
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", cache)

    if plat:
        try:
            jax.devices()
        except Exception as e:   # backend init failures are not typed
            raise RuntimeError(
                f"PAFFY_TPU_PLATFORM={plat!r}: platform not available") from e
    _DONE = True
