"""Persistent XLA compilation cache.

A session compiles dozens of static-shape programs (the match step, the
loop-closure row buckets, the solver buckets); on a GPU that is tens of
seconds to minutes of set-up per process.  The graphs are static per
config, so a persistent on-disk cache lets every session after the first
start warm.  The reference has no analog (C++ is ahead-of-time compiled).
"""

from __future__ import annotations

import os

# Fixed in-checkout default: the cache path is part of each entry's key, so
# a directory that moves between runs never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cpu_only(platforms: str | None) -> bool:
    """True when a ``jax_platforms`` value names the CPU backend alone."""
    names = [p.strip() for p in (platforms or "").split(",") if p.strip()]
    return bool(names) and all(p == "cpu" for p in names)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent).

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it
    itself; nothing else is set here), else :data:`DEFAULT_DIR`.
    Decides from configuration alone and starts no device backend, so a
    client command never opens the accelerator.  Returns the directory, or
    ``""`` on a CPU-only configuration.
    """
    import jax
    if cpu_only(jax.config.jax_platforms):
        # CPU programs compile in well under a second each, and the XLA:CPU
        # loader warns about host-feature mismatches on every reload.
        return ""
    cache_dir = jax.config.jax_compilation_cache_dir
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    # Cache every compilation regardless of compile time / size.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
