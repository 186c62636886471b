"""Persistent XLA compilation cache for the apps, bench.py and chip_smoke.py.

The reference pays its (small) warm-up cost once per process via an explicit
cuFFT warm-up plan (gpuLS_main.cu:94-97).  Here the analogous cost is XLA
compilation, paid again by every process start unless JAX's persistent
compilation cache holds the executables: a ring master waiting on the
consumer's first read then waits for a cache read instead of a compile.

Directory rule: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets no other directory.  Otherwise the cache lives
at ONE fixed path inside the checkout (``DEFAULT_DIR``, listed in
``.gitignore``) -- a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory ``enable`` uses: the environment's, else DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Must run before the first compilation (call it before building
    receivers)."""
    import jax

    path = cache_dir()
    if ENV_VAR not in os.environ or not os.environ[ENV_VAR]:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # App warm-ups are a handful of multi-second compiles; cache everything
    # that takes noticeable time.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
