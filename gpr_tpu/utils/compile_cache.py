"""One place that points JAX's persistent compilation cache at a directory.

Every entry point (``chip_smoke.py``, ``bench.py``, ``benchmarks/*``, the
``apps`` mains, the test suite) calls :func:`setup_compile_cache` before its
first compile.  The directory is part of the cache's key, so it must not
move between runs:

* ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other;
* unset: ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache lives in (see the module docstring)."""
    return os.environ.get(ENV) or DEFAULT_DIR


def setup_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Enable the persistent compilation cache; returns its directory.
    Programs that compile faster than ``min_compile_secs`` are not cached."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
