"""Where JAX keeps its persistent compile cache.

JAX only persists compiled executables when ``jax_compilation_cache_dir``
is set in the process that compiles them, so every entry point (the CLI,
the benchmarks, bench.py) calls :func:`enable_persistent_cache` before
touching the engines; later stages and later runs then reuse the
compiles.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing is
  set in code.
- Otherwise: one fixed directory inside the checkout, :data:`CACHE_DIR`
  (git-ignored).  The path is part of the cache's key, so it must not
  move between runs.

The default min-compile-time threshold (1 s) is kept, so the CPU test
suite's many sub-second compiles don't bloat the cache.
"""

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory compiles persist to for this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_persistent_cache() -> None:
    """Point JAX's persistent compile cache at :func:`cache_dir`.

    Idempotent, and safe before or after backend init (the cache config
    is read at compile time).  With ``JAX_COMPILATION_CACHE_DIR`` set,
    JAX has already taken it from the environment."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
