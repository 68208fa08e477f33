"""Where JAX keeps its persistent compilation cache.

Repeat runs of the CLI, ``bench.py`` and ``chip_smoke.py`` skip recompiling
programs they have compiled before. The cache key includes the directory,
so the directory is fixed:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set
  in code;
* a directory already configured in this process (e.g. by the test
  suite): kept;
* otherwise: ``<checkout>/.cache/<subdir>``.
"""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def configure_compile_cache(subdir: str = "jax") -> str:
    """Point the persistent compilation cache at a fixed directory and
    return it (see the module docstring for the order of precedence)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = os.path.join(_CHECKOUT, ".cache", subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
