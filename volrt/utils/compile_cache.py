"""Where JAX keeps its persistent compilation cache.

Every entry point (``volrt.cli.main``, ``bench.py``, ``chip_smoke.py``) calls
:func:`setup_compile_cache` before it compiles anything, so repeated runs of
the same program on the same machine skip recompilation.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache(environ=os.environ) -> str | None:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use, or None for no cache.

    - ``JAX_COMPILATION_CACHE_DIR`` set: that directory. JAX reads the
      variable itself, so nothing is set here.
    - CPU-only runs (``JAX_PLATFORMS=cpu``): no cache. CPU AOT entries are
      specific to the host's microarchitecture; an entry written on another
      machine loads with mismatched buffer layouts or risks SIGILL. The
      environment is read instead of ``jax.default_backend()`` so that
      choosing the directory never initialises a backend.
    - Otherwise: ``<repo>/.jax_cache`` (git-ignored).
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    platforms = {p.strip() for p in
                 environ.get("JAX_PLATFORMS", "").lower().split(",")}
    if platforms - {""} == {"cpu"}:
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
