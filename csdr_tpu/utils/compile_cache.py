"""JAX's persistent compilation cache for the entry points.

Called by the CLI's `main`, `bench.py` and `chip_smoke.py` — never at import,
so importing the library changes no process-wide setting."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["DEFAULT_DIR", "enable_compile_cache"]

# Fixed, inside the checkout (and listed in .gitignore): the directory is part
# of what a later run must find again, so it never depends on a temporary
# name, a pid or the time.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is changed here.  Otherwise the cache goes to DEFAULT_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
