"""Persistent XLA compilation cache, placed from outside.

Entry points (``chip_smoke.py``, ``bench.py``, ``examples/*.py``) call
:func:`configure` before their first compile; the library itself never sets
a cache.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it and
this module sets nothing.  Otherwise the cache lives at a fixed path in the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``), so a later
process in the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
