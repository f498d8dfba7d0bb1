"""Persistent XLA compilation cache.

Every jitted window shape compiles once per process; the persistent cache
makes later processes start warm. Where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX keeps the cache there and this module sets no directory.
Otherwise the cache sits at ``<checkout>/.jax_cache`` (git-ignored): a
fixed path, so that every process of this checkout finds it again. Safe to
call more than once.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
