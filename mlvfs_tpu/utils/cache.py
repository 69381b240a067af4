"""Where JAX keeps its persistent compile cache.

One rule for the program, the tests and the benchmark: when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is set
here; otherwise the cache lives at the fixed ``<repo>/.jax_cache`` (listed in
``.gitignore``). A fixed path matters: the directory is part of each entry's
key, so a cache that moves never hits.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
