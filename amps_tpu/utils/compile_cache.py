"""Where the persistent XLA compile cache lives.

Every entry point (scripts, apps, tests) calls ``enable_compile_cache``
so that one process's compilations are found again by the next.
``JAX_COMPILATION_CACHE_DIR``, when set, is the only directory used;
otherwise the cache sits at ``<checkout>/.jax_cache`` (listed in
.gitignore), resolved from this package's own path.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    env = os.environ if environ is None else environ
    return (env.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns
    the directory."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
