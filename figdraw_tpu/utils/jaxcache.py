"""Persistent JAX compilation cache setup.

Every jit signature (and every Triton kernel inside it) compiles once per
machine: JAX_COMPILATION_CACHE_DIR when it is set, used exactly as given,
otherwise one fixed directory inside the checkout (`<repo>/.jax_cache/`,
listed in .gitignore). The cache is on for the GPU only; CPU compiles are
fast, and CPU artifacts are machine-feature sensitive.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache(platform: str | None = None) -> None:
    import jax

    if (platform or jax.default_backend()) != "gpu":
        return
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
