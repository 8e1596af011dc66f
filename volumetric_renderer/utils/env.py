"""Process set-up shared by the entry points: compile cache and card info.

``enable_compile_cache`` keeps JAX's persistent compilation cache where
``JAX_COMPILATION_CACHE_DIR`` says and, when it is not set, in
``<checkout>/.jax_cache`` (listed in ``.gitignore``).  A fixed path matters:
the cache key includes it, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=os.environ) -> str:
    """The compile-cache directory under the rule above."""
    return environ.get(CACHE_ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache(environ=os.environ) -> str:
    """Apply the rule: with ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it
    itself and nothing else is set; without it, point JAX's config at
    ``<checkout>/.jax_cache``.  Returns the directory in use."""
    path = compile_cache_dir(environ)
    if CACHE_ENV not in environ:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or ``None`` where there is no ``nvidia-smi``.
    Starts no JAX, so a process can call it before JAX claims the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None
