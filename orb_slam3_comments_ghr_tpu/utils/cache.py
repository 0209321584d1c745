"""Persistent compile-cache policy, called once by every entry point.

* `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself and this module sets
  no directory.
* Otherwise, on an accelerator backend, the cache lives at the fixed path
  `<repo>/.jax_cache`. The path is part of what makes a later run hit, so it
  must not move between runs.
* On the CPU backend the cache is switched off, whatever the environment
  says. XLA:CPU executables encode the compiling host's instruction-set
  features; loading one on a host that lacks some of them has crashed inside
  `backend_compile`, and serializing them has too.

JAX decides once per process whether the cache is on, not per backend. So in
a GPU process the programs placed on the CPU backend (the background mapping
worker, the CPU reference runs of `chip_smoke.py`) are cached as well, keyed
by platform but not by the host's instruction set, and XLA logs a warning
each time it loads one. Keep one cache directory to hosts of one CPU model.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def setup_compile_cache(min_compile_secs: float = 0.5) -> str | None:
    """Apply the policy above; returns the cache directory in use, or None
    when the cache is off."""
    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    d = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", d)
    return d
