"""Test config: the suite runs on the CPU backend with 8 virtual devices, so
sharding paths are exercised without accelerator hardware.

`JAX_PLATFORMS` decides the platform when it is set (CPU runs set
`JAX_PLATFORMS=cpu`); when it is unset the suite pins the CPU backend
itself. Tests marked `gpu` need a card: run them on a GPU machine with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`; elsewhere the `gpu`
fixture skips them."""

import os
import sys

# XLA:CPU's parallel LLVM codegen has segfaulted sporadically in long
# single-process runs (always inside backend_compile, three different call
# sites, never reproducible in shorter runs) — serialize it. Must be set
# before the backend initializes.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_cpu_parallel_codegen_split_count=1"
)

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)  # float32 everywhere

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from orb_slam3_comments_ghr_tpu.utils.cache import setup_compile_cache

setup_compile_cache()

import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's default backend is not
    a GPU. Decided here, at run time, so every xdist worker collects the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu on a GPU "
                    "machine)")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_accumulation():
    """Drop compiled executables between test MODULES. A single pytest
    process otherwise accumulates every jitted program of all ~40 modules in
    the XLA:CPU JIT engine, which has crashed (SIGSEGV/SIGABRT inside
    backend_compile) deterministically around the ~150th test. Per-module
    recompiles cost seconds; the bounded footprint keeps the long-lived
    process stable."""
    yield
    jax.clear_caches()
