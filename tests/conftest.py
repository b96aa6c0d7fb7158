"""Test configuration: 8 virtual CPU devices + float64 parity policy.

The suite runs on the CPU backend unless ``JAX_PLATFORMS`` names another,
with an 8-device virtual mesh (``--xla_force_host_platform_device_count=8``)
for the sharding tests.  Numerical parity tests against the reference's
C++ (double) formulas require x64.  Tests that need a GPU carry the ``gpu``
marker and decide inside a fixture whether there is one (``gpu_device``
below); on the card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(42)


def pytest_collection_modifyitems(session, config, items):
    """Run the sharded-sampler module FIRST.

    jaxlib 0.9.0's CPU compiler segfaults (reproducibly, in
    backend_compile_and_load) when the suite's largest program — the
    shard_map'd python-unrolled warmup chunk of
    test_sharded.py::TestShardedChunked — is compiled after ~240 tests of
    accumulated compiler state; the same test passes in a fresh process.
    Compiling the biggest programs first sidesteps the crash without
    changing any test."""
    front = [it for it in items if "test_sharded" in it.nodeid]
    rest = [it for it in items if "test_sharded" not in it.nodeid]
    items[:] = front + rest


_last_module = [None]


@pytest.fixture(autouse=True)
def _clear_jax_caches_between_modules(request):
    """Drop compiled executables at module boundaries.

    Round 4: the jaxlib-0.9.0 CPU segfault (same
    ``backend_compile_and_load`` signature as the round-2 one) came back
    with the suite's growth, and the crash point MOVES between runs —
    heap-state-dependent accumulation, not one test.  Freeing the
    executable caches per module keeps the live compiler state bounded;
    the persistent on-disk compilation cache (below) keeps repeated
    shapes cheap to re-load."""
    mod = request.node.nodeid.split("::", 1)[0]
    if _last_module[0] is not None and _last_module[0] != mod:
        jax.clear_caches()
    _last_module[0] = mod
    yield


from gpr_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache(min_compile_secs=0.5)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
    return gpus[0]
