"""Test harness configuration.

Forces JAX onto a virtual 8-device CPU platform (before any backend starts)
so the suite runs anywhere and sharding tests exercise a real multi-device
mesh, as the multi-device analog of the reference's CPU<->GPU
cross-validation (test_interpolation.cpp:214-249).  ``--gpu`` leaves JAX on
the GPU instead, for the tests marked ``gpu``.
"""

import os
import pathlib

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow",
        action="store_true",
        default=False,
        help="run slow full-tile validation tests",
    )
    parser.addoption(
        "--gpu",
        action="store_true",
        default=False,
        help="leave JAX on its default platform (the GPU) so `-m gpu` tests run",
    )


def pytest_configure(config):
    if not config.getoption("--gpu"):
        # the CPU even where an accelerator is present: tests must not depend
        # on or monopolize it.  jax may already be imported by a pytest
        # plugin, so set both the env vars and the live config.
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
        # a compile cache of the suite's own, unless JAX_COMPILATION_CACHE_DIR
        # says where the cache lives (then JAX already uses that directory)
        if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
            jax.config.update(
                "jax_compilation_cache_dir",
                str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache_cpu"),
            )
        # cache even fast compiles: the suite jits hundreds of small shapes
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    assert not jax._src.xla_bridge.backends_are_initialized(), (
        "JAX backend initialized before tests/conftest.py could select its platform"
    )
    config.addinivalue_line("markers", "slow: full-tile validation (opt-in via --run-slow)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (takes the `gpu` fixture; skips elsewhere). On the "
        "GPU host: python -m pytest tests/ -m gpu --gpu -p no:xdist",
    )


@pytest.fixture
def gpu():
    """The first GPU device, or skip.  Decided here, at test time, never at
    import: the suite pins JAX to the CPU unless it is started with --gpu."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; the suite runs on the CPU")
    return devs[0]


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
