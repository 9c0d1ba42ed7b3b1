"""Test harness config: a clean 8-device CPU platform.

SURVEY.md §4: meshes/shard_map/psum are tested on CPU via
`--xla_force_host_platform_device_count=8` without real multi-device
hardware. The platform is pinned to CPU through `jax.config` here, before
any backend initializes, so the tests never reach for a card even where
one is present. Benchmarks (bench.py, chip_smoke.py) never import this
conftest.
"""

import os

# XLA_FLAGS is read lazily at (CPU) backend initialization, which happens
# after conftest import — env assignment here is early enough.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Sanitizer stand-ins (SURVEY.md §5, race-detection row): surface NaNs at
# the op that produced them in every test run. Costs a device sync per op
# on CPU tests only — benchmarks (bench.py) never import this conftest.
jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# Guard against a host XLA-CPU compiler segfault (jax/jaxlib 0.9.0,
# observed 2026-08-21/22, FOUR times at the same `pxla.py` compile
# site): a pjit compile late in the full suite crashes once ~300
# distinct compiled programs have accumulated in the process. Every
# victim passes in isolation, and the victim MODULE moves as tests are
# added (td_lambda twice → td_batched → perenv_levels — it tracks the
# accumulated-state position in the collection order, not any specific
# program), so a per-module guard list cannot converge. The durable
# mitigation bounds accumulation globally: drop the jit caches every
# _CACHE_CLEAR_EVERY tests, keeping the live program count well below
# the observed ~300-program trigger at the cost of a few recompiles of
# shared programs per window. Monitoring:
# tests/test_td_lambda.py::test_workaround_toolchain_canary fails when
# jax/jaxlib move, signalling re-evaluation; direct repro attempts are
# recorded in tools/xla_cpu_segfault_repro.py (synthetic compile
# accumulation does NOT trigger it).
_CACHE_CLEAR_EVERY = 100
_tests_since_cache_clear = 0


@pytest.fixture(autouse=True)
def _bounded_compile_cache():
    global _tests_since_cache_clear
    _tests_since_cache_clear += 1
    if _tests_since_cache_clear >= _CACHE_CLEAR_EVERY:
        _tests_since_cache_clear = 0
        jax.clear_caches()
    yield


@pytest.fixture(scope="session")
def devices():
    return jax.devices()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
