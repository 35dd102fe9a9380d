"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
exercised without GPUs (``chip_smoke.py`` drives the same paths on the
card).  Must be set before any jax import anywhere in the test process.
"""

import os

# Force CPU even when the environment preselects an accelerator (tests need
# the 8-device mesh).  jax.config (below) also works after an early jax
# import, as long as no backend has been initialized yet.
os.environ["JAX_PLATFORMS"] = "cpu"
# The persistent compile cache is for one-process CLI/bench runs; under
# the full suite its zstd serializer has segfaulted on write at multi-GB
# RSS, and CPU compiles are cheap — opt out (cli._enable_compile_cache
# honors the empty override).
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import signal

import numpy as np
import pytest

REFERENCE_BMP = "/root/reference/example_input/sample_1280×853.bmp"


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run @pytest.mark.slow tests (full tier; the default "
             "fast tier skips the heavy fuzz and 2-process suites — "
             "see CLAUDE.md)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy randomized / multi-process test "
                   "(skipped unless --runslow or FLRL_SLOW_TESTS=1)")
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test SIGALRM timeout")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("FLRL_SLOW_TESTS"):
        return
    skip = pytest.mark.skip(
        reason="slow tier: pass --runslow (or FLRL_SLOW_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    """Enforce @pytest.mark.timeout(N) with SIGALRM (pytest-timeout is not
    baked into the image; without this the marks are silently inert)."""
    mark = item.get_closest_marker("timeout")
    if mark and mark.args and hasattr(signal, "SIGALRM"):
        seconds = float(mark.args[0])

        def _on_alarm(signum, frame):
            raise TimeoutError(
                f"test exceeded its {seconds:.0f}s timeout mark")

        prev = signal.signal(signal.SIGALRM, _on_alarm)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, prev)
    else:
        yield


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """The full suite compiles many hundreds of XLA:CPU executables in
    one process; past ~90% of the suite the CPU backend segfaulted
    inside ``backend_compile_and_load`` (observed twice on this image,
    different tests — accumulated compiler state, not OOM: 120 GB
    free).  Dropping the in-memory executable caches per test module
    bounds that state; per-module recompiles of shared helpers cost a
    few seconds total."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def sample_bmp() -> np.ndarray:
    """The reference repo's sample input (3,275,658-byte 24-bit BMP)."""
    if not os.path.exists(REFERENCE_BMP):
        pytest.skip("reference sample BMP not available")
    return np.fromfile(REFERENCE_BMP, np.uint8)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


@pytest.fixture
def fuzz_inputs():
    """A battery of adversarial byte streams covering the degenerate cases
    the reference guards (SURVEY.md §4) — shared with the reference-oracle
    golden generator, see ``fuzz_battery.py``."""
    from fuzz_battery import battery
    return battery()
