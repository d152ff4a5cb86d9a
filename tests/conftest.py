"""Test config: force CPU with a virtual 8-device mesh for sharding tests."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run the slow tier too; default tier stays under ~5 "
             "minutes")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: slow tier (opt in with --runslow or "
                   "RADIANCE_FULL_TESTS=1)")


# Tier policy: slow tests are marked EXPLICITLY with @pytest.mark.slow
# at the definition site, so a new test is fast-tier by default and its
# author must opt it out deliberately.  Mark anything >= ~12s call
# time, but keep one load-bearing representative of every default code
# path in the fast tier.
def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") \
            or os.environ.get("RADIANCE_FULL_TESTS") == "1":
        return
    skip = pytest.mark.skip(
        reason="slow tier: pass --runslow (or RADIANCE_FULL_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs():
    """Free compiled executables between test modules.

    The suite compiles a few hundred CPU programs; with everything
    retained, the XLA:CPU JIT deterministically segfaults inside
    backend_compile once enough executables have accumulated (observed
    at the ~160th test regardless of which test runs there).  Dropping
    the jit caches per module keeps the live-executable population
    bounded; cross-module reuse is minimal so the recompile cost is
    noise."""
    yield
    jax.clear_caches()
