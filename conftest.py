"""Marks the tests too slow for tier-1 (``-m 'not slow'``) by node id.

The list lives here because the listed test files and ``tests/conftest.py``
belong to the frozen JAX package's suite and are not edited. Run the listed
tests with ``python -m pytest tests/ -m slow``.
"""

import pytest

# Each alone takes a fifth or more of tier-1's 1,470-s limit on a CPU, and
# only its frozen file could shorten it.
SLOW_TESTS = (
    "tests/test_megakernel_geom.py::test_nonrigid_inverse_mega_runs_fused",  # 1,363-1,775 s
    "tests/test_megakernel_grad.py::test_jvp_kernel_100_objects_matches_geom_kernel",  # 445-575 s
    "tests/test_megakernel_geom.py::test_track_slots_truncation_quantified",  # 385-515 s
)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: too slow for tier-1; run with -m slow")


@pytest.hookimpl(tryfirst=True)  # before pytest's own -m deselection
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
