"""Test configuration: run everything on CPU with 8 virtual devices.

The multi-device tests exercise sharding over a virtual 8-device CPU mesh —
the analog of the reference's single-box ``mpirun -n 2`` test strategy
(reference study/Boussinesq_run.py; SURVEY.md §4).  The environment must be
set before JAX is imported anywhere.  Tests that need a GPU carry the
``gpu`` marker and the ``gpu_device`` fixture, which skips them here.
"""
import os
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

assert jax.devices()[0].platform == "cpu"
assert jax.device_count() == 8, "expected 8 virtual CPU devices for sharding tests"


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none (decided when the
    test runs, never at import or collection)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; run on the card through chip_smoke.py")
    return devs[0]
