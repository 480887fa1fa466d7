"""Test config: JAX on an 8-device virtual CPU mesh.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`, the default set here) with
eight virtual devices, so the multi-device paths (dp-sharded chain
dispatch, mesh collectives) run without an accelerator.  Tests that need
the GPU carry the `gpu` marker and skip here; `python chip_smoke.py` runs
the same checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

REF_DATA = pathlib.Path("/root/reference/test_data")


@pytest.fixture(scope="session")
def ref_data():
    if not REF_DATA.exists():
        pytest.skip("reference test_data not available")
    return REF_DATA
