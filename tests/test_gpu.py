"""Checks that need the GPU.  They skip on any other backend; run them
on the card with `python chip_smoke.py`, whose phases they call, or with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py`."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs the GPU; JAX's backend is "
                    f"{jax.default_backend()!r}")


@pytest.mark.parametrize("phase", ["graft_entry"])
def test_smoke_phase_on_gpu(gpu, phase):
    getattr(chip_smoke.Smoke(False), phase)()
