"""GPU device-line reduction of scripts/profile_trace.py on a fixture."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

from profile_trace import device_summary  # noqa: E402

GPU0 = "/device:GPU:0"


def _fixture():
    # (plane, line, name, start_ns, dur_ns) for 2 calls
    return [
        ("/host:CPU", "python", "dispatch", 0, 5_000_000),
        (GPU0, "Stream #14(Compute)", "loop_fusion", 1_000, 2_000),
        (GPU0, "Stream #14(Compute)", "scan_body", 3_000, 1_000),
        (GPU0, "Stream #15(MemcpyH2D)", "memcpy", 3_500, 1_000),
        (GPU0, "Stream #14(Compute)", "scan_body", 10_000, 1_000),
        (GPU0, "XLA Modules", "jit_chain", 1_000, 11_000),
        (GPU0, "XLA Ops", "fusion.1", 1_000, 2_000),
    ]


def test_busy_is_union_of_kernel_intervals_per_call():
    s = device_summary(_fixture(), n_calls=2)
    # kernels: [1000,3000) [3000,4000) [3500,4500) [10000,11000)
    # union = 3500 + 1000 = 4500 ns over 2 calls
    assert s["device_busy_ms_per_call"] == pytest.approx(4500 / 2 / 1e6)
    assert s["kernel_launches_per_call"] == pytest.approx(4 / 2)
    assert s["device_planes"] == [GPU0]
    top = {k["name"]: k for k in s["top_kernels"]}
    assert top["scan_body"]["count"] == 2
    assert top["loop_fusion"]["ms_per_call"] == pytest.approx(2000 / 2 / 1e6)


def test_derived_and_host_lines_are_not_kernels():
    s = device_summary([e for e in _fixture()
                        if not e[1].startswith("Stream")], n_calls=1)
    assert s["device_busy_ms_per_call"] == 0.0
    assert s["kernel_launches_per_call"] == 0.0
    # the derived lines are still listed for inspection
    assert f"{GPU0} | XLA Modules" in s["device_lines"]
    assert not any(k.startswith("/host") for k in s["device_lines"])
