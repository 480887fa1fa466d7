"""chip_smoke.py helpers: result line, GPU refusal, phase selection."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_result_line_shape():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": "dropped"})
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_require_gpu_refuses_other_backends():
    chip_smoke.require_gpu({"platform": "gpu", "count": 1})
    chip_smoke.require_gpu({"platform": "gpu", "count": 4}, 4)
    for dev, n in (({"platform": "cpu", "count": 8}, 1),
                   ({"platform": "rocm", "count": 1}, 1),
                   ({"platform": "gpu", "count": 1}, 4)):
        with pytest.raises(chip_smoke.SmokeError):
            chip_smoke.require_gpu(dev, n)


@pytest.mark.parametrize("four", [True, False], ids=["four_gpus", "one"])
def test_plan_selects_only_its_phases(four):
    phases = chip_smoke.plan(four)
    parity = {"chain", "polish", "junction", "seed", "sjcount",
              "graft_entry"}
    multi = {"split4", "run_4proc", "dryrun", "run_host4", "compare4"}
    assert all(callable(getattr(chip_smoke.Smoke, p)) for p in phases)
    if four:
        assert not parity & set(phases)
        assert multi <= set(phases)
        assert phases[0] == "preflight4"
    else:
        assert not multi & set(phases)
        assert parity <= set(phases)
        assert phases[0] == "preflight"
    # the reference every compared run needs comes before its compare
    assert phases.index("run_host") < phases.index("compare")


def test_cpu_backend_exits_nonzero_without_result():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not the GPU" in r.stderr
