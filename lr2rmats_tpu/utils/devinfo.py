"""What a measurement ran on: JAX's device and the card's power limit.

A card may be set below its maximum power limit and then runs slower
under load, so every number the bench or chip_smoke.py prints carries the
card's name and power limit beside JAX's own device description.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional


def device_info() -> Dict[str, object]:
    """{"platform", "kind", "count"} as JAX reports its default devices
    (initializes the backend)."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_power() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output (one line per card), or None where there is no nvidia-smi."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None
