"""Sharded alignment-step scaling harness.

BASELINE.md targets >=80% linear reads/s scaling from 1 to 2+ hosts.  This
harness measures the dp/tp-sharded device step
(parallel.mesh.sharded_align_step) on an N-device virtual CPU mesh — it
validates that the sharded program compiles, runs, and produces identical
results at every mesh size; wall-clock numbers on virtual devices share one
host's cores and are NOT a hardware scaling measurement.

Usage:
  JAX_PLATFORMS=cpu PYTHONPATH= \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python scripts/bench_scaling.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    from lr2rmats_tpu.parallel.mesh import make_mesh, sharded_align_step

    devs = jax.devices()
    rng = np.random.default_rng(0)
    M = 1 << 16
    idx_hash = np.sort(rng.integers(0, 2 ** 31, M).astype(np.uint32))
    idx_pos = rng.integers(0, 10 ** 6, M).astype(np.int32)
    B, Q = 512, 32
    read_hash = rng.choice(idx_hash, (B, Q)).astype(np.uint32)
    read_qpos = np.sort(rng.integers(0, 2000, (B, Q)).astype(np.int32), axis=1)

    results = {}
    ref_scores = None
    for n in (1, 2, 4, 8):
        if n > len(devs):
            break
        n_tp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(n_dp=n // n_tp, n_tp=n_tp,
                         devices=devs[:n])
        step = sharded_align_step(mesh)
        scores = np.asarray(step(idx_hash, idx_pos, read_hash, read_qpos))
        t0 = time.perf_counter()
        for _ in range(3):
            np.asarray(step(idx_hash, idx_pos, read_hash, read_qpos))
        dt = (time.perf_counter() - t0) / 3
        if ref_scores is None:
            ref_scores = scores
        else:
            np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)
        results[n] = round(B / dt, 1)
        print(f"devices={n} (dp={n // n_tp} tp={n_tp}): "
              f"{dt * 1000:.1f} ms/step, {B / dt:.0f} reads/s "
              f"(results identical: yes)")
    print(json.dumps({"virtual_mesh_reads_per_s": results}))


if __name__ == "__main__":
    main()
