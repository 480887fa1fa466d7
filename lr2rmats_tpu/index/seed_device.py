"""Minimizer-table lookup on the accelerator (the seeding stage's twin).

The seeding stage (the minimap2 `mm_idx_get` role; reference consumes it
via `minimap2 -x splice`, Snakefile:42-63) is a batch of binary searches
of query minimizer hashes against the sorted index table — exactly the
shape the index was designed for (ARCHITECTURE.md §2.1: sorted array +
searchsorted).  This module keeps the table RESIDENT on the device as an
int32 lane array (2k-bit hashes fit int32 whenever k <= 15, the
production default) and answers a whole read-batch's lookups in ONE
fused `searchsorted(side=left) + searchsorted(side=right)` call with a
single packed [2, nq] int32 result transfer.

Exact-agreement contract: (lo, hi) match `MinimizerIndex.lookup` (numpy
`searchsorted` / native `lookup_range_mt_c`) bit-for-bit — fuzz-tested in
tests/test_seed_device.py and end-to-end via LR2RMATS_DEVICE_SEED=1.

Opt-in (LR2RMATS_DEVICE_SEED=1); the host lookup is the default.  Whether
this twin becomes the default or goes is ROADMAP S3/D3, decided by its
time on the H100 (chip_smoke.py prints it beside the host lookup's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _next_pow2(n: int, floor: int = 4096) -> int:
    return 1 << max(int(n - 1).bit_length(), floor.bit_length() - 1)


class DeviceSeedLookup:
    """searchsorted (lo, hi) ranges against a device-resident hash table.

    Drop-in for `MinimizerIndex.lookup` (same (lo, hi) int64 contract).
    Requires 2*k <= 31 so the masked hashes fit int32 lanes; callers fall
    back to the host path otherwise (`DeviceSeedLookup.supports(index)`).
    """

    def __init__(self, index):
        import jax

        if not self.supports(index):
            raise ValueError(
                "device seed lookup needs 2*k<=31 (int32 hash lanes) and "
                "an int32-addressable table")
        self.index = index
        self.n = int(len(index.hashes))
        self._table = jax.device_put(index.hashes.astype(np.int32))
        self.calls = 0
        self.wall_s = 0.0
        self._fn = self._build()

    @staticmethod
    def supports(index) -> bool:
        # sharded indexes (parallel/shard_index.py) duck-type lookup but
        # hold no flat .hashes table — they keep their collective path
        hashes = getattr(index, "hashes", None)
        return (hashes is not None
                and 2 * int(index.k) <= 31
                and len(hashes) < (1 << 31) - 1)

    def _build(self):
        import jax
        import jax.numpy as jnp

        @jax.jit
        def look(table, q):
            lo = jnp.searchsorted(table, q, side="left")
            hi = jnp.searchsorted(table, q, side="right")
            return jnp.stack([lo, hi]).astype(jnp.int32)

        return look

    def lookup(self, qhashes: np.ndarray, n_threads: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) per query hash — bit-equal to MinimizerIndex.lookup."""
        import time

        nq = len(qhashes)
        if nq == 0:
            z = np.zeros(0, np.int64)
            return z, z
        t0 = time.perf_counter()
        width = _next_pow2(nq)
        # pad with int32 max: above every 2k-bit hash, so lo == hi == n
        # for the pad lanes (discarded by the slice anyway)
        q = np.full(width, (1 << 31) - 1, np.int32)
        q[:nq] = qhashes.astype(np.int32)
        out = np.asarray(self._fn(self._table, q))
        self.calls += 1
        self.wall_s += time.perf_counter() - t0
        return (out[0, :nq].astype(np.int64),
                out[1, :nq].astype(np.int64))
