"""Short-read junction counting on the accelerator.

The verify stage of the STAR SJ.out.tab role (reference Snakefile:116-140;
the repo's host path is junctions/sjcount.py) is the densest, most regular
compute in the whole pipeline: every candidate (read, diagonal) placement
is scored by Hamming distance over the read length, and the surviving
junction crossings scatter-add into per-junction count arrays.  That is
a regular device shape — two gathers, one compare, one masked row-sum —
so this module provides:

  * `DeviceHammingVerifier` — mm[i] = Hamming(read seg rid[i],
    buf[pos[i] : pos[i]+len]) for C candidates in ONE device call, exact
    integer agreement with csrc hamming_pairs_c / the numpy loop
    (tests/test_sjcount_device.py).
  * `DeviceCounts` — uniq/multi/max_over accumulators resident on the
    device, updated per read-batch with scatter-add / scatter-max and
    fetched once at result() time.

Production wiring: JunctionCounter(..., backend="device") or
LR2RMATS_DEVICE_SJCOUNT=1.  Shapes are bucketed (reads to the next
power-of-two row count, lengths to the next lane multiple) so the jit
cache stays small across batches.

Opt-in (LR2RMATS_DEVICE_SJCOUNT=1); the host C++ path is the default.
Whether this twin becomes the default or goes is ROADMAP D3, decided by
its time on the H100 (chip_smoke.py prints it beside the host path's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 6)


class DeviceHammingVerifier:
    """Batched Hamming verification of candidate placements on the device.

    The combined genome+context buffer is shipped ONCE and stays resident;
    per call only the (padded) read matrix and candidate arrays move.
    Requires the buffer + max read length to fit int32 addressing.
    """

    def __init__(self, buf: np.ndarray):
        import jax
        import jax.numpy as jnp
        self._jax = jax
        self._jnp = jnp
        assert len(buf) < 2 ** 31 - 2 ** 20, "buffer exceeds int32 addressing"
        self.n = len(buf)
        self.buf = jax.device_put(np.ascontiguousarray(buf, np.uint8))
        self._fn = jax.jit(self._mm_kernel, static_argnums=())

    def _mm_kernel(self, buf, reads_pad, lens, rid, pos):
        jnp = self._jnp
        L = reads_pad.shape[1]
        iota = jnp.arange(L, dtype=jnp.int32)
        # window gather: [C, L] bytes of the reference buffer
        idx = jnp.clip(pos[:, None] + iota[None, :], 0, self.n - 1)
        win = jnp.take(buf, idx, axis=0)
        r = jnp.take(reads_pad, rid, axis=0)
        mask = iota[None, :] < jnp.take(lens, rid)[:, None]
        return jnp.sum((win != r) & mask, axis=1, dtype=jnp.int32)

    CHUNK = 1 << 17     # candidates per device call

    def verify(self, comb: np.ndarray, comb_off: np.ndarray,
               rid: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Exact equivalent of csrc hamming_pairs_c over the resident buf:
        comb/comb_off delimit read segments; (rid, pos) are candidates.

        Chunked over candidates; each chunk ships only the segments it
        references (the whole-seqset call can reference millions of
        reads, the padded matrix must stay bounded)."""
        jnp = self._jnp
        C = len(rid)
        out = np.empty(C, np.int32)
        all_lens = np.diff(comb_off).astype(np.int32)
        for lo in range(0, C, self.CHUNK):
            hi = min(lo + self.CHUNK, C)
            r = np.asarray(rid[lo:hi], np.int64)
            uniq, local = np.unique(r, return_inverse=True)
            lens = all_lens[uniq]
            S = len(uniq)
            Lmax = int(lens.max()) if S else 0
            Lpad = max(128, -(-Lmax // 128) * 128)
            Spad = _next_pow2(S)
            # vectorized ragged copy into the padded matrix
            tot = int(lens.sum())
            row = np.repeat(np.arange(S), lens)
            starts = np.cumsum(lens, dtype=np.int64) - lens
            col = np.arange(tot, dtype=np.int64) - np.repeat(starts, lens)
            src = np.repeat(comb_off[uniq], lens) + col
            reads_pad = np.zeros((Spad, Lpad), np.uint8)
            reads_pad[row, col] = comb[src]
            lens_pad = np.zeros(Spad, np.int32)
            lens_pad[:S] = lens
            n = hi - lo
            Cpad = _next_pow2(n)
            rid_pad = np.zeros(Cpad, np.int32)
            rid_pad[:n] = local
            pos_pad = np.zeros(Cpad, np.int32)
            pos_pad[:n] = pos[lo:hi]
            mm = self._fn(self.buf, jnp.asarray(reads_pad),
                          jnp.asarray(lens_pad), jnp.asarray(rid_pad),
                          jnp.asarray(pos_pad))
            out[lo:hi] = np.asarray(mm)[:n]
        return out


class DeviceCounts:
    """Device-resident uniq_c / multi_c / max_over with scatter-add updates.

    Junction ids >= n are dropped by the scatter (mode="drop"); padding /
    masked-out candidates use the sentinel id n — NOT -1, which scatter
    would wrap to n-1."""

    def __init__(self, n: int):
        import jax
        import jax.numpy as jnp
        self._jnp = jnp
        self.n = n
        size = max(n, 1)
        self.uniq = jnp.zeros(size, jnp.int32)
        self.multi = jnp.zeros(size, jnp.int32)
        self.over = jnp.zeros(size, jnp.int32)
        drop = jnp.int32(size)      # out-of-bounds-high sentinel

        def _upd(uniq, multi, over, cc, is_uniq, ov):
            one = jnp.ones_like(cc, jnp.int32)
            uniq = uniq.at[jnp.where(is_uniq, cc, drop)].add(
                one, mode="drop")
            multi = multi.at[jnp.where(is_uniq, drop, cc)].add(
                one, mode="drop")
            over = over.at[cc].max(ov, mode="drop")
            return uniq, multi, over

        self._upd = jax.jit(_upd)

    def add(self, cc: np.ndarray, is_uniq: np.ndarray, over: np.ndarray):
        jnp = self._jnp
        M = len(cc)
        if M == 0:
            return
        Mpad = _next_pow2(M)
        cc_p = np.full(Mpad, max(self.n, 1), np.int32)
        cc_p[:M] = cc
        u_p = np.zeros(Mpad, bool)
        u_p[:M] = is_uniq
        o_p = np.zeros(Mpad, np.int32)
        o_p[:M] = over
        self.uniq, self.multi, self.over = self._upd(
            self.uniq, self.multi, self.over, jnp.asarray(cc_p),
            jnp.asarray(u_p), jnp.asarray(o_p))

    def fetch(self):
        return (np.asarray(self.uniq)[: self.n].copy(),
                np.asarray(self.multi)[: self.n].copy(),
                np.asarray(self.over)[: self.n].copy())


def make_verifier(buf: np.ndarray) -> Optional[DeviceHammingVerifier]:
    """None when the buffer cannot be addressed with int32 (fall back to
    the host kernels)."""
    if len(buf) >= 2 ** 31 - 2 ** 20:
        return None
    return DeviceHammingVerifier(buf)
