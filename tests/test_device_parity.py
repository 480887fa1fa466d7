"""Device kernels of the main path against their host twins, on CPU.

The same comparisons chip_smoke.py makes on the GPU at production shapes,
here at small shapes on JAX's CPU backend:

  * the fused chain DP + backtrack (ops.chain_jax) against the native host
    chain (csrc chain_small_batch_c) on anchor rows the aligner builds
    from simulated clean and ONT-like reads, in each anchor bucket.
    Chain membership must match exactly; scores to a few float32 ulps
    (the device sums in float32, the host in float64);
  * the polish placement DP (align.polish._polish_best_pair) against the
    scalar host DP (_constrained_place): integer-valued, exact;
  * the junction DP (ops.splice_device.junction_batch_scan) against the
    numpy reference of the native kernel: integer-valued, exact.
"""

import numpy as np
import pytest

from lr2rmats_tpu.align.batch import A_BUCKETS


def _rows(profile, seed=5, n_reads=200):
    import bench
    from lr2rmats_tpu.align.batch import BatchAligner
    from lr2rmats_tpu.io.fasta import Genome
    rng = np.random.default_rng(seed)
    n = 2_000_000
    g = Genome(["c"], rng.integers(0, 4, n).astype(np.uint8),
               np.array([0, n], np.int64))
    reads, _ = bench.simulate_reads(g, n_reads, rng, profile=profile)
    al = BatchAligner(g)
    try:
        return al._batch_anchors(reads), al.p
    finally:
        al.close()


def _bucket(rows, A, rng):
    """Rows for bucket A: every row with more anchors than the previous
    bucket's width, cut to a random length in (lo, A] (a prefix of a
    ref-sorted row is a valid row)."""
    lo = 1 if A == A_BUCKETS[0] else A_BUCKETS[A_BUCKETS.index(A) - 1]
    sel = [r for r in rows if len(r.qpos) > lo]
    B = len(sel)
    qp = np.zeros((B, A), np.int32)
    gp = np.zeros((B, A), np.int32)
    nn = np.zeros(B, np.int32)
    for b, r in enumerate(sel):
        k = min(len(r.qpos), int(rng.integers(lo + 1, A + 1)))
        qp[b, :k] = r.qpos[:k]
        gp[b, :k] = r.gpos[:k] - r.base
        nn[b] = k
    return qp, gp, nn


@pytest.mark.parametrize("profile", ["clean", "ont"])
@pytest.mark.parametrize("A", A_BUCKETS)
def test_fused_chain_matches_host_chain(A, profile):
    import jax
    from lr2rmats_tpu.align.chain import backtrack, chain_anchors
    from lr2rmats_tpu.native import get_lib
    from lr2rmats_tpu.ops.chain_jax import (dispatch_single_packed,
                                            pack_chain_buf,
                                            unpack_chain_result)
    rows, ap = _rows(None if profile == "clean" else "ont")
    qp, gp, nn = _bucket(rows, A, np.random.default_rng(A))
    B = len(nn)
    assert B >= 20
    pc = ap.chain
    flat = jax.device_get(dispatch_single_packed(
        pack_chain_buf(qp, gp, nn), pc, ap.min_score))
    mask, ps, ss = unpack_chain_result(np.asarray(flat), A, B)
    lib = get_lib()
    if lib is not None:
        hm = np.zeros((B, A), np.uint8)
        hps = np.zeros(B, np.float32)
        hss = np.zeros(B, np.float32)
        lib.chain_small_batch_c(
            qp, gp, nn, B, A, pc.k, pc.window, pc.max_intron, pc.max_qgap,
            pc.gap_open, pc.gap_scale, pc.intron_scale, pc.min_intron_gap,
            float(ap.min_score), hm.reshape(-1), hps, hss)
    else:
        hm = np.zeros((B, A), np.uint8)
        hps = np.zeros(B)
        hss = np.zeros(B)
        for b in range(B):
            k = int(nn[b])
            f, par = chain_anchors(qp[b, :k].astype(np.int64),
                                   gp[b, :k].astype(np.int64), pc)
            pri, hps[b], sec, hss[b] = backtrack(f, par, ap.min_score)
            hm[b, pri] |= 1
            hm[b, sec] |= 2
    valid = np.arange(A)[None, :] < nn[:, None]
    np.testing.assert_array_equal(mask * valid, hm * valid)
    np.testing.assert_allclose(ps, hps, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ss, hss, rtol=1e-6, atol=0)
    assert (hm & 1).any()


@pytest.mark.parametrize("m_range", [(0, 40), (40, 120), (120, 193)],
                         ids=["short", "mid", "long"])
def test_polish_best_pair_matches_constrained_place(m_range):
    from lr2rmats_tpu.align.polish import (_PLACE_M, B, _constrained_place,
                                           _constrained_place_many)
    assert m_range[1] <= _PLACE_M + 1
    rng = np.random.default_rng(m_range[0])
    ref = rng.integers(0, 4, 300_000).astype(np.uint8)
    items = []
    for _ in range(300):
        m = int(rng.integers(*m_range))
        L0 = int(rng.integers(100, 250_000))
        span = m + B + int(rng.integers(0, 3000))
        qwin = ref[L0: L0 + m].copy()
        mut = rng.random(m) < 0.1
        qwin[mut] = (qwin[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        don = L0 + int(rng.integers(0, m + B + 1))
        acc = don + max(span - m + int(rng.integers(-B, B + 1)), 10) - 1
        items.append((qwin, L0, L0 + span, don, acc))
    got = _constrained_place_many(items, ref)
    n_dev = 0
    for it, g in zip(items, got):
        want = _constrained_place(it[0], ref, *it[1:])
        assert (want is None) == (g is None)
        if want is None:
            continue
        assert g[0] == "defer"          # every task rode the device batch
        n_dev += 1
        assert g[1] == want[0]
    assert n_dev > 0


@pytest.mark.parametrize("m_range", [(0, 8), (8, 32), (32, 65)],
                         ids=["short", "mid", "long"])
def test_junction_scan_matches_host(m_range):
    from lr2rmats_tpu.align.splice import refine_splice_indel_np
    from lr2rmats_tpu.ops.splice_device import (MGAP, junction_batch_scan,
                                                prepare_junction_batch,
                                                recover_ops)
    assert m_range[1] <= MGAP + 1
    rng = np.random.default_rng(100 + m_range[0])
    ref = rng.integers(0, 4, 100_000).astype(np.uint8)
    gaps = []
    for _ in range(64):
        m = int(rng.integers(*m_range))
        lr = int(rng.integers(100, 80_000))
        span = int(rng.integers(m + 40, m + 5000))
        q = ref[lr: lr + m].copy()
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if rng.random() < 0.5:                       # plant GT..AG
            don = lr + int(rng.integers(0, m + 1))
            ref[don], ref[don + 1] = 2, 3
            last = lr + span - (m - (don - lr)) - 1
            ref[last - 1], ref[last] = 0, 2
        gaps.append((q, lr, lr + span))
    placed = junction_batch_scan(prepare_junction_batch(ref, gaps))
    rec = recover_ops(ref, gaps, placed)
    n_found = 0
    for (q, lo, hi), d in zip(gaps, rec):
        h = refine_splice_indel_np(q, ref, lo, hi, 4, 30)
        assert h == d
        n_found += h is not None
    assert n_found > 0
