"""Device splice-junction DP (ops/splice_device.py) parity tests.

The device placements must match align.splice.refine_splice_indel_np (the
numpy reference of csrc refine_splice_indel_c) exactly — scores are
integer-valued so float32 is exact — and host op-recovery from the chosen
cell must reproduce the full host ops.
"""

import numpy as np
import pytest

from lr2rmats_tpu.align.splice import refine_splice_indel_np
from lr2rmats_tpu.ops.splice_device import (junction_batch_scan,
                                            prepare_junction_batch,
                                            recover_ops)


def _random_gaps(seed, n, ref_len=100000):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    gaps = []
    for _ in range(n):
        m = int(rng.integers(0, 50))
        lr = int(rng.integers(100, ref_len - 20000))
        span = int(rng.integers(m + 40, m + 5000))
        q = ref[lr: lr + m].copy()
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if rng.random() < 0.5:
            j = int(rng.integers(0, m + 1))
            don = lr + j
            ref[don], ref[don + 1] = 2, 3
            last = lr + span - (m - j) - 1
            ref[last - 1], ref[last] = 0, 2
        gaps.append((q, lr, lr + span))
    return ref, gaps


def test_scan_placements_match_host():
    ref, gaps = _random_gaps(5, 120)
    batch = prepare_junction_batch(ref, gaps)
    score, bj, bcl, bcr, vote, found = junction_batch_scan(batch)
    for g, (q, lr, rr) in enumerate(gaps):
        res = refine_splice_indel_np(q, ref, lr, rr, 4, 30)
        if res is None:
            assert not found[g]
            continue
        assert found[g]
        assert abs(res[4] - score[g]) < 1e-6
        assert res[3] == vote[g]


def test_recovered_ops_match_host():
    ref, gaps = _random_gaps(9, 80)
    batch = prepare_junction_batch(ref, gaps)
    placements = junction_batch_scan(batch)
    rec = recover_ops(ref, gaps, placements)
    for g, (q, lr, rr) in enumerate(gaps):
        h = refine_splice_indel_np(q, ref, lr, rr, 4, 30)
        d = rec[g]
        assert (h is None) == (d is None)
        if h is None:
            continue
        assert h[0] == d[0]          # left ops
        assert h[1] == d[1]          # intron length
        assert h[2] == d[2]          # right ops
        assert h[3] == d[3]          # vote
        assert abs(h[4] - d[4]) < 1e-6


def test_empty_gap_query():
    """m=0 gaps (pure clean introns) must place without a query."""
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 5000).astype(np.uint8)
    ref[1000], ref[1001] = 2, 3      # GT
    ref[1998], ref[1999] = 0, 2      # AG
    gaps = [(np.zeros(0, np.uint8), 1000, 2000)]
    batch = prepare_junction_batch(ref, gaps)
    score, bj, bcl, bcr, vote, found = junction_batch_scan(batch)
    res = refine_splice_indel_np(gaps[0][0], ref, 1000, 2000, 4, 30)
    assert found[0] and res is not None
    assert abs(res[4] - score[0]) < 1e-6
    assert vote[0] == res[3] == 1


def test_device_junction_path_matches_host_records():
    """The full aligner with junction_backend='device' must produce records
    identical to the host-junction path (same CIGARs, tags, positions)."""
    from lr2rmats_tpu.io.fasta import Genome, revcomp
    from lr2rmats_tpu.align.batch import BatchAligner
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 400_000).astype(np.uint8)
    genome = Genome(["c"], codes, np.array([0, 400_000], np.int64))
    reads, names = [], []
    for i in range(40):
        pos = int(rng.integers(1000, 300_000))
        parts = []
        for e in range(3):
            elen = int(rng.integers(150, 400))
            parts.append((pos, pos + elen))
            pos += elen
            if e < 2:
                genome.codes[pos], genome.codes[pos + 1] = 2, 3
                pos += int(rng.integers(100, 3000))
                genome.codes[pos - 2], genome.codes[pos - 1] = 0, 2
        read = np.concatenate([genome.codes[a:b] for a, b in parts]).copy()
        mut = rng.random(len(read)) < 0.04
        read[mut] = (read[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if i % 2:
            read = revcomp(read)
        reads.append(read)
        names.append(f"r{i}")
    ah = BatchAligner(genome, backend="host", junction_backend="host")
    ad = BatchAligner(genome, backend="host", junction_backend="device",
                      index=ah.index)
    r1 = ah.align_batch(names, reads)
    r2 = ad.align_batch(names, reads)
    assert len(r1) == len(r2) > 0
    h = {(r.qname, r.flag): r for r in r1}
    for r in r2:
        o = h[(r.qname, r.flag)]
        assert o.pos == r.pos
        assert np.array_equal(o.cigar, r.cigar)
        assert o.tags == r.tags
