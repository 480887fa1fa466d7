"""Anchor-position junction prior + cross-read consensus polish tests.

The prior (align/splice.py W_POS) must agree bit-for-bit across all three
implementations (numpy, native C, device scan), and the
polish pass (align/polish.py) must snap an error-driven junction
misplacement onto the clean-sibling consensus with exact CIGAR/NM/AS
rewrites.
"""

import numpy as np
import pytest

from lr2rmats_tpu.align.splice import (refine_splice, refine_splice_np,
                                       refine_splice_indel,
                                       refine_splice_indel_np)
from lr2rmats_tpu.io.fasta import decode_seq
from lr2rmats_tpu.io.sam import OP_M, OP_N, AlnRec


# ---------------------------------------------------------------------------
# prior parity: native vs numpy with nonzero (el, er)

def test_refine_splice_prior_native_match():
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 4, 30_000).astype(np.uint8)
    for trial in range(40):
        m = int(rng.integers(0, 30))
        left = int(rng.integers(100, 5000))
        right = left + m + int(rng.integers(40, 9000))
        q = np.empty(m, np.uint8)
        half = m // 2
        q[:half] = ref[left: left + half]
        q[half:] = ref[right - (m - half): right]
        mut = rng.random(m) < 0.1
        q[mut] = (q[mut] + 1) % 4
        el = int(rng.integers(0, 7))
        er = int(rng.integers(0, 7))
        a = refine_splice(q, ref, left, right, el, er)
        b = refine_splice_np(q, ref, left, right, el, er)
        assert a[0] == b[0], trial
        assert a[1] == pytest.approx(b[1]), trial
        assert a[2] == b[2], trial


def test_refine_splice_indel_prior_native_match():
    rng = np.random.default_rng(37)
    ref = rng.integers(0, 4, 20_000).astype(np.uint8)
    for trial in range(30):
        m = int(rng.integers(0, 40))
        left = int(rng.integers(100, 5000))
        right = left + m + int(rng.integers(40, 8000))
        q = np.empty(m, np.uint8)
        half = m // 2
        q[:half] = ref[left: left + half]
        q[half:] = ref[right - (m - half): right]
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + 1) % 4
        el = int(rng.integers(0, 7))
        er = int(rng.integers(0, 7))
        a = refine_splice_indel(q, ref, left, right, el_exp=el, er_exp=er)
        b = refine_splice_indel_np(q, ref, left, right, el_exp=el, er_exp=er)
        if a is None or b is None:
            assert a == b, trial
            continue
        assert a[0] == b[0], trial
        assert a[1] == b[1], trial
        assert a[2] == b[2], trial
        assert a[3] == b[3], trial
        assert a[4] == pytest.approx(b[4]), trial


def test_device_scan_prior_match():
    """5-tuple gaps (with el/er prior centers) through the device scan."""
    from lr2rmats_tpu.ops.splice_device import (junction_batch_scan,
                                                prepare_junction_batch)
    rng = np.random.default_rng(41)
    ref = rng.integers(0, 4, 100_000).astype(np.uint8)
    gaps = []
    for _ in range(80):
        m = int(rng.integers(0, 50))
        lr = int(rng.integers(100, 80_000))
        span = int(rng.integers(m + 40, m + 5000))
        q = ref[lr: lr + m].copy()
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if rng.random() < 0.5:
            j = int(rng.integers(0, m + 1))
            ref[lr + j], ref[lr + j + 1] = 2, 3
            last = lr + span - (m - j) - 1
            ref[last - 1], ref[last] = 0, 2
        gaps.append((q, lr, lr + span,
                     int(rng.integers(0, 7)), int(rng.integers(0, 7))))
    batch = prepare_junction_batch(ref, gaps)
    score, bj, bcl, bcr, vote, found = junction_batch_scan(batch)
    for g, (q, lr, rr, el, er) in enumerate(gaps):
        res = refine_splice_indel_np(q, ref, lr, rr, 4, 30,
                                     el_exp=el, er_exp=er)
        if res is None:
            assert not found[g], g
            continue
        assert found[g], g
        assert abs(res[4] - score[g]) < 1e-6, g
        assert res[3] == vote[g], g


def test_prior_hinge_penalty_applied():
    """A placement that under-slides into the anchored flank pays exactly
    W_POS per base; placements at/beyond the anchor center stay free."""
    from lr2rmats_tpu.align.splice import W_POS
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 3000).astype(np.uint8)
    left, right = 1000, 2500
    # a single canonical motif forcing the junction to j=0
    ref[left + 0], ref[left + 1] = 2, 3        # GT donor at j=0
    ref[right - 10], ref[right - 9] = 0, 2     # AG acceptor for m-j=8
    # kill accidental GTs downstream so the placement stays pinned
    ref[left + 2: left + 12] = 1
    q = ref[right - 8: right].copy()           # matches the right flank
    j0, s0, _ = refine_splice_np(q, ref, left, right, 0, 0)
    assert j0 == 0
    for el in (1, 2, 4):
        j, s, _ = refine_splice_np(q, ref, left, right, el, 0)
        if j == 0:   # placement held: the penalty is exactly el * W_POS
            assert s == pytest.approx(s0 - W_POS * el)
    # er deeper than the right flank coverage penalizes too
    j, s, _ = refine_splice_np(q, ref, left, right, 0, 0)
    j2, s2, _ = refine_splice_np(q, ref, left, right, 0, 8)
    assert s2 <= s  # acc offset m-j=8 >= er=8 -> actually free
    assert s2 == pytest.approx(s)


# ---------------------------------------------------------------------------
# polish pass

def _mk_rec(name, tid, pos, seq_codes, ops, nm=0):
    match = sum(l for op, l in ops if op == OP_M) - nm
    return AlnRec(qname=name, flag=0, tid=tid, pos=pos, mapq=60,
                  cigar=np.array([(l << 4) | op for op, l in ops],
                                 np.uint32),
                  seq=decode_seq(seq_codes),
                  tags={"NM": nm, "AS": 2 * match - 4 * nm})


def _toy_junction_set():
    """Genome with one true GT..AG junction; two clean reads placed on
    truth and one read mis-placed 4 bp upstream (its CIGAR says so, and
    its bases genuinely match truth)."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 6000).astype(np.uint8)
    don, acc = 2000, 2499          # 0-based first/last intron base
    codes[don], codes[don + 1] = 2, 3
    codes[acc - 1], codes[acc] = 0, 2
    # make sure no accidental GT 4bp upstream
    codes[don - 4], codes[don - 3] = 1, 1
    a, b = don - 60, acc + 61      # exon windows [a, don) and (acc, b]
    read = np.concatenate([codes[a: don], codes[acc + 1: b]])
    recs = [
        _mk_rec("clean1", 0, a, read, [(OP_M, 60), (OP_N, 500), (OP_M, 60)]),
        _mk_rec("clean2", 0, a, read, [(OP_M, 60), (OP_N, 500), (OP_M, 60)]),
    ]
    # misplaced: junction 4 bp upstream — q[56:60] (truth's last 4 donor
    # bases) land on codes[acc-3..acc] where they mismatch
    bad = _mk_rec("bad", 0, a, read, [(OP_M, 56), (OP_N, 500), (OP_M, 64)])
    # recompute bad's true NM under its (wrong) placement
    nm = int(np.sum(read[:56] != codes[a: a + 56]))
    nm += int(np.sum(read[56:] != codes[a + 56 + 500: a + 56 + 500 + 64]))
    bad.tags["NM"] = nm
    bad.tags["AS"] = 2 * (120 - nm) - 4 * nm
    recs.append(bad)
    return codes, recs, (don, acc)


def test_support_weighting_clean_flanks():
    from lr2rmats_tpu.align.polish import (W_CLEAN,
                                           collect_junction_support)
    codes, recs, (don, acc) = _toy_junction_set()
    offs = np.array([0, len(codes)], np.int64)
    sup = collect_junction_support(recs[:2], codes, offs)
    assert sup == {(0, don, acc): 2 * W_CLEAN}


def test_polish_snaps_misplaced_junction():
    from lr2rmats_tpu.align.polish import polish_records
    codes, recs, (don, acc) = _toy_junction_set()
    offs = np.array([0, len(codes)], np.int64)
    n = polish_records(recs, codes, offs)
    assert n == 1
    bad = recs[2]
    ops = [(int(c) & 0xF, int(c) >> 4) for c in bad.cigar]
    assert ops == [(OP_M, 60), (OP_N, 500), (OP_M, 60)]
    # the read is error-free under the true placement
    assert bad.tags["NM"] == 0
    assert bad.tags["AS"] == 2 * 120
    # clean records untouched
    for r in recs[:2]:
        assert [(int(c) & 0xF, int(c) >> 4) for c in r.cigar] == \
            [(OP_M, 60), (OP_N, 500), (OP_M, 60)]


def test_polish_noop_when_consensus_agrees():
    from lr2rmats_tpu.align.polish import polish_records
    codes, recs, _ = _toy_junction_set()
    offs = np.array([0, len(codes)], np.int64)
    assert polish_records(recs[:2], codes, offs) == 0


def test_constrained_place_many_matches_scalar():
    """The batched forced-placement DP (accelerator scan + host traceback)
    must equal the scalar host path bit-for-bit, including infeasible and
    fallback (span < m+B) tasks."""
    from lr2rmats_tpu.align.polish import (B, _constrained_place,
                                           _constrained_place_many)
    rng = np.random.default_rng(77)
    ref = rng.integers(0, 4, 200_000).astype(np.uint8)
    items = []
    for _ in range(300):
        m = int(rng.integers(0, 120))
        L0 = int(rng.integers(100, 150_000))
        span = int(rng.integers(max(m - 5, 1) + 60, m + 4000))
        R0 = L0 + span
        qwin = ref[L0: L0 + m].copy()
        mut = rng.random(m) < 0.1
        qwin[mut] = (qwin[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        # forced intron somewhere in the window (sometimes infeasible)
        j = int(rng.integers(0, m + 2 * B + 1)) - B
        don = L0 + max(j, -2)
        ilen = span - m + int(rng.integers(-B, B + 1))
        acc = don + max(ilen, 10) - 1
        items.append((qwin, L0, R0, don, acc))
    # a couple of short-span fallback tasks
    items.append((ref[500:560].copy(), 500, 560 + 4, 520, 540))
    batched = _constrained_place_many(items, ref)
    n_defer = 0
    for it, got in zip(items, batched):
        want = _constrained_place(it[0], ref, it[1], it[2], it[3], it[4])
        assert (want is None) == (got is None)
        if want is None:
            continue
        if got[0] == "defer":
            # device lanes return the best split score only; the accepted
            # moves re-run the host DP (= `want` here) for the traceback
            n_defer += 1
            assert want[0] == got[1], (it, want[0], got[1])
            continue
        assert want[0] == got[0]          # score (integer-valued)
        assert want[1] == got[1] and want[2] == got[2]
        assert want[3] == got[3] and want[4] == got[4]
    assert n_defer > 0                    # the batch path actually ran
