"""Splice-aware banded junction DP on the accelerator.

The north-star kernel of the minimap2 `-ax splice` role (reference
Snakefile:61): for every inter-anchor-block gap that looks like an intron,
align both query flanks with a banded shift DP (|shift| <= B indels) and
score every (query split j, left shift cl, right shift cr) joint placement
with the GT..AG/CT..AC motif bonus — the exact semantics of
align/splice.py::refine_splice_indel_np / csrc refine_splice_indel_c, whose
scores are all integers and therefore exact in float32.

Batched over gaps: gaps sit on the minor axis, the DP walks the query
axis as a lax.scan over [W, G] state rows (`junction_batch_scan`).  It
returns per-gap placements (score, j, cl, cr, vote).  Op recovery for the
chosen cell (the cheap ~15%) runs on the host via csrc
junction_cell_ops_batch_c, so the accelerator owns the (m+1)*W*W combine
scan that dominates refine_splice_indel_c.

Production wiring: BatchAligner(junction_backend="device") or
LR2RMATS_DEVICE_JUNCTIONS=1 routes the aligner's junction gaps through
this module (collect/assemble passes in csrc), producing records
BIT-IDENTICAL to the host-junction path (tests/test_splice_device.py).
The host path is the default; whether the device path should be is
ROADMAP S1.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MATCH = 1.0
MISMATCH = -2.0
GAP = -3.0
NEG = -1e18

MGAP = 64          # max gap-query length handled on device (host fallback)
B_DEF = 4
PAD_CODE = 7       # never equals a real base code 0..3


# ---------------------------------------------------------------------------
# host-side batch preparation
# ---------------------------------------------------------------------------

def _dinuc_classes(ref, pos, table):
    """Vectorized dinucleotide classification at pos (start of the pair).
    table maps (b0, b1) -> class.  Out-of-range -> -1."""
    n = len(ref)
    valid = (pos >= 0) & (pos + 1 < n)
    b0 = ref[np.clip(pos, 0, n - 1)].astype(np.int64)
    b1 = ref[np.clip(pos + 1, 0, n - 1)].astype(np.int64)
    cls = table[np.clip(b0, 0, 4) * 5 + np.clip(b1, 0, 4)]
    return np.where(valid, cls, -1).astype(np.int8)


_DTAB = np.zeros(25, np.int8)
_DTAB[2 * 5 + 3] = 1   # GT
_DTAB[1 * 5 + 3] = 2   # CT
_DTAB[2 * 5 + 1] = 3   # GC
_DTAB[0 * 5 + 3] = 4   # AT
_ATAB = np.zeros(25, np.int8)
_ATAB[0 * 5 + 2] = 1   # AG
_ATAB[0 * 5 + 1] = 2   # AC
_ATAB[2 * 5 + 1] = 3   # GC
_ATAB[0 * 5 + 3] = 4   # AT


def prepare_junction_batch(ref: np.ndarray, gaps: List[Tuple[np.ndarray, int, int]],
                           B: int = B_DEF):
    """Pack (q, left_ref, right_ref) gap descriptors into padded arrays
    (fully vectorized window/class gathers).

    Returns dict of arrays with G = len(gaps) lanes, or None when empty.
    Gaps must satisfy len(q) <= MGAP and right_ref - left_ref >= len(q)+B
    (callers route larger gaps to the host implementation).
    """
    G = len(gaps)
    if G == 0:
        return None
    n = len(ref)
    m_arr = np.array([len(g[0]) for g in gaps], np.int32)
    lr_arr = np.array([g[1] for g in gaps], np.int64)
    rr_arr = np.array([g[2] for g in gaps], np.int64)
    # anchor-position prior centers (edge pullback El/Er; splice.W_POS);
    # legacy 3-tuple gaps mean "no pullback applied" (center 0)
    el_arr = np.array([g[3] if len(g) > 3 else 0 for g in gaps], np.int32)
    er_arr = np.array([g[4] if len(g) > 4 else 0 for g in gaps], np.int32)
    span_arr = rr_arr - lr_arr
    q = np.full((MGAP, G), PAD_CODE, np.int32)
    qr = np.full((MGAP, G), PAD_CODE, np.int32)
    for g, gap in enumerate(gaps):            # ragged copies stay a loop
        qg = gap[0]
        m = len(qg)
        q[:m, g] = qg
        qr[:m, g] = qg[::-1]
    rows = np.arange(MGAP + B, dtype=np.int64)[:, None]       # [MGAP+B, 1]
    mask_l = rows < np.minimum(m_arr + B, span_arr)[None, :]
    lidx = np.clip(lr_arr[None, :] + rows, 0, n - 1)
    lwin = np.where(mask_l, ref[lidx], PAD_CODE).astype(np.int32)
    ridx = np.clip(rr_arr[None, :] - 1 - rows, 0, n - 1)
    rwin = np.where(mask_l, ref[ridx], PAD_CODE).astype(np.int32)
    # donor/acceptor classes over candidate offsets i in [0, m+2B]
    # (class 0 = none; -1 = out-of-reference or beyond-m candidate)
    crows = np.arange(MGAP + 2 * B + 1, dtype=np.int64)[:, None]
    cmask = crows <= (m_arr + 2 * B)[None, :]
    dok = _dinuc_classes(ref, lr_arr[None, :] + crows - B, _DTAB)
    dok = np.where(cmask, dok, -1).astype(np.int8)
    apos = rr_arr[None, :] - (crows - B) - 2     # last-1 = start of the pair
    aok = _dinuc_classes(ref, apos, _ATAB)
    aok = np.where(cmask, aok, -1).astype(np.int8)
    return dict(q=q, qr=qr, lwin=lwin, rwin=rwin, m=m_arr, span=span_arr,
                dok=dok, aok=aok, el=el_arr, er=er_arr, B=B)


# ---------------------------------------------------------------------------
# shared combine (XLA) — takes SL/SR [M+1, W, G] from the flank DPs
# ---------------------------------------------------------------------------

def _motif_terms(dc, ac):
    """bonus, vote from donor/acceptor class tensors (elementwise — no
    table gathers).  Classes: donor 1=GT 2=CT 3=GC 4=AT; acceptor 1=AG
    2=AC 3=GC 4=AT; -1/0 = none."""
    canon_p = (dc == 1) & (ac == 1)
    canon_m = (dc == 2) & (ac == 2)
    semi_p = ((dc == 3) & (ac == 1)) | ((dc == 4) & (ac == 2))
    semi_m = ((dc == 2) & (ac == 3)) | ((dc == 1) & (ac == 4))
    bonus = jnp.where(canon_p | canon_m, 10.0,
                      jnp.where(semi_p | semi_m, 8.0, 0.0)).astype(jnp.float32)
    vote = (jnp.where(canon_p | semi_p, 1, 0)
            + jnp.where(canon_m | semi_m, -1, 0)).astype(jnp.int32)
    return bonus, vote


@functools.partial(jax.jit, static_argnames=("B",))
def _combine(SL, SR, m, span, dok, aok, el, er, B: int, min_intron):
    """Best (j, cl, cr) per gap.  SL/SR: [M+1, W, G] f32.

    el/er [G] are the anchor-position prior centers (splice.py W_POS); the
    penalty values are multiples of 3/8 on integer offsets, so f32 math
    here equals the host's f64 bit-for-bit."""
    M1, W, G = SL.shape
    M = M1 - 1
    jj = jnp.arange(M1, dtype=jnp.int32)
    # SRr[j] = SR[m - j] (per-lane row reversal)
    idx = jnp.clip(m[None, :] - jj[:, None], 0, M)          # [M+1, G]
    SRr = jnp.take_along_axis(SR, idx[:, None, :].repeat(W, 1), axis=0)
    # donor class at offset j+cl; acceptor at (m-j)+cr
    doff = jj[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]   # [M+1, W]
    dc = dok[doff]                                           # [M+1, W, G]
    aoff = jnp.clip((m[None, :] - jj[:, None])[:, None, :]
                    + jnp.arange(W, dtype=jnp.int32)[None, :, None],
                    0, MGAP + 2 * B)                         # [M+1, W, G]
    ac = jnp.take_along_axis(
        jnp.broadcast_to(aok[:, None, :], (aok.shape[0], W, G)), aoff, axis=0)
    bonus, vote = _motif_terms(dc[:, :, None, :], ac[:, None, :, :])
    # ilen = span - m + 2B - (cl + cr)
    clcr = (jnp.arange(W, dtype=jnp.int32)[:, None]
            + jnp.arange(W, dtype=jnp.int32)[None, :])       # [W, W]
    ilen = (span - m + 2 * B).astype(jnp.int64)[None, None, None, :] \
        - clcr[None, :, :, None].astype(jnp.int64)
    # anchor-position prior: doff - B / roff - B are the ref bases consumed
    # by the left/right flank (the donor/acceptor offsets into the gap);
    # one-sided hinge against under-slides into the anchored flank
    # (align/splice.py W_POS)
    w_pos = jnp.float32(0.375)
    pen_l = w_pos * jnp.maximum(el[None, None, :] - (doff[:, :, None] - B),
                                0).astype(jnp.float32)   # [M+1, W, G]
    roff = ((m[None, :] - jj[:, None])[:, None, :]
            + jnp.arange(W, dtype=jnp.int32)[None, :, None])  # [M+1, W, G]
    pen_r = w_pos * jnp.maximum(er[None, None, :] - (roff - B),
                                0).astype(jnp.float32)
    total = (SL[:, :, None, :] + SRr[:, None, :, :] + bonus
             - pen_l[:, :, None, :] - pen_r[:, None, :, :])
    ok = ((jj[:, None, None, None] <= m[None, None, None, :])
          & (dc[:, :, None, :] >= 0) & (ac[:, None, :, :] >= 0)
          & (ilen >= min_intron))
    total = jnp.where(ok, total, jnp.float32(NEG))
    # ties resolve to the LARGEST (j, cl, cr) — the host kernels' >= scan
    # (align/splice.py refine_splice_indel_np tie note); argmax is
    # first-max, so flatten the axis-reversed tensor and map indices back
    flat = total[::-1, ::-1, ::-1, :].reshape(M1 * W * W, G)
    best = jnp.argmax(flat, axis=0).astype(jnp.int32)
    score = jnp.max(flat, axis=0)
    bj = (M1 - 1) - best // (W * W)
    bcl = (W - 1) - (best // W) % W
    bcr = (W - 1) - best % W
    bvote = jnp.take_along_axis(
        vote[::-1, ::-1, ::-1, :].reshape(M1 * W * W, G),
        best[None, :], axis=0)[0]
    found = score > jnp.float32(NEG / 2)
    return score, bj, bcl, bcr, bvote, found


# ---------------------------------------------------------------------------
# flank DP: lax.scan (XLA)
# ---------------------------------------------------------------------------

def _shift_dp_scan(q, win, m, B: int):
    """Banded shift DP over the query axis; returns S [M+1, W, G] f32.

    q:   [M, G]  gap-query codes (PAD_CODE beyond m)
    win: [M+B, G] reference window codes
    """
    M, G = q.shape
    W = 2 * B + 1
    neg = jnp.float32(NEG)
    cc = jnp.arange(W, dtype=jnp.int32)
    # row 0: S[0, B+s] = GAP*s for s in [0, B] (s <= nr always), NEG below B
    row0 = jnp.where((cc >= B)[:, None],
                     jnp.float32(GAP) * (cc - B)[:, None].astype(jnp.float32),
                     neg)
    row0 = jnp.broadcast_to(row0, (W, G))
    # win padded with B+1 leading rows so row j+c-B-1 lives at j-1+c
    winpad = jnp.concatenate(
        [jnp.full((B + 1, G), PAD_CODE, win.dtype), win], 0)

    def body(prev, j):
        # j is 1-based query position
        qj = jax.lax.dynamic_slice(q, (j - 1, 0), (1, G))    # [1, G]
        wsl = jax.lax.dynamic_slice(winpad, (j, 0), (W, G))  # rlen-1 rows
        sub = jnp.where(wsl == qj, jnp.float32(MATCH), jnp.float32(MISMATCH))
        rlen = (j + cc - B)[:, None]                         # [W, 1]
        diag = jnp.where(rlen >= 1, prev + sub, neg)
        ins = jnp.concatenate([prev[1:] + jnp.float32(GAP),
                               jnp.full((1, G), neg)], 0)
        v = jnp.maximum(diag, ins)
        # sequential deletion scan over the W shifts (static unroll)
        rows = []
        best = jnp.full((G,), neg)
        for c in range(W):
            best = jnp.maximum(best + jnp.float32(GAP), v[c])
            valid = (j + c - B >= 0) & (j + c - B <= m + B)  # [G]
            best = jnp.where(valid, best, neg)
            rows.append(best)
        row = jnp.stack(rows, 0)                             # [W, G]
        return row, row

    _, S = jax.lax.scan(body, row0, jnp.arange(1, M + 1, dtype=jnp.int32))
    return jnp.concatenate([row0[None], S], 0)               # [M+1, W, G]


@functools.partial(jax.jit, static_argnames=("B",))
def _junction_scan(q, qr, lwin, rwin, m, span, dok, aok, el, er, B: int,
                   min_intron):
    SL = _shift_dp_scan(q, lwin, m, B)
    SR = _shift_dp_scan(qr, rwin, m, B)
    return _combine(SL, SR, m, span, dok, aok, el, er, B, min_intron)


def junction_batch_scan(batch, min_intron: int = 30):
    """Run the junction DP on the device; returns numpy placement arrays
    (score, j, cl, cr, vote, found)."""
    B = batch["B"]
    out = _junction_scan(
        jnp.asarray(batch["q"]), jnp.asarray(batch["qr"]),
        jnp.asarray(batch["lwin"]), jnp.asarray(batch["rwin"]),
        jnp.asarray(batch["m"]), jnp.asarray(batch["span"]),
        jnp.asarray(batch["dok"]), jnp.asarray(batch["aok"]),
        jnp.asarray(batch["el"]), jnp.asarray(batch["er"]),
        B, jnp.int64(min_intron))
    return tuple(np.asarray(x) for x in jax.device_get(out))


# ---------------------------------------------------------------------------
# host op-recovery for device placements
# ---------------------------------------------------------------------------

def recover_ops(ref: np.ndarray, gaps, placements, B: int = B_DEF):
    """For each found gap, recover (left_ops, intron_len, right_ops, vote,
    score) exactly as refine_splice_indel would, using the native cell
    traceback (csrc junction_cell_ops_batch_c).  Returns list with None for
    not-found gaps."""
    from ..native import get_lib
    score, bj, bcl, bcr, vote, found = placements
    lib = get_lib()
    results: List[Optional[tuple]] = [None] * len(gaps)
    sel = [g for g in range(len(gaps)) if found[g]]
    if not sel:
        return results
    if lib is None:
        from ..align.splice import refine_splice_indel_np
        for g in sel:
            qg, lr, rr = gaps[g][:3]
            el = gaps[g][3] if len(gaps[g]) > 3 else 0
            er = gaps[g][4] if len(gaps[g]) > 4 else 0
            results[g] = refine_splice_indel_np(qg, ref, lr, rr, B,
                                                el_exp=el, er_exp=er)
        return results
    n = len(sel)
    q_offs = np.zeros(n + 1, np.int64)
    for t, g in enumerate(sel):
        q_offs[t + 1] = q_offs[t] + len(gaps[g][0])
    qs = (np.concatenate([np.ascontiguousarray(gaps[g][0], np.uint8)
                          for g in sel])
          if q_offs[-1] else np.zeros(0, np.uint8))
    lr = np.array([gaps[g][1] for g in sel], np.int64)
    rr = np.array([gaps[g][2] for g in sel], np.int64)
    stride = MGAP + 2 * B + 4
    lo = np.zeros(n * 2 * stride, np.int32)
    ro = np.zeros(n * 2 * stride, np.int32)
    ln = np.zeros(n, np.int32)
    rn = np.zeros(n, np.int32)
    lib.junction_cell_ops_batch_c(
        qs, q_offs, ref, len(ref), lr, rr,
        np.ascontiguousarray(bj[sel], np.int32),
        np.ascontiguousarray(bcl[sel], np.int32),
        np.ascontiguousarray(bcr[sel], np.int32),
        B, n, stride, lo, ln, ro, rn)
    for t, g in enumerate(sel):
        base = t * 2 * stride
        lops = [(int(lo[base + 2 * i]), int(lo[base + 2 * i + 1]))
                for i in range(ln[t])]
        rops = [(int(ro[base + 2 * i]), int(ro[base + 2 * i + 1]))
                for i in range(rn[t])]
        m = len(gaps[g][0])
        span = gaps[g][2] - gaps[g][1]
        ilen = int(span - m + 2 * B - (bcl[g] + bcr[g]))
        results[g] = (lops, ilen, rops, int(vote[g]), float(score[g]))
    return results
