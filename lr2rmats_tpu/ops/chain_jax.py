"""Batched splice-aware chaining DP + backtrack in JAX (the device path).

Same recurrence as the host implementation (align.chain.chain_anchors) but
over a padded batch of anchors.  The DP runs TRANSPOSED — anchors on the
major (row) axis, batch rows on the minor axis — so each step's window
read and score update are contiguous row slices of an [A+W, B] buffer.

The backtrack (primary chain = trace from argmax; secondary = best
anchor-disjoint chain, ≤48 candidate ends examined — align.chain.backtrack
semantics exactly) runs fused in the same device call:

  * chain traces are while_loops over chain length with [B]-wide per-row
    parent gathers and a one-hot OR into the membership mask;
  * the disjointness test needs "does the root path of end e cross the
    primary chain" for every e — because parent[a] < a always, one forward
    pass computes it: reach[a] = on_primary[a] | reach[parent[a]].

Only a 2-bit-per-anchor membership mask (bit0=primary, bit1=secondary) and
the two scores return to the host.

Agreement with the host version is tested in tests/test_chain_jax.py.

External layout:
  qpos, rpos : int32 [B, A]   anchors sorted by (rpos, qpos) per row
  n_anchor   : int32 [B]      valid count per row (rest is padding)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..align.chain import ChainParams


def _scan_core(qp, rp, n_anchor, W: int, k: int, max_qgap, max_intron,
               gap_open, gap_scale, intron_scale, min_intron_gap):
    """Transposed chain DP.  qp/rp are [W+A, B] (W dead rows on top).
    Returns f [A, B] float32, parent [A, B] int32 (-1 = chain start)."""
    AW, B = qp.shape
    A = AW - W
    neg = jnp.float32(-1e18)
    fpad = jnp.concatenate([jnp.full((W, B), neg),
                            jnp.full((A, B), jnp.float32(k))], 0)
    arange_w = jnp.arange(W, dtype=jnp.int32)[:, None]

    def body(i, carry):
        f, parents = carry
        fw = jax.lax.dynamic_slice(f, (i, 0), (W, B))        # rows i..i+W-1
        qw = jax.lax.dynamic_slice(qp, (i, 0), (W, B))       # = anchors i-W..i-1
        rw = jax.lax.dynamic_slice(rp, (i, 0), (W, B))
        qi = jax.lax.dynamic_slice(qp, (i + W, 0), (1, B))
        ri = jax.lax.dynamic_slice(rp, (i + W, 0), (1, B))
        jreal = i - W + arange_w                             # [W, 1]
        valid_j = (jreal >= 0) & (jreal < n_anchor[None, :])
        dq = qi - qw
        dr = ri - rw
        ok = valid_j & (dq > 0) & (dr > 0) & (dq <= max_qgap) & (dr <= max_intron)
        gain = jnp.minimum(jnp.minimum(dq, dr), k).astype(jnp.float32)
        dd = dr - dq
        add = jnp.abs(dd).astype(jnp.float32)
        lin = gap_open + gap_scale * add
        logc = gap_open + intron_scale * jnp.log2(add + 1.0)
        cost = jnp.where(dd > min_intron_gap, jnp.minimum(logc, lin), lin)
        cost = jnp.where(dd == 0, 0.0, cost)
        sc = jnp.where(ok, fw + gain - cost, neg)            # [W, B]
        best_w = jnp.argmax(sc, axis=0)                      # [B]
        best_sc = jnp.max(sc, axis=0)
        cur = jax.lax.dynamic_slice(f, (i + W, 0), (1, B))[0]
        anchor_valid = i < n_anchor
        take = anchor_valid & (best_sc > cur)
        new_f = jnp.where(take, best_sc, cur)
        parent_i = jnp.where(take, i - W + best_w, -1)
        f = jax.lax.dynamic_update_slice(f, new_f[None, :], (i + W, 0))
        parents = jax.lax.dynamic_update_slice(parents, parent_i[None, :],
                                               (i, 0))
        return f, parents

    parents0 = jnp.full((A, B), -1, jnp.int32)
    f, parents = jax.lax.fori_loop(0, A, body, (fpad, parents0))
    return f[W:], parents


def _pad_top(x, W: int):
    """Top-pad W zero rows (materialized, so the scan slices contiguously)."""
    A, B = x.shape
    return jnp.concatenate([jnp.zeros((W, B), x.dtype), x], 0)


@functools.partial(jax.jit, static_argnames=("window", "k"))
def _chain_scan_T(qT, rT, n_anchor, window: int, k: int,
                  max_qgap, max_intron, gap_open, gap_scale, intron_scale,
                  min_intron_gap):
    """Transposed contract: qT/rT [A, B] in, f/parent [A, B] out.  The
    transposes live HOST-side (numpy): a `.T` at the jit boundary lets XLA
    layout assignment propagate the transposed layout into the scan body,
    turning the contiguous row slices back into strided ops (20x slower,
    measured)."""
    W = window
    f, parents = _scan_core(_pad_top(qT, W), _pad_top(rT, W), n_anchor,
                            W, k, max_qgap, max_intron, gap_open, gap_scale,
                            intron_scale, min_intron_gap)
    A, B = f.shape
    neg = jnp.float32(-1e18)
    row = jnp.arange(A, dtype=jnp.int32)[:, None]
    pad = row >= n_anchor[None, :]
    f = jnp.where(pad, neg, f)
    parents = jnp.where(pad, -1, parents)
    return f, parents


EXC_ROWS = 8  # delta-overflow exception slots per lane (see pack_chain_buf)


def _backtrack_core(buf, window: int, k: int,
                    max_qgap, max_intron, gap_open, gap_scale, intron_scale,
                    min_intron_gap, min_score):
    """Fused chain DP + backtrack; see module docstring.  buf is one packed
    [A/2 + A/2 + EXC_ROWS + 1, B] int32 H2D array:
      rows [0, A/2)        query positions as u16 PAIRS (anchor 2i low
                           half-word, 2i+1 high — query positions fit 16
                           bits for any cDNA read; >=64 kb rows fall back
                           to the host chain)
      rows [A/2, A)        rT CONSECUTIVE DELTAS as u16 pairs (anchors are
                           ref-sorted so deltas are non-negative; rT[0]=0
                           cluster-relative); rT rebuilds on device as a
                           cumsum — this halves the dominant payload block
                           (rT was ~2/3 of every transfer)
      rows [A, A+EXC_ROWS) delta-overflow exceptions, one slot per row per
                           lane: (hi_bits << 16) | anchor_idx for deltas
                           >= 2^16 (introns over 65 kb); slot 0/0 is a
                           no-op pad.  Rows with more than EXC_ROWS
                           oversized deltas chain on the host instead.
      last row             n_anchor
    One array, half-width q and rT: one host-to-device copy per bucket.

    Every backtrack pass exploits the window invariant parent[i] ∈ [i-W, i)
    (both the device scan and the host DP only ever link within the
    predecessor window), so chain membership and reachability reduce to
    windowed row-slice loops with the same access pattern as the scan, with
    no per-row gathers.

    Returns ONE flat uint32 array: [K*B] 2-bit-packed chain membership
    (bit0=primary, bit1=secondary; anchor a of lane b at word (a//16)*B+b,
    shift 2*(a%16); K=ceil(A/16)) ++ [B] pscore (f32 bitcast) ++ [B] sscore
    (f32 bitcast)."""
    AB1, B = buf.shape
    A = AB1 - EXC_ROWS - 1

    def unpack_u16(rows):
        pk = jax.lax.bitcast_convert_type(rows, jnp.uint32)
        lo = (pk & jnp.uint32(0xFFFF)).astype(jnp.int32)
        hi = (pk >> jnp.uint32(16)).astype(jnp.int32)
        return jnp.stack([lo, hi], axis=1).reshape(A, B)

    qT = unpack_u16(buf[: A // 2])
    d = unpack_u16(buf[A // 2: A])
    # apply the oversized-delta exceptions (one [A, B] select per slot)
    iota_a = jnp.arange(A, dtype=jnp.int32)[:, None]
    for e in range(EXC_ROWS):
        slot = buf[A + e]                              # [B]
        at = slot & jnp.int32(0xFFFF)
        hi_bits = jax.lax.shift_right_logical(
            jax.lax.bitcast_convert_type(slot, jnp.uint32),
            jnp.uint32(16)).astype(jnp.int32)
        d = d + jnp.where(iota_a == at[None, :], (hi_bits << 16)[None, :], 0)
    rT = jnp.cumsum(d, axis=0)
    n_anchor = buf[AB1 - 1]
    W = window
    fT, pT = _scan_core(_pad_top(qT, W), _pad_top(rT, W), n_anchor,
                        W, k, max_qgap, max_intron, gap_open, gap_scale,
                        intron_scale, min_intron_gap)
    neg = jnp.float32(-1e18)
    # iota_a from the exception loop above is reused here ([A, 1])
    arange_w = jnp.arange(W, dtype=jnp.int32)[:, None]        # [W, 1]

    valid = iota_a < n_anchor[None, :]                        # [A, B]
    fm = jnp.where(valid, fT, neg)
    pe = jnp.argmax(fm, axis=0).astype(jnp.int32)             # [B]
    ps = jnp.max(fm, axis=0)
    p_ok = ps >= min_score

    # bottom-pad parents with W dead rows so backward window slices fit
    pT_pad = jnp.concatenate([pT, jnp.full((W, B), -1, jnp.int32)], 0)

    def membership(end, ok):
        """[A, B] bool: anchor a on the chain ending at end[lane].

        Backward windowed pass: a is on the chain iff a == end, or some
        on-chain anchor in (a, a+W] has parent a."""
        buf0 = jnp.zeros((A + W, B), jnp.bool_)

        def body(t, buf):
            i = A - 1 - t
            win_on = jax.lax.dynamic_slice(buf, (i + 1, 0), (W, B))
            win_par = jax.lax.dynamic_slice(pT_pad, (i + 1, 0), (W, B))
            row = (i == end) | jnp.any(win_on & (win_par == i), axis=0)
            row = row & ok
            return jax.lax.dynamic_update_slice(buf, row[None, :], (i, 0))

        buf = jax.lax.fori_loop(0, A, body, buf0)
        return buf[:A]

    mask1 = membership(pe, p_ok)

    # reach[a] = root path of a crosses the primary chain.  Forward windowed
    # pass: reach[a] = mask1[a] | reach[parent[a]], parent[a] ∈ [a-W, a).
    def reach_body(i, buf):
        win = jax.lax.dynamic_slice(buf, (i, 0), (W, B))      # rows i-W..i-1
        par = jax.lax.dynamic_slice(pT, (i, 0), (1, B))       # [1, B]
        sel = (arange_w == (par - (i - W))) & (par >= 0)      # [W, B]
        up = jnp.any(win & sel, axis=0)
        row = jax.lax.dynamic_slice(mask1, (i, 0), (1, B))[0] | up
        return jax.lax.dynamic_update_slice(buf, row[None, :], (i + W, 0))

    reach = jax.lax.fori_loop(0, A, reach_body,
                              jnp.zeros((W + A, B), jnp.bool_))[W:]

    scorable = valid & (fm >= min_score) & p_ok[None, :]
    disj = scorable & ~reach
    f_disj = jnp.where(disj, fm, neg)
    se = jnp.argmax(f_disj, axis=0).astype(jnp.int32)
    ss = jnp.max(f_disj, axis=0)
    any_disj = jnp.any(disj, axis=0)
    # the host examines candidate ends in descending-score order (ties ->
    # lower index first) and gives up after 48 overlapping ones; every
    # overlapping candidate ranked ahead of the best disjoint end would have
    # been traced first, so replicate the cap by counting them
    fse = jnp.take_along_axis(fm, se[None, :], axis=0)        # [1, B]
    ahead = (fm > fse) | ((fm == fse) & (iota_a < se[None, :]))
    n_better = jnp.sum(scorable & reach & ~mask1 & ahead, axis=0)
    s_ok = any_disj & (n_better < 48)
    mask2 = membership(se, s_ok)

    # 2-bit pack, 16 anchors per uint32 word
    val = mask1.astype(jnp.uint32) + 2 * mask2.astype(jnp.uint32)  # [A, B]
    K = (A + 15) // 16
    pad = K * 16 - A
    if pad:
        val = jnp.concatenate([val, jnp.zeros((pad, B), jnp.uint32)], 0)
    val = val.reshape(K, 16, B)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :, None]
    packed = jnp.sum(val << shifts, axis=1, dtype=jnp.uint32)      # [K, B]
    ps_bits = jax.lax.bitcast_convert_type(
        jnp.where(p_ok, ps, 0.0), jnp.uint32)
    ss_bits = jax.lax.bitcast_convert_type(
        jnp.where(s_ok, ss, 0.0), jnp.uint32)
    # ONE flat array: one device-to-host copy per call
    return jnp.concatenate([packed.reshape(-1), ps_bits, ss_bits])


@functools.partial(jax.jit, static_argnames=("window", "k"))
def _chain_backtrack(buf, window: int, k: int,
                     max_qgap, max_intron, gap_open, gap_scale, intron_scale,
                     min_intron_gap, min_score):
    return _backtrack_core(buf, window, k, max_qgap, max_intron, gap_open,
                           gap_scale, intron_scale, min_intron_gap,
                           min_score)


@functools.partial(jax.jit, static_argnames=("window", "k"))
def _chain_backtrack_multi(bufs, window: int, k: int,
                           max_qgap, max_intron, gap_open, gap_scale,
                           intron_scale, min_intron_gap, min_score):
    """One device call for SEVERAL bucket shapes: a read batch's anchor
    buckets fuse into one dispatch.  Returns the buckets' flat outputs
    concatenated in order; split host-side by K_i*B_i + 2*B_i."""
    outs = [_backtrack_core(b, window, k, max_qgap, max_intron, gap_open,
                            gap_scale, intron_scale, min_intron_gap,
                            min_score) for b in bufs]
    return jnp.concatenate(outs)


def unpack_chain_result(flat: np.ndarray, A: int, B: int):
    """Host-side inverse of the kernel's packing: flat [K*B+2B] uint32 ->
    (mask [B, A] uint8 with bit0=primary / bit1=secondary, ps [B] f32,
    ss [B] f32)."""
    K = (A + 15) // 16
    packed = flat[: K * B].reshape(K, B)
    ps = flat[K * B: K * B + B].view(np.float32)
    ss = flat[K * B + B:].view(np.float32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :, None]
    bits = ((packed[:, None, :] >> shifts) & 3).astype(np.uint8)
    return bits.reshape(K * 16, B)[:A].T, ps, ss


def chain_backtrack_batch_async(qpos: np.ndarray, rpos: np.ndarray,
                                n_anchor: np.ndarray, p: ChainParams,
                                min_score: float):
    """Dispatch fused chain+backtrack; returns the flat device result
    (decode with unpack_chain_result after jax.device_get).

    With several local devices and a divisible batch, the buffer is placed
    row-sharded (minor axis) over a dp mesh — every op in the kernel is
    independent per batch row, so XLA runs the chunk data-parallel across
    devices with no collectives until the packed output gathers.
    (Host-local dp sharding: under a jax.distributed process group the
    cross-host axis is the per-sample scatter (parallel.distributed), so
    the chain chunk only ever spans this host's addressable devices.)"""
    return dispatch_single_packed(pack_chain_buf(qpos, rpos, n_anchor), p,
                                  min_score)


def count_delta_overflows(gpos: np.ndarray) -> int:
    """Number of exception slots pack_chain_buf needs for one row —
    rows exceeding EXC_ROWS must chain on the host (align.batch routes
    them before packing).  The first delta is gpos[0] itself (the packer
    stores d[0] = r[0]), so a non-cluster-relative first position >= 2^16
    consumes a slot too; production rows are base-subtracted (r[0] == 0)."""
    if len(gpos) == 0:
        return 0
    n = int(gpos[0] >= (1 << 16))
    if len(gpos) >= 2:
        n += int(np.sum(np.diff(gpos) >= (1 << 16)))
    return n


def pack_chain_buf(qpos: np.ndarray, rpos: np.ndarray, n_anchor: np.ndarray
                   ) -> np.ndarray:
    """Host-pack the fused kernel's [A/2 + A/2 + EXC_ROWS + 1, B] int32
    buffer: q positions and rT deltas as u16 pairs, overflow exception
    slots, n_anchor row (layout: _backtrack_core docstring).  Callers must
    pre-route rows with more than EXC_ROWS oversized deltas to the host
    chain."""
    B, A = qpos.shape
    assert A % 2 == 0, "anchor buckets must be even for u16 packing"
    q = qpos.T.astype(np.uint32)                     # [A, B]
    r = rpos.T.astype(np.int64)
    d = np.empty((A, B), np.int64)
    d[0] = r[0]                                       # cluster-relative (=0)
    np.subtract(r[1:], r[:-1], out=d[1:])
    # padding columns beyond n_anchor carry zeros in rpos, making one
    # negative delta at the first pad anchor — clamp; those slots are
    # masked by n_anchor in the kernel
    np.maximum(d, 0, out=d)
    over_r, over_c = np.nonzero(d >= (1 << 16))       # (anchor, lane)
    du = (d & 0xFFFF).astype(np.uint32)
    buf = np.empty((A + EXC_ROWS + 1, B), np.int32)
    buf[: A // 2] = ((q[1::2] << np.uint32(16)) | q[0::2]).view(np.int32)
    buf[A // 2: A] = ((du[1::2] << np.uint32(16)) | du[0::2]).view(np.int32)
    buf[A: A + EXC_ROWS] = 0                          # (idx 0, hi 0) no-op
    if len(over_r):
        # slot index per lane: running count of that lane's exceptions
        order = np.lexsort((over_r, over_c))
        over_r, over_c = over_r[order], over_c[order]
        first = np.ones(len(over_c), bool)
        first[1:] = over_c[1:] != over_c[:-1]
        starts = np.nonzero(first)[0]
        slot = np.arange(len(over_c)) - starts[
            np.cumsum(first, dtype=np.int64) - 1]
        if int(slot.max()) >= EXC_ROWS:
            # a bare assert is stripped under -O, and the overflowing
            # write would land in (and be clobbered by) the n_anchor row
            # — silently wrong rT from that anchor on
            raise ValueError("row with >EXC_ROWS oversized deltas reached "
                             "the device packer (route it to the host "
                             "chain; see count_delta_overflows)")
        hi = (d[over_r, over_c] >> 16).astype(np.int64)
        buf[A + slot, over_c] = ((hi << 16) | over_r).astype(np.int32)
    buf[A + EXC_ROWS] = n_anchor
    return buf


def _dp_shardings(B: int, min_lanes_per_dev: int):
    """([*, B] sharded on B, [B] sharded) NamedShardings over the local
    dp mesh, or None when the row count doesn't warrant sharding.  One
    shared decision point — _shard_buf and chain_anchors_batch_async used
    to carry divergent copies."""
    devs = jax.local_devices()
    if not (len(devs) > 1 and B % len(devs) == 0
            and B >= min_lanes_per_dev * len(devs)):
        return None
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(devs), ("dp",))
    return NamedSharding(mesh, P(None, "dp")), NamedSharding(mesh, P("dp"))


def _shard_buf(buf: np.ndarray):
    """dp-shard a packed buffer over local devices when its row count
    divides (row-parallel kernel => pure data parallelism).  device_put
    on the HOST array ships each shard straight to its device; a prior
    jnp.asarray would pay a redundant full transfer to device 0 first."""
    sh = _dp_shardings(buf.shape[1], 8)
    if sh is not None:
        return jax.device_put(buf, sh[0])
    return jnp.asarray(buf)


def chain_backtrack_multi_async(items, p: ChainParams, min_score: float):
    """Fused multi-bucket dispatch: ONE device call for a whole read-batch.

    items: [(qpos [B_i, A_i], rpos, n_anchor), ...] — one per bucket, fixed
    shapes.  Decode the result with split_multi_result."""
    return dispatch_multi_packed(
        [pack_chain_buf(q, r, n) for q, r, n in items], p, min_score)


def dispatch_multi_packed(bufs, p: ChainParams, min_score: float):
    """chain_backtrack_multi_async over PRE-PACKED host buffers
    (pack_chain_buf output) — the packing can run on a worker thread."""
    args = tuple(_shard_buf(b) for b in bufs)
    return _chain_backtrack_multi(
        args, p.window, p.k,
        jnp.int32(p.max_qgap), jnp.int32(p.max_intron),
        jnp.float32(p.gap_open), jnp.float32(p.gap_scale),
        jnp.float32(p.intron_scale), jnp.int32(p.min_intron_gap),
        jnp.float32(min_score))


def dispatch_single_packed(buf, p: ChainParams, min_score: float):
    """chain_backtrack_batch_async over one PRE-PACKED host buffer."""
    return _chain_backtrack(
        _shard_buf(buf), p.window, p.k,
        jnp.int32(p.max_qgap), jnp.int32(p.max_intron),
        jnp.float32(p.gap_open), jnp.float32(p.gap_scale),
        jnp.float32(p.intron_scale), jnp.int32(p.min_intron_gap),
        jnp.float32(min_score))


def split_multi_result(flat: np.ndarray, shapes):
    """Inverse of the multi kernel's concatenation: shapes = [(A_i, B_i)];
    yields each bucket's (mask [B, A] uint8, ps [B], ss [B])."""
    off = 0
    for A, B in shapes:
        n = ((A + 15) // 16) * B + 2 * B
        yield unpack_chain_result(flat[off: off + n], A, B)
        off += n


def chain_anchors_batch_async(qpos: np.ndarray, rpos: np.ndarray,
                              n_anchor: np.ndarray, p: ChainParams,
                              shard: bool = True):
    """Dispatch the chain DP without blocking; returns device arrays
    (fT, parentT) in the kernel's native [A, B] layout."""
    qh = np.ascontiguousarray(qpos.T).astype(np.int32, copy=False)
    rh = np.ascontiguousarray(rpos.T).astype(np.int32, copy=False)
    nh = np.asarray(n_anchor, np.int32)
    sh = _dp_shardings(qpos.shape[0], 2) if shard else None
    if sh is not None:
        # shard straight from host (no full copy to device 0 first)
        q = jax.device_put(qh, sh[0])
        r = jax.device_put(rh, sh[0])
        n = jax.device_put(nh, sh[1])
    else:
        q, r, n = jnp.asarray(qh), jnp.asarray(rh), jnp.asarray(nh)
    return _chain_scan_T(
        q, r, n, p.window, p.k,
        jnp.int32(p.max_qgap), jnp.int32(p.max_intron),
        jnp.float32(p.gap_open), jnp.float32(p.gap_scale),
        jnp.float32(p.intron_scale), jnp.int32(p.min_intron_gap))


def chain_anchors_batch(qpos: np.ndarray, rpos: np.ndarray,
                        n_anchor: np.ndarray, p: ChainParams,
                        shard: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Batched chaining; returns (f [B,A] float32, parent [B,A] int32).

    With several local devices and a divisible batch, rows are placed with a
    dp NamedSharding so XLA runs the batch data-parallel across devices.
    """
    fT, parentT = chain_anchors_batch_async(qpos, rpos, n_anchor, p, shard)
    f, parent = jax.device_get((fT, parentT))
    return np.ascontiguousarray(f.T), np.ascontiguousarray(parent.T)
