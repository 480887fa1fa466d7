"""Multi-device scaling: device meshes, sharded alignment step, merge collectives.

The reference scales by shared-nothing per-sample jobs over a cluster
(reference Snakefile wildcards + qsub, SURVEY §2.3).  The design here
replaces that with first-class sharding over a jax mesh:

  dp axis — long-read batches are data-parallel
  tp axis — the minimizer hash table is sharded; each shard contributes its
            local seed hits which are all-gathered over the device
            interconnect before chaining

The sharded step below is the full device-side alignment step (seed lookup
-> anchor all-gather -> chain DP -> per-read best score), expressed with
shard_map so the collectives are explicit.  Host-side extension then runs on
each host's local shard of reads (see align.batch).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align.chain import ChainParams


def make_mesh(n_dp: Optional[int] = None, n_tp: int = 1,
              devices=None) -> Mesh:
    """Build a (dp, tp) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_tp
    assert n_dp * n_tp <= n, f"mesh {n_dp}x{n_tp} > {n} devices"
    dev = np.array(devices[: n_dp * n_tp]).reshape(n_dp, n_tp)
    return Mesh(dev, ("dp", "tp"))


def _chain_score_local(qpos, rpos, n_anchor, *, window: int, k: int,
                       max_qgap, max_intron, gap_open, gap_scale,
                       intron_scale, min_intron_gap):
    """Chain DP returning per-row best score (used inside shard_map).

    Same recurrence as ops.chain_jax._chain_scan, inlined so it can trace
    inside shard_map without nested jit.
    """
    B, A = qpos.shape
    W = window
    q = qpos.astype(jnp.int32)
    r = rpos.astype(jnp.int32)
    neg = jnp.float32(-1e18)
    arange_w = jnp.arange(W, dtype=jnp.int32)
    init_f = jnp.full((B, A), jnp.float32(k))

    def body(f, i):
        jidx = i - W + arange_w
        valid_j = (jidx >= 0) & (jidx < n_anchor[:, None])
        jc = jnp.clip(jidx, 0, A - 1)
        fj = jnp.take_along_axis(f, jnp.broadcast_to(jc, (B, W)), axis=1)
        qj = jnp.take_along_axis(q, jnp.broadcast_to(jc, (B, W)), axis=1)
        rj = jnp.take_along_axis(r, jnp.broadcast_to(jc, (B, W)), axis=1)
        qi = q[:, i][:, None]
        ri = r[:, i][:, None]
        dq = qi - qj
        dr = ri - rj
        ok = valid_j & (dq > 0) & (dr > 0) & (dq <= max_qgap) & (dr <= max_intron)
        gain = jnp.minimum(jnp.minimum(dq, dr), k).astype(jnp.float32)
        dd = dr - dq
        add = jnp.abs(dd).astype(jnp.float32)
        lin = gap_open + gap_scale * add
        logc = gap_open + intron_scale * jnp.log2(add + 1.0)
        cost = jnp.where(dd > min_intron_gap, jnp.minimum(logc, lin), lin)
        cost = jnp.where(dd == 0, 0.0, cost)
        sc = jnp.where(ok, fj + gain - cost, neg)
        best_sc = jnp.max(sc, axis=1)
        anchor_valid = i < n_anchor
        new_fi = jnp.where(anchor_valid & (best_sc > f[:, i]), best_sc, f[:, i])
        f = f.at[:, i].set(new_fi)
        return f, None

    f, _ = jax.lax.scan(body, init_f, jnp.arange(A, dtype=jnp.int32))
    col = jnp.arange(A)[None, :]
    f = jnp.where(col >= n_anchor[:, None], neg, f)
    return jnp.max(f, axis=1)


def sharded_align_step(mesh: Mesh, chain_params: Optional[ChainParams] = None,
                       hits_per_seed: int = 4):
    """Build the jitted multi-device alignment step.

    Inputs (global shapes):
      idx_hash [M]        uint32 sorted minimizer hashes — sharded over tp
      idx_pos  [M]        int32 positions                — sharded over tp
      read_hash [B, Q]    uint32 per-read minimizer hashes — sharded over dp
      read_qpos [B, Q]    int32 per-read minimizer positions — sharded dp

    Each tp shard looks up its local table, emits up to hits_per_seed
    anchors per seed, all-gathers anchors over tp, sorts by ref pos, runs
    the chain DP, and returns per-read best chain scores [B] (dp-sharded).

    SCOPE: idx_pos rides int32 lanes with an invalid-anchor sentinel of
    2**30, so positions must stay below 2**30 (~1 Gbp buffer) — callers
    are guarded.  The PRODUCTION pipeline never hits this: its device
    chain runs on cluster-relative int32 positions (align/batch.py,
    CLAUDE.md invariant); this step is the mesh collective data-plane
    validation kernel (dryrun_multichip, tests/test_parallel.py).
    """
    p = chain_params or ChainParams()

    def step(idx_hash, idx_pos, read_hash, read_qpos):
        Bl, Q = read_hash.shape
        H = hits_per_seed
        lo = jnp.searchsorted(idx_hash, read_hash.reshape(-1))
        lo = lo.reshape(Bl, Q)
        M = idx_hash.shape[0]
        # up to H consecutive hits per seed
        hit_idx = lo[:, :, None] + jnp.arange(H)[None, None, :]
        hit_ok = hit_idx < M
        hit_idx = jnp.clip(hit_idx, 0, M - 1)
        hh = idx_hash[hit_idx]
        ok = hit_ok & (hh == read_hash[:, :, None])
        gpos = jnp.where(ok, idx_pos[hit_idx], jnp.int32(2 ** 30))
        qpos = jnp.broadcast_to(read_qpos[:, :, None], gpos.shape)
        gpos = gpos.reshape(Bl, Q * H)
        qpos = qpos.reshape(Bl, Q * H)
        ok = ok.reshape(Bl, Q * H)
        # all-gather anchors over the index-shard axis (device collective)
        gpos = jax.lax.all_gather(gpos, "tp", axis=1, tiled=True)
        qpos = jax.lax.all_gather(qpos, "tp", axis=1, tiled=True)
        ok = jax.lax.all_gather(ok, "tp", axis=1, tiled=True)
        # sort anchors by gpos (invalid -> +inf end)
        order = jnp.argsort(gpos, axis=1)
        gpos = jnp.take_along_axis(gpos, order, axis=1)
        qpos = jnp.take_along_axis(qpos, order, axis=1)
        ok = jnp.take_along_axis(ok, order, axis=1)
        n_anchor = jnp.sum(ok, axis=1).astype(jnp.int32)
        scores = _chain_score_local(
            qpos, gpos, n_anchor, window=p.window, k=p.k,
            max_qgap=jnp.int32(p.max_qgap), max_intron=jnp.int32(p.max_intron),
            gap_open=jnp.float32(p.gap_open),
            gap_scale=jnp.float32(p.gap_scale),
            intron_scale=jnp.float32(p.intron_scale),
            min_intron_gap=jnp.int32(p.min_intron_gap))
        return scores

    from jax import shard_map
    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P("tp"), P("tp"), P("dp", None), P("dp", None)),
        out_specs=P("dp"),
        check_vma=False)
    jitted = jax.jit(fn)

    def guarded(idx_hash, idx_pos, read_hash, read_qpos):
        mx = int(np.max(idx_pos)) if len(idx_pos) else 0
        if mx >= 2 ** 30:
            raise ValueError(
                f"sharded_align_step: idx_pos max {mx} >= 2**30 — global "
                "positions past ~1 Gbp collide with the invalid-anchor "
                "sentinel on int32 lanes.  Human-scale genomes go through "
                "the production cluster-relative chain path "
                "(align/batch.py), not this mesh validation kernel.")
        return jitted(idx_hash, idx_pos, read_hash, read_qpos)

    return guarded


def mesh_exchange_candidates(T, mesh: Optional[Mesh] = None):
    """Run a candidate-transcript set through the dp all-gather collective
    (the `cat *.gtf | unique-gtf` gather, reference Snakefile:189-192),
    in-place.

    Rows are padded to the dp size, placed dp-sharded, all-gathered over
    the device interconnect, and written back in (shard, ordinal) order — byte-identical to the
    host concatenation, which the mesh pipeline test asserts.  On one
    device this is a no-op.  SINGLE-PROCESS scope: T holds the full
    candidate set and this collective validates the on-mesh merge data
    plane (shard → all-gather → identical order).  Across jax.distributed
    HOSTS the merge's data plane is parallel.distributed.gather_blobs
    (pipeline/stages.py routes there; per-host row counts differ, which a
    fixed dp padding cannot express).
    """
    devs = jax.devices()
    if len(devs) < 2 or T.n == 0:
        return T
    mesh = mesh or Mesh(np.array(devs), ("dp",))
    n_dp = mesh.devices.size
    n = T.n
    pad = (-n) % n_dp

    def padded(a):
        a = a[:n]
        if pad:
            shape = (pad,) + a.shape[1:]
            a = np.concatenate([a, np.zeros(shape, a.dtype)], 0)
        return np.ascontiguousarray(a)

    es = padded(T.exon_start)
    ee = padded(T.exon_end)
    en = padded(T.exon_n)
    tid = padded(T.tid)
    s2 = NamedSharding(mesh, P("dp", None))
    s1 = NamedSharding(mesh, P("dp"))
    gather = allgather_candidates(mesh)
    out = gather(jax.device_put(es, s2), jax.device_put(ee, s2),
                 jax.device_put(en, s1), jax.device_put(tid, s1))
    ges, gee, gen, gtid = (np.asarray(x) for x in out)
    T.exon_start[:n] = ges[:n]
    T.exon_end[:n] = gee[:n]
    T.exon_n[:n] = gen[:n]
    T.tid[:n] = gtid[:n]
    return T


def allgather_candidates(mesh: Mesh):
    """All-gather per-shard candidate transcript tensors over dp — the
    collective replacing the `cat *.gtf | unique-gtf` gather
    (reference Snakefile:189-192).  Rows keep (shard, ordinal) order so the
    downstream sequential merge is deterministic."""

    def gather(exon_start, exon_end, exon_n, tid):
        out = []
        for x in (exon_start, exon_end):
            out.append(jax.lax.all_gather(x, "dp", axis=0, tiled=True))
        for x in (exon_n, tid):
            out.append(jax.lax.all_gather(x, "dp", axis=0, tiled=True))
        return tuple(out)

    from jax import shard_map
    fn = shard_map(
        gather, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp"), P("dp")),
        out_specs=(P(None, None), P(None, None), P(None), P(None)),
        check_vma=False)
    return jax.jit(fn)
