"""Production hash-range-sharded minimizer index (SURVEY §5, VERDICT r2 #5).

The reference handles genome scale by replicating the minimap2 index per
cluster job (reference Snakefile:24-38, 61).  At full-human scale the
table is ~18 GB (GRCH38_DRYRUN.json), so the design here also
offers the sharded arm: the hash-sorted table is partitioned by
hash % n (minimizer hashes are window minima and skew low, so contiguous
ranges would not balance; the mod of a murmur-mixed hash does), one
shard per host/mesh-tp slot.  Every hash lives in exactly one shard and
the per-shard radix sort is stable, so each query's hit list is
bit-identical to the unsharded table's — sharded runs produce
byte-identical output at any shard count (tested).

Two modes:

  * in-process (tp over one host's mesh): all shards are resident; lookup
    routes each query hash to its shard's bucketed binary search and
    returns ranges into the concatenated table.  This is the code path
    the virtual-mesh pipeline test drives byte-identical.
  * multi-process (one shard per jax.distributed host): each host builds
    and holds ONLY its hash range (~1/n build memory and resident RSS —
    measured by scripts/dryrun_grch38.py --shards).  `lookup` is then a
    COLLECTIVE: every host contributes its query hashes, answers the
    queries that land in its range, and the hits ride an all-gather back
    (parallel.distributed.gather_blobs over the distributed backend); `self.pos/strand`
    hold the returned per-call hit arrays.  All hosts must call
    lookup_collective in lockstep (same number of batches; pad with empty
    queries) and from ONE thread (drive batches with dispatch_batch /
    finish_batch, not the seed-ahead worker of align_seqset_packed — the
    per-call self.pos would race).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..index.minimizer import K_DEFAULT, W_DEFAULT, MinimizerIndex
from ..utils import log


def shard_of(h: np.ndarray, n_shards: int, k: int = 0) -> np.ndarray:
    """Shard id per hash: h % n.  Minimizer hashes are window MINIMA and
    skew low, so contiguous hash ranges never balance; the mod of a
    murmur-mixed hash does, while still keeping every copy of a hash in
    exactly one shard (the property lookup routing and bit-identity rely
    on).  k is unused (kept for signature stability)."""
    return (h % np.uint64(n_shards)).astype(np.int64)


class ShardedMinimizerIndex:
    """Duck-type of MinimizerIndex (lookup / pos / strand / chrom_offsets /
    global_to_chrom / names / k / w) over hash-range shards."""

    def __init__(self, shards: List[Optional[MinimizerIndex]],
                 local_only: bool = False):
        """shards: per-range MinimizerIndex; in multi-process mode pass
        None for every range this host does not hold and local_only=True."""
        self.n_shards = len(shards)
        self.shards = shards
        self.local_only = local_only
        some = next(s for s in shards if s is not None)
        self.k, self.w = some.k, some.w
        self.chrom_offsets = some.chrom_offsets
        self.names = some.names
        self.max_occ = some.max_occ
        if not local_only:
            # ranges returned by lookup() index the concatenated table
            self._base = np.zeros(self.n_shards + 1, np.int64)
            for i, s in enumerate(shards):
                self._base[i + 1] = self._base[i] + len(s.hashes)
            self.pos = np.concatenate([s.pos for s in shards])
            self.strand = np.concatenate([s.strand for s in shards])
        else:
            self.pos = np.zeros(0, np.int64)
            self.strand = np.zeros(0, np.int8)
        # collective-lookup observability (multi-process mode)
        self.coll_stats = {"gather_q_s": 0.0, "lookup_s": 0.0,
                           "gather_a_s": 0.0, "scatter_s": 0.0,
                           "q_mb": 0.0, "a_mb": 0.0}
        self._pos_is_u32: Optional[bool] = None

    # -------------------------------------------------------------- factory
    @classmethod
    def build(cls, genome, n_shards: int, k: int = K_DEFAULT,
              w: int = W_DEFAULT, max_occ_frac: float = 2e-4,
              min_max_occ: int = 50, local_shard: Optional[int] = None
              ) -> "ShardedMinimizerIndex":
        """Build shards.  local_shard=None builds ALL shards in-process
        (two passes: raw shard tables + histograms, then the globally
        reduced occurrence cap).  local_shard=sid builds only that shard;
        the occurrence histogram is all-reduced over the jax.distributed
        process group so the cap matches the unsharded build exactly."""
        if local_shard is None:
            raw = [MinimizerIndex._extract_sorted(genome, k, w, (i, n_shards))
                   for i in range(n_shards)]
            ghist = np.sum([r[3] for r in raw], axis=0)
            cap = MinimizerIndex.occ_cap_from_hist(ghist, max_occ_frac,
                                                   min_max_occ)
            shards = []
            for (h, p, s, hist) in raw:
                h, p, s = MinimizerIndex._apply_cap(h, p, s, cap, hist)
                idx = MinimizerIndex(k, w, h, p, s, genome.offsets.copy(),
                                     list(genome.names), cap)
                shards.append(idx)
            log("index", "sharded index built: %d shards, %d minimizers "
                "(max_occ=%d)", n_shards,
                sum(len(s.hashes) for s in shards), cap)
            return cls(shards)
        # multi-process arm: local extraction + distributed hist reduce
        from .distributed import gather_blobs, multihost_info
        h, p, s, hist = MinimizerIndex._extract_sorted(
            genome, k, w, (local_shard, n_shards))
        pid, nproc = multihost_info()
        if nproc > 1:
            hists = gather_blobs(hist.tobytes())
            ghist = np.sum([np.frombuffer(b, np.int64) for b in hists],
                           axis=0)
        else:
            ghist = hist
        cap = MinimizerIndex.occ_cap_from_hist(ghist, max_occ_frac,
                                               min_max_occ)
        h, p, s = MinimizerIndex._apply_cap(h, p, s, cap, hist)
        idx = MinimizerIndex(k, w, h, p, s, genome.offsets.copy(),
                             list(genome.names), cap)
        shards: List[Optional[MinimizerIndex]] = [None] * n_shards
        shards[local_shard] = idx
        log("index", "local index shard %d/%d built: %d minimizers "
            "(max_occ=%d)", local_shard, n_shards, len(h), cap)
        out = cls(shards, local_only=True)
        out.local_shard = local_shard
        return out

    # -------------------------------------------------------------- lookup
    def lookup_collective(self, qhashes: np.ndarray, n_threads: int = 4
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-level lookup.  In multi-process mode this is a COLLECTIVE
        (all hosts must call it in lockstep, once per batch; pad with empty
        query arrays when a host runs out of batches).  align.batch's
        seeding path calls this one."""
        if self.local_only:
            return self._lookup_distributed(qhashes, n_threads)
        return self.lookup(qhashes, n_threads)

    def lookup(self, qhashes: np.ndarray, n_threads: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Point lookup.  In-process mode: exact routed lookup.  In
        multi-process mode: answers from the LOCAL shard only — used by the
        rare per-read terminal-exon rescue (align/aligner.py _seed_clip),
        which cannot be a collective; primary seeding stays exact via
        lookup_collective.  Rescue may therefore miss remote-range seeds in
        the multi-process arm (measured: no accuracy movement on the
        GRCh38 dry run)."""
        if self.local_only:
            shard = self.shards[self.local_shard]
            own = shard_of(np.asarray(qhashes, np.uint64), self.n_shards,
                           self.k)
            lo = np.zeros(len(qhashes), np.int64)
            hi = np.zeros(len(qhashes), np.int64)
            m = own == self.local_shard
            if m.any():
                l, h = shard.lookup(np.ascontiguousarray(qhashes[m]),
                                    n_threads)
                lo[m], hi[m] = l, h
            self.pos = shard.pos
            self.strand = shard.strand
            return lo, hi
        sid = shard_of(np.asarray(qhashes, np.uint64), self.n_shards,
                       self.k)
        lo = np.zeros(len(qhashes), np.int64)
        hi = np.zeros(len(qhashes), np.int64)
        for i, s in enumerate(self.shards):
            m = sid == i
            if not m.any():
                continue
            l, h = s.lookup(np.ascontiguousarray(qhashes[m]), n_threads)
            lo[m] = l + self._base[i]
            hi[m] = h + self._base[i]
        return lo, hi

    def _lookup_distributed(self, qhashes: np.ndarray, n_threads: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Collective lookup: all-gather query hashes, answer the local
        range, all-gather (pos, strand) hits back.  Hit order within a
        query matches the unsharded table (a hash lives in one shard).
        Sets self.pos/self.strand to this call's hit arrays; the returned
        (lo, hi) index into them."""
        from .distributed import gather_blobs, multihost_info
        pid, nproc = multihost_info()
        if nproc != self.n_shards:
            # every hash range needs exactly one answering host: with
            # fewer processes than shards, queries in unowned ranges
            # would come back empty (lo == hi) and ~(1 - nproc/n_shards)
            # of all seeds would silently vanish
            raise ValueError(
                f"sharded collective lookup needs one process per shard: "
                f"{nproc} processes != {self.n_shards} shards")
        import time as _time
        st = self.coll_stats
        sid_local = self.local_shard
        shard = self.shards[sid_local]
        q = np.ascontiguousarray(qhashes, np.uint64)
        t0 = _time.perf_counter()
        blobs = gather_blobs(q.tobytes())
        st["gather_q_s"] += _time.perf_counter() - t0
        st["q_mb"] += q.nbytes / 1e6
        queries = [np.frombuffer(b, np.uint64) for b in blobs]
        # answer every process's queries that land in my hash range.
        # Frame wire format (v2, slimmed): header "<qqq" (src, m,
        # pos_is_u32), idx int32[m], cnt int32[m], pos uint32|int64[total],
        # strand int8[total] — int32 idx/cnt always fit (batch sizes and
        # max_occ are far below 2^31); pos rides uint32 whenever the
        # genome is under 4.3 Gbp, halving the dominant array.
        t0 = _time.perf_counter()
        if self._pos_is_u32 is None:
            self._pos_is_u32 = bool(len(shard.pos) == 0 or
                                    int(shard.pos.max()) < (1 << 32))
        pos_is_u32 = self._pos_is_u32
        pdt = np.uint32 if pos_is_u32 else np.int64
        frames = []
        for src, qh in enumerate(queries):
            owner = shard_of(qh, self.n_shards, self.k)
            mine = np.nonzero(owner == sid_local)[0]
            if not len(mine):
                frames.append(struct.pack("<qqq", src, 0, int(pos_is_u32)))
                continue
            l, h = shard.lookup(np.ascontiguousarray(qh[mine]), n_threads)
            cnt = (h - l).astype(np.int64)
            total = int(cnt.sum())
            ooff = np.cumsum(cnt) - cnt
            from ..native import get_lib
            lib = get_lib()
            if lib is not None:
                import ctypes
                out_pos = np.empty(total, pdt)
                out_str = np.empty(total, np.int8)
                lib.gather_hits_c(
                    np.ascontiguousarray(shard.pos, np.int64),
                    np.ascontiguousarray(shard.strand, np.int8),
                    np.ascontiguousarray(l, np.int64), cnt, ooff,
                    len(mine), int(pos_is_u32),
                    out_pos.ctypes.data_as(ctypes.c_void_p), out_str,
                    n_threads)
                pos_b = out_pos.tobytes()
                str_b = out_str.tobytes()
            else:
                rep = np.repeat(np.arange(len(mine)), cnt)
                at = (l[rep] + (np.arange(total) - ooff[rep])
                      ).astype(np.int64)
                pos_b = shard.pos[at].astype(pdt).tobytes()
                str_b = shard.strand[at].astype(np.int8).tobytes()
            frames.append(struct.pack("<qqq", src, len(mine),
                                      int(pos_is_u32)) +
                          mine.astype(np.int32).tobytes() +
                          cnt.astype(np.int32).tobytes() +
                          pos_b + str_b)
        st["lookup_s"] += _time.perf_counter() - t0
        payload = b"".join(frames)
        st["a_mb"] += len(payload) / 1e6
        t0 = _time.perf_counter()
        answers = gather_blobs(payload)
        st["gather_a_s"] += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        # pass 1: parse the frames addressed to me, fill per-query counts
        counts = np.zeros(len(q), np.int64)
        parsed = []
        for blob in answers:
            off = 0
            while off < len(blob):
                src, m, p32 = struct.unpack_from("<qqq", blob, off)
                off += 24
                if src != pid:
                    # frame addressed to a peer: skip the body by
                    # arithmetic — materializing its astype copies was
                    # pure allocation churn (every process receives ALL
                    # frames under allgather semantics)
                    cnt_v = np.frombuffer(blob, np.int32, m, off + 4 * m)
                    total = int(cnt_v.sum(dtype=np.int64))
                    off += 8 * m + ((4 if p32 else 8) + 1) * total
                    continue
                idx = np.frombuffer(blob, np.int32, m, off)
                off += 4 * m
                cnt = np.frombuffer(blob, np.int32, m, off).astype(np.int64)
                off += 4 * m
                total = int(cnt.sum())
                ppos = np.frombuffer(blob, np.uint32 if p32 else np.int64,
                                     total, off).astype(np.int64)
                off += (4 if p32 else 8) * total
                pstr = np.frombuffer(blob, np.int8, total, off)
                off += total
                if m:
                    counts[idx] = cnt
                    parsed.append((idx, cnt, ppos, pstr))
        lo = (np.cumsum(counts) - counts).astype(np.int64)
        hi = lo + counts
        # pass 2: vectorized scatter into the per-call hit table
        self.pos = np.zeros(int(counts.sum()), np.int64)
        self.strand = np.zeros(len(self.pos), np.int8)
        from ..native import get_lib
        lib = get_lib()
        for idx, cnt, ppos, pstr in parsed:
            total = len(ppos)
            soff = np.cumsum(cnt) - cnt
            if lib is not None:
                lib.scatter_hits_c(
                    np.ascontiguousarray(ppos, np.int64),
                    np.ascontiguousarray(pstr, np.int8),
                    np.ascontiguousarray(idx, np.int32), cnt, soff,
                    len(idx), lo, self.pos, self.strand, n_threads)
            else:
                rep = np.repeat(idx, cnt)
                within = np.arange(total) - np.repeat(soff, cnt)
                dest = lo[rep] + within
                self.pos[dest] = ppos
                self.strand[dest] = pstr
        st["scatter_s"] += _time.perf_counter() - t0
        return lo, hi

    def global_to_chrom(self, gpos: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        tid = np.searchsorted(self.chrom_offsets, gpos, side="right") - 1
        return tid.astype(np.int32), (gpos - self.chrom_offsets[tid])

    def resident_bytes(self) -> int:
        return sum(s.hashes.nbytes + s.pos.nbytes + s.strand.nbytes
                   for s in self.shards if s is not None)
