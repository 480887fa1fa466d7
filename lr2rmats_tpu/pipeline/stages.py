"""End-to-end pipeline: the Snakemake DAG role (reference Snakefile:1-192).

Stage graph per sample S (process boundaries become function calls; files
remain the checkpoint artifacts so interrupted runs resume, mirroring
Snakemake's output-existence semantics — reference SURVEY §5 checkpoint):

  index        : build/load the minimizer index            (minimap_idx)
  align        : long-read spliced alignment -> SAM + BED  (minimap_map)
  sam_novel    : filter + update-gtf pass 1 -> sam_novel.gtf  (sam_novel_gtf)
  new_gtf      : original+novel merge + sort -> new.gtf       (new_gtf)
  sj_count     : short-read junction support -> STARSJ.out.tab (star_map role)
  gtf_novel    : update-gtf pass 2 (with SJ) -> gtf_novel.gtf + reports
  update       : cross-sample unique-gtf + final merge+sort -> updated.gtf
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..io.fasta import Genome, read_fasta
from ..io.gtf import ChrNames, read_anno_trans
from ..io.sam import SamWriter, open_alignments
from ..io.sj import write_sj_star
from ..align.aligner import AlignParams
from ..align.batch import BatchAligner
from ..junctions.sjcount import count_junction_support
from ..report.sortgtf import sort_gtf_file
from ..transcript.filter import FilterParams
from ..transcript.model import UpdateGtfParams
from ..utils import Timer, log


from .commands import cmd_filter, cmd_unique_gtf, cmd_update_gtf
from .config import PipelineConfig


def _sig(path: str):
    st = os.stat(path)
    return [st.st_size, st.st_mtime_ns]


def _fresh(out: str, *inputs: str) -> bool:
    """Artifact checkpoint: output exists and its recorded input signatures
    (size + ns mtime, kept in a `<out>.inputs.json` sidecar written by
    _done) still match.  Snakemake-style semantics without the
    second-granularity mtime race of the round-1 `<=` comparison.

    The sidecar is REQUIRED: it is written only after the stage completed,
    so a crash-truncated in-place output (kill -9 / OOM / disk-full
    mid-write) is never accepted as fresh — the old mtime fallback
    accepted exactly those (partial output newer than its inputs).  A
    recorded input that has since been deleted also marks the stage stale
    (the rerun then fails loudly on the missing input, the Snakemake
    behavior being mirrored)."""
    if not os.path.exists(out):
        return False
    side = out + ".inputs.json"
    if not os.path.exists(side):
        return False
    import json
    try:
        with open(side) as f:
            rec = json.load(f)
    except Exception:
        return False
    for i in inputs:
        if not os.path.exists(i):
            return False
        if rec.get(i) != _sig(i):
            return False
    return True


def _done(out: str, *inputs: str) -> None:
    """Record input signatures for _fresh."""
    import json
    with open(out + ".inputs.json", "w") as f:
        json.dump({i: _sig(i) for i in inputs if os.path.exists(i)}, f)


def _ensure_dirs(out_dir: str) -> None:
    for d in ("alignment", "gtf", "output", "logs", "benchmark"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)


def write_bed12_batch(rb, refs, bed_path: str) -> bool:
    """BED12 export straight from the packed RecordBatch — no SAM re-parse
    (that cost ~16 s at 500k reads).  Exon segmentation is the gen_exons
    (min_exon=1, min_intron=1, max_delet=inf) case: only N ops split.
    Returns False (caller falls back to the SAM path) when the native
    formatter is unavailable or a zero-length exon edge case appears."""
    from ..native import get_lib
    from ..report.summary import _str_blob
    lib = get_lib()
    if lib is None or rb.n == 0:
        return False
    keep = np.nonzero((rb.flag & 0x4) == 0)[0]
    if not len(keep):
        open(bed_path, "w").close()
        return True
    n_all = rb.n
    counts_all = np.diff(rb.cig_offs)
    rep = np.repeat(np.arange(n_all), counts_all)
    op = (rb.cig_buf & 0xF).astype(np.int64)
    ln = (rb.cig_buf >> 4).astype(np.int64)
    refc = np.where((op == 0) | (op == 2) | (op == 3) | (op == 7) |
                    (op == 8), ln, 0)
    cs = np.cumsum(refc)
    base = np.concatenate([[0], cs])[rb.cig_offs[:-1]]
    within_after = cs - base[rep]
    within_before = within_after - refc
    is_n = op == 3
    nN = np.bincount(rep[is_n], minlength=n_all).astype(np.int64)
    # restrict to kept (mapped) rows
    nNk = nN[keep]
    ne = nNk + 1
    eoff = np.zeros(len(keep) + 1, np.int64)
    np.cumsum(ne, out=eoff[1:])
    tot = int(eoff[-1])
    starts_rel = np.zeros(tot, np.int64)
    ends_rel = np.zeros(tot, np.int64)
    # ragged scatter of N-op boundaries (N ops are in record order)
    kept_mask = np.zeros(n_all, bool)
    kept_mask[keep] = True
    kept_row = np.full(n_all, -1, np.int64)
    kept_row[keep] = np.arange(len(keep))
    idxN = np.nonzero(is_n & kept_mask[rep])[0]
    rN_rec = kept_row[rep[idxN]]
    cumN = np.zeros(len(keep), np.int64)
    np.cumsum(nNk, out=cumN[0:])  # cumN[i] = #N in rows 0..i
    startN = cumN - nNk
    rank = np.arange(len(idxN)) - startN[rN_rec]
    starts_rel[eoff[rN_rec] + rank + 1] = within_after[idxN]
    ends_rel[eoff[rN_rec] + rank] = within_before[idxN]
    last_op = rb.cig_offs[1:] - 1
    tot_ref = np.where(counts_all > 0, within_after[np.maximum(last_op, 0)],
                       0)
    ends_rel[eoff[1:] - 1] = tot_ref[keep]
    sizes = ends_rel - starts_rel
    if (sizes <= 0).any():
        return False     # zero-length exon quirk: use the reference path
    nb = _str_blob([rb.qname[i] for i in keep], len(keep))
    cb = _str_blob([r[0] for r in refs], len(refs))
    if nb is None or cb is None:
        return False
    start0 = rb.pos[keep].astype(np.int64)
    end = start0 + tot_ref[keep]
    cap = int(nb[1][-1] + len(keep) * 140 + tot * 26) + 64
    out = np.empty(cap, np.uint8)
    wrote = int(lib.format_bed12_c(
        nb[0], nb[1], cb[0], cb[1],
        np.ascontiguousarray(rb.tid[keep], np.int32),
        np.ascontiguousarray((rb.flag[keep] & 0x10) != 0).view(np.uint8),
        np.ascontiguousarray(rb.mapq[keep], np.int32),
        start0, end, sizes, starts_rel, eoff,
        len(keep), out, cap))
    if wrote < 0:
        return False
    with open(bed_path, "wb") as f:
        f.write(out[:wrote].tobytes())
    return True


def write_bed12(sam_path: str, bed_path: str) -> None:
    """BED12 export of spliced alignments (the `bedtools bamtobed -bed12`
    role, reference Snakefile:63)."""
    from ..transcript.exon_chain import gen_exons
    refs, _, records = open_alignments(sam_path)
    with open(bed_path, "w") as f:
        for r in records:
            if r.is_unmapped:
                continue
            s, e, _ = gen_exons(r, 1, 1, 1 << 30)  # strand comes from r.is_rev
            chrom = refs[r.tid][0]
            start0 = int(s[0]) - 1
            end = int(e[-1])
            sizes = ",".join(str(int(b - a + 1)) for a, b in zip(s, e)) + ","
            starts = ",".join(str(int(a - 1) - start0) for a in s) + ","
            strand = "-" if r.is_rev else "+"
            f.write(f"{chrom}\t{start0}\t{end}\t{r.qname}\t{r.mapq}\t{strand}"
                    f"\t{start0}\t{end}\t0\t{len(s)}\t{sizes}\t{starts}\n")


def run_pipeline(cfg: PipelineConfig, align_params: Optional[AlignParams] = None,
                 use_device: bool = True) -> str:
    """Run the full two-pass pipeline; returns the updated.gtf path.

    `use_device=False` keeps every stage on the host paths (native/numpy
    twins of the device kernels, byte-identical output); otherwise the
    device kernels run on JAX's default backend and any device error
    raises.

    Under a jax.distributed process group (parallel.distributed), each
    process runs the round-robin shard of samples it owns and the final
    cross-sample gather rides the distributed backend; process 0 writes
    updated.gtf (the reference's qsub-per-sample + shared-FS `cat` gather,
    Snakefile:172-192 / README.md:139-153)."""
    from ..parallel.distributed import (barrier, gather_indexed_payloads,
                                        multihost_info, owned_indices)
    if not cfg.samples:
        # fail before any work, not 5 stages later with an opaque "-b"
        # ValueError out of the final unique-gtf merge
        raise ValueError("pipeline config has no samples (cfg.samples "
                         "is empty)")
    pid, nproc = multihost_info()
    out_dir = cfg.out_dir
    _ensure_dirs(out_dir)
    if use_device:
        from ..utils.devcache import enable_compile_cache
        enable_compile_cache()
    A = lambda *p: os.path.join(out_dir, *p)
    psuf = f".p{pid}" if nproc > 1 else ""

    # tee stage logs into logs/pipeline.log (Snakemake `log:` role)
    import sys
    from ..utils.log import set_log_stream

    class _Tee:
        """Writes to the log file and whatever sys.stderr currently is."""

        def __init__(self, f):
            self.f = f

        def write(self, s):
            sys.stderr.write(s)
            if not self.f.closed:
                self.f.write(s)

        def flush(self):
            sys.stderr.flush()
            if not self.f.closed:
                self.f.flush()

    _logf = open(A("logs", f"pipeline{psuf}.log"), "a")
    set_log_stream(_Tee(_logf))
    filter_pool = None
    try:

        # record the resolved configuration (run_snakemake.py writes config.yaml
        # into the out dir, run_snakemake.py:132-135); process 0 only — the out
        # dir may be a shared filesystem
        if pid == 0:
            with open(A("config.yaml"), "w") as f:
                f.write(cfg.to_yaml())

        # ---- stage: genome + index (minimap_idx, Snakefile:24-38)
        with Timer("stage/index", benchmark_file=A("benchmark", f"index{psuf}.benchmark.txt")):
            genome = Genome.load(cfg.genome_fasta)
            aligner: Optional[BatchAligner] = None

        updated_gtf = (cfg.updated_gtf if os.path.isabs(cfg.updated_gtf)
                       else A(cfg.updated_gtf))
        os.makedirs(os.path.dirname(updated_gtf) or ".", exist_ok=True)

        gtf_novel_paths: List[str] = []

        # sample shard this process owns (round-robin over the process group;
        # one process owns everything in a single-host run)
        all_items = list(cfg.samples.items())
        own = owned_indices(len(all_items))
        items = [all_items[i] for i in own]
        # header source for the final unique-gtf: the globally-first sample's
        # SAM — process 0 always owns sample 0 under round-robin assignment
        first_sam = (A("alignment", f"{all_items[0][0]}.minimap.sam")
                     if all_items else None)

        # ---- phase 1: alignment per sample (minimap_map, Snakefile:42-63).
        # Sequential: one aligner drives the process's devices; host-side
        # per-sample stages parallelize in phase 2.  The rb-direct filter of
        # sample N runs on a background thread so it overlaps sample N+1's
        # (device-bound) alignment; phase 2 joins the futures first.
        from concurrent.futures import Future, ThreadPoolExecutor
        filter_pool = ThreadPoolExecutor(1)
        filter_futs: Dict[str, Future] = {}

        def _rb_filter(sample: str, sam_path: str, hdr: bytes, body):
            filtered = A("alignment", f"{sample}.filtered.sam")
            with Timer(f"stage/filter[{sample}]",
                       benchmark_file=A("benchmark",
                                        f"{sample}.novel_gtf.benchmark.txt")):
                # body is the emit_sam_array view: ONE concat builds the
                # header+body buffer (the old bytes path paid two extra
                # ~900 MB copies at 500k-read scale)
                cmd_filter(None, filtered,
                           FilterParams(cfg.aln_cov, cfg.iden_frac,
                                        cfg.sec_rat),
                           rm_gtf=cfg.rm_gtf or None, out_format="sam",
                           data=np.concatenate(
                               [np.frombuffer(hdr, np.uint8),
                                np.asarray(body, np.uint8)]))
                _done(filtered, sam_path)

        for sample, reads in items:
            sam_path = A("alignment", f"{sample}.minimap.sam")
            bed_path = A("alignment", f"{sample}.minimap.bed")
            if not _fresh(sam_path, cfg.genome_fasta, reads.long_read):
                with Timer(f"stage/align[{sample}]", benchmark_file=A("benchmark", f"{sample}.minimap.benchmark.txt")):
                    if aligner is None:
                        if getattr(cfg, "index_shards", 1) > 1:
                            # hash-range-sharded table with routed lookups
                            # (SURVEY §5; byte-identical to the unsharded path,
                            # tests/test_shard_index.py)
                            from ..parallel.shard_index import \
                                ShardedMinimizerIndex
                            idx = ShardedMinimizerIndex.build(
                                genome, cfg.index_shards)
                        else:
                            from ..index.minimizer import MinimizerIndex
                            cache = cfg.index_cache or (cfg.genome_fasta +
                                                        ".tmmi.npz")
                            idx = MinimizerIndex.build_or_load(genome, cache)
                        aligner = BatchAligner(
                            genome, align_params, index=idx,
                            backend="jax" if use_device else "host")
                    long_reads = read_fasta(reads.long_read)
                    rb = aligner.align_seqset_packed(long_reads)
                    n = rb.n
                    st = aligner.stats
                    log("align", "%s: phases device=%.3fs (%d calls) "
                        "seed=%.3fs dispatch=%.3fs build=%.3fs polish=%.3fs",
                        sample, st.get("device_wall_s", 0.0),
                        st.get("device_calls", 0), st.get("seed_s", 0.0),
                        st.get("dispatch_s", 0.0), st.get("build_s", 0.0),
                        st.get("polish_s", 0.0))
                    from ..io.sam import sam_header
                    hdr = sam_header(aligner.refs).encode()
                    body = rb.emit_sam_array(aligner.refs)
                    with open(sam_path + ".tmp", "wb") as f:
                        f.write(hdr)
                        f.write(memoryview(body))
                    os.replace(sam_path + ".tmp", sam_path)
                    _done(sam_path, cfg.genome_fasta, reads.long_read)
                    log("align", "%s: %d alignment records", sample, n)
                    # rb-direct filter: the SAM bytes are still in memory, so
                    # produce the filtered artifact from them — the filter
                    # stage then skips, and the multi-hundred-MB alignment SAM
                    # is never read back from disk (cold-path IO;
                    # byte-identical output since the same native scan runs on
                    # the same bytes).  Runs on the background thread.
                    from ..native import get_lib
                    if get_lib() is not None:
                        filter_futs[sample] = filter_pool.submit(
                            _rb_filter, sample, sam_path, hdr, body)
                    del body
                    if not write_bed12_batch(rb, aligner.refs, bed_path):
                        write_bed12(sam_path, bed_path)
                    _done(bed_path, sam_path)
            # the bed has its own checkpoint: a crash between the SAM's
            # _done and the bed write used to leave it missing/truncated
            # with no way to regenerate on resume (the in-memory rb fast
            # path is gone then; the SAM re-parse fallback still works)
            if not _fresh(bed_path, sam_path):
                write_bed12(sam_path, bed_path)
                _done(bed_path, sam_path)

        # ---- phase 2: per-sample host stages, parallel over samples (the
        # Snakemake job-parallelism role, reference Snakefile wildcards +
        # --jobs; the hot loops are native and release the GIL)
        def _sample_stages(sample: str, reads) -> str:
            sam_path = A("alignment", f"{sample}.minimap.sam")
            # join this sample's in-flight rb-direct filter (phase 1) first
            fut = filter_futs.pop(sample, None)
            if fut is not None:
                fut.result()
            # ---- stage: sam_novel_gtf (filter + pass-1 update-gtf, Snakefile:67-93)
            # SAM artifact (raw-span fast path); BAM remains available
            # via the `filter` CLI for interop
            filtered_bam = A("alignment", f"{sample}.filtered.sam")
            sam_novel = A("gtf", f"{sample}_sam_novel.gtf")
            if not _fresh(filtered_bam, sam_path):
                with Timer(f"stage/filter[{sample}]", benchmark_file=A("benchmark", f"{sample}.novel_gtf.benchmark.txt")):
                    cmd_filter(sam_path, filtered_bam,
                               FilterParams(cfg.aln_cov, cfg.iden_frac,
                                            cfg.sec_rat),
                               rm_gtf=cfg.rm_gtf or None, out_format="sam")
                    _done(filtered_bam, sam_path)
            # one ingestion of the (large) filtered SAM feeds both update-gtf
            # passes; each pass classifies an independent copy
            input_cache: dict = {}
            if not _fresh(sam_novel, filtered_bam, cfg.gtf):
                with Timer(f"stage/update_gtf_pass1[{sample}]", benchmark_file=A("benchmark", f"{sample}_new_gtf.benchmark.txt")):
                    ugp = UpdateGtfParams(full_level=cfg.full_level)
                    cmd_update_gtf(filtered_bam, cfg.gtf, ugp, out_path=sam_novel,
                                   input_cache=input_cache)
                    _done(sam_novel, filtered_bam, cfg.gtf)

            # ---- stage: new_gtf (merge + sort, Snakefile:96-112)
            new_gtf = A("gtf", f"{sample}_new.gtf")
            if not _fresh(new_gtf, cfg.gtf, sam_novel):
                tmp = A("gtf", f"{sample}_tmp.gtf")
                with open(tmp, "wb") as out:
                    import shutil
                    for p in (cfg.gtf, sam_novel):
                        with open(p, "rb") as src:
                            shutil.copyfileobj(src, out)  # constant-memory
                sort_gtf_file(tmp, new_gtf)
                os.remove(tmp)
                _done(new_gtf, cfg.gtf, sam_novel)

            # ---- stage: sj_count (star_map role, Snakefile:116-140)
            sj_tab = A("alignment", f"{sample}.STARSJ.out.tab")
            short_inputs = [p for p in (reads.short_first, reads.short_second) if p]
            if short_inputs and not _fresh(sj_tab, new_gtf, *short_inputs):
                with Timer(f"stage/sj_count[{sample}]", benchmark_file=A("benchmark", f"{sample}.star.benchmark.txt")):
                    cname = ChrNames(genome.names)
                    merged = read_anno_trans(new_gtf, cname)
                    # paired-end mates count with proper-pair gating (STAR
                    # analog); single-end counts independently
                    if reads.short_first and reads.short_second:
                        read_sets = [(read_fasta(reads.short_first),
                                      read_fasta(reads.short_second))]
                    else:
                        read_sets = [read_fasta(p) for p in short_inputs]
                    sj = count_junction_support(genome, [merged], read_sets)
                    with open(sj_tab, "w") as f:
                        write_sj_star(sj, cname, f)
                    _done(sj_tab, new_gtf, *short_inputs)

            # ---- stage: gtf_novel_gtf (pass-2 update-gtf, Snakefile:142-170)
            gtf_novel = A("gtf", f"{sample}_gtf_novel.gtf")
            if not _fresh(gtf_novel, filtered_bam, cfg.gtf,
                          *( [sj_tab] if short_inputs else [] )):
                with Timer(f"stage/update_gtf_pass2[{sample}]", benchmark_file=A("benchmark", f"{sample}_gtf_novel_gtf.benchmark.txt")):
                    ugp = UpdateGtfParams(full_level=cfg.full_level,
                                          split_trans=cfg.split_trans,
                                          min_sj_cnt=cfg.sup_cnt)
                    cmd_update_gtf(
                        filtered_bam, cfg.gtf, ugp,
                        sj_path=sj_tab if short_inputs else None,
                        out_path=gtf_novel,
                        summary=A("output", f"{sample}.summary.txt"),
                        bam_gtf=A("output", f"{sample}.bam.gtf"),
                        bam_detail=A("output", f"{sample}.detail.txt"),
                        known_gtf=A("output", f"{sample}.known.gtf"),
                        novel_gtf=A("output", f"{sample}.novel.gtf"),
                        unrecog_gtf=A("output", f"{sample}.unrecog.gtf"),
                        exon_bed=A("output", f"{sample}.novel_exon.bed"),
                        input_cache=input_cache)
                    _done(gtf_novel, filtered_bam, cfg.gtf,
                          *([sj_tab] if short_inputs else []))
            input_cache.clear()
            return gtf_novel

        if len(items) > 1 and (cfg.jobs or 0) != 1:
            n_jobs = cfg.jobs or min(4, len(items))
            with ThreadPoolExecutor(n_jobs) as pool:
                gtf_novel_paths = list(pool.map(
                    lambda sr: _sample_stages(sr[0], sr[1]), items))
        else:
            gtf_novel_paths = [_sample_stages(s, r) for s, r in items]
        filter_pool.shutdown(wait=True)

        # ---- cross-process gather: every process contributes its samples'
        # pass-2 candidates over the distributed backend (the reference's
        # shared-FS `cat` at Snakefile:172-192); afterwards every
        # process holds all payloads in global sample order
        if nproc > 1:
            payloads = [(gi, open(p, "rb").read())
                        for gi, p in zip(own, gtf_novel_paths)]
            gathered = gather_indexed_payloads(payloads)
            if pid != 0:
                barrier("final_merge")
                log("pipeline", "process %d/%d: sample shard done; updated GTF "
                    "written by process 0", pid, nproc)
                set_log_stream(None)
                _logf.close()
                return updated_gtf
            gtf_novel_paths = []
            for gi in range(len(all_items)):
                p = A("gtf", f"{all_items[gi][0]}_gtf_novel.gathered.gtf")
                with open(p, "wb") as f:
                    f.write(gathered[gi])
                gtf_novel_paths.append(p)

        # ---- stage: update_gtf (cross-sample merge, Snakefile:172-192)
        with Timer("stage/final_merge", benchmark_file=A("benchmark", "update_gtf.benchmark.txt")):
            tmp = A("gtf", "tmp.gtf")
            with open(tmp, "wb") as out:
                import shutil
                for p in gtf_novel_paths:
                    with open(p, "rb") as src:
                        shutil.copyfileobj(src, out)  # constant-memory
            uniq_gtf = A("gtf", "uniq.gtf")
            ugp = UpdateGtfParams(input_mode="gtf")
            # multi-device: route candidate tensors through the dp all-gather
            # collective (the Snakefile:189-192 cross-sample gather, on the
            # device interconnect); single-process only — across processes
            # the gather above is the data plane and local meshes see only
            # addressable devices
            device_gather = False
            if nproc == 1 and use_device:
                import jax
                device_gather = len(jax.devices()) > 1
            cmd_unique_gtf(tmp, ugp, hdr_bam=first_sam, out_path=uniq_gtf,
                           device_gather=device_gather)
            with open(tmp, "wb") as out:
                import shutil
                for p in (cfg.gtf, uniq_gtf):
                    with open(p, "rb") as src:
                        shutil.copyfileobj(src, out)  # constant-memory
            sort_gtf_file(tmp, updated_gtf)
            os.remove(tmp)
        if nproc > 1:
            barrier("final_merge")
        log("pipeline", "updated GTF written to %s", updated_gtf)
        set_log_stream(None)
        _logf.close()
        return updated_gtf
    finally:
        # the log stream is process-global and the rb-filter worker
        # may still be in flight: always restore/join, even when a
        # stage raises (leaked stream tees the NEXT run's logs into
        # this file; an unjoined worker leaks a thread)
        if filter_pool is not None:
            filter_pool.shutdown(wait=True)
        set_log_stream(None)
        if not _logf.closed:
            _logf.close()
