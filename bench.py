"""Throughput benchmark: long reads aligned per second on one accelerator.

Synthetic workload (the reference publishes no numbers — BASELINE.md).
Headline arm: the ONT-like realistic error profile — 2.5% sub + 1.5% del +
1% ins, minor splice motif classes, repeat content — on the production
device backend.  A clean-profile secondary arm keeps the older numbers
comparable.  Measures the end-to-end batched alignment path (seed ->
device chain DP -> splice-aware extension -> SAM records).

Runs in one process on the GPU (a non-GPU backend is refused) and prints
ONE JSON line:
  {"metric": "long_reads_aligned_per_sec", "value": N, "unit": "reads/s",
   "detail": {"platform": ..., "device_kind": ..., "gpu": "<name>, <power
   limit>", ...}}
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GENOME_MB = float(os.environ.get("BENCH_GENOME_MB", "20"))
# 4 production batches: measures the steady-state pipeline (seed-ahead
# overlap + fixed-cost amortization) rather than a single cold batch —
# the regime every real run (500k reads) lives in
N_READS = int(os.environ.get("BENCH_READS", "6144"))
SEED = 123
_T0 = time.perf_counter()


def hb(msg: str) -> None:
    """Timestamped progress line on stderr."""
    print(f"[hb {time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def build_genome(n_bases: int, rng):
    from lr2rmats_tpu.io.fasta import Genome
    codes = rng.integers(0, 4, n_bases).astype(np.uint8)
    return Genome(["chrB"], codes, np.array([0, n_bases], np.int64))


def simulate_reads(genome, n_reads: int, rng, err=0.03, profile=None):
    """Simulated cDNA reads: 2-6 exons of 150-600 bp, introns 200-20k.

    Two-pass: gene structures are planted first in NON-overlapping genome
    slots (the round-1 one-pass version let later genes overwrite earlier
    genes' splice motifs, so ~0.5% of 'aligner errors' were corrupted
    truth), then reads are generated.

    profile=None  : uniform substitutions at rate `err`, all introns
                    canonical GT..AG (round-1 workload, clean truth)
    profile="ont" : ONT-like 2.5% sub + 1.5% del + 1% ins, 96% GT..AG /
                    2% GC..AG / 2% AT..AC motifs (minor spliceosome
                    classes), plus 200 copies of 1-4 kb segments pasted
                    elsewhere (repeat content)
    """
    minor_frac = 0.04 if profile == "ont" else 0.0
    from lr2rmats_tpu.io.fasta import revcomp
    L = len(genome.codes)
    if profile == "ont":
        # paste repeats BEFORE planting genes so motifs survive
        for _ in range(200):
            sl = int(rng.integers(1000, 4000))
            src = int(rng.integers(0, L - sl))
            dst = int(rng.integers(0, L - sl))
            genome.codes[dst: dst + sl] = genome.codes[src: src + sl]
    # pass A: plant gene structures serially (strictly non-overlapping)
    genes = []
    pos = 1000
    while len(genes) < n_reads:
        pos += int(rng.integers(200, 2000))
        n_exons = int(rng.integers(2, 7))
        parts = []
        okg = True
        for e in range(n_exons):
            elen = int(rng.integers(150, 600))
            if pos + elen + 20_100 > L:
                okg = False
                break
            parts.append((pos, pos + elen))
            pos += elen
            if e < n_exons - 1:
                r = rng.random()
                if r >= minor_frac:
                    genome.codes[pos], genome.codes[pos + 1] = 2, 3   # GT
                    endm = (0, 2)                                      # AG
                elif r < minor_frac / 2:
                    genome.codes[pos], genome.codes[pos + 1] = 2, 1   # GC
                    endm = (0, 2)                                      # AG
                else:                                                  # AT..AC
                    genome.codes[pos], genome.codes[pos + 1] = 0, 3
                    endm = (0, 1)
                ilen = int(rng.integers(200, 20_000))
                pos += ilen
                genome.codes[pos - 2], genome.codes[pos - 1] = endm
        if not okg:
            break
        if len(parts) >= 2:
            genes.append(parts)
    # pass B: n_reads reads over the genes (several per gene when the
    # genome is too small for n_reads non-overlapping genes)
    reads = []
    truths = []
    for i in range(n_reads):
        parts = genes[i % len(genes)]
        read = np.concatenate([genome.codes[a:b] for a, b in parts]).copy()
        if profile == "ont":
            # substitutions
            mask = rng.random(len(read)) < 0.025
            read[mask] = (read[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
            # indels (deletion-biased, like ONT homopolymer errors)
            keep = rng.random(len(read)) >= 0.015
            read = read[keep]
            ins = np.nonzero(rng.random(len(read)) < 0.01)[0]
            if len(ins):
                read = np.insert(read, ins,
                                 rng.integers(0, 4, len(ins)).astype(np.uint8))
        else:
            mask = rng.random(len(read)) < err
            read[mask] = (read[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
        if rng.random() < 0.5:
            read = revcomp(read)
        reads.append(read)
        truths.append(parts)
    return reads, truths


def accuracy_vs_truth(truths, names, primary):
    """(n exact exon chains, splice-site TPs, total true sites)."""
    from lr2rmats_tpu.transcript.exon_chain import gen_exons
    exact = 0
    site_tp = site_n = 0
    for i, parts in enumerate(truths):
        true_sites = []
        for (a1, b1), (a2, b2) in zip(parts[:-1], parts[1:]):
            true_sites += [b1, a2 + 1]          # 1-based donor end / acc start
        site_n += len(true_sites)
        r = primary.get(names[i])
        if r is None:
            continue
        es, ee, _ = gen_exons(r, 3, 3, 50)
        got = []
        for j in range(len(es) - 1):
            got += [int(ee[j]), int(es[j + 1])]
        if got == true_sites:
            exact += 1
        site_tp += len(set(got) & set(true_sites))
    return exact, site_tp, site_n


def _measure(aligner, seqset, names, truths, repeats: int, tag: str):
    """Best-of-N timed passes over the production packed path.  Returns
    (reads/s, best stats, detail dict for this arm)."""
    import time as _time
    dt = float("inf")
    for k in range(max(repeats, 1)):
        hb(f"{tag}: repeat {k + 1}/{repeats} start "
           f"({seqset.n} reads)")
        aligner.stats = {"device_wall_s": 0.0, "anchors": 0,
                         "device_calls": 0}
        t1 = _time.perf_counter()
        rb_i = aligner.align_seqset_packed(seqset)
        t_emit = _time.perf_counter()
        sam_body = rb_i.emit_sam(aligner.refs)
        emit_i = _time.perf_counter() - t_emit
        dt_i = _time.perf_counter() - t1
        assert sam_body
        hb(f"{tag}: repeat {k + 1}/{repeats} done in {dt_i:.2f}s")
        if dt_i < dt:
            dt, rb, emit_s, best_stats = dt_i, rb_i, emit_i, aligner.stats
    n_aligned = 0
    primary = {}
    for r in rb.to_alnrecs():
        if not (r.flag & 0x100):
            n_aligned += 1
            primary[r.qname] = r
    exact, site_tp, site_n = accuracy_vs_truth(truths, names, primary)
    n = seqset.n
    detail = {
        "align_wall_s": round(dt, 2),
        "aligned_frac": round(n_aligned / n, 4),
        "exact_exon_chain_frac": round(exact / n, 4),
        "splice_site_recall": round(site_tp / max(site_n, 1), 4),
        "emit_s": round(emit_s, 3),
    }
    return n / dt, best_stats, detail


def _pack(reads, names):
    from lr2rmats_tpu.io.fasta import SeqSet
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    return SeqSet(names, np.concatenate(reads), offs)


def main():
    import jax
    from lr2rmats_tpu.utils.devcache import enable_compile_cache
    from lr2rmats_tpu.utils.devinfo import device_info, gpu_name_power
    dev = device_info()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev['platform']!r}")
    enable_compile_cache()
    rng = np.random.default_rng(SEED)
    # headline = ONT-like realistic profile (reference workload is real
    # noisy long reads, reference README.md:5-7); BENCH_ERR_PROFILE=clean
    # restores the clean-profile headline
    profile = os.environ.get("BENCH_ERR_PROFILE", "ont")
    if profile in ("clean", "none", ""):
        profile = None
    t0 = time.perf_counter()
    hb(f"setup: genome {GENOME_MB} Mb + {N_READS} reads "
       f"(profile={profile or 'clean'})")
    genome = build_genome(int(GENOME_MB * 1e6), rng)
    reads, truths = simulate_reads(genome, N_READS, rng, profile=profile)
    names = [f"read{i}" for i in range(len(reads))]

    hb("setup: building minimizer index")
    from lr2rmats_tpu.align.batch import BatchAligner
    aligner = BatchAligner(genome)
    setup_s = time.perf_counter() - t0

    hb(f"{dev}; warmup: compiling chain kernel shapes")
    aligner.warmup_chain_shapes()
    hb("warmup: small batch")
    aligner.align_batch(names[:64], reads[:64])
    hb("warmup done")

    seqset = _pack(reads, names)
    profile_dir = os.environ.get("BENCH_PROFILE")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    # best-of-N: every repeat runs the full production path end-to-end
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    tag = "ont" if profile == "ont" else "clean"
    rps, st, arm = _measure(aligner, seqset, names, truths, repeats, tag)
    if profile_dir:
        jax.profiler.stop_trace()

    # device_wall_s: wall blocked on device results (chain fetches and the
    # polish placement DP), a share of the align wall
    dt = arm["align_wall_s"]
    dev_s = st["device_wall_s"]
    detail = {
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "gpu": gpu_name_power(),
        "err_profile": tag,
        "n_reads": len(reads),
        "genome_mb": GENOME_MB,
        "setup_wall_s": round(setup_s, 2),
        "device_wall_s": round(dev_s, 3),
        "device_fraction": round(dev_s / dt, 3) if dt else 0.0,
        "device_calls": st["device_calls"],
        "anchors_chained": st["anchors"],
        "host_phases_s": {k[:-2]: round(st.get(k, 0.0), 3)
                          for k in ("seed_s", "dispatch_s", "build_s",
                                    "polish_s")},
        **arm,
    }
    if tag == "ont":
        detail["ont_exact_exon_chain_frac"] = detail["exact_exon_chain_frac"]
        # per-seed accuracy stability artifact (scripts/ont_accuracy_sweep.py)
        acc_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "ONT_ACCURACY.json")
        if os.path.exists(acc_path):
            with open(acc_path) as f:
                sweep = json.load(f)
            detail["ont_accuracy_seeds"] = sweep.get("per_seed")
    # secondary arm: clean canonical profile, one timed pass at 1/4 size
    if tag == "ont" and not os.environ.get("BENCH_SKIP_CLEAN"):
        hb("clean arm: simulate + align")
        rng2 = np.random.default_rng(SEED)
        genome2 = build_genome(int(GENOME_MB * 1e6), rng2)
        creads, ctruths = simulate_reads(genome2, max(N_READS // 4, 512),
                                         rng2, profile=None)
        cnames = [f"read{i}" for i in range(len(creads))]
        al2 = BatchAligner(genome2)
        al2.warmup_chain_shapes()
        # best-of-2: one pass at 1536 reads is dominated by the cold
        # first batch (new aligner instance)
        crps, _, carm = _measure(al2, _pack(creads, cnames), cnames,
                                 ctruths, 2, "clean")
        detail["clean_reads_per_sec"] = round(crps, 2)
        detail["clean_exact_exon_chain_frac"] = carm["exact_exon_chain_frac"]
    if os.environ.get("BENCH_NOTE"):
        detail["note"] = os.environ["BENCH_NOTE"]
    hb("done; emitting JSON")
    print(json.dumps({
        "metric": "long_reads_aligned_per_sec",
        "value": round(rps, 2),
        "unit": "reads/s",
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
