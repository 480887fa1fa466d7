"""Command-line interface.

Subcommand surface mirrors the reference binary (reference main.c:19-35):
filter, fusion, update-gtf, unique-gtf, bam2gtf, bam2sj — plus `run`
(the run_snakemake.py + Snakemake role) driving the whole pipeline.
"""

from __future__ import annotations

import argparse
import sys

from .. import PROG, __version__
from ..transcript.filter import (COV_RATIO, MAP_QUAL, MIN_INTRON_NUM,
                                 SEC_RATIO, FilterParams)
from ..transcript.fusion import (ALL_COV, EACH_COV, FUSION_DIS, OVLP_FRAC,
                                 FusionParams)
from ..transcript.model import (DELETION_MAX_LEN, END_DISTANCE,
                                INTER_EXON_MIN_LEN, INTRON_MIN_LEN,
                                MIN_SJ_CNT, SING_OVLP_FRAC, SPLICE_DISTANCE,
                                UpdateGtfParams)


def _add_update_opts(sp, unique: bool = False):
    sp.add_argument("-m", "--input-mode", default="b", choices=["b", "g"],
                    help="format of input file, BAM(b) or GTF(g) [b]")
    sp.add_argument("-b", "--bam", default=None,
                    help="BAM for header information with GTF input")
    if not unique:
        sp.add_argument("-j", "--sj", default=None,
                        help="junction file in STAR SJ.out.tab format")
        sp.add_argument("-M", "--use-multi", action="store_true",
                        help="use multi-mapped junction counts")
        sp.add_argument("-J", "--min-junc-cnt", type=int, default=MIN_SJ_CNT,
                        help=f"min short-read junction count [{MIN_SJ_CNT}]")
        sp.add_argument("-l", "--full-length", type=int, default=5,
                        help="full-length level 1-5 strict->relaxed [5]")
        sp.add_argument("-s", "--split-trans", action="store_true",
                        help="split read on unreliable junctions")
        sp.add_argument("-t", "--max-delet", type=int, default=DELETION_MAX_LEN)
    else:
        sp.add_argument("-t", "--max-delet", type=int, default=DELETION_MAX_LEN)
        sp.add_argument("-I", "--intersect", action="store_true",
                        help="output intersected transcripts")
    sp.add_argument("-c" if not unique else "-F", "--force-strand",
                    action="store_true",
                    help="force strand match when merging")
    sp.add_argument("-e", "--min-exon", type=int, default=INTER_EXON_MIN_LEN)
    sp.add_argument("-i", "--min-intron", type=int, default=INTRON_MIN_LEN)
    sp.add_argument("-d", "--distance", type=int, default=SPLICE_DISTANCE)
    sp.add_argument("-D", "--DISTANCE", type=int, default=END_DISTANCE)
    sp.add_argument("-f", "--frac", type=float, default=SING_OVLP_FRAC)
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("-S", "--source", default=PROG)
    if not unique:
        sp.add_argument("--ref-compat", action="store_true",
                        help="replicate the reference's acceptor-site "
                        "matching off-by-one (update_gtf.c:746) bit-for-bit "
                        "instead of the corrected default semantics "
                        "(ARCHITECTURE.md §5); also LR2RMATS_REF_COMPAT=1")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG, description=f"{PROG} {__version__} — accelerator-native long-read "
        "transcript discovery (lr2rmats capability set)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("filter", help="filter low-confidence alignments")
    sp.add_argument("input")
    sp.add_argument("-v", "--coverage", type=float, default=COV_RATIO)
    sp.add_argument("-q", "--map-qual", type=float, default=MAP_QUAL)
    sp.add_argument("-s", "--sec-rat", type=float, default=SEC_RATIO)
    sp.add_argument("-i", "--intron", type=int, default=MIN_INTRON_NUM)
    sp.add_argument("-r", "--remove-gtf", default=None)
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--sam", action="store_true", help="write SAM not BAM")
    sp.add_argument("--no-sort", action="store_true",
                    help="keep input order (reference pipes through samtools sort)")

    sp = sub.add_parser("fusion", help="candidate gene-fusion transcripts")
    sp.add_argument("input")
    sp.add_argument("-o", "--ovlp-frac", type=float, default=OVLP_FRAC)
    sp.add_argument("-v", "--each-cov", type=float, default=EACH_COV)
    sp.add_argument("-V", "--all-cov", type=float, default=ALL_COV)
    sp.add_argument("-d", "--dis", default=str(FUSION_DIS))
    sp.add_argument("-f", "--fusion-site", default=None)
    sp.add_argument("--output", default=None)
    sp.add_argument("--sam", action="store_true")

    sp = sub.add_parser("update-gtf",
                        help="update GTF with novel transcripts")
    sp.add_argument("input", help="in.bam / in.gtf")
    sp.add_argument("gtf", help="old annotation GTF")
    _add_update_opts(sp)
    sp.add_argument("-n", "--min-output", action="store_true")
    sp.add_argument("-E", "--exon-bed", default=None)
    sp.add_argument("-a", "--bam-gtf", default=None)
    sp.add_argument("-A", "--bam-detail", "--bam-detial",
                    dest="bam_detail", default=None)
    sp.add_argument("-k", "--known-gtf", default=None)
    sp.add_argument("-v", "--novel-gtf", default=None)
    sp.add_argument("-u", "--unrecog", default=None)
    sp.add_argument("-y", "--summary", default=None)

    sp = sub.add_parser("unique-gtf", help="unique transcripts across inputs")
    sp.add_argument("input")
    _add_update_opts(sp, unique=True)

    sp = sub.add_parser("bam2gtf", help="transcript GTF from alignments")
    sp.add_argument("input")
    sp.add_argument("-e", "--min-exon", type=int, default=INTER_EXON_MIN_LEN)
    sp.add_argument("-i", "--min-intron", type=int, default=INTRON_MIN_LEN)
    sp.add_argument("-t", "--max-delet", type=int, default=DELETION_MAX_LEN)
    sp.add_argument("-s", "--source", default=PROG)
    sp.add_argument("-o", "--output", default=None)

    sp = sub.add_parser("bam2sj", help="splice junctions from alignments")
    sp.add_argument("input")
    sp.add_argument("-g", "--genome-file", default=None)
    sp.add_argument("-i", "--intron-len", type=int, default=INTRON_MIN_LEN)
    sp.add_argument("-p", "--prop-pair", action="store_true", default=True,
                    help="filter out reads mapped in improper pair "
                         "(always on, matching the reference default)")
    sp.add_argument("--no-prop-pair", dest="prop_pair", action="store_false")
    sp.add_argument("-o", "--output", default=None)

    sp = sub.add_parser("run", help="run the full two-pass pipeline")
    sp.add_argument("--config", default=None, help="config.yaml (reference schema)")
    sp.add_argument("--genome", default=None)
    sp.add_argument("--gtf", default=None)
    sp.add_argument("--rm-gtf", default="")
    sp.add_argument("--long-read-list", default=None)
    sp.add_argument("--short-read-list", default=None)
    sp.add_argument("--long-read", default=None, help="single-sample long reads")
    sp.add_argument("--short-read-1", default=None)
    sp.add_argument("--short-read-2", default=None)
    # algorithm knobs: default None so a config.yaml's `lr2rmats:` values
    # survive unless the flag is given explicitly (PipelineConfig holds
    # the reference defaults 0.67/0.75/0.98/1/-s/3)
    sp.add_argument("--aln-cov", type=float, default=None)
    sp.add_argument("--iden-frac", type=float, default=None)
    sp.add_argument("--sec-rat", type=float, default=None)
    sp.add_argument("--sup-cnt", type=int, default=None)
    sp.add_argument("--split-trans", action="store_true", default=None,
                    dest="split_trans")
    sp.add_argument("--no-split-trans", action="store_false", default=None,
                    dest="split_trans",
                    help="disable -s splitting (yaml: split_trans: \"\")")
    sp.add_argument("--full-level", type=int, default=None)
    sp.add_argument("--out-dir", default=".")
    sp.add_argument("--jobs", type=int, default=None,
                    help="per-sample host-stage parallelism (Snakemake "
                         "--jobs role; default min(4, n_samples), 1=serial)")
    sp.add_argument("--index-shards", type=int, default=1,
                    help="minimizer-table hash-range shards (>1 routes seed "
                         "lookups per shard; byte-identical output)")
    sp.add_argument("--cpu", action="store_true",
                    help="run the device kernels on JAX's CPU backend")
    sp.add_argument("--coordinator", default=None,
                    help="jax.distributed coordinator host:port (multi-host "
                         "run; the reference's qsub cluster submission, "
                         "README.md:139-153)")
    sp.add_argument("--num-processes", type=int, default=None,
                    help="process-group size for a multi-host run")
    sp.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in the multi-host group")

    sp = sub.add_parser("sort-gtf",
                        help="sort GTF transcript blocks (sort_gtf.sh role)")
    sp.add_argument("input")
    sp.add_argument("-o", "--output", default=None)

    sp = sub.add_parser("gtf2bed",
                        help="BED12 per transcript (the UCSC "
                             "gtfToGenePred|genePredToBed convenience role)")
    sp.add_argument("input")
    sp.add_argument("-o", "--output", default=None)

    sp = sub.add_parser("version", help="print version")
    return ap


def _ugp_from_args(args, unique: bool = False) -> UpdateGtfParams:
    ugp = UpdateGtfParams(
        input_mode="bam" if args.input_mode == "b" else "gtf",
        min_exon=args.min_exon, min_intron=args.min_intron,
        max_delet=args.max_delet, ss_dis=args.distance, end_dis=args.DISTANCE,
        single_exon_ovlp_frac=args.frac, force_strand=args.force_strand,
        source=args.source)
    if not unique:
        ugp.use_multi = args.use_multi
        ugp.min_sj_cnt = args.min_junc_cnt
        ugp.full_level = args.full_length
        ugp.split_trans = args.split_trans
        if getattr(args, "ref_compat", False):
            ugp.ref_acceptor_compat = True
    return ugp


def run_config(args):
    """PipelineConfig for parsed `run` arguments."""
    from .config import PipelineConfig, SampleReads
    if args.config:
        cfg = PipelineConfig.from_yaml(args.config)
    elif args.long_read_list:
        cfg = PipelineConfig.from_read_lists(
            args.genome, args.gtf, args.long_read_list,
            args.short_read_list)
    else:
        cfg = PipelineConfig(genome_fasta=args.genome, gtf=args.gtf)
        cfg.samples["samp1"] = SampleReads(
            args.long_read, args.short_read_1, args.short_read_2)
    cfg.rm_gtf = args.rm_gtf or cfg.rm_gtf
    # explicit CLI flags win; otherwise the config.yaml (or the
    # PipelineConfig reference defaults) stand
    for knob in ("aln_cov", "iden_frac", "sec_rat", "sup_cnt",
                 "split_trans", "full_level"):
        v = getattr(args, knob)
        if v is not None:
            setattr(cfg, knob, v)
    cfg.out_dir = args.out_dir
    cfg.jobs = args.jobs
    cfg.index_shards = args.index_shards
    return cfg


def main(argv=None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as e:
        # reference-style fatal (err_fatal: '[func] Can not open "..."')
        print(f'[{PROG}] Can not open "{e.filename or e}"', file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"[{PROG}] {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    from . import commands as C
    args = build_parser().parse_args(argv)

    if args.cmd == "version":
        print(f"{PROG} {__version__}")
        return 0
    if args.cmd == "sort-gtf":
        import sys as _sys
        from ..report.sortgtf import sort_gtf_lines
        with open(args.input) as f:
            lines = sort_gtf_lines(f)
        out = open(args.output, "w") if args.output else _sys.stdout
        out.writelines(lines)
        if args.output:
            out.close()
        return 0
    if args.cmd == "gtf2bed":
        import sys as _sys
        from ..io.gtf import ChrNames, read_gtf_trans
        cname = ChrNames([])
        T = read_gtf_trans(args.input, cname)
        out = open(args.output, "w") if args.output else _sys.stdout
        for i in range(T.n):
            en = int(T.exon_n[i])
            es = T.exon_start[i, :en].astype(int)
            ee = T.exon_end[i, :en].astype(int)
            start0 = int(es[0]) - 1
            end = int(ee[-1])
            sizes = ",".join(str(b - a + 1) for a, b in zip(es, ee)) + ","
            starts = ",".join(str(a - 1 - start0) for a in es) + ","
            strand = "-" if T.is_rev[i] else "+"
            out.write(f"{cname[int(T.tid[i])]}\t{start0}\t{end}\t"
                      f"{T.trans_id[i]}\t0\t{strand}\t{start0}\t{end}\t0\t"
                      f"{en}\t{sizes}\t{starts}\n")
        if args.output:
            out.close()
        return 0
    if args.cmd == "filter":
        C.cmd_filter(args.input, args.output,
                     FilterParams(args.coverage, args.map_qual, args.sec_rat,
                                  args.intron),
                     rm_gtf=args.remove_gtf,
                     out_format="sam" if args.sam else "bam",
                     sort_output=not args.no_sort)
        return 0
    if args.cmd == "fusion":
        from ..transcript.fusion import FusionParams
        dis = args.dis
        mult = 1
        if isinstance(dis, str) and dis and dis[-1] in "GgMmKk":
            mult = {"g": 10 ** 9, "m": 10 ** 6, "k": 10 ** 3}[dis[-1].lower()]
            dis = dis[:-1]
        C.cmd_fusion(args.input, args.output,
                     FusionParams(args.ovlp_frac, args.each_cov, args.all_cov,
                                  int(float(dis) * mult)),
                     fusion_site=args.fusion_site,
                     out_format="sam" if args.sam else "bam")
        return 0
    if args.cmd == "update-gtf":
        ugp = _ugp_from_args(args)
        ugp.keep_min_set = args.min_output
        C.cmd_update_gtf(args.input, args.gtf, ugp, hdr_bam=args.bam,
                         sj_path=args.sj, out_path=args.output,
                         exon_bed=args.exon_bed, bam_gtf=args.bam_gtf,
                         bam_detail=args.bam_detail, known_gtf=args.known_gtf,
                         novel_gtf=args.novel_gtf, unrecog_gtf=args.unrecog,
                         summary=args.summary)
        return 0
    if args.cmd == "unique-gtf":
        ugp = _ugp_from_args(args, unique=True)
        C.cmd_unique_gtf(args.input, ugp, hdr_bam=args.bam,
                         out_path=args.output,
                         output_intersect=args.intersect)
        return 0
    if args.cmd == "bam2gtf":
        C.cmd_bam2gtf(args.input, args.output, args.min_exon, args.min_intron,
                      args.max_delet, args.source)
        return 0
    if args.cmd == "bam2sj":
        C.cmd_bam2sj(args.input, args.genome_file, args.output,
                     args.intron_len, require_proper_pair=args.prop_pair)
        return 0
    if args.cmd == "run":
        from .stages import run_pipeline
        cfg = run_config(args)
        if args.cpu:
            # the device kernels on JAX's CPU backend
            # (run_pipeline(use_device=False) is the host path)
            import jax
            jax.config.update("jax_platforms", "cpu")
        if args.num_processes and args.num_processes > 1:
            from ..parallel.distributed import init_multihost
            if args.coordinator is None or args.process_id is None:
                raise ValueError(
                    "--num-processes > 1 needs --coordinator and "
                    "--process-id")
            init_multihost(args.coordinator, args.num_processes,
                           args.process_id)
        run_pipeline(cfg)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
