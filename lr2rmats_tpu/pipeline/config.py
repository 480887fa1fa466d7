"""Pipeline configuration.

Consumes the reference's config.yaml schema (reference config.yaml /
config.template.yaml: genome / sample / output / lr2rmats sections; exe_files
and per-rule cluster resources are accepted and ignored — there are no
external binaries to point at) and the count-prefixed read-list format of
run_snakemake.py:20-45.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SampleReads:
    long_read: str
    short_first: Optional[str] = None
    short_second: Optional[str] = None   # None/[] => single-end (README:169-175)


@dataclass
class PipelineConfig:
    genome_fasta: str = ""
    gtf: str = ""
    rm_gtf: str = ""                      # rRNA removal GTF ('' = none)
    samples: Dict[str, SampleReads] = field(default_factory=dict)
    updated_gtf: str = "output/updated.gtf"
    out_dir: str = "."
    # algorithm knobs (reference config.yaml:68-75)
    aln_cov: float = 0.67
    iden_frac: float = 0.75
    sec_rat: float = 0.98
    sup_cnt: int = 1
    split_trans: bool = True
    full_level: int = 3
    # engine knobs
    index_cache: Optional[str] = None     # minimap_idx_file role
    batch_reads: int = 64
    jobs: Optional[int] = None            # per-sample host-stage parallelism
                                          # (Snakemake --jobs role); None =
                                          # min(4, n_samples), 1 = serial
    index_shards: int = 1                 # minimizer table hash-range shards
                                          # (SURVEY §5 long-genome arm); >1
                                          # routes seed lookups per shard

    @classmethod
    def from_yaml(cls, path: str) -> "PipelineConfig":
        try:
            import yaml
        except ImportError as e:
            raise ValueError(
                "--config needs PyYAML, which is not installed; pass the "
                "inputs as --genome/--gtf/--long-read/--short-read-1/2 or "
                "as --long-read-list/--short-read-list files instead") from e
        with open(path) as f:
            raw = yaml.safe_load(f)
        cfg = cls()
        g = raw.get("genome", {})
        cfg.genome_fasta = g.get("fasta", "")
        cfg.gtf = g.get("gtf", "")
        cfg.index_cache = g.get("minimap_idx_file") or g.get("minimap_idx")
        lr = raw.get("lr2rmats", {})
        rm = lr.get("rm_gtf", g.get("rm_gtf", "")) or ""
        cfg.rm_gtf = rm.replace("-r ", "").strip()
        cfg.aln_cov = float(lr.get("aln_cov", cfg.aln_cov))
        cfg.iden_frac = float(lr.get("iden_frac", cfg.iden_frac))
        cfg.sec_rat = float(lr.get("sec_rat", cfg.sec_rat))
        cfg.sup_cnt = int(lr.get("sup_cnt", cfg.sup_cnt))
        st = lr.get("split_trans", "-s")
        cfg.split_trans = bool(st) and st != ""
        cfg.full_level = int(lr.get("full_level", cfg.full_level))
        out = raw.get("output", {})
        cfg.updated_gtf = out.get("updated_gtf", cfg.updated_gtf)
        sample = raw.get("sample", {})
        longs = sample.get("long_read", {}) or {}
        shorts = sample.get("short_read", {}) or {}
        for name, lr_path in longs.items():
            sr = shorts.get(name, {}) or {}
            second = sr.get("second")
            if second in ([], "", None):
                second = None
            cfg.samples[name] = SampleReads(lr_path, sr.get("first"), second)
        return cfg

    def to_yaml(self) -> str:
        """The resolved configuration in the reference's config.yaml schema
        (what run_snakemake.py:132-135 writes into the out dir), readable
        by `from_yaml`.  Standard library only: every key and scalar is a
        JSON literal, which YAML reads back as the same value."""
        doc = {
            "genome": {"fasta": self.genome_fasta, "gtf": self.gtf},
            "sample": {
                "long_read": {s: r.long_read
                              for s, r in self.samples.items()},
                "short_read": {s: {"first": r.short_first,
                                   "second": r.short_second or []}
                               for s, r in self.samples.items()},
            },
            "output": {"updated_gtf": self.updated_gtf},
            "lr2rmats": {"rm_gtf": self.rm_gtf, "aln_cov": self.aln_cov,
                         "iden_frac": self.iden_frac,
                         "sec_rat": self.sec_rat, "sup_cnt": self.sup_cnt,
                         "split_trans": "-s" if self.split_trans else "",
                         "full_level": self.full_level},
        }
        lines: List[str] = []

        def emit(d: dict, indent: str) -> None:
            for k, v in d.items():
                key = json.dumps(str(k))
                if isinstance(v, dict) and v:
                    lines.append(f"{indent}{key}:")
                    emit(v, indent + "  ")
                else:
                    lines.append(f"{indent}{key}: {json.dumps(v)}")

        emit(doc, "")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_read_lists(cls, genome: str, gtf: str, long_list: str,
                        short_list: str, **kw) -> "PipelineConfig":
        """Count-prefixed list files (reference run_snakemake.py:20-45)."""
        cfg = cls(genome_fasta=genome, gtf=gtf, **kw)
        longs: List[str] = []
        with open(long_list) as f:
            n_samp = int(f.readline().split()[0])
            for _ in range(n_samp):
                n_rep = int(f.readline().split()[0])
                for _ in range(n_rep):
                    longs.append(os.path.abspath(f.readline().split()[0]))
        shorts: List[tuple] = []
        with open(short_list) as f:
            n_samp = int(f.readline().split()[0])
            for _ in range(n_samp):
                n_rep = int(f.readline().split()[0])
                for _ in range(n_rep):
                    line = f.readline()
                    if "#" in line:
                        line = line[: line.index("#")]
                    parts = line.split()
                    first = os.path.abspath(parts[0])
                    second = os.path.abspath(parts[1]) if len(parts) >= 2 else None
                    shorts.append((first, second))
        for i, lr_path in enumerate(longs):
            first, second = shorts[i] if i < len(shorts) else (None, None)
            cfg.samples[f"samp{i + 1}"] = SampleReads(lr_path, first, second)
        return cfg
