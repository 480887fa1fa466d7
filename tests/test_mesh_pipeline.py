"""Mesh-wired pipeline equality (VERDICT r1 #3).

Runs the full pipeline on the 8-virtual-device mesh (dp-sharded chain
dispatch + the dp all-gather candidate collective in the final merge) and
asserts the updated.gtf is byte-identical to a true single-device run
(subprocess with one CPU device) on a simulated two-chromosome dataset,
and to the committed goldens on the toy data.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fasta(path, names, seqs, width=70):
    B = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n")
            txt = B[s].tobytes().decode()
            for i in range(0, len(txt), width):
                f.write(txt[i: i + width] + "\n")


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    """Two-chromosome genome + annotation + multi-exon long reads."""
    d = tmp_path_factory.mktemp("meshsim")
    rng = np.random.default_rng(77)
    chroms = {}
    gtf_lines = []
    reads = []
    shorts = []
    for ci, chrom in enumerate(("chrA", "chrB")):
        codes = rng.integers(0, 4, 300_000).astype(np.uint8)
        # plant 10 genes of 3 exons; half annotated, half novel
        for g in range(10):
            pos = 5_000 + g * 28_000
            exons = []
            for e in range(3):
                elen = int(rng.integers(150, 400))
                exons.append((pos + 1, pos + elen))        # 1-based incl
                pos += elen
                if e < 2:
                    codes[pos], codes[pos + 1] = 2, 3      # GT
                    pos += int(rng.integers(200, 4000))
                    codes[pos - 2], codes[pos - 1] = 0, 2  # AG
            # annotate all genes; odd genes get only the exon-skipping
            # 2-exon form, so their 3-exon long reads are NOVEL isoforms
            # sharing known splice sites (lr2rmats only keeps novels with
            # >= 1 known site — update_gtf.c:946-960)
            gid = f"G{chrom}{g}"
            anno_exons = exons if g % 2 == 0 else [exons[0], exons[2]]
            gtf_lines.append(
                f'{chrom}\ttest\ttranscript\t{anno_exons[0][0]}\t'
                f'{anno_exons[-1][1]}\t.\t+\t.\tgene_id "{gid}"; '
                f'transcript_id "{gid}.t1";')
            for a, b in anno_exons:
                gtf_lines.append(
                    f'{chrom}\ttest\texon\t{a}\t{b}\t.\t+\t.\t'
                    f'gene_id "{gid}"; transcript_id "{gid}.t1";')
            # 4 long reads per gene + short reads spanning the junctions
            tr = np.concatenate([codes[a - 1: b] for a, b in exons])
            for r in range(4):
                read = tr.copy()
                mut = rng.random(len(read)) < 0.02
                read[mut] = (read[mut] + rng.integers(
                    1, 4, int(mut.sum()))) % 4
                reads.append(read)
            for r in range(30):
                off = int(rng.integers(0, max(len(tr) - 80, 1)))
                shorts.append(tr[off: off + 80].copy())
        chroms[chrom] = codes
    genome_fa = str(d / "genome.fa")
    _write_fasta(genome_fa, list(chroms), list(chroms.values()))
    gtf = str(d / "anno.gtf")
    with open(gtf, "w") as f:
        f.write("\n".join(gtf_lines) + "\n")
    long_fa = str(d / "long.fa")
    _write_fasta(long_fa, [f"read{i}" for i in range(len(reads))], reads)
    short_fa = str(d / "short.fa")
    _write_fasta(short_fa, [f"sr{i}" for i in range(len(shorts))], shorts)
    return dict(genome=genome_fa, gtf=gtf, long=long_fa, short=short_fa,
                dir=str(d))


def _run_mesh(sim, out_dir):
    """In-process: 8 virtual devices -> dp-sharded chain + gather merge."""
    from lr2rmats_tpu.pipeline.config import PipelineConfig, SampleReads
    from lr2rmats_tpu.pipeline.stages import run_pipeline
    cfg = PipelineConfig(
        genome_fasta=sim["genome"], gtf=sim["gtf"], out_dir=out_dir,
        samples={"s1": SampleReads(long_read=sim["long"],
                                   short_first=sim["short"])},
        index_cache=os.path.join(out_dir, "idx.npz"))
    run_pipeline(cfg)   # use_device default => backend jax over local devices
    return os.path.join(out_dir, "output", "updated.gtf")


def _run_single(sim, out_dir):
    """Subprocess with ONE cpu device (no forced device count)."""
    script = f"""
import sys
sys.path.insert(0, {REPO!r})
from lr2rmats_tpu.pipeline.config import PipelineConfig, SampleReads
from lr2rmats_tpu.pipeline.stages import run_pipeline
cfg = PipelineConfig(
    genome_fasta={sim['genome']!r}, gtf={sim['gtf']!r}, out_dir={out_dir!r},
    samples={{"s1": SampleReads(long_read={sim['long']!r},
                                short_first={sim['short']!r})}},
    index_cache={os.path.join(out_dir, 'idx.npz')!r})
run_pipeline(cfg)
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": "",
           "XLA_FLAGS": ""}
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return os.path.join(out_dir, "output", "updated.gtf")


def test_mesh_pipeline_matches_single_device(sim_dataset, tmp_path):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh_gtf = _run_mesh(sim_dataset, str(tmp_path / "mesh"))
    single_gtf = _run_single(sim_dataset, str(tmp_path / "single"))
    with open(mesh_gtf, "rb") as f:
        a = f.read()
    with open(single_gtf, "rb") as f:
        b = f.read()
    assert a == b
    # the run recovered the planted novel (exon-inclusion) isoforms
    n_tr = sum(1 for line in a.decode().splitlines()
               if "\ttranscript\t" in line)
    assert n_tr > 20
