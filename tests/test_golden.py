"""Byte-level golden-output regression test (VERDICT r1 #9).

Runs the full pipeline on the reference toy fixtures and byte-diffs every
output against the committed snapshots in tests/golden/toy/.  Structural
assertions (test_pipeline_e2e) can miss semantic drift; these cannot.

If an intentional behavior change alters outputs, regenerate with:
    python -m lr2rmats_tpu run --genome .../genome.fa ... --out-dir D
    cp D/output/updated.gtf D/output/samp1.* tests/golden/toy/
and say why in the commit message.
"""

import os
import shutil

import pytest

REF = "/root/reference/test_data"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "toy")

FILES = ["updated.gtf", "samp1.bam.gtf", "samp1.detail.txt",
         "samp1.known.gtf", "samp1.novel.gtf", "samp1.novel_exon.bed",
         "samp1.summary.txt", "samp1.unrecog.gtf"]


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    if not os.path.isdir(REF):
        pytest.skip("reference test_data not available")
    out = str(tmp_path_factory.mktemp("golden_run"))
    from lr2rmats_tpu.pipeline.config import PipelineConfig, SampleReads
    from lr2rmats_tpu.pipeline.stages import run_pipeline
    cfg = PipelineConfig(
        genome_fasta=f"{REF}/genome/genome.fa",
        gtf=f"{REF}/gtf/original.gtf",
        rm_gtf=f"{REF}/gtf/rRNA.gtf",
        out_dir=out,
        samples={"samp1": SampleReads(
            long_read=f"{REF}/read/samp1_long.fa",
            short_first=f"{REF}/read/samp1_short_1.fa",
            short_second=f"{REF}/read/samp1_short_2.fa")},
        # keep the cached index out of the read-only reference tree
        index_cache=os.path.join(out, "idx.tmmi.npz"),
    )
    run_pipeline(cfg, use_device=False)
    return out


@pytest.mark.parametrize("name", FILES)
def test_golden_byte_identical(toy_run, name):
    got = os.path.join(toy_run, "output", name)
    want = os.path.join(GOLDEN, name)
    with open(got, "rb") as f:
        g = f.read()
    with open(want, "rb") as f:
        w = f.read()
    assert g == w, f"{name} differs from committed golden"


def test_ref_compat_flips_known(toy_run, tmp_path):
    """--ref-compat (ARCHITECTURE.md §5 deviation #1): under exact
    reference acceptor semantics NO multi-exon transcript can classify
    known, so the toy CCS read flips known -> novel-with-known-sites.
    Machine-checked against the compiled C in test_reference_oracle; this
    pins the end-to-end CLI surface."""
    from lr2rmats_tpu.pipeline.commands import cmd_update_gtf
    from lr2rmats_tpu.transcript.model import UpdateGtfParams

    sam = os.path.join(toy_run, "alignment", "samp1.filtered.sam")
    if not os.path.exists(sam):
        pytest.skip("filtered SAM not kept by this pipeline config")

    def counts(compat):
        summ = str(tmp_path / f"sum_{compat}.txt")
        cmd_update_gtf(sam, f"{REF}/gtf/original.gtf",
                       UpdateGtfParams(ref_acceptor_compat=compat),
                       out_path=os.devnull, summary=summ)
        known = novel = -1
        for line in open(summ):
            if line.startswith("Known_Transcripts_from_BAM"):
                known = int(line.split()[-1])
            if line.startswith("Novel_Transcript_from_BAM\t"):
                novel = int(line.split()[-1])
        return known, novel

    k0, n0 = counts(False)
    k1, n1 = counts(True)
    assert k0 == 1 and k1 == 0
    assert n1 == n0 + 1
