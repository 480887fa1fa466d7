"""config.yaml without PyYAML on the `run` path (pipeline/config.py)."""

import builtins

import pytest

from lr2rmats_tpu.pipeline.config import PipelineConfig, SampleReads


def test_config_yaml_round_trip(tmp_path, monkeypatch):
    """to_yaml needs no PyYAML; from_yaml reads it back field for field,
    including paths that need quoting and a single-end sample."""
    cfg = PipelineConfig(genome_fasta=str(tmp_path / 'g dir' / 'a"b.fa'),
                         gtf="anno.gtf", rm_gtf="rRNA.gtf", sup_cnt=3,
                         split_trans=False, full_level=5, aln_cov=0.5)
    cfg.samples["s1"] = SampleReads("l1.fa", "s1_1.fa", "s1_2.fa")
    cfg.samples["s:2"] = SampleReads("l2.fa", "s2.fa", None)
    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    text = cfg.to_yaml()
    monkeypatch.setattr(builtins, "__import__", real_import)
    p = tmp_path / "config.yaml"
    p.write_text(text)
    back = PipelineConfig.from_yaml(str(p))
    for k in ("genome_fasta", "gtf", "rm_gtf", "updated_gtf", "aln_cov",
              "iden_frac", "sec_rat", "sup_cnt", "split_trans",
              "full_level", "samples"):
        assert getattr(back, k) == getattr(cfg, k), k


def test_from_yaml_without_pyyaml_is_a_clear_error(tmp_path, monkeypatch):
    import sys
    p = tmp_path / "config.yaml"
    p.write_text("genome: {}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="PyYAML"):
        PipelineConfig.from_yaml(str(p))
