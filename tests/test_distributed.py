"""Multi-host (jax.distributed) pipeline equality.

The reference distributes per-sample jobs over a cluster with qsub and
gathers per-sample novel GTFs through the shared filesystem
(`cat ... | unique-gtf`, reference Snakefile:172-192; cluster submission
README.md:139-153).  Here each process of a real 2-process CPU
jax.distributed group (Gloo backend) owns a round-robin shard of the
samples and the cross-sample gather rides the distributed backend; the
test asserts the 2-process updated.gtf is byte-identical to a
single-process run on a simulated 2-sample dataset.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORD = "127.0.0.1:29873"


def _write_fasta(path, names, seqs, width=70):
    B = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n")
            txt = B[s].tobytes().decode()
            for i in range(0, len(txt), width):
                f.write(txt[i: i + width] + "\n")


@pytest.fixture(scope="module")
def sim2(tmp_path_factory):
    """One-chromosome genome, 10 genes, 40 long reads split in 2 samples."""
    d = tmp_path_factory.mktemp("distsim")
    rng = np.random.default_rng(909)
    codes = rng.integers(0, 4, 300_000).astype(np.uint8)
    gtf_lines = []
    reads = []
    shorts = []
    for g in range(10):
        pos = 5_000 + g * 28_000
        exons = []
        for e in range(3):
            elen = int(rng.integers(150, 400))
            exons.append((pos + 1, pos + elen))
            pos += elen
            if e < 2:
                codes[pos], codes[pos + 1] = 2, 3          # GT
                pos += int(rng.integers(200, 4000))
                codes[pos - 2], codes[pos - 1] = 0, 2      # AG
        gid = f"G{g}"
        anno_exons = exons if g % 2 == 0 else [exons[0], exons[2]]
        gtf_lines.append(
            f'chrA\ttest\ttranscript\t{anno_exons[0][0]}\t'
            f'{anno_exons[-1][1]}\t.\t+\t.\tgene_id "{gid}"; '
            f'transcript_id "{gid}.t1";')
        for a, b in anno_exons:
            gtf_lines.append(
                f'chrA\ttest\texon\t{a}\t{b}\t.\t+\t.\t'
                f'gene_id "{gid}"; transcript_id "{gid}.t1";')
        tr = np.concatenate([codes[a - 1: b] for a, b in exons])
        for r in range(4):
            read = tr.copy()
            mut = rng.random(len(read)) < 0.02
            read[mut] = (read[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            reads.append(read)
        for r in range(30):
            off = int(rng.integers(0, max(len(tr) - 80, 1)))
            shorts.append(tr[off: off + 80].copy())
    genome_fa = str(d / "genome.fa")
    _write_fasta(genome_fa, ["chrA"], [codes])
    gtf = str(d / "anno.gtf")
    with open(gtf, "w") as f:
        f.write("\n".join(gtf_lines) + "\n")
    # interleave reads across the two samples so both contribute novels
    long_a = str(d / "longA.fa")
    long_b = str(d / "longB.fa")
    _write_fasta(long_a, [f"rA{i}" for i in range(0, len(reads), 2)],
                 reads[0::2])
    _write_fasta(long_b, [f"rB{i}" for i in range(1, len(reads), 2)],
                 reads[1::2])
    short_fa = str(d / "short.fa")
    _write_fasta(short_fa, [f"sr{i}" for i in range(len(shorts))], shorts)
    # count-prefixed read lists (reference run_snakemake.py:20-45)
    long_list = str(d / "long.list")
    with open(long_list, "w") as f:
        f.write(f"2\n1\n{long_a}\n1\n{long_b}\n")
    short_list = str(d / "short.list")
    with open(short_list, "w") as f:
        f.write(f"2\n1\n{short_fa}\n1\n{short_fa}\n")
    return dict(genome=genome_fa, gtf=gtf, long_list=long_list,
                short_list=short_list)


def _cli_cmd(sim2, out_dir, extra=()):
    return [sys.executable, "-m", "lr2rmats_tpu", "run",
            "--genome", sim2["genome"], "--gtf", sim2["gtf"],
            "--long-read-list", sim2["long_list"],
            "--short-read-list", sim2["short_list"],
            "--out-dir", out_dir, "--cpu", *extra]


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "",
            "PYTHONPATH": REPO}


def test_two_process_matches_single(sim2, tmp_path):
    single = str(tmp_path / "single")
    r = subprocess.run(_cli_cmd(sim2, single), env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

    dist = str(tmp_path / "dist")
    procs = [subprocess.Popen(
        _cli_cmd(sim2, dist, extra=(
            "--coordinator", COORD, "--num-processes", "2",
            "--process-id", str(pid))),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    with open(os.path.join(single, "output", "updated.gtf"), "rb") as f:
        a = f.read()
    with open(os.path.join(dist, "output", "updated.gtf"), "rb") as f:
        b = f.read()
    assert a == b
    n_tr = sum(1 for line in a.decode().splitlines()
               if "\ttranscript\t" in line)
    assert n_tr > 10  # annotation survived + novels recovered
    # both processes aligned their own sample shard
    for samp in ("samp1", "samp2"):
        assert os.path.exists(
            os.path.join(dist, "alignment", f"{samp}.minimap.sam"))


def test_owned_indices_round_robin():
    from lr2rmats_tpu.parallel.distributed import owned_indices
    assert owned_indices(5, 0, 2) == [0, 2, 4]
    assert owned_indices(5, 1, 2) == [1, 3]
    assert owned_indices(3, 0, 1) == [0, 1, 2]
    assert owned_indices(1, 1, 4) == []


def test_gather_single_process_identity():
    from lr2rmats_tpu.parallel.distributed import (gather_blobs,
                                                   gather_indexed_payloads)
    assert gather_blobs(b"abc") == [b"abc"]
    got = gather_indexed_payloads([(3, b"x"), (0, b""), (7, b"yy")])
    assert got == {3: b"x", 0: b"", 7: b"yy"}


@pytest.mark.parametrize("gpu", [True, False], ids=["gpu", "cpu"])
def test_init_multihost_pins_one_card_per_process(monkeypatch, gpu):
    """On the GPU each process of the group owns exactly one card."""
    import jax
    from lr2rmats_tpu.parallel import distributed as D
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(D, "_gpu_platform", lambda: gpu)
    monkeypatch.setitem(D._STATE, "process_id", 0)
    monkeypatch.setitem(D._STATE, "num_processes", 1)
    D.init_multihost("localhost:1234", 4, 2)
    assert seen["local_device_ids"] == ([2] if gpu else None)
    assert seen["process_id"] == 2 and seen["num_processes"] == 4
    assert D.multihost_info() == (2, 4)
