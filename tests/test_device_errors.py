"""A device error raises: no device call falls back to the host quietly.

Each case makes one device path of the aligner fail mid-run and checks
that the run stops with that error instead of finishing on a host twin.
The host paths run only where the caller asks for them
(`backend="host"`, `run_pipeline(use_device=False)`)."""

import numpy as np
import pytest

from lr2rmats_tpu.align.batch import BatchAligner
from lr2rmats_tpu.index.minimizer import MinimizerIndex
from lr2rmats_tpu.io.fasta import Genome, SeqSet


def _workload(seed=3, mb=2.0, n_reads=150, profile=None):
    import bench
    rng = np.random.default_rng(seed)
    n = int(mb * 1e6)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    genome = Genome(["c1"], codes, np.array([0, n], np.int64))
    reads, _ = bench.simulate_reads(genome, n_reads, rng, profile=profile)
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    ss = SeqSet([f"r{i}" for i in range(len(reads))],
                np.concatenate(reads), offs)
    return genome, ss


def _run(genome, ss, backend, junction_backend=None):
    idx = MinimizerIndex.build(genome)
    al = BatchAligner(genome, index=idx, backend=backend,
                      junction_backend=junction_backend)
    try:
        rb = al.align_seqset_packed(ss, batch_size=32)
        return rb.emit_sam(al.refs), al
    finally:
        al.close()


def _chain_dispatch(monkeypatch):
    """dispatch_multi_packed dies on the 3rd batch."""
    import lr2rmats_tpu.ops.chain_jax as cj
    real = cj.dispatch_multi_packed
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("device error: chain dispatch")
        return real(*a, **kw)

    monkeypatch.setattr(cj, "dispatch_multi_packed", dying)
    return dict(seed=3), dict(backend="jax")


def _chain_fetch(monkeypatch):
    """A pending device result explodes when the fetch touches it."""
    import lr2rmats_tpu.ops.chain_jax as cj
    real = cj.dispatch_multi_packed

    class Grenade:
        def __getattr__(self, name):
            raise RuntimeError("device error: chain fetch")

        def __iter__(self):
            raise RuntimeError("device error: chain fetch")

        def __getitem__(self, i):
            raise RuntimeError("device error: chain fetch")

    calls = {"n": 0}

    def arming(*a, **kw):
        calls["n"] += 1
        return Grenade() if calls["n"] == 2 else real(*a, **kw)

    monkeypatch.setattr(cj, "dispatch_multi_packed", arming)
    return dict(seed=5), dict(backend="jax")


def _polish_dp(monkeypatch):
    """_polish_best_pair dies.  The ONT profile guarantees near-miss
    junctions, so the batched device DP really is reached."""
    import lr2rmats_tpu.align.polish as pol

    def dying(*a, **kw):
        raise RuntimeError("device error: polish placement DP")

    monkeypatch.setattr(pol, "_polish_best_pair", dying)
    return dict(seed=7, n_reads=400, profile="ont"), dict(backend="jax")


def _seed_twin(monkeypatch):
    """The device seed lookup twin dies on the seed worker."""
    from lr2rmats_tpu.index.seed_device import DeviceSeedLookup
    monkeypatch.setenv("LR2RMATS_DEVICE_SEED", "1")

    def dying(self, q, n_threads=0):
        raise RuntimeError("device error: seed lookup twin")

    monkeypatch.setattr(DeviceSeedLookup, "lookup", dying)
    return dict(seed=9), dict(backend="host")


def _junction_build(monkeypatch):
    """The device junction DP dies inside the record build."""
    import lr2rmats_tpu.ops.splice_device as sd

    def dying(*a, **kw):
        raise RuntimeError("device error: junction build")

    monkeypatch.setattr(sd, "junction_batch_scan", dying)
    return dict(seed=11), dict(backend="jax", junction_backend="device")


@pytest.mark.parametrize("site", [_chain_dispatch, _chain_fetch, _polish_dp,
                                  _seed_twin, _junction_build],
                         ids=["chain_dispatch", "chain_fetch", "polish_dp",
                              "seed_twin", "junction_build"])
def test_device_error_raises(monkeypatch, site):
    work, aligner = site(monkeypatch)
    genome, ss = _workload(**work)
    with pytest.raises(RuntimeError, match="device error"):
        _run(genome, ss, **aligner)
