"""Multi-host distribution: jax.distributed init + cross-process gather.

The reference distributes per-sample jobs over a cluster with qsub
(reference README.md:139-153; per-rule resources config.yaml:37-66) and
gathers the per-sample novel GTFs through the shared filesystem
(`cat ... | unique-gtf`, reference Snakefile:172-192).  The equivalent
here is a `jax.distributed` process group: each process owns a
round-robin shard of the samples, runs alignment + both update-gtf passes
on its own accelerator, and the final cross-sample gather rides the
distributed backend (NCCL between GPUs, Gloo on CPU test clusters) as an
all-gather of the per-sample candidate payloads — no shared filesystem
required.

Within each process the (dp, tp) mesh of parallel.mesh still applies over
its local devices; this module is the layer above it.

Tested with a real 2-process CPU cluster in tests/test_distributed.py:
the gathered updated.gtf is byte-identical to the single-process run.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# process-group state, set by init_multihost (our own bookkeeping so that
# single-process runs never touch jax.distributed internals)
_STATE: Dict[str, int] = {"process_id": 0, "num_processes": 1}


def _gpu_platform() -> bool:
    """True when JAX will come up on CUDA devices.  Decided without
    initializing a backend, which jax.distributed.initialize forbids."""
    import importlib.util
    import jax
    plats = (jax.config.jax_platforms or "").lower()
    if plats:
        return plats.split(",")[0] in ("cuda", "gpu")
    return any(importlib.util.find_spec(m) is not None
               for m in ("jax_cuda12_plugin", "jax_cuda13_plugin"))


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join the jax.distributed process group (jax.distributed role of the
    reference's qsub cluster submission, README.md:139-153).

    Must be called before any other jax API touches the backend.  On the
    GPU each process owns exactly one card, `local_device_ids=[process_id]`
    (one host, one process per card); without it every process would open
    every card and the second one would run out of memory.
    """
    import jax
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes,
        process_id=process_id,
        local_device_ids=[process_id] if _gpu_platform() else None)
    _STATE["process_id"] = process_id
    _STATE["num_processes"] = num_processes


def adopt_multihost() -> None:
    """Record an externally initialized jax.distributed group (when the
    launcher called jax.distributed.initialize() itself)."""
    import jax
    _STATE["process_id"] = jax.process_index()
    _STATE["num_processes"] = jax.process_count()


def multihost_info() -> Tuple[int, int]:
    """(process_id, num_processes); (0, 1) when not in a process group."""
    return _STATE["process_id"], _STATE["num_processes"]


def owned_indices(n_items: int, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> List[int]:
    """Round-robin sample ownership (the per-sample scatter of the
    reference Snakefile {sample} wildcards over cluster jobs)."""
    pid, nproc = multihost_info()
    pid = process_id if process_id is not None else pid
    nproc = num_processes if num_processes is not None else nproc
    return list(range(pid, n_items, nproc))


def barrier(name: str = "lr2rmats") -> None:
    """Block until every process reaches this point."""
    pid, nproc = multihost_info()
    if nproc <= 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def gather_blobs(blob: bytes) -> List[bytes]:
    """All-gather one byte payload per process, returned in process order.

    The data plane is a device all-gather over the distributed backend
    (multihost_utils.process_allgather): payloads are padded to the global
    max length, gathered as a uint8 tensor, and trimmed per the gathered
    length vector.
    """
    pid, nproc = multihost_info()
    if nproc <= 1:
        return [blob]
    from jax.experimental import multihost_utils
    lens = multihost_utils.process_allgather(
        np.array([len(blob)], np.int64))
    lens = np.asarray(lens).reshape(nproc)
    # Bucket the gather width to the next power of two: process_allgather
    # compiles per shape, and a FRESH width costs ~2.8 s of XLA compile vs
    # ~80 ms steady-state for a 40 MB payload (scripts/bench_gather.py) —
    # with raw widths every pipeline batch recompiled all its gathers.
    width = max(int(lens.max()), 1)
    width = 1 << max(12, (width - 1).bit_length())
    pad = np.zeros(width, np.uint8)
    if blob:
        pad[: len(blob)] = np.frombuffer(blob, np.uint8)
    g = np.asarray(multihost_utils.process_allgather(pad))
    g = g.reshape(nproc, width)
    return [g[i, : int(lens[i])].tobytes() for i in range(nproc)]


def gather_indexed_payloads(
        payloads: Sequence[Tuple[int, bytes]]) -> Dict[int, bytes]:
    """All-gather (global_index, payload) frames from every process.

    Each process contributes the payloads for the samples it owns; the
    result maps every global sample index to its payload, on every
    process.  This is the reference's `expand()` + `cat` gather
    (Snakefile:172-192) over the distributed backend instead of a shared
    filesystem.
    """
    frames = b"".join(
        struct.pack("<qq", gi, len(b)) + b for gi, b in payloads)
    out: Dict[int, bytes] = {}
    for blob in gather_blobs(frames):
        off = 0
        while off < len(blob):
            gi, ln = struct.unpack_from("<qq", blob, off)
            off += 16
            out[gi] = blob[off: off + ln]
            off += ln
    return out
