"""lr2rmats_tpu — an accelerator-native long-read transcript-discovery engine.

A from-scratch reimplementation of the capabilities of Xinglab/lr2rmats
(the reference C/Snakemake pipeline) designed for an accelerator:

  * long-read spliced alignment  (replaces minimap2):  minimizer seeding +
    colinear chaining + splice-aware extension, batched in JAX with the DP
    inner loops mapped onto the GPU (see `lr2rmats_tpu.align`).
  * short-read junction support  (replaces the STAR `SJ.out.tab` role):
    batched junction-context matching (see `lr2rmats_tpu.junctions`).
  * transcript toolkit (replaces the lr2rmats C core): filter / update-gtf /
    unique-gtf / bam2gtf / bam2sj / fusion, all operating on dense padded
    exon-interval tensors (see `lr2rmats_tpu.transcript`).
  * pipeline orchestration (replaces Snakemake): a stage graph with
    file-artifact checkpointing (see `lr2rmats_tpu.pipeline`).
  * multi-device scaling via jax.sharding meshes (see `lr2rmats_tpu.parallel`).
"""

__version__ = "0.1.0"


def _tune_allocator() -> None:
    """Keep freed large buffers in the process heap.

    This environment materializes VM memory lazily at ~120-180 MB/s on
    first touch (measured: 800 MB of fresh pages fault in over 5-17 s while
    already-touched memory streams at 10 GB/s).  glibc's default
    M_MMAP_THRESHOLD sends every large numpy/bytes allocation through
    mmap/munmap, so each batch re-pays the fault cost.  Raising the mmap
    and trim thresholds serves big allocations from the retained heap:
    the same 800 MB allocate+touch drops from ~5 s to ~0 s after warmup.
    Opt out with LR2RMATS_NO_MALLOPT=1.
    """
    import os
    if os.environ.get("LR2RMATS_NO_MALLOPT"):
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_allocator()

PROG = "lr2rmats_tpu"
