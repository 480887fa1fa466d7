"""Device time and kernel launches of the main path's two device calls.

Traces, with jax.profiler, the fused chain+backtrack dispatch
(ops.chain_jax) at each anchor bucket's production shape and as the fused
multi-bucket call `run` makes, and the polish placement DP
(align.polish._polish_best_pair), each in a window of its own.  From each
trace it reads the GPU's device lines and reports, per call: device busy
time (union of kernel intervals), number of kernel launches, the heaviest
kernels, and the host wall around the call (block_until_ready).

    python scripts/profile_trace.py [--out chiprun_out/profile_trace.json]

Traces go under <repo>/.trace (listed in .gitignore); the summary JSON goes
to --out.  Needs the GPU: a non-GPU backend is refused.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import time
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# derived lines the profiler adds beside the GPU's stream lines; kernels
# live on the stream lines ("Stream #N(...)")
KERNEL_LINE_PREFIX = "Stream"


def device_summary(events, n_calls: int, top: int = 8) -> dict:
    """Reduce flattened trace events to per-call device numbers.

    events: iterable of (plane, line, name, start_ns, dur_ns).  Device
    planes are those named "/device:GPU:<i>"; kernels are the events on
    their stream lines.  Busy time is the union of kernel intervals per
    device plane, summed over planes."""
    per_plane = defaultdict(list)
    lines = defaultdict(lambda: [0, 0.0])
    for plane, line, name, start, dur in events:
        if not plane.startswith("/device:GPU:"):
            continue
        lines[f"{plane} | {line}"][0] += 1
        lines[f"{plane} | {line}"][1] += dur
        if line.startswith(KERNEL_LINE_PREFIX):
            per_plane[plane].append((start, start + dur, name))
    busy = 0.0
    n_kernels = 0
    by_name = defaultdict(lambda: [0, 0.0])
    for plane, ivs in per_plane.items():
        ivs.sort()
        n_kernels += len(ivs)
        cur_s, cur_e = None, None
        for s, e, name in ivs:
            by_name[name][0] += 1
            by_name[name][1] += e - s
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
    n = max(n_calls, 1)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device_planes": sorted(per_plane),
        "device_busy_ms_per_call": busy / n / 1e6,
        "kernel_launches_per_call": n_kernels / n,
        "top_kernels": [{"name": k[:100], "count": v[0],
                         "ms_per_call": v[1] / n / 1e6}
                        for k, v in heavy],
        "device_lines": {k: {"events": v[0], "ms": v[1] / 1e6}
                         for k, v in sorted(lines.items())},
    }


def _flatten(xplane_path: str):
    import jax
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    for plane in pd.planes:
        for line in plane.lines:
            for e in line.events:
                yield (plane.name, line.name, e.name, float(e.start_ns),
                       float(e.duration_ns))


def _profile(fn, tag: str, n_calls: int = 5) -> dict:
    """Warm fn (compile outside the window), time it on the host clock,
    then trace n_calls calls and reduce the trace."""
    import jax
    t0 = time.perf_counter()
    fn()
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    d = os.path.join(REPO, ".trace", tag)
    shutil.rmtree(d, ignore_errors=True)
    with jax.profiler.trace(d):
        for _ in range(n_calls):
            fn()
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    out = device_summary(_flatten(path), n_calls)
    out.update(first_call_s=compile_s, host_wall_ms_min=min(walls),
               host_wall_ms_median=float(np.median(walls)), n_calls=n_calls)
    return out


def _anchor_rows(rng, B: int, A: int, lo: int):
    """B rows of lo..A colinear anchors with introns and noise, sorted by
    (ref, query) like the aligner's rows."""
    q = np.zeros((B, A), np.int32)
    r = np.zeros((B, A), np.int32)
    n = rng.integers(lo, A + 1, B).astype(np.int32)
    for b in range(B):
        na = int(n[b])
        qq = np.sort(rng.integers(0, 3000, na))
        rr = qq.copy()
        for at in rng.integers(0, 3000, 3):
            rr = np.where(qq > at, rr + int(rng.integers(80, 8000)), rr)
        noise = rng.random(na) < 0.1
        rr = np.where(noise, rng.integers(0, 40_000, na), rr)
        order = np.lexsort((qq, rr))
        q[b, :na] = qq[order]
        r[b, :na] = rr[order] - rr[order].min()
    return q, r, n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "profile_trace.json"))
    args = ap.parse_args()
    import jax
    from lr2rmats_tpu.align import polish
    from lr2rmats_tpu.align.batch import A_BUCKETS, CHAIN_CHUNK
    from lr2rmats_tpu.align.chain import ChainParams
    from lr2rmats_tpu.ops import chain_jax as cj
    from lr2rmats_tpu.utils.devcache import enable_compile_cache
    from lr2rmats_tpu.utils.devinfo import device_info, gpu_name_power
    dev = device_info()
    if dev["platform"] != "gpu":
        sys.exit(f"profile_trace.py traces the GPU; JAX found "
                 f"{dev['platform']!r}")
    enable_compile_cache()
    out = {"device": dev, "gpu": gpu_name_power()}
    p = ChainParams()
    rng = np.random.default_rng(3)
    bufs = {}
    for i, A in enumerate(A_BUCKETS):
        lo = 2 if i == 0 else A_BUCKETS[i - 1] + 1
        bufs[A] = cj.pack_chain_buf(*_anchor_rows(rng, CHAIN_CHUNK[A], A, lo))

    def chain_single(A):
        return lambda: jax.block_until_ready(
            cj.dispatch_single_packed(bufs[A], p, 40.0))

    for A in A_BUCKETS:
        out[f"chain_A{A}_B{CHAIN_CHUNK[A]}"] = _profile(chain_single(A),
                                                        f"chain{A}")
    multi = [bufs[A] for A in A_BUCKETS[1:]]
    out["chain_multi_" + "+".join(
        f"A{A}xB{CHAIN_CHUNK[A]}" for A in A_BUCKETS[1:])] = _profile(
        lambda: jax.block_until_ready(cj.dispatch_multi_packed(
            multi, p, 40.0)), "chain_multi")

    M, B = polish._PLACE_M, polish.B
    for G in (256, 2048):
        q = rng.integers(0, 4, (M, G)).astype(np.int8)
        qr = q[::-1].copy()
        lwin = rng.integers(0, 4, (M + B, G)).astype(np.int8)
        rwin = rng.integers(0, 4, (M + B, G)).astype(np.int8)
        m_arr = rng.integers(M // 2, M + 1, G).astype(np.int32)
        dl = rng.integers(0, B + 1, G).astype(np.int32)
        dr = rng.integers(0, B + 1, G).astype(np.int32)
        args_ = [jax.numpy.asarray(a) for a in
                 (q, qr, lwin, rwin, m_arr, dl, dr)]
        out[f"polish_M{M}_G{G}"] = _profile(
            lambda: jax.block_until_ready(polish._polish_best_pair(*args_)),
            f"polish{G}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for k, v in out.items():
        if isinstance(v, dict) and "device_busy_ms_per_call" in v:
            print(f"{k}: device {v['device_busy_ms_per_call']:.3f} ms/call, "
                  f"{v['kernel_launches_per_call']:.1f} launches/call, host "
                  f"wall median {v['host_wall_ms_median']:.3f} ms")
    print(json.dumps({"device": dev, "gpu": out["gpu"]}))


if __name__ == "__main__":
    main()
