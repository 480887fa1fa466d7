"""Smoke test of the whole system on NVIDIA GPUs.

    python chip_smoke.py              # one card
    python chip_smoke.py --four-gpus  # the 4-card paths and their reference

One card (one process holds the card; the host reference runs in a
JAX_PLATFORMS=cpu child that never opens it):
  preflight   JAX must find the GPU (JAX_PLATFORMS defaults to cuda here,
              so a failed CUDA start is an error, never a CPU run); prints
              the card's name and power limit, the compile-cache directory
              and whether the native library loaded (it must)
  dataset     scripts/simulate.py --genome-mb 45 --genes 1500
              --long-reads 100000 --short-pairs 50000 --seed 5: the
              500k-read BASELINE config-3 analog with the reads cut 5x to
              fit a smoke run
  run_gpu     the full two-pass pipeline through the `run` CLI on the GPU
  run_host    the same dataset through the host path (use_device=False)
  compare     alignment/*.minimap.sam, *.filtered.sam and
              output/updated.gtf must be byte-identical
  chain, polish, junction, seed, sjcount, graft_entry
              each device kernel that stays, at the real batch shapes,
              beside its host twin: shapes, equality, ms per call

--four-gpus runs only the 4-card paths, each in child processes that own
the cards in turn: `run` in one process over 4 cards (run_gpu), the reads
split into 4 samples under `run --num-processes 4` with one card per
process (run_4proc), __graft_entry__.dryrun_multichip(4) (dryrun), and the
host-path references both are compared with byte for byte.

Any failed phase exits non-zero without the result line.  The last line
of standard output is {"ok": true, "device": {"platform": "gpu", "kind":
..., "count": N}}, the devices as JAX reports them.
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
SIM_ARGS = ["--genome-mb", "45", "--genes", "1500", "--long-reads", "100000",
            "--short-pairs", "50000", "--seed", "5"]
SINGLE_PHASES = ["preflight", "dataset", "run_gpu", "run_host", "compare",
                 "chain", "polish", "junction", "seed", "sjcount",
                 "graft_entry"]
FOUR_GPU_PHASES = ["preflight4", "dataset", "split4", "run_gpu", "run_4proc",
                   "dryrun", "run_host", "run_host4", "compare",
                   "compare4"]


class SmokeError(RuntimeError):
    pass


def plan(four_gpus: bool):
    """Ordered phase names for one card or for --four-gpus."""
    return list(FOUR_GPU_PHASES if four_gpus else SINGLE_PHASES)


def require_gpu(dev: dict, count: int = 1) -> None:
    """Refuse anything but `count` or more GPUs."""
    if dev.get("platform") != "gpu":
        raise SmokeError(f"JAX found {dev.get('platform')!r}, not the GPU")
    if dev.get("count", 0) < count:
        raise SmokeError(f"need {count} GPUs, JAX found {dev.get('count')}")


def result_line(dev: dict) -> str:
    """The last line of standard output."""
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


def say(msg: str) -> None:
    print(msg, flush=True)


def _env(platforms: str) -> dict:
    return {**os.environ, "JAX_PLATFORMS": platforms}


def _check(cmd, env, what: str) -> None:
    r = subprocess.run(cmd, cwd=REPO, env=env)
    if r.returncode != 0:
        raise SmokeError(f"{what} exited {r.returncode}")


def _run_argv(out_dir: str, lists: bool = False):
    d = os.path.join(WORK, "data")
    argv = ["run", "--genome", os.path.join(d, "genome.fa"),
            "--gtf", os.path.join(d, "anno.gtf"), "--out-dir", out_dir]
    if lists:
        return argv + ["--long-read-list", os.path.join(WORK, "long.list"),
                       "--short-read-list", os.path.join(WORK, "short.list")]
    return argv + ["--long-read", os.path.join(d, "long.fa"),
                   "--short-read-1", os.path.join(d, "short_1.fa"),
                   "--short-read-2", os.path.join(d, "short_2.fa")]


def _host_run(argv) -> None:
    """The host-path reference: `run` arguments, use_device=False."""
    from lr2rmats_tpu.pipeline.cli import build_parser, run_config
    from lr2rmats_tpu.pipeline.stages import run_pipeline
    run_pipeline(run_config(build_parser().parse_args(argv)),
                 use_device=False)


def _host_reference(out_dir: str, lists: bool) -> None:
    code = ("import sys, chip_smoke; "
            f"chip_smoke._host_run({_run_argv(out_dir, lists)!r})")
    t0 = time.perf_counter()
    _check([sys.executable, "-c", code], _env("cpu"), "host reference run")
    say(f"run (host path, use_device=False): {time.perf_counter() - t0:.3f}"
        f" s; {_align_stats(out_dir)}")


def _same_bytes(a_dir: str, b_dir: str, samples) -> None:
    rels = [os.path.join("output", "updated.gtf")]
    for s in samples:
        rels += [os.path.join("alignment", f"{s}.minimap.sam"),
                 os.path.join("alignment", f"{s}.filtered.sam")]
    for rel in rels:
        with open(os.path.join(a_dir, rel), "rb") as f:
            a = f.read()
        with open(os.path.join(b_dir, rel), "rb") as f:
            b = f.read()
        say(f"compare {rel}: {len(a)} bytes, "
            f"{'byte-identical' if a == b else 'DIFFERENT'}")
        if a != b:
            raise SmokeError(f"{rel} differs between {a_dir} and {b_dir}")


def _align_stats(out_dir: str) -> str:
    """The align stage's wall and device phases from the run's log."""
    wall, phases = None, None
    for name in sorted(os.listdir(os.path.join(out_dir, "logs"))):
        with open(os.path.join(out_dir, "logs", name)) as f:
            for line in f:
                if "[stage/align[" in line and "done in" in line:
                    wall = line.split("done in")[1].split("s wall")[0].strip()
                if "phases device=" in line:
                    phases = line.split("] ", 1)[1].strip()
    return f"align wall {wall} s; {phases}"


class Smoke:
    def __init__(self, four_gpus: bool):
        self.four = four_gpus
        self.dev = None
        self.ctx = {}

    # ------------------------------------------------------------ set-up
    def preflight(self):
        os.environ.setdefault("JAX_PLATFORMS", "cuda")
        from lr2rmats_tpu.utils.devcache import enable_compile_cache
        from lr2rmats_tpu.utils.devinfo import device_info
        self.dev = device_info()
        require_gpu(self.dev)
        say(f"jax devices: {self.dev}")
        self._common_preflight(enable_compile_cache())

    def preflight4(self):
        """Device check in a child: the parent never opens the cards, so
        each later child owns them in turn."""
        code = ("import json; from lr2rmats_tpu.utils.devinfo import "
                "device_info; print(json.dumps(device_info()))")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           env=_env(os.environ.get("JAX_PLATFORMS", "cuda")),
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SmokeError("device check failed: " + r.stderr[-2000:])
        self.dev = json.loads(r.stdout.strip().splitlines()[-1])
        require_gpu(self.dev, 4)
        say(f"jax devices: {self.dev}")
        from lr2rmats_tpu.utils.devcache import cache_dir
        self._common_preflight(cache_dir())

    def _common_preflight(self, cache: str):
        from lr2rmats_tpu.native import get_lib
        from lr2rmats_tpu.utils.devinfo import gpu_name_power
        gpu = gpu_name_power()
        if not gpu:
            raise SmokeError("nvidia-smi did not report the card")
        say(f"gpu (name, power limit): {gpu}")
        say(f"compile cache: {cache}")
        if get_lib() is None:
            raise SmokeError("native lib: NOT loaded (build/liblrio.so)")
        say("native lib: loaded")

    def dataset(self):
        shutil.rmtree(WORK, ignore_errors=True)
        _check([sys.executable, "scripts/simulate.py", "--out",
                os.path.join(WORK, "data")] + SIM_ARGS, _env("cpu"),
               "scripts/simulate.py")
        say("dataset: BASELINE config-3 analog, 45 Mbp genome, 1500 genes, "
            "100000 long reads + 50000 short pairs (reads cut 5x from the "
            "500k config to fit a smoke run)")
        # build the minimizer index cache here, so every run below loads
        # it and their align-stage walls compare like for like
        from lr2rmats_tpu.index.minimizer import MinimizerIndex
        from lr2rmats_tpu.io.fasta import Genome
        fa = os.path.join(WORK, "data", "genome.fa")
        t0 = time.perf_counter()
        MinimizerIndex.build_or_load(Genome.load(fa), fa + ".tmmi.npz")
        say(f"index: built and cached ({time.perf_counter() - t0:.3f} s)")

    def split4(self):
        """Round-robin the long reads and short pairs into 4 samples."""
        d = os.path.join(WORK, "data")
        longs, shorts = [], []
        for src, dst in (("long.fa", longs), ("short_1.fa", None),
                         ("short_2.fa", None)):
            with open(os.path.join(d, src)) as f:
                recs = [(h, s) for h, s in zip(f, f)]
            paths = [os.path.join(WORK, f"s{i + 1}_{src}") for i in range(4)]
            for i, p in enumerate(paths):
                with open(p, "w") as f:
                    f.writelines(h + s for h, s in recs[i::4])
            if dst is not None:
                dst.extend(paths)
            else:
                shorts.append(paths)
        with open(os.path.join(WORK, "long.list"), "w") as f:
            f.write("4\n" + "".join(f"1\n{p}\n" for p in longs))
        with open(os.path.join(WORK, "short.list"), "w") as f:
            f.write("4\n" + "".join(f"1\n{a} {b}\n"
                                    for a, b in zip(*shorts)))
        say("split4: 4 samples, reads dealt round-robin")

    # ------------------------------------------------------------ runs
    def run_gpu(self):
        out = os.path.join(WORK, "gpu")
        t0 = time.perf_counter()
        if self.four:
            _check([sys.executable, "-m", "lr2rmats_tpu"] + _run_argv(out),
                   _env(os.environ.get("JAX_PLATFORMS", "cuda")),
                   "run over 4 GPUs")
        else:
            from lr2rmats_tpu.pipeline.cli import main
            rc = main(_run_argv(out))
            if rc != 0:
                raise SmokeError(f"run exited {rc}")
        say(f"run ({self.dev['platform']}, {self.dev['count']} device(s), one process): "
            f"{time.perf_counter() - t0:.3f} s; {_align_stats(out)}")

    def run_4proc(self):
        out = os.path.join(WORK, "gpu4proc")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        argv = _run_argv(out, lists=True) + [
            "--coordinator", f"localhost:{port}", "--num-processes", "4"]
        env = _env(os.environ.get("JAX_PLATFORMS", "cuda"))
        procs = [subprocess.Popen([sys.executable, "-m", "lr2rmats_tpu"]
                                  + argv + ["--process-id", str(i)],
                                  cwd=REPO, env=env) for i in range(4)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise SmokeError(f"run --num-processes 4 exited {rcs}")
        say(f"run (4 processes, one GPU each, 4 samples): "
            f"{time.perf_counter() - t0:.3f} s; {_align_stats(out)}")

    def dryrun(self):
        code = ("from lr2rmats_tpu.utils.devcache import enable_compile_cache;"
                " enable_compile_cache(); import __graft_entry__ as g; "
                "g.dryrun_multichip(4)")
        t0 = time.perf_counter()
        _check([sys.executable, "-c", code],
               _env(os.environ.get("JAX_PLATFORMS", "cuda")),
               "dryrun_multichip(4)")
        say(f"dryrun_multichip(4): ok ({time.perf_counter() - t0:.3f} s)")

    def run_host(self):
        _host_reference(os.path.join(WORK, "host"), lists=False)

    def run_host4(self):
        _host_reference(os.path.join(WORK, "host4"), lists=True)

    def compare(self):
        _same_bytes(os.path.join(WORK, "gpu"), os.path.join(WORK, "host"),
                    ["samp1"])

    def compare4(self):
        _same_bytes(os.path.join(WORK, "gpu4proc"),
                    os.path.join(WORK, "host4"),
                    [f"samp{i}" for i in range(1, 5)])

    # ------------------------------------------------------------ parity
    def _data(self):
        if "genome" not in self.ctx:
            from lr2rmats_tpu.index.minimizer import MinimizerIndex
            from lr2rmats_tpu.io.fasta import Genome, read_fasta
            d = os.path.join(WORK, "data")
            g = Genome.load(os.path.join(d, "genome.fa"))
            self.ctx["genome"] = g
            self.ctx["index"] = MinimizerIndex.build_or_load(
                g, os.path.join(d, "genome.fa.tmmi.npz"))
            self.ctx["long"] = read_fasta(os.path.join(d, "long.fa"))
        return self.ctx["genome"], self.ctx["index"], self.ctx["long"]

    def _aligner_batch(self):
        """An aligner and one production batch of reads at the shapes
        `run` uses for this dataset (auto-doubled batch included)."""
        from lr2rmats_tpu.align.batch import DEFAULT_BATCH, BatchAligner
        genome, idx, reads = self._data()
        al = BatchAligner(genome, index=idx)
        if reads.n >= 64 * DEFAULT_BATCH:
            al.chunk_scale = 2
        n = DEFAULT_BATCH * al.chunk_scale
        return al, [reads.get(i) for i in range(n)]

    def chain(self):
        import jax
        import numpy as np
        from lr2rmats_tpu.ops.chain_jax import dispatch_multi_packed
        al, codes = self._aligner_batch()
        rows = al._batch_anchors(codes)
        prep = al._prepare_dispatch(rows)
        al._materialize_chains(rows, al._chain_rows_async(rows, prep))
        t0 = time.perf_counter()
        dev = al._materialize_chains(rows, al._chain_rows_async(rows, prep))
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = al._materialize_chains(rows, "host")
        host_ms = (time.perf_counter() - t0) * 1e3
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(dispatch_multi_packed(
                prep["multi_bufs"], al.p.chain, al.p.min_score))
            walls.append((time.perf_counter() - t0) * 1e3)
        # membership exact; scores to a few float32 ulps (the device sums
        # in float32, the host in float64)
        bad = sum(1 for d, h in zip(dev, host)
                  if not (np.array_equal(d[0], h[0])
                          and np.array_equal(d[2], h[2])))
        rel = max((abs(d[k] - h[k]) / max(abs(h[k]), 1.0)
                   for d, h in zip(dev, host) for k in (1, 3)), default=0.0)
        self._parity("chain", bad == 0 and rel <= 1e-6,
                     f"{len(codes)} reads, {len(rows)} rows, fused call "
                     f"(A, B)={prep['shapes']}, rows with other chains="
                     f"{bad}, max score rel diff={rel:.2e}; fused "
                     f"call {np.median(walls):.3f} ms median (host arrays "
                     f"in, device result ready); batch chain device "
                     f"{dev_ms:.3f} ms vs host {host_ms:.3f} ms")

    def polish(self):
        import numpy as np
        from lr2rmats_tpu.align.polish import (B, _constrained_place,
                                               _constrained_place_many)
        genome, _, _ = self._data()
        ref = genome.codes
        rng = np.random.default_rng(7)
        items = []
        for _ in range(2048):
            m = int(rng.integers(0, 150))
            L0 = int(rng.integers(100, len(ref) - 10_000))
            span = int(rng.integers(max(m - 5, 1) + 60, m + 4000))
            qwin = ref[L0: L0 + m].copy()
            mut = rng.random(m) < 0.12
            qwin[mut] = (qwin[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            don = L0 + max(int(rng.integers(0, m + 2 * B + 1)) - B, -2)
            acc = don + max(span - m + int(rng.integers(-B, B + 1)), 10) - 1
            items.append((qwin, L0, L0 + span, don, acc))
        _constrained_place_many(items, ref)
        t0 = time.perf_counter()
        got = _constrained_place_many(items, ref)
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = [_constrained_place(*it[:1], ref, *it[1:]) for it in items]
        host_ms = (time.perf_counter() - t0) * 1e3
        bad = n_dev = 0
        for w, g in zip(want, got):
            if (w is None) != (g is None):
                bad += 1
            elif w is not None:
                n_dev += g[0] == "defer"
                bad += (g[1] if g[0] == "defer" else g[0]) != w[0]
        self._parity("polish", bad == 0 and n_dev > 0,
                     f"{len(items)} tasks, {n_dev} on the device, "
                     f"differing={bad}; device {dev_ms:.3f} ms/call vs "
                     f"host {host_ms:.3f} ms")

    def junction(self):
        import numpy as np
        from lr2rmats_tpu.align.splice import refine_splice_indel_np
        from lr2rmats_tpu.ops.splice_device import (MGAP,
                                                    junction_batch_scan,
                                                    prepare_junction_batch,
                                                    recover_ops)
        genome, _, _ = self._data()
        ref = genome.codes.copy()
        rng = np.random.default_rng(42)
        gaps = []
        for _ in range(1024):
            m = int(rng.integers(0, MGAP + 1))
            lr = int(rng.integers(100, len(ref) - 20_000))
            span = int(rng.integers(m + 40, m + 5000))
            q = ref[lr: lr + m].copy()
            mut = rng.random(m) < 0.15
            q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            if rng.random() < 0.5:                  # plant GT..AG
                don = lr + int(rng.integers(0, m + 1))
                ref[don], ref[don + 1] = 2, 3
                last = lr + span - (m - (don - lr)) - 1
                ref[last - 1], ref[last] = 0, 2
            gaps.append((q, lr, lr + span))
        batch = prepare_junction_batch(ref, gaps)
        junction_batch_scan(batch)
        t0 = time.perf_counter()
        placed = junction_batch_scan(batch)
        dev_ms = (time.perf_counter() - t0) * 1e3
        rec = recover_ops(ref, gaps, placed)
        t0 = time.perf_counter()
        want = [refine_splice_indel_np(q, ref, lo, hi, 4, 30)
                for q, lo, hi in gaps]
        host_ms = (time.perf_counter() - t0) * 1e3
        bad = sum(1 for w, d in zip(want, rec) if w != d)
        self._parity("junction", bad == 0,
                     f"{len(gaps)} gaps (q [{MGAP}, G]), differing={bad}; "
                     f"device {dev_ms:.3f} ms/call vs host (numpy "
                     f"reference) {host_ms:.3f} ms")

    def seed(self):
        import numpy as np
        from lr2rmats_tpu.index.seed_device import DeviceSeedLookup
        al, codes = self._aligner_batch()
        h = al._batch_minimizers(codes)[0]
        dev = DeviceSeedLookup(al.index)
        dev.lookup(h)
        t0 = time.perf_counter()
        lo_d, hi_d = dev.lookup(h)
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        lo_h, hi_h = al.index.lookup(h)
        host_ms = (time.perf_counter() - t0) * 1e3
        ok = np.array_equal(lo_d, lo_h) and np.array_equal(hi_d, hi_h)
        self._parity("seed", ok,
                     f"table {dev.n} entries, {len(h)} queries; device "
                     f"{dev_ms:.3f} ms/call vs host {host_ms:.3f} ms")

    def sjcount(self):
        import numpy as np
        from lr2rmats_tpu.io.fasta import read_fasta
        from lr2rmats_tpu.io.gtf import ChrNames, read_anno_trans
        from lr2rmats_tpu.junctions.sjcount import (JunctionCounter,
                                                    gather_junctions)
        genome, _, _ = self._data()
        d = os.path.join(WORK, "data")
        T = read_anno_trans(os.path.join(WORK, "gpu", "gtf",
                                         "samp1_new.gtf"),
                            ChrNames(genome.names))
        tid, don, acc, anno = gather_junctions([T])
        s1 = read_fasta(os.path.join(d, "short_1.fa"))
        s2 = read_fasta(os.path.join(d, "short_2.fa"))
        res, ms = {}, {}
        for backend in ("device", "host", "device"):
            jc = JunctionCounter(genome, tid, don, acc, anno,
                                 backend=backend)
            t0 = time.perf_counter()
            jc.count_pairs_batched(s1, s2)
            res[backend] = jc.result()
            ms[backend] = (time.perf_counter() - t0) * 1e3
        a, b = res["host"], res["device"]
        ok = all(np.array_equal(getattr(a, k), getattr(b, k))
                 for k in ("tid", "don", "acc", "uniq_c", "multi_c",
                           "max_over"))
        self._parity("sjcount", ok,
                     f"{s1.n} pairs, {len(tid)} junctions, support "
                     f"{int(a.uniq_c.sum() + a.multi_c.sum())}; device "
                     f"{ms['device']:.3f} ms vs host {ms['host']:.3f} ms")

    def graft_entry(self):
        import jax
        import numpy as np
        import __graft_entry__ as g
        fn, args = g.entry()
        out = np.asarray(jax.device_get(jax.jit(fn)(*args)))
        self._parity("graft_entry", bool(out.size), f"entry() -> {out.shape}"
                     f" {out.dtype}")

    def _parity(self, name: str, ok: bool, detail: str) -> None:
        say(f"parity {name}: {'equal' if ok else 'NOT EQUAL'}; {detail}")
        if not ok:
            raise SmokeError(f"parity {name} failed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card paths and their reference")
    args = ap.parse_args(argv)
    smoke = Smoke(args.four_gpus)
    t_all = time.perf_counter()
    try:
        for name in plan(args.four_gpus):
            t0 = time.perf_counter()
            getattr(smoke, name)()
            say(f"phase {name}: ok ({time.perf_counter() - t0:.3f} s)")
    except Exception as e:
        print(f"chip_smoke: phase {name} FAILED: {e!r}", file=sys.stderr)
        raise
    shutil.rmtree(WORK, ignore_errors=True)
    say(f"all phases ok ({time.perf_counter() - t_all:.3f} s)")
    say(result_line(smoke.dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
