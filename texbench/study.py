"""The noise study and the sets of runs from which the bounds are set: runs
of cells one after another, each in its own process as the benchmark's
runs are, with the host's speed probed before each and every run's output
kept. The benchmark's own runs never start it.

    python3 -m texbench.study --out runs/set1.jsonl --seconds 51 \\
        fleet5.ref:101 fleet5.ref:102:pin etc1k.hq:7:base:trace

Each argument is ``<workload>:<seed>[:<variant>][:trace]``. A variant
changes only how the run's process is placed, never its work:

  * ``base``: as the benchmark runs it;
  * ``pin``: the process confined to CPUs ``--cpus`` (``sched_setaffinity``
    on the child before it starts, inherited by its threads);
  * ``nosmi``: the window's ``nvidia-smi`` sampler left off;
  * ``heap``: glibc's allocator told to keep freed memory (the trim and
    mmap thresholds raised through ``GLIBC_TUNABLES``), so that a pass's
    containers are not returned to the kernel and faulted in again.

Before each run the study times a copy of 256 MiB of host memory and a
fixed pure-Python loop (best of 3): the host's speed at that moment,
beside the run's own readings. One JSON line per run goes to ``--out``:
the arguments, the probe, the exit code, the wall seconds, the result
line, the earlier lines of standard output and the end of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HEAP = ("glibc.malloc.trim_threshold=4294967296:"
        "glibc.malloc.mmap_threshold=33554432")

#: The child: ``texbench.run``'s own entry, with the sampler switched off
#: for ``nosmi``.
CHILD = """
import runpy, sys
variant, argv = sys.argv[1], sys.argv[2:]
if variant == "nosmi":
    import texbench.clocks as c
    c.Clocks.__enter__ = lambda self: self
    c.Clocks.__exit__ = lambda self, *exc: False
sys.argv = ["texbench.run", *argv]
runpy.run_module("texbench.run", run_name="__main__")
"""


def probe() -> dict:
    """The host's speed now: GB/s of a 256 MiB copy, ms of a fixed loop."""
    src = np.ones(1 << 28, np.uint8)
    dst = np.empty_like(src)
    copy, loop = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        copy.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sum(i * i for i in range(1_000_000))
        loop.append(time.perf_counter() - t0)
    return {"copy_gb_s": src.nbytes / min(copy) / 1e9,
            "loop_ms": min(loop) * 1e3}


def run_one(workload: str, seed: int, variant: str, trace: bool,
            seconds: float, timeout: float, cpus: set) -> dict:
    cmd = [sys.executable, "-c", CHILD, variant, "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", "1" if trace else "0"]
    env = dict(os.environ)
    if variant == "heap":
        env["GLIBC_TUNABLES"] = HEAP
    pre = (lambda: os.sched_setaffinity(0, cpus)) if variant == "pin" else None
    host = probe()
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=timeout, preexec_fn=pre)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if rc == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "variant": variant,
            "trace": trace, "probe": host, "rc": rc,
            "wall_s": time.perf_counter() - t0, "result": result,
            "notes": lines[:-1] if result else lines[-20:],
            "stderr": err[-4000:]}


def summary(r: dict) -> str:
    res = r["result"]
    head = (f"{r['workload']} seed {r['seed']} {r['variant']} trace "
            f"{int(r['trace'])} probe {r['probe']['copy_gb_s']:.2f} GB/s "
            f"{r['probe']['loop_ms']:.1f} ms")
    if res is None:
        return f"{head} rc {r['rc']} no result: {r['stderr'][-600:]}"
    vals = " ".join(f"{k}={v['value']:.6g}" for k, v in res["metrics"].items())
    return (f"{head} correct {res['correct']} {vals} peak "
            f"{res['device']['memory_peak_bytes']} wall {r['wall_s']:.1f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--cpus", default="2,3")
    p.add_argument("runs", nargs="+")
    args = p.parse_args(argv)
    cpus = {int(c) for c in args.cpus.split(",")}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for spec in args.runs:
        workload, seed, *rest = spec.split(":")
        trace = "trace" in rest
        variant = next((v for v in rest if v != "trace"), "base")
        r = run_one(workload, int(seed), variant, trace, args.seconds,
                    args.timeout, cpus)
        with out.open("a") as f:
            f.write(json.dumps(r) + "\n")
        print(summary(r), flush=True)
        for line in r["notes"]:
            print("   ", line[:300], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
