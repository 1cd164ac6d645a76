"""Run one cell of the port's benchmark on the card.

    python3 -m texbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration and traffic mix; :mod:`texbench.drive` makes the
inputs from the seed, warms up the cell's own shapes and drives the port
in a closed loop for ``--seconds``. Then the program's state is dropped
and every kept answer is compared with the plain reference
(:mod:`texbench.reference`). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read from
a torch.profiler trace of the window's first units, kept in memory),
``device``, ``breakdown`` (traced runs) and, last, ``checks``: each number
compared beside its limit, which also end standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result. It never runs the port on the CPU.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from texbench import drive, roofline, trace  # noqa: E402
from texbench.clocks import Clocks, card  # noqa: E402
from texbench.hoststats import UnitStats  # noqa: E402
from texbench.manifest import Manifest, reader  # noqa: E402

#: Top-level modules that must not be loaded in the measuring process: JAX
#: and the JAX package the port was made from.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "texcomp"})


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _traced(client, units: int, latencies: list, device) -> trace.Reading:
    """Run ``units`` units under torch.profiler, recording the kernel
    wrappers' calls and, for the pipeline, its stage times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    recorder = roofline.CallRecorder()
    stages = client.stage_times()
    with profile(activities=acts) as prof:
        with recorder, record_function(trace.SPAN):
            for _ in range(units):
                t0 = time.perf_counter()
                with record_function(client.label):
                    client.unit()
                latencies.append(time.perf_counter() - t0)
    client.stage_times_off()
    reading = trace.reduce(*trace.raw_events(prof))
    reading.mpix = units * client.mpix
    reading.least_s = recorder.least_s()
    reading.recorded_kernels = recorder.kernels()
    reading.stage_host_s = dict(stages.host_s) if stages is not None else None
    return reading


def window(client, seconds: float, trace_units: int, device,
           stats: UnitStats):
    """Units back to back while the window is open; the last one starts
    before it closes. Returns (span seconds, latencies, trace reading,
    host CPU seconds of this process)."""
    latencies: list = []
    cpu0 = time.process_time()
    t_start = time.perf_counter()
    reading = (_traced(client, trace_units, latencies, device)
               if trace_units else None)
    if trace_units:
        stats.mark()
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        client.unit()
        latencies.append(time.perf_counter() - t0)
        stats.mark()
    return (time.perf_counter() - t_start, latencies, reading,
            time.process_time() - cpu0)


def end_to_end(man: Manifest, cell: dict, mix: dict, setup_s: float,
               span_s: float, latencies: list, mpix: float) -> dict:
    """The cell's end-to-end metrics: ``setup_s``, and per the mix's
    ``metrics`` a ``rate`` (the megapixels of every unit the window
    started over the time to the end of the last) or a ``p95`` (of every
    unit's latency, ms)."""
    kinds = {"rate": lambda: len(latencies) * mpix / span_s,
             "p95": lambda: float(np.percentile(np.array(latencies) * 1e3, 95))}
    out = {}
    for m in man.end_to_end(cell["name"]):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = kinds[mix["metrics"][m["name"]]]()
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(man: Manifest, cell: dict, reading: trace.Reading) -> dict:
    out = {}
    for m in man.per_layer(cell["name"]):
        value = reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(man: Manifest, cell: dict, seed: int, seconds: float,
             traced: bool, device, *, config: dict | None = None,
             mix: dict | None = None, t0: float = _T0) -> tuple[dict, list]:
    """One run of ``cell`` on ``device``. Returns (result, notes): the
    result line's object and the lines printed before it."""
    config = man.config(cell["config"]) if config is None else config
    mix = man.traffic(cell["traffic"]) if mix is None else mix
    t_make = time.perf_counter()
    client = drive.make(config, mix, seed, device)
    t_warm = time.perf_counter()
    client.warm()
    _sync(device)
    # What set-up made (modules, inputs) is no work of the window's: the
    # collector's full passes in the window scan what the window allocates.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    with Clocks() as clocks, UnitStats() as stats:
        span_s, latencies, reading, cpu_s = window(
            client, seconds, mix["trace_units"] if traced else 0, device,
            stats)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    client.release()
    readings, attempted, failed, checked = client.check()

    if traced:
        metrics = per_layer(man, cell, reading)
    else:
        metrics = end_to_end(man, cell, mix, setup_s, span_s, latencies,
                             client.mpix)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for v, lim in readings.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if traced:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.span_s
        result["breakdown"] = {"device_ops": reading.device_ops(),
                               "idle_gaps": reading.top_idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in readings.items()}
    notes = [f"texbench setup: {setup_s:.3f} s: start and imports "
             f"{t_make - t0:.3f}, the port and the inputs "
             f"{t_warm - t_make:.3f}, warm-up {setup_s - (t_warm - t0):.3f}",
             f"texbench window: {len(latencies)} units in {span_s:.6f} s, "
             f"process CPU {cpu_s:.3f} s; {checked} answers compared; unit "
             "ms " + " ".join(f"{x * 1e3:.1f}" for x in latencies),
             "texbench units (host, per unit): " + json.dumps(stats.summary()),
             "texbench clocks: " + json.dumps({"window": clocks.summary(),
                                               "card": card() if cuda else None})]
    if traced:
        notes.append(
            f"texbench trace: {len(reading.kernels)} kernels, "
            f"{len(reading.port_kernels())} of the port (the recorded calls "
            f"launched {reading.recorded_kernels}, least time "
            f"{reading.least_s}), {len(reading.copies)} copies, busy "
            f"{reading.busy_s:.6f} of {reading.span_s:.6f} s")
    return result, notes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = Manifest()
    cell = man.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"texbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}; no result", file=sys.stderr)
        return 2
    result, notes = run_cell(man, cell, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    # Once the window has closed, and the reference has run too.
    found = forbidden_modules()
    if found:
        print(f"texbench: loaded in the measuring process: "
              f"{', '.join(found)}; no result", file=sys.stderr)
        return 3
    for line in notes:
        print(line, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
