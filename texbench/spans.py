"""The port's own spans in a traced run of a cell, read on the clock of the
card's kernels and copies.

    python3 -m texbench.spans --workload etc1k.hq --seed <n> --seconds <s> --trace 1

runs :func:`texbench.run.main` with the same arguments and prints all it
prints; it keeps the raw events of the traced window (``--trace 1``) and
then prints one more line, ``texbench spans: {...}``, with what the port's
``texcomp.*`` spans (``texcomp_torch.utils.profiling.span``) show:

- ``api.host_ms.hq``: a request's ``texcomp.api.compress`` span less the
  time its ``texcomp.etc1.hq.encode`` and ``texcomp.api.download``
  children cover: the API's own host work (view, copies, container);
- ``api.drain_ms.hq``: a request's ``texcomp.api.download``, where the
  host waits for the card's backlog and copies the payload back;
- ``hq.candidates_ms.hq``: a request's ``texcomp.etc1.hq.candidates``
  spans, the HQ encode's eager candidate generation;
- ``device.idle_in_candidates_pct.hq``: the card's idle time inside those
  spans over all its idle time in the window;

and, per request, the time every span name covers, and how many device
events carry a ``texcomp.`` name (0: the port's annotations add no busy
time). "Per request" divides by the ``texcomp.api.compress`` spans inside
the window; a request's children are the port's spans inside its own (one
client, one request at a time). A reading with nothing to read is null.
"""

from __future__ import annotations

import json
import sys

from texbench import run, trace

#: The port's spans, and the one that is a request.
PORT = "texcomp."
REQUEST = "texcomp.api.compress"


def _covered(intervals) -> int:
    return sum(e - s for s, e in trace._union([[s, e] for s, e in intervals]))


def window(host: list, device: list) -> tuple[list, list, int]:
    """(the port's spans wholly inside the window, [(name, start ns, end
    ns)] by start; the device's busy intervals there, [[start, end]]; the
    window's idle ns) from :func:`texbench.trace.raw_events`' lists."""
    spans = [(s, e) for n, s, e in host if n == trace.SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {trace.SPAN!r} span")
    t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
    busy = trace._union([[max(s, t0), min(e, t1)] for _, s, e in device
                         if e > t0 and s < t1])
    port = sorted(((n, s, e) for n, s, e in host
                   if n.startswith(PORT) and s >= t0 and e <= t1),
                  key=lambda x: x[1])
    return port, busy, (t1 - t0) - sum(e - s for s, e in busy)


def requests(port: list) -> list:
    """[(request span, [the port's spans inside it])]."""
    return [(r, [s for s in port if s is not r and r[1] <= s[1]
                 and s[2] <= r[2]])
            for r in port if r[0] == REQUEST]


def per_request_ms(port: list, name: str, less: tuple = ()) -> float | None:
    """Milliseconds a request: what the request's spans named ``name`` (its
    own or its children's) cover, less what its children named in
    ``less`` cover."""
    reqs = requests(port)
    if not reqs:
        return None
    ns = 0
    for req, kids in reqs:
        ns += _covered((s, e) for n, s, e in [req, *kids] if n == name)
        ns -= _covered((s, e) for n, s, e in kids if n in less)
    return ns / 1e6 / len(reqs)


def idle_in_pct(port: list, busy: list, idle_ns: int,
                name: str) -> float | None:
    """The device's idle time inside the spans named ``name`` over its
    idle time in the window."""
    inside = trace._union([[s, e] for n, s, e in port if n == name])
    if not inside or idle_ns <= 0:
        return None
    idle = 0
    for s, e in inside:
        idle += (e - s) - sum(max(0, min(e, be) - max(s, bs))
                              for bs, be in busy)
    return 100.0 * idle / idle_ns


def read(host: list, device: list) -> dict:
    """The readings the module's docstring lists."""
    port, busy, idle_ns = window(host, device)
    n_requests = len(requests(port))
    return {
        "api.host_ms.hq": per_request_ms(
            port, REQUEST, less=("texcomp.etc1.hq.encode",
                                 "texcomp.api.download")),
        "api.drain_ms.hq": per_request_ms(port, "texcomp.api.download"),
        "hq.candidates_ms.hq": per_request_ms(port,
                                              "texcomp.etc1.hq.candidates"),
        "device.idle_in_candidates_pct.hq": idle_in_pct(
            port, busy, idle_ns, "texcomp.etc1.hq.candidates"),
        "requests": n_requests,
        "spans_per_request": len(port) / n_requests if n_requests else None,
        "ms_per_request": {n: per_request_ms(port, n)
                           for n in sorted({n for n, _, _ in port})},
        "device_events_named_port": sum(n.startswith(PORT)
                                        for n, _, _ in device),
    }


def main(argv=None) -> int:
    kept = []
    raw_events = trace.raw_events

    def keep(prof):
        events = raw_events(prof)
        kept.append(events)
        return events

    trace.raw_events = keep
    try:
        rc = run.main(argv)
    finally:
        trace.raw_events = raw_events
    for host, device in kept:
        print("texbench spans: " + json.dumps(read(host, device)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
