"""The port's spans read on a recorded event list (texbench/spans.py), and
the run that keeps a traced window's events for them."""

import json

import pytest

from texbench import run, spans, trace

MS = 1_000_000  # ns

#: A traced window of 100 ms holding two requests and a step outside it.
HOST = [
    ("texbench.window", 0, 100 * MS),
    ("texbench.api.compress", 1 * MS, 99 * MS),
    # Request 1: device busy 21-36 ms inside it.
    ("texcomp.api.compress", 15 * MS, 42 * MS),
    ("texcomp.api.upload", 15 * MS, 16 * MS),
    ("texcomp.etc1.hq.encode", 16 * MS, 39 * MS),
    ("texcomp.etc1.hq.candidates", 18 * MS, 30 * MS),
    ("aten::add", 19 * MS, 20 * MS),
    ("texcomp.etc1.hq.search", 30 * MS, 32 * MS),
    ("texcomp.etc1.hq.candidates", 32 * MS, 37 * MS),
    ("texcomp.etc1.hq.search", 37 * MS, 38 * MS),
    ("texcomp.api.download", 39 * MS, 41 * MS),
    # Request 2: the device idle all through it.
    ("texcomp.api.compress", 56 * MS, 70 * MS),
    ("texcomp.api.upload", 56 * MS, 57 * MS),
    ("texcomp.etc1.hq.encode", 57 * MS, 67 * MS),
    ("texcomp.etc1.hq.candidates", 57 * MS, 61 * MS),
    ("texcomp.etc1.hq.search", 61 * MS, 62 * MS),
    ("texcomp.etc1.hq.candidates", 62 * MS, 66 * MS),
    ("texcomp.etc1.hq.search", 66 * MS, 67 * MS),
    ("texcomp.api.download", 67 * MS, 69 * MS),
    # Outside the window: not read.
    ("texcomp.api.compress", 101 * MS, 120 * MS),
    ("texcomp.etc1.hq.candidates", 102 * MS, 110 * MS),
]
DEVICE = [
    ("Memcpy HtoD (Pageable -> Device)", 12 * MS, 14 * MS),
    ("void at::native::vectorized_elementwise_kernel<4>()", 21 * MS, 36 * MS),
    ("void (anonymous namespace)::hq_search_kernel<false>()", 50 * MS,
     55 * MS),
    ("void at::native::reduce_kernel<512, 1>()", 98 * MS, 104 * MS),
]
# Idle: 0-12, 14-21, 36-50 and 55-98 ms, 76 ms in all.

EXPECTED = {
    # (27 - 23 - 2 + 14 - 10 - 2) / 2
    "api.host_ms.hq": 2.0,
    "api.drain_ms.hq": 2.0,
    # (12 + 5 + 4 + 4) / 2
    "hq.candidates_ms.hq": 12.5,
    # idle 18-21 and 36-37 in request 1, all 8 ms in request 2, of 76
    "device.idle_in_candidates_pct.hq": 100.0 * 12 / 76,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reading(metric):
    assert spans.read(HOST, DEVICE)[metric] == pytest.approx(EXPECTED[metric])


def test_the_window_keeps_the_port_spans_inside_it_and_the_busy_intervals():
    port, busy, idle_ns = spans.window(HOST, DEVICE)
    assert len(port) == 16
    assert all(n.startswith("texcomp.") and 0 <= s < e <= 100 * MS
               for n, s, e in port)
    assert [s for _, s, _ in port] == sorted(s for _, s, _ in port)
    assert busy == [[12 * MS, 14 * MS], [21 * MS, 36 * MS],
                    [50 * MS, 55 * MS], [98 * MS, 100 * MS]]
    assert idle_ns == 76 * MS
    # The same busy time as the benchmark's own reduction.
    assert sum(e - s for s, e in busy) / 1e9 == pytest.approx(
        trace.reduce(HOST, DEVICE).busy_s)


def test_requests_and_their_children():
    reqs = spans.requests(spans.window(HOST, DEVICE)[0])
    assert [len(kids) for _, kids in reqs] == [7, 7]
    got = spans.read(HOST, DEVICE)
    assert got["requests"] == 2 and got["spans_per_request"] == 8
    assert got["ms_per_request"]["texcomp.api.compress"] == pytest.approx(20.5)
    assert got["ms_per_request"]["texcomp.etc1.hq.search"] == pytest.approx(2.5)
    assert got["device_events_named_port"] == 0


def test_nothing_to_read_reads_null():
    got = spans.read([("texbench.window", 0, MS)], [])
    assert all(got[m] is None for m in EXPECTED)
    # Requests, but the card never idle.
    busy_all = [("k", 0, 100 * MS)]
    assert spans.read(HOST, busy_all)[
        "device.idle_in_candidates_pct.hq"] is None
    with pytest.raises(RuntimeError):
        spans.read([("texcomp.api.compress", 0, MS)], [])


def test_the_run_keeps_the_traced_window_and_prints_its_spans(monkeypatch,
                                                              capsys):
    monkeypatch.setattr(trace, "raw_events", lambda prof: (HOST, DEVICE))

    def fake_main(argv):
        assert argv == ["--trace", "1"]
        trace.raw_events(None)
        return 0

    monkeypatch.setattr(run, "main", fake_main)
    wrapped = trace.raw_events
    assert spans.main(["--trace", "1"]) == 0
    assert trace.raw_events is wrapped
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("texbench spans: ")
    got = json.loads(line[len("texbench spans: "):])
    assert got["hq.candidates_ms.hq"] == pytest.approx(12.5)
