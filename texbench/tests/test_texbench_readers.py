"""Each per-layer reader on a recorded event list, and the reduction of
events to a span's reading."""

import pytest

from texbench import trace
from texbench.manifest import HERE, reader

MS = 1_000_000  # ns

#: A recorded span of 100 ms: host annotations and ops, and device work.
HOST = [
    ("texbench.window", 0, 100 * MS),
    ("texbench.fleet.run", 1 * MS, 99 * MS),
    ("aten::copy_", 13 * MS, 20 * MS),
    ("cudaLaunchKernel", 20 * MS, 21 * MS),
]
DEVICE = [
    ("Memcpy HtoD (Pinned -> Device)", 12 * MS, 14 * MS),
    ("void (anonymous namespace)::encode_kernel<2>(unsigned char const*)",
     21 * MS, 31 * MS),
    ("void at::native::vectorized_elementwise_kernel<4>()", 31 * MS, 36 * MS),
    ("(anonymous namespace)::upscale_modulate_kernel(unsigned int const*)",
     50 * MS, 55 * MS),
]


def reading():
    r = trace.reduce(HOST, DEVICE)
    r.mpix = 2.0
    r.least_s = 0.003
    r.recorded_kernels = 2
    r.stage_host_s = {"stack": 0.03, "pack": 0.05}
    return r


def test_the_reduction():
    r = reading()
    assert r.span_s == pytest.approx(0.1)
    assert r.busy_s == pytest.approx(0.022)
    assert len(r.kernels) == 3 and len(r.copies) == 1
    assert len(r.port_kernels()) == 2
    # Idle 0-12, 14-21, 36-50 and 55-100 ms; the copy covers the middle of
    # 14-21, the pass the others.
    gaps = dict(r.top_idle_gaps())
    assert gaps == pytest.approx({"texbench.fleet.run": 0.071,
                                  "aten::copy_": 0.007})
    assert r.device_ops()[0][1] == pytest.approx(0.010)


#: A reader's reading, by its metric's name less the cell suffix, so that
#: a cell's own reader of a kind this table has is checked as it is added.
EXPECTED = {
    "pipeline.host_pct": 80.0,
    "hq.launches_per_mpix": 1.5,
    "kernels_roofline": 20.0,
    "device.idle_pct": 78.0,
}


#: Every reader under texbench/metrics/, also those of the cells PERF.md
#: keeps for later.
READERS = sorted(p.stem for p in (HERE / "metrics").glob("*.py"))


@pytest.mark.parametrize("metric", READERS)
def test_each_reader(metric):
    want = EXPECTED[metric.rsplit(".", 1)[0]]
    assert reader(metric)(reading()) == pytest.approx(want)


def test_readers_report_nothing_where_nothing_was_read():
    r = trace.reduce([("texbench.window", 0, MS)], [])
    for name in READERS:
        assert reader(name)(r) is None


def test_the_roofline_reports_nothing_when_calls_and_kernels_disagree():
    r = reading()
    r.recorded_kernels = 3
    assert r.roofline_pct() is None
