"""The per-unit host readings printed beside every window."""

import gc

from texbench.hoststats import UnitStats


def test_one_entry_a_unit_with_the_cpu_and_collections_it_took():
    with UnitStats() as stats:
        for _ in range(3):
            sum(i * i for i in range(200_000))
            gc.collect()
            stats.mark()
    got = stats.summary()
    for key in UnitStats.KEYS:
        assert len(got[key]["per_unit"]) == 3
        assert all(v >= 0 for v in got[key]["per_unit"])
    assert got["user_s"]["total"] > 0
    assert got["gc_s"]["total"] > 0
    assert gc.callbacks.count(stats._callback) == 0
