"""``phase2_grouped_share``: the share of the window's phase-2 chunks that
ran in a lockstep group with another chunk, and nothing from a program
without the counter."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.test_portbench_fused_share import run_of


def read(run):
    return harness.load_reader("phase2_grouped_share.batch")(run)


def test_grouped_share_is_over_the_window_chunks():
    run = run_of({"query.full_chunks": 17, "query.compacted_chunks": 0,
                  "query.grouped_chunks": 17},
                 {"query.full_chunks": 177, "query.compacted_chunks": 40,
                  "query.grouped_chunks": 167})
    assert read(run) == pytest.approx(75.0)


@pytest.mark.parametrize("before,after", [
    ({"query.full_chunks": 17}, {"query.full_chunks": 34}),
    ({"query.full_chunks": 17, "query.grouped_chunks": 17},
     {"query.full_chunks": 17, "query.grouped_chunks": 17}),
    ({}, {"query.grouped_chunks": 0}),
])
def test_grouped_share_reads_nothing_without_counter_or_chunks(before,
                                                               after):
    assert read(run_of(before, after)) is None
