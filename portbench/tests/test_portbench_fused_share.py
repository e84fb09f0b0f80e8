"""``phase2_fused_share``: the share of the window's phase-2 rounds that
the program ran as one ``class_round`` launch each, and nothing from a
program without the counter."""
from __future__ import annotations

import types

import pytest

from portbench import harness


def run_of(before, after):
    drv = types.SimpleNamespace(records=[((), 0, 1, [], True)], t0=0.0,
                                t_end=10.0, t_last=10.0, before=before,
                                after=after)
    return harness.Run(cell={}, config={}, mix={}, seconds=10.0,
                       setup_s=1.5, driver=drv, trace=None)


def read(run):
    return harness.load_reader("phase2_fused_share.batch")(run)


def test_fused_share_is_over_the_window_rounds():
    run = run_of({"query.exact_rounds": 7, "query.fused_rounds": 7},
                 {"query.exact_rounds": 407, "query.fused_rounds": 307})
    assert read(run) == pytest.approx(75.0)


@pytest.mark.parametrize("before,after", [
    ({"query.exact_rounds": 7}, {"query.exact_rounds": 407}),
    ({"query.exact_rounds": 7, "query.fused_rounds": 0},
     {"query.exact_rounds": 7, "query.fused_rounds": 0}),
])
def test_fused_share_reads_nothing_without_counter_or_rounds(before, after):
    assert read(run_of(before, after)) is None
