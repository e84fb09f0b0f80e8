"""``phase2_operand_mb``: the class operand bytes a phase-2 round was
given over the window, in MB a round, and nothing from a program without
the counter."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.test_portbench_fused_share import run_of


def read(run):
    return harness.load_reader("phase2_operand_mb.batch")(run)


def test_operand_mb_is_over_the_window_rounds():
    run = run_of({"query.exact_rounds": 7, "query.operand_bytes": 9_000_000},
                 {"query.exact_rounds": 407,
                  "query.operand_bytes": 529_000_000})
    assert read(run) == pytest.approx(1.3)


@pytest.mark.parametrize("before,after", [
    ({"query.exact_rounds": 7}, {"query.exact_rounds": 407}),
    ({"query.exact_rounds": 7, "query.operand_bytes": 0},
     {"query.exact_rounds": 7, "query.operand_bytes": 0}),
])
def test_operand_mb_reads_nothing_without_counter_or_rounds(before, after):
    assert read(run_of(before, after)) is None
