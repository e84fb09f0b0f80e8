"""The metric arithmetic against hand-worked records, intervals and
shapes."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.metrics import kernel_bytes


def run_of(records, *, t0=0.0, t_end=10.0, t_last=None, trace_=None,
           before=None, after=None):
    drv = types.SimpleNamespace(records=records, t0=t0, t_end=t_end,
                                t_last=t_end if t_last is None else t_last,
                                before=before or {}, after=after or {})
    return harness.Run(cell={}, config={}, mix={}, seconds=t_end - t0,
                       setup_s=1.5, driver=drv, trace=trace_)


def read(name, run):
    return harness.load_reader(name)(run)


def test_p95_is_over_every_request():
    # 100 requests of 1..100 ms: numpy's linear p95 is 95.05 ms; a failed
    # request counts with its time
    recs = [(("bool",), 0.0, (i + 1) / 1e3, True, i != 99)
            for i in range(100)]
    assert read("serve_p95_ms", run_of(recs)) == pytest.approx(95.05)


def test_serve_rate_counts_answers_inside_the_window():
    recs = [(("bool",), 0.1, 5.0, True, True),
            (("bool",), 0.2, 9.9, True, True),
            (("bool",), 9.5, 10.4, True, True),     # lands after the close
            (("bool",), 0.3, 3.0, None, False)]     # failed
    assert read("serve_qps", run_of(recs)) == pytest.approx(0.2)


def test_batch_rate_is_over_the_extended_window():
    recs = [(list(range(512)), 0.0, 4.0, [], True),
            (list(range(512)), 4.0, 8.0, [], True),
            (list(range(512)), 8.0, 12.5, [], True)]   # in flight at 10 s
    run = run_of(recs, t_last=12.5)
    assert read("batch_qps", run) == pytest.approx(3 * 512 / 12.5)


def test_build_time_is_window_over_builds():
    recs = [(0.0, 0.9, 10, True), (0.9, 1.8, 10, True), (1.8, 3.3, 10, True)]
    run = run_of(recs, t_end=3.0, t_last=3.3)
    assert read("build_s", run) == pytest.approx(1.1)


def test_counter_readers_take_window_deltas():
    run = run_of([((), 0, 1, [], True)] * 4,
                 before={"serve.served": 10, "serve.batches": 2,
                         "query.n_jobs": 100, "query.filter_false": 10,
                         "query.filter_true": 5, "query.exact_rounds": 7},
                 after={"serve.served": 70, "serve.batches": 5,
                        "query.n_jobs": 300, "query.filter_false": 100,
                        "query.filter_true": 35, "query.exact_rounds": 407,
                        "fixpoint_rounds": 10})
    assert read("serve_batch_size.serve", run) == pytest.approx(20.0)
    assert read("phase1_decided_share.batch", run) == pytest.approx(60.0)
    assert read("phase2_rounds.batch", run) == pytest.approx(100.0)
    assert read("build_rounds.build", run) == 10.0


def test_busy_time_is_the_union_of_device_intervals():
    ivals = [(0, 4), (2, 6), (5, 7), (10, 12), (11, 11.5), (20, 30)]
    assert trace.union_length(ivals, 0, 25) == pytest.approx(7 + 2 + 5)
    assert trace.gaps(ivals, 0, 25) == [(7, 10), (12, 20)]
    summary = trace.TraceSummary(window_s=25.0, busy_s=14.0, device_ops=[],
                                 idle_gaps=[], kernel_events={}, calls={})
    idle = read("device_idle.serve", run_of([], trace_=summary))
    assert idle == pytest.approx(44.0)
    # idle time goes to the innermost host op at each moment
    ops = [("outer", 0, 100), ("inner", 5, 9), ("deep", 6, 7),
           ("late", 30, 40)]
    assert trace.timeline(ops) == [
        (0, 5, "outer"), (5, 6, "inner"), (6, 7, "deep"), (7, 9, "inner"),
        (9, 30, "outer"), (30, 40, "late"), (40, 100, "outer")]
    idle = trace.idle_by_op([(4, 8), (35, 50), (90, 130)],
                            trace.timeline(ops))
    assert {k: round(v * 1e9, 6) for k, v in idle.items()} == {
        "outer": 1 + 10 + 10, "inner": 2, "deep": 1, "late": 5,
        trace.NO_OP: 30}


def test_logical_bytes_of_hand_worked_shapes():
    # B4's served dist call: A [32768, 1024] words with 8,230 set bits,
    # X and the output uint16 [32768, 128]
    x_b = out_b = 32768 * 128 * 2
    want = 4 * (8230 + 32768) + 2 * 8388608
    assert kernel_bytes.logical_bytes(8230, 32768, x_b, out_b) == want
    assert want == 16_941_208
    # B1: A [64, 2] words with bits set at known places, X int32 [64, 4]
    a = torch.zeros((64, 2), dtype=torch.int32)
    a[0, 0] = 0b1011
    a[5, 1] = -1                       # 32 bits
    a[63, 0] = 1 << 30
    assert kernel_bytes.operand_bits(a) == 3 + 32 + 1
    tr = trace.Tracer()
    tr.active = True
    x = torch.zeros((64, 4), dtype=torch.int32)
    out = torch.zeros((64, 4), dtype=torch.int32)
    tr.record_call("bitset_matmul", a, x, out)
    tr.record_call("bitset_matmul", a, x, out)
    calls = tr.calls["bitset_matmul"]
    assert kernel_bytes.call_bytes(calls) == \
        2 * (4 * (36 + 64) + 64 * 4 * 4 + 64 * 4 * 4)


def test_sparse_operand_counts_the_same_bits():
    """A block-compressed A counts its set bits, not its dense words: the
    same matrix reads the same bytes either way."""
    a = torch.zeros((16, 1), dtype=torch.int32)
    a[3, 0] = 0b111
    a[8:16, 0] = -1                    # one ONE block of 8 rows x 1 word
    comp = types.SimpleNamespace(pool=a[0:8].reshape(1, 8, 1), n_mixed=1,
                                 one_bj=torch.zeros(1, dtype=torch.int32),
                                 br=8, bw=1)
    assert kernel_bytes.operand_bits(comp) == kernel_bytes.operand_bits(a) \
        == 3 + 8 * 32


def test_roofline_share_from_a_trace():
    a = torch.zeros((32, 1), dtype=torch.int32)
    a[0, 0] = 1
    x = torch.zeros((32, 8), dtype=torch.int32)
    calls = trace.KernelCalls(calls=4, x_bytes=4 * x.numel() * 4,
                              out_bytes=4 * 32 * 8 * 4,
                              operands={1: [a, 4, 32]})
    bytes_per_call = 4 * (1 + 32) + 2 * 32 * 8 * 4
    bound = bytes_per_call / kernel_bytes.HBM_BYTES_PER_S
    summary = trace.TraceSummary(
        window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[],
        kernel_events={"void bitset_matmul_kernel<8>(...)": [3, 3e-6],
                       "other_kernel": [9, 1.0]},
        calls={"bitset_matmul": calls})
    share = read("bitset_matmul_roofline.serve", run_of([], trace_=summary))
    assert share == pytest.approx(100 * bound / 1e-6)
    assert read("lane_matmul_roofline.serve",
                run_of([], trace_=summary)) is None


def test_percentile_matches_numpy_estimator():
    lat = np.random.default_rng(0).exponential(100, 1000)
    recs = [(("bool",), 0.0, v / 1e3, True, True) for v in lat]
    assert read("serve_p95_ms", run_of(recs)) == pytest.approx(
        np.percentile(lat, 95))
