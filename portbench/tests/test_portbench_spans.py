"""The program's spans as the harness reads them
(``portbench.harness.spans``, ``portbench/span_table.py``): each span
metric on hand-built records, device ops put down to the span that
launched them, and a CPU run of a tiny cell with the spans in the
program."""

import sys
import time

import pytest

from conftest import ROOT, tiny_cell
from libwave_tpu_torch.utils.trace import SpanRecord
from portbench.harness import runner
from portbench.harness import spans as sp


def _rec(name, start, end, parent):
    return SpanRecord(name, start, end, parent, 0, {})


# one solve of two LM iterations, 0-1000 ns: a cost, then per iteration a
# linearization and a PCG with one matvec
RECORDS = [
    _rec("ba.solve", 0, 1000, None),           # 0
    _rec("ba.cost", 10, 60, 0),                # 1
    _rec("ba.iteration", 100, 500, 0),         # 2
    _rec("ba.linearize", 110, 200, 2),         # 3
    _rec("schur.pcg", 210, 480, 2),            # 4
    _rec("schur.matvec", 250, 400, 4),         # 5
    _rec("ba.iteration", 500, 900, 0),         # 6
    _rec("ba.linearize", 510, 640, 6),         # 7
    _rec("schur.pcg", 650, 880, 6),            # 8
    _rec("schur.matvec", 700, 800, 8),         # 9
]
COUNTERS = {"ba.lm_iterations": 2, "schur.cg_trips": 2}


def _op(start, end, launch, kernel=True):
    return sp.DeviceOp("k", start, end, launch, kernel)


def _run(ops):
    return sp.SpanRun(untraced=RECORDS, untraced_counters=COUNTERS,
                      traced=RECORDS, traced_counters=COUNTERS,
                      windows=[(0, 1000)], device_ops=ops)


OPS = [
    _op(20, 40, 15),       # the initial cost
    _op(150, 190, 120),    # linearize, iteration 0
    _op(300, 350, 260),    # matvec, iteration 0
    _op(360, 380, 220),    # PCG itself, iteration 0
    _op(520, 600, 515),    # linearize, iteration 1
    _op(590, 620, 530),    # linearize again, overlapping the last
    _op(720, 760, 710),    # matvec, iteration 1
    _op(950, 960, 905),    # after the last iteration: the solve itself
    _op(970, 990, 1005),   # launched after the solve span: the harness's
]


def test_innermost_span_of_a_launch():
    spans = sp.Spans(RECORDS)
    assert spans.innermost(260) == 5
    assert spans.innermost(400) == 4  # the matvec has ended, PCG still open
    assert spans.innermost(490) == 2
    assert spans.innermost(950) == 0
    assert spans.innermost(1005) is None and spans.innermost(-5) is None
    assert spans.within(5, "schur.pcg") and not spans.within(5, "ba.linearize")


def test_device_ops_are_put_down_to_the_span_that_launched_them():
    run = _run(OPS + [_op(980, 985, None)])
    assert sp.owners(run) == [1, 3, 5, 4, 7, 7, 9, 0, None, -1]
    tab = sp.table(run)
    rows = tab["rows"]
    assert tab["unmatched"] == 1
    # by the launch, not by where the op ran: op 3 ran inside the matvec's
    # time but was launched by the PCG
    assert rows["schur.pcg"]["device_ms"] == pytest.approx(20e-6 / 2)
    assert rows["schur.matvec"]["device_ms"] == pytest.approx(90e-6 / 2)
    assert rows["ba.linearize"]["device_ms"] == pytest.approx(140e-6 / 2)
    assert rows["portbench.solve"]["kernels"] == 0.5
    assert rows["schur.matvec"]["count"] == 2
    # host self time: the matvecs' durations come off the PCG's
    assert rows["schur.pcg"]["host_self_ms"] == pytest.approx(
        (270 - 150 + 230 - 100) * 1e-6 / 2)
    # every idle gap is put down to the span open at its middle
    idle = sum(r["idle_ms"] for r in rows.values())
    busy = 20 + 40 + 50 + 20 + 100 + 40 + 10 + 20  # the ops' union, ns
    assert idle == pytest.approx((1000 - busy) * 1e-6 / 2)
    # the gap 0-20 has its middle in the cost, the gap 60-150 in the solve
    assert rows["ba.cost"]["idle_ms"] == pytest.approx(20e-6 / 2)
    assert rows["ba.solve"]["idle_ms"] > 0


def test_host_ms_per_iter():
    assert sp.host_ms_per_iter(_run(OPS)) == pytest.approx(800e-6 / 2)


def test_linearize_host_ms_per_iter():
    assert sp.host_ms_per_iter(_run(OPS), "ba.linearize") == pytest.approx(
        220e-6 / 2)


def test_linearize_device_ms_per_iter():
    # ops 1, 4, 5: 40 + the union of 520-600 and 590-620
    assert sp.device_ms_per_iter(_run(OPS), "ba.linearize") == \
        pytest.approx(140e-6 / 2)


def test_pcg_device_ms_per_iter():
    # the PCG's own op and its matvecs' ops
    assert sp.device_ms_per_iter(_run(OPS), "schur.pcg") == pytest.approx(
        (50 + 20 + 40) * 1e-6 / 2)


def test_span_metrics_read_nothing_without_spans():
    # the program at a commit with no spans: no records, no counters
    empty = sp.SpanRun(untraced=[], untraced_counters={}, traced=[],
                       traced_counters={}, windows=[(0, 1000)],
                       device_ops=OPS)
    assert sp.host_ms_per_iter(empty) is None
    assert sp.device_ms_per_iter(empty, "schur.pcg") is None
    assert sp.device_ms_per_iter(_run([]), "schur.pcg") is None


def test_span_table_and_traced_run_on_the_cpu(cpu):
    sys.path.insert(0, str(ROOT / "portbench"))
    import span_table

    cell = tiny_cell()
    out = span_table.measure(cell, 5, cpu, pairs=1)
    iters = cell.traffic["trace_solves"] * cell.traffic["lm_iterations"]
    for counters in out["counters"].values():
        assert counters["ba.lm_iterations"] == iters
        assert counters["schur.cg_trips"] == iters * cell.config["solver"][
            "cg_max_iters"]
    m = out["metrics"]
    assert 0 < m["linearize_host_ms_per_iter"] < m["host_ms_per_iter"]
    # no device ops on the CPU: the device metrics read nothing
    assert m["linearize_device_ms_per_iter"] is None
    assert m["pcg_device_ms_per_iter"] is None
    assert out["profile_metrics"]["pcg_live_share"] == 100.0

    # the benchmark's own traced run, with the spans in the program: its
    # metrics read as before (on the CPU only the device's, which read
    # nothing)
    res = runner.run_cell(cell, 5, 0.2, True, cpu, time.perf_counter())
    assert res.result["correct"], res.check_lines
    assert res.result["metrics"] == {}
    assert res.result["attempted"] == cell.traffic["trace_solves"]
