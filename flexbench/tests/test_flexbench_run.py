"""A run at CPU size: its last line, its checks, its traced window."""
import pytest

from flexbench import devtrace, run
from flexbench.tests.helpers import cpu_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["solar.randread.c128qd32",
                                  "solar.randread.c1qd32"])
def test_a_run_prints_the_five_keys_and_its_checks_last(cpu, capsys, cell):
    rc, res, err = cpu_run(capsys, cell)
    assert rc == 0
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"kiops", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # every number compared, beside its limit, last on standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [t.split()[1] for t in tail] == list(res["checks"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_traced_run_without_device_time_prints_no_result(cpu, capsys):
    rc, res, err = cpu_run(capsys, "solar.randread.c1qd32", trace=1)
    assert rc == 1 and res is None
    assert "no device time" in err


def test_breakdown_only_in_a_traced_line():
    plain = run.result_line(correct=True, attempted=1, failed=0, metrics={},
                            device={}, checks={})
    traced = run.result_line(correct=True, attempted=1, failed=0, metrics={},
                             device={}, checks={},
                             breakdown={"device_ops": [], "idle_gaps": []})
    assert list(plain) == KEYS + ["checks"]
    assert list(traced) == KEYS + ["breakdown", "checks"]


def test_the_trace_reduces_to_busy_time_and_named_idle_gaps():
    # device: [10, 20) and [15, 30) overlap, [50, 60); window [0, 100)
    ops = [("k", 10, 10), ("k", 15, 15), ("copy", 50, 10)]
    inner = devtrace.Level([("post_send", 30, 10)])
    outer = devtrace.Level([("flexbench.entry", 0, 60),
                            ("flexbench.wait", 60, 40)])
    s = devtrace.reduce(ops, 0, 100, [inner, outer])
    assert s.busy_s == pytest.approx(30e-9)
    assert s.op_s == pytest.approx(35e-9)
    assert s.window_s == pytest.approx(100e-9)
    assert s.device_ops == [["k", 25e-9], ["copy", 10e-9]]
    gaps = dict(s.idle_gaps)
    # idle: [0,10) entry, [30,40) post_send, [40,50) entry, [60,100) wait
    assert gaps == {"flexbench.entry": 20e-9, "post_send": 10e-9,
                    "flexbench.wait": 40e-9}


def test_the_sample_is_drawn_from_the_seed():
    a, b = run.Reservoir(4, 7), run.Reservoir(4, 7)
    for i in range(1000):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 4
    assert max(a.items) > 4
