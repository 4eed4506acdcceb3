"""The yardstick's arithmetic on synthetic inputs: the busy union, the
trace reduction, the metric readers and the work counts."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, trace
from perfbench.work import hodgkin_huxley as wh


def test_union():
    merged, total = trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 10)])
    assert merged == [[0, 3], [5, 9], [10, 10]] and total == 7


def _event(name, t0, t1, cuda):
    dt = torch.autograd.DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=t0, end=t1), device_type=dt.CUDA if cuda else dt.CPU)


def test_short_names():
    assert trace.short("void hh_kernel<1>(double const*, double*, int, "
                       "int, HHTable)") == "hh_kernel"
    assert trace.short("std::enable_if<!(false), void>::type internal::"
                       "gemvx::kernel<int, double, cublasGemvParamsEx<int, "
                       "double> >(cublasGemvParamsEx<int, double>)") == \
        "internal::gemvx::kernel"
    assert trace.short("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"
    assert trace.short("void at::native::elementwise_kernel<128, 2, at::"
                       "native::gpu_kernel_impl<F>(at::TensorIteratorBase&, "
                       "F const&)::{lambda(int)#1}>(int, at::native::"
                       "gpu_kernel_impl<F>(at::TensorIteratorBase&, F "
                       "const&)::{lambda(int)#1})") == \
        "at::native::elementwise_kernel"


def test_trace_read():
    ev = [_event("k1", 100, 300, True), _event("k1", 250, 400, True),
          _event("copy", 2100, 2200, True), _event("cudaLaunch", 0, 5,
                                                    False)]
    prof = SimpleNamespace(events=lambda: ev)
    tr = trace.read(prof, window_s=0.003)
    assert tr["items"] == 3 and tr["busy_s"] == pytest.approx(400e-6)
    ops = dict(tr["breakdown"]["device_ops"])
    assert ops == {"k1": pytest.approx(350e-6), "copy": pytest.approx(1e-4)}
    assert tr["breakdown"]["idle_gaps"] == [["k1 -> copy",
                                             pytest.approx(1700e-6)]]


def test_device_readers():
    """Busy time and items of the traced requests, each over their
    number."""
    req = [{"t0": 0.0, "t1": 0.4, "ok": True, "traced": i < 2, "rec": {}}
           for i in range(5)]
    run = {"cell": {"kind": "estimate"}, "requests": req,
           "trace": {"busy_s": 0.1, "items": 30},
           "config": {"family": "hodgkin_huxley", "models": [[0, 0.01]]},
           "state": {"active": [((0,), 1000)]}}
    busy = harness.metric_reader("device_busy_ms.estimate")(run)
    assert busy == pytest.approx(50.0)
    assert harness.metric_reader("sample.device_ops_per_estimate")(run) \
        == 15
    least = 1000 * 1000 * 288 / 34e12
    assert harness.metric_reader("sample_roofline")(run) == \
        pytest.approx(100 * 2 * least / 0.1)
    for r in req:
        r["traced"] = False           # no traced request
    assert harness.metric_reader("device_busy_ms.estimate")(run) is None
    run["trace"] = None
    assert harness.metric_reader("sample_roofline")(run) is None


def test_host_clock_readers():
    req = [{"t0": 0.0, "t1": 0.1 * (i + 1), "ok": i != 3, "traced": False,
            "rec": {}} for i in range(21)]
    run = {"cell": {"kind": "estimate"}, "window_s": 2.0, "requests": req,
           "setup_s": 9.0, "trace": None}
    assert harness.metric_reader("estimate_s")(run) == 0.1
    assert harness.metric_reader("setup_s")(run) == 9.0
    assert harness.metric_reader("device_busy_ms.estimate")(run) is None
    run["cell"]["kind"] = "other"
    assert harness.metric_reader("estimate_s")(run) is None


def test_program_readers():
    """The program's numbers from ``run["program"]``, which a traced run
    alone carries; None without it or where the recording held none."""
    names = ("sample.host_syncs_per_estimate", "estimator.host_ms",
             "setup.alloc_s")
    run = {"program": {"summary": dict(zip(names, (89.4, 6.6, 1.7)))}}
    assert [harness.metric_reader(n)(run) for n in names] == [89.4, 6.6,
                                                              1.7]
    run["program"]["summary"] = dict.fromkeys(names)
    assert [harness.metric_reader(n)(run) for n in names] == [None] * 3
    run["program"] = None
    assert [harness.metric_reader(n)(run) for n in names] == [None] * 3


def test_least_seconds():
    hh = {"models": [[0, 0.01], [2, 0.08]]}
    t, bound = wh.least_seconds(hh, [((0, 1), 100)])
    assert bound == "operations"
    assert t == pytest.approx(100 * (1000 * 288 + 125 * 79) / 34e12)
    assert wh.k2_work([[1, 0.04]], 10) == (10 * 250 * 73,
                                           8 * (3 * 10 + 5 * 10))


def test_a_traced_run_reports_its_per_layer_metrics():
    """A traced run on the host (no device items: no busy time, so no
    roofline) names the cell's per-layer metrics, not its end-to-end
    ones, and keeps the busy time and breakdown."""
    res = harness.run_cell("hh12.estimate_k3", 2 ** 32 + 5, 0.0, True,
                           device="cpu", overrides=dict(budget=2e4))
    per_layer = {m["name"] for m in harness.metrics_of(
        harness.manifest(), "hh12.estimate_k3", True)}
    assert set(res["metrics"]) <= per_layer
    assert res["metrics"]["sample.device_ops_per_estimate"]["value"] == 0
    assert res["device"]["busy_s"] == 0 and "breakdown" in res
    # the program's recorder was on: its spans are read
    for name in ("sample.host_syncs_per_estimate", "estimator.host_ms",
                 "setup.alloc_s"):
        assert res["metrics"][name]["value"] > 0, name
