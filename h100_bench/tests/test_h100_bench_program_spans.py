"""The program's spans read against a profile (``program_spans``), the
three metrics that read them, and ``trace_program``'s run of the tiny cell
on the CPU."""

import os
from types import SimpleNamespace

import pytest

from h100_bench import harness, program_spans

from conftest import tiny_args, tiny_cell

MS = 1_000_000


def _event(kind, name, start, end, corr=0, annotation=False):
    return SimpleNamespace(device_type=lambda: SimpleNamespace(name=kind), name=lambda: name,
                           start_ns=lambda: start, end_ns=lambda: end,
                           correlation_id=lambda: corr, is_user_annotation=lambda: annotation)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _span(i, name, start, end, parent=None, request=1, **attrs):
    return dict(id=i, name=name, start_ns=start, end_ns=end, parent=parent, request=request,
                attrs=attrs)


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH, "metrics", f"{name}.py"),
                               "m_" + name.replace(".", "_"))


# one request: a step whose fused call launches norm_rope_kernel at 2 ms
# (its gap 1 ms) and whose gemm, launched under the block at 4 ms, runs at
# 9 ms (its gap 2 ms); a copy launched after every span ends the last gap
SPANS = [_span(1, "fill.call", 0, 20 * MS, steps=1, height=64, width=96),
         _span(2, "fill.denoise_step", 1 * MS, 12 * MS, parent=1, step=0),
         _span(3, "flux.double_block", 1 * MS, 11 * MS, parent=2),
         _span(4, "attn.fused", 1 * MS, 3 * MS, parent=3)]


def _events(shift=0):
    return [_event("CPU", "cudaLaunchKernel", 2 * MS + shift, 2 * MS + shift + 10, corr=11),
            _event("CPU", "cudaLaunchKernel", 4 * MS + shift, 4 * MS + shift + 10, corr=12),
            _event("CPU", "cudaMemcpyAsync", 25 * MS + shift, 25 * MS + shift + 10, corr=13),
            _event("CUDA", "gemm0", 0, 5 * MS, corr=10),
            _event("CUDA", "norm_rope_kernel", 6 * MS, 7 * MS, corr=11),
            _event("CUDA", "gemm", 9 * MS, 10 * MS, corr=12),
            _event("CUDA", "Memcpy DtoH", 26 * MS, 27 * MS, corr=13),
            _event("CUDA", "denoise_step", 0, 12 * MS, annotation=True)]


def test_gaps_go_to_the_innermost_span_at_the_launch():
    out = program_spans.key_by_span(_prof(_events()), SPANS, skip={"denoise_step"})
    # gemm0 has no launch in the trace and ends in no gap
    assert out["idle_gaps"] == [["before Memcpy DtoH", 0.016], ["flux.double_block", 0.002],
                                ["attn.fused", 0.001]]
    assert out["clock"] == {"offset_ns": 0, "launches": 1, "inside_share": 1.0,
                            "largest_outside_ns": 0}
    assert out["idle_s"] == pytest.approx(0.019)
    assert out["idle_named_share"] == pytest.approx(0.003 / 0.019)
    ops = out["ops_by_span"]
    assert ops["fill.denoise_step"] == [2, 0.002] and ops["attn.fused"] == [1, 0.001]
    assert ops["fill.call"] == [3, pytest.approx(0.007)] and "denoise_step" not in ops
    assert out["step_ops"] == [2]


def test_without_correlated_launches_the_gap_end_decides():
    events = [e for e in _events() if e.device_type().name == "CUDA"]
    out = program_spans.key_by_span(_prof(events), SPANS, skip={"denoise_step"})
    # norm_rope_kernel starts at 6 ms (under the block), gemm at 9 ms, the copy at 26 ms
    assert out["idle_gaps"] == [["before Memcpy DtoH", 0.016], ["flux.double_block", 0.003]]
    assert out["clock"] == {}


def test_a_constant_clock_offset_is_found_and_taken_off():
    # the launches' clock runs 5 ms ahead: at zero offset the fused launch
    # falls outside attn.fused; the smallest offset that puts it back inside
    # is -4 ms, and the gaps are keyed as with no offset
    out = program_spans.key_by_span(_prof(_events(shift=5 * MS)), SPANS)
    assert out["clock"] == {"offset_ns": -4 * MS, "launches": 1, "inside_share": 1.0,
                            "largest_outside_ns": 0}
    assert out["idle_gaps"][1:] == [["flux.double_block", 0.002], ["attn.fused", 0.001]]


def test_annotations_are_not_device_work():
    dev, launches = program_spans.device_and_launches(_prof(_events()))
    assert [d[2] for d in dev] == ["gemm0", "norm_rope_kernel", "gemm", "Memcpy DtoH"]
    assert launches == {11: 2 * MS, 12: 4 * MS, 13: 25 * MS}


def test_innermost_climbs_past_closed_siblings():
    inner = program_spans.Innermost([_span(1, "root", 0, 100), _span(2, "a", 10, 20, parent=1),
                                     _span(3, "b", 30, 40, parent=1),
                                     _span(4, "c", 32, 35, parent=3)])
    assert [inner.at(t)["name"] if inner.at(t) else None
            for t in (5, 15, 25, 33, 38, 50, 150)] == ["root", "a", "root", "c", "b", "root", None]


def _data(busy=1.0):
    """A window of three requests of one shape, the second profiled."""
    spans = []
    for r, (t0, step_ms) in enumerate(((0, 50), (10_000, 150), (20_000, 70))):
        rid = 100 * (r + 1)
        base = t0 * MS
        spans.append(_span(rid, "edit.request", base, base + 2100 * MS, request=rid))
        spans.append(_span(rid + 1, "fill.call", base, base + 2000 * MS, parent=rid, request=rid,
                           steps=2, height=512, width=384))
        for k in range(2):
            s = base + (100 + k * 200) * MS
            spans.append(_span(rid + 2 + k, "fill.denoise_step", s, s + step_ms * MS,
                               parent=rid + 1, request=rid, step=k))
    trace = {"busy_s": busy, "ops_by_span": {"fill.denoise_step": [6444, 0.09]}}
    return {"spans": {}, "trace": trace, "cfg": {},
            "program": {"spans": spans, "requests": [100, 200, 300], "profiled": 1}}


def test_the_three_readers():
    data = _data()
    assert _reader("host_step_ms.serve").read(data) == 60.0     # requests 1 and 3
    assert _reader("launches_per_step.serve").read(data) == 3222.0
    assert _reader("device_idle_share.serve").read(data) == 50.0


@pytest.mark.parametrize("name", ["host_step_ms.serve", "launches_per_step.serve",
                                  "device_idle_share.serve"])
def test_each_reader_reads_nothing_without_the_programs_spans(name):
    read = _reader(name).read
    assert read({"spans": {}, "trace": {}, "cfg": {}}) is None
    assert read(dict(_data(), program={"spans": [], "requests": [], "profiled": None})) is None


def test_steps_that_disagree_with_the_call_read_nothing():
    data = _data()
    data["program"]["spans"] = [s for s in data["program"]["spans"]
                                if not (s["request"] == 200 and s["name"] == "fill.denoise_step"
                                        and s["attrs"]["step"] == 1)]
    assert _reader("launches_per_step.serve").read(data) is None
    # no other request of the profiled one's shape: no wall time to divide by
    data = _data()
    for s in data["program"]["spans"]:
        if s["name"] == "fill.call" and s["request"] != 200:
            s["attrs"]["height"] = 640
    assert _reader("device_idle_share.serve").read(data) is None


def test_trace_program_on_the_tiny_cell():
    """The traced run on the CPU: no profile there, so only the host's step
    time reads; every request is one edit.request with its steps."""
    mod = harness.load_module(os.path.join(harness.BENCH, "trace_program.py"),
                              "h100_bench_trace_program")
    cell = tiny_cell()
    args = tiny_args()
    args.trace = 1
    out = mod.traced_run(cell, args, "cpu")
    line = mod.summary(cell, out)
    assert line["correct"] and not line["banned"] and line["dropped"] == 0
    names = line["span_names"]
    n = len(out["data"]["program"]["requests"])
    assert n == out["attempted"] and names["edit.request"] == names["fill.call"] == n
    assert names["fill.denoise_step"] == n * cell["mix"]["steps"]
    m = line["metrics"]
    assert m["host_step_ms.serve"] > 0
    assert m["launches_per_step.serve"] is None and m["device_idle_share.serve"] is None
    cost = mod.span_cost_ns(number=2000, repeat=3)
    assert cost["on_ns"] > cost["off_ns"]
