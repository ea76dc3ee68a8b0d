"""The reduction of a profiler window: busy time is the union of the device
intervals, annotations are not device work, idle gaps go to the operation
that ended them."""

from types import SimpleNamespace

from h100_bench import harness


def _event(kind, name, start, end):
    return SimpleNamespace(device_type=lambda: SimpleNamespace(name=kind), name=lambda: name,
                           start_ns=lambda: start, end_ns=lambda: end)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_is_the_union_and_gaps_go_to_the_next_operation():
    ms = 1_000_000
    events = [_event("CUDA", "gemm", 0, 4 * ms), _event("CUDA", "copy", 2 * ms, 5 * ms),
              _event("CUDA", "gemm", 8 * ms, 9 * ms), _event("CUDA", "norm", 10 * ms, 11 * ms),
              _event("CUDA", "denoise_step", 0, 11 * ms), _event("CPU", "aten::mm", 0, 20 * ms)]
    out = harness.reduce_trace(_prof(events), 0.02, spans={"denoise_step"})
    assert abs(out["busy_s"] - 0.007) < 1e-12 and out["window_s"] == 0.02
    assert out["kernels"]["gemm"] == (2, 0.005)
    assert out["idle_gaps"] == [["before gemm", 0.003], ["before norm", 0.001]]
    assert out["device_ops"][0] == ["gemm", 0.005]


def test_nothing_on_the_device_reads_nothing():
    assert harness.reduce_trace(_prof([_event("CPU", "aten::mm", 0, 5)]), 1.0) == {}
