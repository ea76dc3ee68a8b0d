"""host_step_ms.serve: the mean host duration of the program's
``fill.denoise_step`` span over the window's requests other than the
profiled one, in ms. Nothing syncs inside a step, so this is the time the
host takes to enqueue one; when the launch queue is full it is the
device's pace instead."""

from h100_bench.program_spans import STEP_SPAN, window_spans


def read(data):
    spans, profiled = window_spans(data)
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans
          if s["name"] == STEP_SPAN and s["request"] != profiled]
    return sum(ms) / len(ms) if ms else None
