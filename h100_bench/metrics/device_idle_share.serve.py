"""device_idle_share.serve: 1 - the profiled request's device busy time
(the union of its kernels, copies and sets) over the mean host duration of
``fill.call`` of the window's unprofiled requests of the same height and
width, in %: an image's device work as the trace reads it, over its wall
time with no profiler running."""

from h100_bench.program_spans import window_spans


def read(data):
    spans, profiled = window_spans(data)
    busy = (data.get("trace") or {}).get("busy_s")
    if profiled is None or not busy:
        return None
    calls = [s for s in spans if s["name"] == "fill.call"]
    mine = [s for s in calls if s["request"] == profiled]
    if len(mine) != 1:
        return None
    shape = lambda s: (s["attrs"].get("height"), s["attrs"].get("width"))
    wall = [(s["end_ns"] - s["start_ns"]) / 1e9 for s in calls
            if s["request"] != profiled and shape(s) == shape(mine[0])]
    if not wall:
        return None
    return 100.0 * (1.0 - busy / (sum(wall) / len(wall)))
