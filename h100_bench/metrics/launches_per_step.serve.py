"""launches_per_step.serve: the device operations (kernels, copies, sets)
that the profiled request launched inside its ``fill.denoise_step`` spans,
over its steps. Counted on the device, so CUDA-graph replays count too.
Nothing is read unless the request has as many step spans as its
``fill.call`` says it takes steps."""

from h100_bench.program_spans import STEP_SPAN, window_spans


def read(data):
    spans, profiled = window_spans(data)
    ops = ((data.get("trace") or {}).get("ops_by_span") or {}).get(STEP_SPAN)
    if profiled is None or not ops:
        return None
    mine = [s for s in spans if s["request"] == profiled]
    steps = sum(s["name"] == STEP_SPAN for s in mine)
    calls = [s for s in mine if s["name"] == "fill.call"]
    if len(calls) != 1 or not steps or calls[0]["attrs"].get("steps") != steps:
        return None
    return ops[0] / steps
