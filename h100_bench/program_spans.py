"""The program's own spans read against a profiler trace.

``textflux_torch.utils.tracking`` stamps each span with ``time.time_ns()``
on the host; the profiler stamps each CUDA runtime or driver call (the
launch) and each device operation, and ties the two by a correlation id.
Here, for one profiled request: the offset between the two clocks, taken
from the request's ``attn.fused`` spans (each launches the fused
attention's two kernels, and nothing else launches them); the device's
idle gaps keyed by the innermost span that was open on the host when the
operation ending each gap was launched; and the device operations
launched under each span. A span is a dict with the fields of
``tracking.SpanRecord``. Nothing here imports the program.
"""

from __future__ import annotations

import statistics
from bisect import bisect_right
from collections import defaultdict

FUSED_SPAN = "attn.fused"
FUSED_KERNEL = "norm_rope_kernel"     # the first of the fused call's two launches
STEP_SPAN = "fill.denoise_step"


def device_and_launches(prof, skip=()) -> tuple:
    """(the device operations as (start, end, name, correlation id) in start
    order, the launch time of each correlation id) of a profile: CUDA
    activity other than annotations, and the host's runtime or driver
    calls."""
    dev, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type().name == "CUDA":
            if name not in skip and not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    dev.sort()
    return dev, launches


class Innermost:
    """The innermost span open at a given time, for properly nested spans
    (one host thread)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
        self.starts = [s["start_ns"] for s in self.spans]
        self.by_id = {s["id"]: s for s in self.spans}

    def at(self, t: int):
        # the last span to start by t holds it, or one of its ancestors does
        i = bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s["end_ns"] < t:
            s = self.by_id.get(s["parent"])
        return s

    def chain(self, s):
        """`s` and its ancestors."""
        while s is not None:
            yield s
            s = self.by_id.get(s["parent"])


def clock_offset(dev, launches, spans) -> dict:
    """The offset (ns) that puts a launch time on the spans' clock: the
    i-th ``attn.fused`` span launched the i-th ``norm_rope_kernel``, so each
    pair bounds it; the smallest offset that all pairs allow (their median
    need where none does). With it: the share of those launches inside
    their span, and the largest distance of one outside. Empty when the
    counts differ."""
    calls = sorted((s for s in spans if s["name"] == FUSED_SPAN), key=lambda s: s["start_ns"])
    first = sorted(launches[c] for _, _, name, c in dev if FUSED_KERNEL in name and c in launches)
    if not calls or len(calls) != len(first):
        return {}
    pairs = list(zip(calls, first))
    lo = max(s["start_ns"] - t for s, t in pairs)
    hi = min(s["end_ns"] - t for s, t in pairs)
    offset = (min(max(0, lo), hi) if lo <= hi else int(statistics.median(
        min(max(0, s["start_ns"] - t), s["end_ns"] - t) for s, t in pairs)))
    outside = [max(s["start_ns"] - t - offset, t + offset - s["end_ns"], 0) for s, t in pairs]
    return {"offset_ns": offset, "launches": len(pairs),
            "inside_share": sum(d == 0 for d in outside) / len(pairs),
            "largest_outside_ns": max(outside)}


def key_by_span(prof, host_spans, skip=(), top: int = 10) -> dict:
    """From the profile of the request whose spans are `host_spans`:

    - ``idle_gaps``: the gaps of the union of device intervals (as
      ``harness.reduce_trace`` takes them), each keyed by the innermost
      span open when the operation that ended it was launched (where the
      trace has no launch for it, when the gap ended; where no span was
      open, ``before <operation>`` as ``reduce_trace`` keys it), top `top`;
    - ``ops_by_span``: {span name: [operations, device seconds]} launched
      under each span, children included;
    - ``idle_s``: the idle time between the first operation and the last,
      and ``idle_named_share``, the share of it that a span names;
    - ``step_ops``: the operations under each ``fill.denoise_step``, in order;
    - ``clock``: ``clock_offset``, whose offset the rest applies.

    ``harness.reduce_trace`` gives the rest of the profile's reduction."""
    dev, launches = device_and_launches(prof, skip)
    if not dev:
        return {}
    spans = list(host_spans)
    clock = clock_offset(dev, launches, spans)
    offset = clock.get("offset_ns", 0)
    inner = Innermost(spans)

    idle = defaultdict(float)
    by_span = defaultdict(lambda: [0, 0.0])
    per_step = defaultdict(int)
    named = total = 0.0
    cur_e = dev[0][1]
    for s, e, name, corr in dev:
        t = launches.get(corr)
        owner = inner.at(s if t is None else t + offset)
        held = list(inner.chain(owner))
        for n in {x["name"] for x in held}:
            by_span[n][0] += 1
            by_span[n][1] += (e - s) / 1e9
        for x in held:
            if x["name"] == STEP_SPAN:
                per_step[x["id"]] += 1
        if s > cur_e:
            gap = (s - cur_e) / 1e9
            total += gap
            if owner is None:
                idle["before " + name[:80]] += gap
            else:
                idle[owner["name"]] += gap
                named += gap
            cur_e = e
        else:
            cur_e = max(cur_e, e)
    steps = sorted((x for x in spans if x["name"] == STEP_SPAN), key=lambda x: x["start_ns"])
    return {"idle_gaps": [[n, g] for n, g in sorted(idle.items(), key=lambda x: -x[1])[:top]],
            "ops_by_span": dict(sorted((n, list(v)) for n, v in by_span.items())),
            "idle_s": total, "idle_named_share": named / total if total else None,
            "step_ops": [per_step[x["id"]] for x in steps],
            "clock": clock}


def window_spans(data) -> tuple:
    """(the window's spans, the profiled request's id or None) of a run's
    ``data["program"]``: ``spans``, ``requests`` (the request id of each
    window index, in send order) and ``profiled`` (the profiled index or
    None). ((), None) when the program recorded nothing."""
    prog = data.get("program") or {}
    spans, requests, profiled = prog.get("spans"), prog.get("requests") or [], prog.get("profiled")
    if not spans:
        return (), None
    return spans, (requests[profiled] if profiled is not None and profiled < len(requests)
                   else None)
