"""One traced run of a cell with the program's own spans recorded: what a
``--trace 1`` run reads once the harness takes the program's spans.

    python3 h100_bench/trace_program.py --workload <cell> --seed <n> --seconds <s> \\
        [--out <file.json>]

Runs the cell's driver as ``run.py --trace 1`` does, with
``textflux_torch.utils.tracking`` recording from the window's start to its
end (and through the set-up, for the ``cuda.build`` span alone). The
profiled request's spans key its idle gaps and count its device operations
by span (``program_spans.key_by_span``); the metrics under ``metrics/``
that read the program's spans (``host_step_ms.serve``,
``launches_per_step.serve``, ``device_idle_share.serve``) are read beside
the cell's own. Prints one JSON line: those metrics, the cell's per-layer
metrics, the keyed idle gaps, the clock check, ``cuda.build``, the spans
an image makes, the host's cost of a span off and on, and ``correct``;
``--out`` also keeps the operations by span and the records' summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import timeit
from collections import Counter

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

from h100_bench import harness, program_spans  # noqa: E402

RUN = harness.load_module(os.path.join(BENCH, "run.py"), "h100_bench_run")
PROGRAM_METRICS = ("host_step_ms.serve", "launches_per_step.serve", "device_idle_share.serve")


def span_cost_ns(number: int = 200_000, repeat: int = 9) -> dict:
    """The host's cost of one span, off and on (recording, no profiler),
    over a bare loop, in ns: the best of `repeat` timings."""
    from textflux_torch.utils import tracking

    def best(stmt):
        t = timeit.repeat(stmt, globals={"span": tracking.span}, number=number, repeat=repeat)
        return min(t) / number * 1e9

    bare = best("pass")
    was = tracking.enable(False)
    off = best("with span('attn.fused'): pass")
    tracking.enable(True, capacity=number)
    on = best("with span('attn.fused'): pass")
    tracking.enable(was, capacity=tracking.CAPACITY)
    return {"off_ns": off - bare, "on_ns": on - bare}


def traced_run(cell: dict, args, device: str) -> dict:
    """The driver's run of `cell` with `args.trace` on and the program's
    spans recorded through the window; returns the driver's output with
    ``data["program"]`` and the traced request's keyed reduction."""
    import torch

    from textflux_torch.utils import tracking

    cuda = device == "cuda"
    held = {}
    base_reduce = harness.reduce_trace

    def window_starts():
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        held["setup"] = tracking.drain()     # the warm-up's: only cuda.build is kept

    def window_ends():
        tracking.enable(False)
        held["spans"] = [r._asdict() for r in tracking.drain()]
        held["dropped"] = tracking.dropped()
        held["banned"] = harness.banned_modules()

    def requests():
        roots = sorted((s for s in held["spans"] if s["name"] == "edit.request"),
                       key=lambda s: s["start_ns"])
        return [s["id"] for s in roots]

    def reduce(prof, wall_s, spans=(), top=10):
        out = base_reduce(prof, wall_s, spans=spans, top=top)
        rid = requests()[cell["driver_module"].TRACE_REQUEST]
        if out:
            out.update(program_spans.key_by_span(
                prof, [s for s in held["spans"] if s["request"] == rid], skip=spans, top=top))
        return out

    ctx = dict(device=device, t_start=RUN.T_START, control=False,
               sync=torch.cuda.synchronize if cuda else (lambda: None),
               reset_peak=window_starts,
               peak=torch.cuda.max_memory_allocated if cuda else (lambda: 0),
               closed=window_ends)
    tracking.enable(True, capacity=tracking.CAPACITY)
    harness.reduce_trace = reduce
    try:
        out = cell["driver_module"].run(cell, args, ctx)
    finally:
        harness.reduce_trace = base_reduce
        tracking.enable(False)
    out["data"]["program"] = dict(spans=held["spans"], requests=requests(),
                                  profiled=cell["driver_module"].TRACE_REQUEST)
    out["program_info"] = dict(dropped=held["dropped"], banned=held["banned"],
                               builds=[r.attrs for r in held["setup"] if r.name == "cuda.build"])
    return out


def summary(cell: dict, out: dict) -> dict:
    """The result line: the program's metrics beside the cell's, the keyed
    reduction of the traced request and what the spans cost."""
    data = out["data"]
    metrics = harness.read_per_layer(cell, data)
    for name in PROGRAM_METRICS:
        reader = harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                                     "h100_bench_metric_" + name.replace(".", "_"))
        metrics[name] = reader.read(data)
    trace = data.get("trace") or {}
    spans = data["program"]["spans"]
    step_ops = trace.get("step_ops") or []
    limits = cell["limits"]
    return dict(
        correct=all(out["numbers"][k] <= v for k, v in limits.items()) and not out["failed"],
        metrics=metrics, end_to_end=out["end_to_end"], images=data["images"],
        busy_s=trace.get("busy_s"), window_s=trace.get("window_s"),
        idle_s=trace.get("idle_s"), idle_gaps=trace.get("idle_gaps"),
        idle_named_share=trace.get("idle_named_share"),
        clock=trace.get("clock"), step_ops=[min(step_ops), max(step_ops)] if step_ops else None,
        spans_per_image=len(spans) / max(1, len(data["program"]["requests"])),
        span_names=dict(Counter(s["name"] for s in spans)), **out["program_info"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="a JSON file for the whole reduction")
    args = p.parse_args(argv)
    args.trace = 1
    RUN.set_environment()
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = traced_run(cell, args, "cuda")
    line = dict(summary(cell, out), span_cost=span_cost_ns(),
                device=harness.device_line(torch, cell["chips"]))
    if args.out:
        trace = out["data"].get("trace") or {}
        with open(args.out, "w") as f:
            json.dump(dict(line, ops_by_span=trace.get("ops_by_span"),
                           step_ops=trace.get("step_ops"), device_ops=trace.get("device_ops"),
                           info=out["info"]), f, indent=1)
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] and not line["banned"] else 1


if __name__ == "__main__":
    sys.exit(main())
