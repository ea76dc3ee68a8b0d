"""What every cell shares: finding a cell's files by name, the device line,
CUDA-event spans around the program's calls, the reduction of a profiler
trace, and the result line.

Nothing here imports the program. A cell is ``workloads/<name>.json``
(its configuration, traffic mix and driver); the configuration is
``configs/<config>.json``, the mix ``mixes/<traffic>.json``, the driver
``drivers/<driver>.py`` and each per-layer metric ``metrics/<metric>.py``.
Which metrics a cell reports is read from ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
from collections import defaultdict

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
BANNED = ("jax", "jaxlib", "flax", "optax", "textflux_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> dict:
    """The cell's workload file with its configuration, mix, driver and the
    metrics BENCHMARK.json gives it."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(BENCH, "workloads", f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"workloads/{name}.json disagrees with BENCHMARK.json")

    return assemble(name, cell, entry["chips"],
                    load_json(BENCH, "configs", f"{cell['config']}.json"),
                    load_json(BENCH, "mixes", f"{cell['traffic']}.json"),
                    bench["end_to_end"], bench["per_layer"])


def assemble(name, cell, chips, cfg, mix, end_to_end, per_layer) -> dict:
    """A cell from its parts: the metrics are those whose ``workloads``
    name it, or that name none."""
    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    cell = dict(cell, name=name, chips=chips, cfg=cfg, mix=mix,
                end_to_end=mine(end_to_end), per_layer=mine(per_layer))
    cell["driver_module"] = load_module(os.path.join(BENCH, "drivers", f"{cell['driver']}.py"),
                                        f"h100_bench_driver_{cell['driver']}")
    return cell


def read_per_layer(cell: dict, data: dict) -> dict:
    """{metric: {"value", "unit"}} from each metric's reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell["per_layer"]:
        reader = load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                             "h100_bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def banned_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load
    (compared whole: the program's package name begins with the JAX
    package's)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(BANNED))


def device_line(torch, chips: int) -> dict:
    """The card: name, count and nvidia-smi's power limit."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": (smi.stdout.strip().splitlines() or ["not read"])[0].split(", ")[-1]}


def as_device(line: dict) -> dict:
    """The result's ``device``: the card line without its power limit."""
    return {k: v for k, v in line.items() if k != "power_limit"}


def quantile(values, q: float) -> float:
    """The q-quantile of `values` (Python's inclusive method)."""
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return cuts[int(round(q * 100)) - 1]


class Spans:
    """CUDA-event spans around calls of the program's objects: ``wrap``
    replaces an instance's method by one that records an event pair around
    each call; ``ms()`` gives each span's device-timeline milliseconds."""

    def __init__(self, torch):
        self.torch = torch
        self.events = defaultdict(list)
        self.paused = False       # the calls still run under their annotation

    def wrap(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)
        torch = self.torch

        def timed(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                s.record()
                out = inner(*a, **kw)
                e.record()
            if not self.paused:
                self.events[name].append((s, e))
            return out

        setattr(obj, attr, timed)

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}


def reduce_trace(prof, wall_s: float, spans=(), top: int = 10) -> dict:
    """From one profiler window of `wall_s` seconds (CUDA activity only, so
    the trace slows the host as little as it can): the device's busy time
    (the union of its kernels, copies and sets; the spans' annotations left
    out), each kernel's calls and seconds, the device operations that took
    most time, and the idle gaps summed by the operation that ended each
    one (what the host was preparing while the device waited)."""
    dev = sorted((e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type().name == "CUDA" and e.name() not in spans)
    if not dev:
        return {}
    kernels = defaultdict(lambda: [0, 0.0])
    idle = defaultdict(float)
    busy, cur_s, cur_e = 0, dev[0][0], dev[0][1]
    for s, e, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) / 1e9
        if s > cur_e:
            busy += cur_e - cur_s
            idle["before " + name[:80]] += (s - cur_e) / 1e9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    ops = sorted(((n[:90], v[1]) for n, v in kernels.items()), key=lambda x: -x[1])
    return {"busy_s": busy / 1e9, "window_s": wall_s,
            "kernels": {n: tuple(v) for n, v in kernels.items()},
            "device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda x: -x[1])[:top]]}


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown=None) -> str:
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if breakdown:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(line)
