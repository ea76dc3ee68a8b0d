"""The benchmark of textflux_torch on the H100: one run of one cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's system from the seed, warms up, measures for --seconds,
judges what the window produced against the plain reference, and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), ``device`` and,
traced, ``breakdown``; each number compared, beside its limit, comes last
there and in the last lines on standard error. Exits 2 without a result
when the card is missing, and 3 when a module of the JAX package or JAX
itself was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def set_environment() -> None:
    """Before torch loads: every build and kernel cache at a fixed path
    inside the checkout, and no JAX behind a library's back."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(ROOT, "build", "h100_bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell: dict, args, device: str, *, control: bool = False) -> tuple:
    """(result line or None, exit code, the checks) of one run of `cell` on
    `device`: "cuda" in the benchmark, "cpu" in the tests."""
    import torch

    from h100_bench import harness

    cuda = device == "cuda"
    closed = {}
    ctx = dict(device=device, t_start=T_START, control=control,
               sync=torch.cuda.synchronize if cuda else (lambda: None),
               reset_peak=torch.cuda.reset_peak_memory_stats if cuda else (lambda: None),
               peak=torch.cuda.max_memory_allocated if cuda else (lambda: 0),
               closed=lambda: closed.update(banned=harness.banned_modules()))
    out = cell["driver_module"].run(cell, args, ctx)
    banned = sorted(set(closed.get("banned", [])) | set(harness.banned_modules()))
    if banned:
        print(f"modules of JAX or the JAX package were loaded: {banned}", file=sys.stderr)
        return None, 3, []
    if control:
        return out, 0, []
    limits = cell["limits"]
    checks = [dict(name=k, value=out["numbers"][k], limit=limits[k]) for k in limits]
    checks.append(dict(name="failed_requests", value=out["failed"], limit=0))
    correct = all(c["value"] <= c["limit"] for c in checks)
    line = harness.device_line(torch, cell["chips"]) if cuda else dict(
        platform="cpu", kind="cpu", count=0, power_limit="none")
    device_out = dict(harness.as_device(line), memory_peak_bytes=out["memory_peak_bytes"])
    breakdown = None
    if args.trace:
        metrics = harness.read_per_layer(cell, out["data"])
        trace = out["data"].get("trace") or {}
        device_out.update(busy_s=trace.get("busy_s", 0.0), window_s=trace.get("window_s", 0.0))
        if trace:
            breakdown = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["end_to_end"].items() if k in units}
    print("run " + json.dumps(dict(out["info"], power_limit=line["power_limit"])),
          file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    return harness.result_line(correct=correct, attempted=out["attempted"], failed=out["failed"],
                               metrics=metrics, device=device_out, checks=checks,
                               breakdown=breakdown), 0, checks


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    import torch

    from h100_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import textflux_torch
    if not os.path.abspath(textflux_torch.__file__).startswith(ROOT + os.sep):
        print(f"textflux_torch comes from {textflux_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, code, _ = run_cell(cell, args, "cuda")
    if line is not None:
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
