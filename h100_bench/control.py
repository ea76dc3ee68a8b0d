"""The control of a cell's comparison, on the chip at the cell's own size.

    python3 h100_bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 1]

For each seed, in one process: the cell's program over a short window at
its own load (one cycle of shapes), then the reference, then the control,
the reference computed in the precision below the configuration's
(``control_rounding``: e4m3 for bf16, int4 codes for int8), put in the
program's place and judged by the same numbers. One JSON line per seed:
the program's numbers and the control's; the limits are set between them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    run = harness.load_module(os.path.join(harness.BENCH, "run.py"), "h100_bench_run")
    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
        out, code, _ = run.run_cell(cell, args, "cuda", control=True)
        if out is None:
            return code
        print(json.dumps(dict(workload=a.workload, seed=seed, **out["numbers"],
                              info=out["info"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
