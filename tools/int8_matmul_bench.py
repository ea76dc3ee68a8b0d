"""The int8 weight-only kernel's time on one NVIDIA GPU beside its bound, its
plain version and cuBLAS's bf16 GEMM, at the serving path's shapes.

    python3 tools/int8_matmul_bench.py [--out build/int8_matmul_bench.jsonl] [--sweep]

Shapes (M tokens, K in, N out): the DiT step's main linears (single-block
linear1 and linear2, the double blocks' qkv and MLP) at the joint sequence
of the 4:3 edit canvas (1,408) and at 30 and 512 rows, T5-XXL's four
products at 512 rows, and the double blocks' modulation at 1 and 30 rows.
Per shape one JSON line:

  bound_ms    max(2*M*N*K / 989 TFLOP/s, bytes / 3.35 TB/s), bytes = the
              codes, the scale, x and y once;
  kernel_ms   ``int8_matmul.launch`` with the tile ``token_tile`` picks;
  tiles_ms    with --sweep, the kernel at each token tile;
  plain_ms    the plain version (cast, scale, F.linear, bias add);
  library_ms  F.linear(x, w, b) with w already bf16: cuBLAS's bf16 GEMM with
              its bias epilogue, the yardstick (the port does not call it).

Each time is CUDA events over 20 calls after 3 warm-ups, enqueued behind a
sleep on the card so that the host's launch path is not in it, with the
weights cycled through enough copies to exceed the 50 MB L2 (a serving step
reads each weight once). The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from textflux_torch.ops import int8_matmul as IM  # noqa: E402

L2_BYTES = 50 << 20
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM dense bf16, HBM3 (700 W)
STEP = ((3072, 21504, "linear1"), (15360, 3072, "linear2"), (3072, 9216, "qkv"),
        (3072, 12288, "mlp_in"), (12288, 3072, "mlp_out"))
SHAPES = ([(m, k, n, name) for m in (1408, 512, 30) for k, n, name in STEP]
          + [(512, 4096, 4096, "t5_qkvo"), (512, 4096, 10240, "t5_wi"),
             (512, 10240, 4096, "t5_wo"), (1, 3072, 18432, "mod"), (30, 3072, 18432, "mod")])


def flops(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def bound_ms(m: int, n: int, k: int) -> float:
    """max(FLOPs / peak, bytes / HBM bandwidth) in ms, the bytes being the
    codes and the scale once, x read and y written once in bf16."""
    nbytes = n * k + 4 * n + 2 * m * k + 2 * m * n
    return 1e3 * max(flops(m, n, k) / PEAK_FLOPS, nbytes / PEAK_BYTES)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)      # the card waits while the host enqueues
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cycled(make, nbytes: int):
    """Copies made by `make` enough to exceed L2, and a callable that hands
    them out in turn."""
    copies = [make() for _ in range(max(1, -(-2 * L2_BYTES // max(1, nbytes))))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]

    return nxt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "int8_matmul_bench.jsonl"))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh, torch.inference_mode():
        for m, k, n, name in SHAPES:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            scale = torch.rand(n, generator=g, device=dev) * 1e-3 + 4e-4
            bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
            codes = cycled(lambda: torch.randint(-127, 128, (n, k), generator=g, device=dev,
                                                 dtype=torch.int8), n * k)
            row = {"name": name, "m": m, "k": k, "n": n, "bound_ms": bound_ms(m, n, k),
                   "tile": IM.token_tile(m, n, torch.cuda.get_device_properties(0)
                                         .multi_processor_count)}
            row["kernel_ms"] = device_ms(lambda: IM.launch(x, codes(), scale, bias))
            if args.sweep:
                row["tiles_ms"] = {t: device_ms(lambda: IM.launch(x, codes(), scale, bias, tile=t))
                                   for t in IM.TOKEN_TILES}
            row["plain_ms"] = device_ms(lambda: IM.int8_matmul_reference(x, codes(), scale, bias))
            del codes
            weights = cycled(lambda: torch.randn(n, k, generator=g, device=dev)
                             .to(torch.bfloat16), 2 * n * k)
            row["library_ms"] = device_ms(lambda: F.linear(x, weights(), bias))
            del weights
            row["kernel_tflops"] = flops(m, n, k) / row["kernel_ms"] / 1e9
            row["kernel_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            row["kernel_of_library"] = row["library_ms"] / row["kernel_ms"]
            print(json.dumps(row), flush=True)
            fh.write(json.dumps(row) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
