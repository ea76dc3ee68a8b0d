"""Launch cost and steady denoise steps of one checkout of the PyTorch port,
on one NVIDIA GPU, so that two checkouts can be set side by side in one call.

    python3 tools/launch_ab.py --root DIR [--steps 30]

DIR is a checkout of the repository: its textflux_torch/ is imported and its
kernels build into DIR/build. Only entry points that every slice of the port
has are called. Prints one JSON line with

  attention: the fused serving kernel's wrapper (launch_folded) at the
    serving shape B=1, S=1408, H=24, D=128, the flash forward
    (flash_attention) at the training shape B=1, S=4224, H=24, D=128, and
    scaled_dot_product_attention on the same inputs beside each:
      event_ms    CUDA events over 20 back-to-back calls after 3 warm-up
                  calls, as chip_smoke.py's kernel_ms;
      device_ms   the same 20 calls enqueued while the card runs a sleep
                  kernel: the calls' kernels back to back, without the
                  host's launch path;
      enqueue_us  host wall time per call of 57 calls (one per DiT block)
                  enqueued while the card sleeps;
  serving: one euler image of --steps steps through cli.run_inference.run at
    full width (random bf16 weights from seed 0, resource/example), each
    step's CUDA-event ms and the host's ms inside the step call (which does
    not synchronise), with the median, min and max of the steps after the
    first two.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLEEP_CYCLES = 200_000_000   # ~0.1 s of the card's clock: longer than any host loop below
BLOCKS = 57                  # 19 double + 38 single blocks: fused launches per denoise step


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def behind_sleep(fn, iters: int) -> tuple:
    """(device ms per call, host us per call) of `iters` calls enqueued while
    the card sleeps."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / iters
    end.record()
    busy = not end.query()   # still asleep when the host finished: the timing holds
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us, busy


def time_call(fn) -> dict:
    dev_ms, _, busy_a = behind_sleep(fn, 20)
    _, enqueue_us, busy_b = behind_sleep(fn, BLOCKS)
    return dict(event_ms=event_ms(fn), device_ms=dev_ms, enqueue_us=enqueue_us,
                slept_through=busy_a and busy_b)


def attention() -> dict:
    import torch.nn.functional as F

    from textflux_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    out = {}
    s, h, d = 1408, 24, 128
    q, k, v = (randn(1, s, h, d) for _ in range(3))
    tables = [randn(s, d, dtype=torch.float32) for _ in range(4)]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["fused_serving"] = time_call(lambda: FA.launch_folded(q, k, v, *tables, kv_len=s))
    out["sdpa_serving"] = time_call(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    s = 4224
    q, k, v = (randn(1, s, h, d) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["flash_fwd_train"] = time_call(lambda: FA.flash_attention(q, k, v, kv_len=s))
    out["sdpa_train"] = time_call(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    return out


def serving(steps: int) -> dict:
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from textflux_torch.cli.run_inference import run
    from textflux_torch.config import (PipelineConfig, clip_l_config, flux_fill_config,
                                       flux_vae_config, t5_xxl_config)
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.pipeline.fill import FillPipeline

    dev, dt = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe = FillPipeline(
        flux=FluxTransformer(flux_fill_config(), device=dev, dtype=dt, generator=gen),
        vae=FluxVAE(flux_vae_config(), device=dev, dtype=dt, generator=gen),
        clip=CLIPTextModel(clip_l_config(), device=dev, dtype=dt, generator=gen),
        t5=T5Encoder(t5_xxl_config(), device=dev, dtype=dt, generator=gen),
        clip_tokenize=smoke.clip_byte_tokenize, t5_tokenize=smoke.t5_byte_tokenize,
        pipe_cfg=PipelineConfig(), device=dev)
    events, host_ms = [], []
    inner = pipe._denoise_step

    def timed_step(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        res = inner(*a, **kw)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        e.record()
        events.append((s, e))
        return res

    pipe._denoise_step = timed_step
    ex = os.path.join(HERE, "resource", "example")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(pipe, os.path.join(ex, "ori", "ori_0001.png"), os.path.join(ex, "mask", "mask_0001.png"),
        os.path.join(ex, "txt", "words_0001.txt"), steps=steps, seed=0, sampler="euler")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    steady, steady_host = step_ms[2:], host_ms[2:]
    return dict(attn_impl=pipe.attn_impl, steps=steps, s_per_img=seconds, step_ms=step_ms,
                host_ms=host_ms, steady_median_ms=float(np.median(steady)),
                steady_min_ms=min(steady), steady_max_ms=max(steady),
                steady_host_median_ms=float(np.median(steady_host)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose textflux_torch/ is measured")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_ab: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import textflux_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(textflux_torch.__file__))) != root:
        raise RuntimeError(f"textflux_torch came from {textflux_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(root=root, device=torch.cuda.get_device_name(0), attention=attention())
    rec["serving"] = serving(args.steps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
