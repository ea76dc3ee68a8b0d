"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: card name and power limit (nvidia-smi), CUDA version, TF32 flags;
  2. build: compile the CUDA kernels from textflux_torch/csrc/ (timed);
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16, with times for the kernel, the plain version and one PyTorch
     library call computing the same function (yardstick only);
  4. main path: full-width FLUX.1-Fill-dev + CLIP-L + T5-XXL + FLUX VAE with
     random bf16 weights made on the card from a seed, driven through
     textflux_torch.cli.run_inference.run on resource/example (euler, then
     overshoot), with the kernel launch counts checked;
  5. profile: one more denoise step timed unprofiled, then traced with
     torch.profiler: device time by kernel and the device's idle share.
The line before the last holds the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.

`--phases` picks a subset (default: all of them).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(REPO, "resource", "example")
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BF16_TOL = 2e-2              # unit-scale inputs, bf16 rounding of q/k/p/out
PHASES = ("device", "build", "kernels", "main", "profile")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {"nvidia_smi": smi}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from textflux_torch.ops.cuda_build import build, load_library

    t0 = time.perf_counter()
    path, nvcc_s = build(verbose=True)
    load_library()
    log(f"build: {os.path.relpath(path, REPO)} nvcc {nvcc_s:.1f} s, "
        f"total {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------

def _attention_case(name, b, t_txt, lat_hw, h, d, axes, *, kv_len=None,
                    per_row=True, strided=False, gen):
    from textflux_torch.ops import packing
    from textflux_torch.ops.rope import rope_tables_half

    ids = np.concatenate([packing.text_ids(t_txt), packing.latent_image_ids(*lat_hw)], 0)
    s = len(ids)
    dev = "cuda"
    cos, sin = (torch.as_tensor(t, device=dev) for t in rope_tables_half(ids, axes))

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    if strided:
        # the single blocks' layout: q/k/v are views into the rows of the
        # fused linear1 output [q | k | v | mlp], row stride 3*H*D + 4*H*D
        fused = randn(b, s, 7 * h * d)
        q, k, v = (fused[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
                   for i in range(3))
    else:
        q, k, v = (randn(b, s, h, d) for _ in range(3))
    if per_row:  # double-block tables: txt rows and img rows carry different norms
        qs = torch.cat([(1 + 0.1 * randn(d, dtype=torch.float32)).expand(t_txt, d),
                        (1 + 0.1 * randn(d, dtype=torch.float32)).expand(s - t_txt, d)])
        ks = torch.cat([(1 + 0.1 * randn(d, dtype=torch.float32)).expand(t_txt, d),
                        (1 + 0.1 * randn(d, dtype=torch.float32)).expand(s - t_txt, d)])
    else:
        qs = 1 + 0.1 * randn(d, dtype=torch.float32)
        ks = 1 + 0.1 * randn(d, dtype=torch.float32)
    return dict(name=name, q=q, k=k, v=v, cos=cos, sin=sin, qs=qs, ks=ks,
                kv_len=s if kv_len is None else kv_len)


def _bound_ms(c) -> tuple:
    b, s, h, d = c["q"].shape
    flops = 4 * b * h * s * c["kv_len"] * d
    nbytes = 4 * b * s * h * d * 2 + 4 * s * d * 4  # q, k, v read, o written; 4 fp32 tables
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> list:
    import torch.nn.functional as F

    from textflux_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
    full_axes = (16, 56, 56)
    cases = [
        _attention_case("serving", 1, 512, (56, 64), 24, 128, full_axes, gen=gen),
        _attention_case("serving_single_block", 1, 512, (56, 64), 24, 128, full_axes,
                        per_row=False, strided=True, gen=gen),
        _attention_case("serving_kv_len", 1, 512, (56, 64), 24, 128, full_axes,
                        kv_len=1300, gen=gen),
        _attention_case("ragged_s1000", 1, 104, (56, 64), 24, 128, full_axes,
                        per_row=False, gen=gen),
        _attention_case("d64", 2, 64, (32, 32), 8, 64, (16, 24, 24), gen=gen),
    ]
    rows = []
    failed = []
    for c in cases:
        raw = (c["q"], c["k"], c["v"], c["cos"], c["sin"], c["qs"], c["ks"])
        out = FA.flash_attention_qk_norm_rope(*raw, kv_len=c["kv_len"])
        torch.cuda.synchronize()
        ref = FA.flash_attention_qk_norm_rope_reference(*raw, kv_len=c["kv_len"])
        # times below are of the kernel alone, on tables folded once outside
        tables = FA.fold_tables(c["cos"], c["sin"], c["qs"], c["ks"])
        args = (c["q"], c["k"], c["v"], *tables)
        n = c["kv_len"]
        # rows >= kv_len are padding whose outputs a caller drops; compare the real rows
        err = (out[:, :n].float() - ref[:, :n].float()).abs().max().item()
        finite = bool(torch.isfinite(out[:, :n].float()).all())
        kernel_ms = cuda_ms(lambda: FA.launch_folded(*args, kv_len=c["kv_len"]))
        plain_ms = cuda_ms(lambda: FA._reference_folded(*args, kv_len=c["kv_len"], eps=1e-6),
                           iters=5)
        # library yardstick: SDPA on q/k normed and roped outside the timing
        d = c["q"].shape[-1]
        qn = (FA._norm_rope(c["q"].float().transpose(1, 2), tables[0], tables[1], 1e-6)
              ).to(torch.bfloat16)
        kn = FA._norm_rope(c["k"].float().transpose(1, 2), tables[2], tables[3], 1e-6
                           ).to(torch.bfloat16)
        vh = c["v"].transpose(1, 2)
        mask = None
        if n < c["q"].shape[1]:
            mask = (torch.arange(c["q"].shape[1], device="cuda") < n)[None, None, None, :]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qn, kn, vh, attn_mask=mask))
        bound_ms, bound_by = _bound_ms(c)
        row = dict(case=c["name"], shape=list(c["q"].shape), kv_len=n, max_err=err,
                   tol=BF16_TOL, finite=finite, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log("kernel case " + json.dumps(row))
        if not (finite and err <= BF16_TOL):
            failed.append(c["name"])
        rows.append(row)
        del qn, kn, c
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version in cases {failed}")
    return rows


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def clip_byte_tokenize(prompt: str, length: int = 77, vocab: int = 49408) -> np.ndarray:
    """Deterministic stand-in for the CLIP tokenizer (no tokenizer files in
    the repo): BOS, the prompt's bytes, EOS, then EOS padding."""
    bos, eos = vocab - 2, vocab - 1
    body = list(prompt.encode("utf-8")[: length - 2])
    ids = [bos] + body + [eos] * (length - 1 - len(body))
    return np.asarray(ids, np.int64)[None]


def t5_byte_tokenize(prompt: str, length: int = 512) -> np.ndarray:
    """Deterministic stand-in for the T5 tokenizer: byte ids + 3, EOS (1),
    then padding (0) to `length`."""
    body = [x + 3 for x in prompt.encode("utf-8")[: length - 1]]
    ids = body + [1] + [0] * (length - 1 - len(body))
    return np.asarray(ids, np.int64)[None]


def _image_stats(img) -> dict:
    arr = np.asarray(img, np.float32)
    return dict(size=list(img.size), finite=bool(np.isfinite(arr).all()),
                std=float(arr.std()), min=float(arr.min()), max=float(arr.max()))


def profile_step(step, call, top: int = 12) -> None:
    """Device time of one denoise step by kernel (torch.profiler), and the
    device's idle share: 1 - traced device time / host wall time of the same
    step run unprofiled (the profiler's own overhead stretches the host side
    of the traced step)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        step(*call["args"], **call["kwargs"])   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*call["args"], **call["kwargs"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(*call["args"], **call["kwargs"])
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    log("profile " + json.dumps(dict(
        step_wall_ms=wall_ms, device_busy_ms=busy_ms,
        # None: the profiler saw no device time, so the share is not measured
        idle_share=max(0.0, 1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        top=[dict(name=e.key[:90], calls=e.count, ms=e.self_device_time_total / 1e3)
             for e in rows])))


def phase_main(profile: bool = False) -> dict:
    from textflux_torch.cli.run_inference import run
    from textflux_torch.config import (PipelineConfig, clip_l_config, flux_fill_config,
                                       flux_vae_config, t5_xxl_config)
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope
    from textflux_torch.pipeline.fill import FillPipeline

    dev, dt = "cuda", torch.bfloat16
    flux_cfg = flux_fill_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = dict(
        flux=FluxTransformer(flux_cfg, device=dev, dtype=dt, generator=gen),
        vae=FluxVAE(flux_vae_config(), device=dev, dtype=dt, generator=gen),
        clip=CLIPTextModel(clip_l_config(), device=dev, dtype=dt, generator=gen),
        t5=T5Encoder(t5_xxl_config(), device=dev, dtype=dt, generator=gen),
    )
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in models.items()}
    log(f"init: {time.perf_counter() - t0:.1f} s, params {n_params}, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pipe = FillPipeline(**models, clip_tokenize=clip_byte_tokenize,
                        t5_tokenize=t5_byte_tokenize, pipe_cfg=PipelineConfig(),
                        device=dev)
    if pipe.attn_impl != "fused":
        raise AssertionError(f"expected the fused attention path on CUDA, got {pipe.attn_impl}")

    # per-step device time: wrap the pipeline's step with CUDA events
    step_events = []
    last_call = {}
    inner_step = pipe._denoise_step

    def timed_step(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner_step(*a, **kw)
        e.record()
        step_events.append((s, e))
        last_call.update(args=a, kwargs=kw)
        return out

    pipe._denoise_step = timed_step
    per_block = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    paths = (os.path.join(EXAMPLE, "ori", "ori_0001.png"),
             os.path.join(EXAMPLE, "mask", "mask_0001.png"),
             os.path.join(EXAMPLE, "txt", "words_0001.txt"))
    runs = {}
    for sampler, steps in (("euler", 4), ("overshoot", 2)):
        step_events.clear()
        torch.cuda.synchronize()
        flash_attention_qk_norm_rope.launches = 0
        t0 = time.perf_counter()
        result, cropped, rendered, original, mask = run(
            pipe, *paths, steps=steps, seed=0, sampler=sampler)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_attention_qk_norm_rope.launches
        step_ms = [s.elapsed_time(e) for s, e in step_events]
        stats = dict(result=_image_stats(result), crop=_image_stats(cropped))
        rec = dict(sampler=sampler, steps=steps, s_per_img=seconds,
                   mean_step_ms=float(np.mean(step_ms)), step_ms=step_ms,
                   joint_seq=pipe.last_joint_seq, launches=launches,
                   expected_launches=per_block * steps, images=stats)
        log("main path " + json.dumps(rec))
        runs[sampler] = rec
        for k_, st in stats.items():
            if not st["finite"] or st["std"] <= 0.0:
                raise AssertionError(f"{sampler}: {k_} image is not finite/non-constant: {st}")
        if launches != per_block * steps:
            raise AssertionError(f"{sampler}: kernel launched {launches} times, "
                                 f"expected {per_block} x {steps}")
    peak = torch.cuda.max_memory_allocated()
    log(f"max_memory_allocated: {peak / 2**30:.2f} GiB")
    if profile:
        profile_step(inner_step, last_call)
    return dict(runs=runs, max_memory_allocated=peak)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "textflux_torch")):
        print(f"chip_smoke: no textflux_torch/ beside {__file__}; run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    phases = args.phases.split(",")
    dev = phase_device()
    if "build" in phases or "kernels" in phases or "main" in phases:
        phase_build()
    kernel_rows = phase_kernels() if "kernels" in phases else []
    main_rec = phase_main("profile" in phases) if "main" in phases else None

    serving = next((r for r in kernel_rows if r["case"] == "serving"), None)
    launches = (sum(r["launches"] for r in main_rec["runs"].values())
                if main_rec else None)
    entry = dict(
        name="flash_attention_qk_norm_rope", route="cuda",
        source="textflux_torch/csrc/fused_attention.cu",
        replaces="textflux_tpu/ops/flash_attention.py:577",
        launches=launches,
        launches_by_run=({k: v["launches"] for k, v in main_rec["runs"].items()}
                         if main_rec else None),
    )
    if serving:
        entry.update(max_abs_err=max(r["max_err"] for r in kernel_rows),
                     max_err=max(r["max_err"] for r in kernel_rows), tol=BF16_TOL,
                     ms=serving["kernel_ms"], kernel_ms=serving["kernel_ms"],
                     plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
                     bound_by=serving["bound_by"], library_ms=serving["library_ms"])
    log(dev["nvidia_smi"])
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
