"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: card name and power limit (nvidia-smi), CUDA version, TF32 flags;
  2. build: compile the CUDA kernels from textflux_torch/csrc/ (timed), with
     each kernel's registers and spills from ptxas (-Xptxas -v); a wgmma
     kernel that spills, or any wgmma serialisation warning, fails;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16, with times for the kernel, the plain version and one PyTorch
     library call computing the same function (yardstick only);
  4. main path: full-width FLUX.1-Fill-dev + CLIP-L + T5-XXL + FLUX VAE with
     random bf16 weights made on the card from a seed, driven through
     textflux_torch.cli.run_inference.run on resource/example (euler, then
     overshoot), with the kernel launch counts checked;
  5. profile: one more denoise step timed unprofiled, then traced with
     torch.profiler: device time by kernel and the device's idle share (and
     the same for one train step when the train phase runs, and for one
     denoise step of each quantised mode when the quantized phase runs);
  6. train: the serving models freed, full-width models built anew from the
     seed, then 3 LoRA optimizer steps (rank 128) through
     textflux_torch.cli.train.train_lora on one 1024-px sample composed
     from resource/example, with the flash kernels' launch counts per step,
     the factors' movement and the frozen base checked;
  7. checkpoint: a full-size checkpoint in the diffusers layout written to
     build/checkpoint_smoke/ (the seed-0 DiT through the port's exporter in
     3 shards; VAE, CLIP-L and T5-XXL at every key and full shape of
     tests/golden/checkpoint_manifest.json with random bf16 values; a
     rank-128 LoRA over the manifest's 684 LoRA keys), then served through
     textflux_torch.cli.run_inference.main: without the LoRA (every DiT
     parameter and the image held against the in-memory model's), with it
     (three folded row blocks held against scale*(alpha/r)*B@A), then
     generate_batch (B=2, padded) against the single-item call, and the
     tiled VAE at 1536x1536 against the untiled one. Load seconds, GB/s and
     peak device memory by component; the checkpoint stays for phase 8.
     The card has no tokenizer files (and no transformers package): the
     phase patches textflux_torch.pipeline.tokenizers.load_tokenizers with
     the byte stand-ins below, and says so;
  8. train_main: LoRA training from a data directory through
     textflux_torch.cli.train.main on that checkpoint (written here when
     phase 7 did not run; removed after the last phase): an AnyWord json
     over the two example images (the dataset's glyph strip, polygon fill
     and mask augmentation), Prodigy at lr 1, rank 128, 1024 px. Run A
     trains 4 steps, checkpointing at step 3, profiling step 1; run B
     resumes a copy of A's step-3 checkpoint to step 4; A's export is
     served through FillPipeline.from_pretrained(lora_path=...) for 2
     steps. Per step: CUDA-event time, the host's wait in the loader, the
     bucket and the flash launches; load seconds by component, the
     checkpoint save's time on the training thread and the peak device
     memory per run. Checked: every target's B moved in each run, B's
     state right after the resume equals A's step-3 checkpoint bitwise,
     the export's keys equal the manifest's, and two served row blocks are
     the base with the export folded in (some elements changed);
  9. quantized: that checkpoint served through
     textflux_torch.cli.run_inference.main with --quantize-mode
     weight_only, w8a8, nf4 and mixed (T5 int8 weight-only with each), then
     --staged-text weight_only, 2 steps at the 512 px single-line shape: load
     seconds, GB/s and device bytes by component, the device's peak over the
     load and over serving, step ms, fused launches per step and the relative
     velocity error of one full-depth DiT forward against the bf16 DiT. Fails
     when a mode breaks the JAX package's divergence bounds on a full-width
     1-double + 1-single stack (2 / 3 / 25 / 5 %, mixed also under nf4's / 3)
     or the weight_only load peaks more than 1 GiB above the models' bytes;
 10. qlora: in memory (weights made on the card, nothing written): the
     full-width DiT quantised nf4 in place, rank-128 LoRA with 8-bit AdamW
     (lr 2e-5, clip 1.0), 3 steps at 4,224 tokens through train_lora, then
     one step over a weight_only base: step ms, the peak, launches per step
     (114/0/57/57), the optimizer's state bytes beside AdamW's; every
     target's B must move;
 11. eval: phase 7's checkpoint (written here when no earlier phase did)
     through textflux_torch.cli.run_eval.main over an AnyWord json of three
     items on the example images (two in one //32 bucket): --batch-size 1,
     --batch-size 2 into a second directory (images equal within 1 level),
     --multiline, then --skip-existing on the first directory (does
     nothing); failures.json, fused launches (57 a step per item or
     chunk), step ms, seconds per item and the serving peak per run. Then
     the demo callbacks on the loaded pipeline (check_gradio must raise),
     Text2ImagePipeline at full FLUX.1-dev width (64 input channels, random
     bf16 weights made after the Fill DiT is freed; 512x512, euler 4),
     eval_ocr.main over the first run's crops with the PP-OCRv3 entry point
     and eval_fid_lpips.main against the example images, with random
     full-config PP-OCRv3, InceptionV3 and LPIPS-alex weights written here;
     each metric network on the card held against the port on the CPU
     (EVAL_*_TOL), the features with TF32 allowed measured beside them,
     and the networks' times;
 12. train_full: full-parameter training on phase 7's checkpoint (written
     here when no earlier phase did) through textflux_torch.cli.train.main:
     --mode attn (the reference's attention unfreeze, 3.945 B trainable
     parameters as float32 masters beside the frozen bf16 weights) with
     8-bit AdamW at lr 2e-5, full depth, the AnyWord json of phase 8 at
     1024 px (joint 4,224), 4 steps, no checkpoint; the final float32
     export goes to a sink that checks it on the card (the manifest's keys
     and shapes, float32, the trained keys bitwise the live masters) and
     writes nothing (the disk budget: phases 7, 8 and 11 write ~45.6 GB of
     the 45 GiB a run may write, the export alone would be 47.6 GB). Step
     ms, the DiT load, launches per step, the peak and the state's bytes by
     part; every trainable parameter moved, every frozen parameter and
     masked linear1 row bitwise as loaded; one more step profiled. Then
     --mode attn with AdamW and --mode all with 8-bit AdamW through
     train_full, 2 steps each, at full width and 2 + 4 blocks (at full
     depth they need ~95 and ~119 GB).
Phase 3 runs every kernel at its path's shapes and at the JAX package's
multi-line serving shape (S = 8704). It also holds the four training
kernels (flash forward, LSE, dQ, dK/dV) against their plain versions, the
L that the forward writes against the plain LSE, and the fused kernel's
norm+rope pass (timed alone) against its plain version; it checks that a
second launch of the forward, dQ and dK/dV on the same inputs gives
bitwise the same outputs. The train, qlora and train_full phases expect 114 / 0 / 57
/ 57 launches of forward / LSE / dQ / dK/dV per full-depth step: the forward hands its L
to the backward. The line before the last holds the kernel table as JSON;
the last line is {"ok": true, "device": {...}}.

`--phases` picks a subset (default: all of them).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(REPO, "resource", "example")
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BF16_TOL = 2e-2              # unit-scale inputs, bf16 rounding of q/k/p/out
PHASES = ("device", "build", "kernels", "main", "profile", "train", "checkpoint",
          "train_main", "quantized", "qlora", "eval", "train_full")


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
    try:   # the eval phase's polygon crops and the multi-line glyphs use cv2
        import cv2
        log(f"cv2 {cv2.__version__} imports")
    except ImportError as e:
        log(f"cv2 does not import: {e}")
    return {"nvidia_smi": smi}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("flash_fwd_sm90_kernel", "flash_dq_sm90_kernel", "flash_dkv_sm90_kernel",
                "flash_lse_kernel", "norm_rope_kernel")


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel instantiation (name<D>) from
    an -Xptxas -v build log, and ptxas's wgmma serialisation warnings."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = next((k for k in KERNEL_NAMES if k in m.group(1)), None)
            d = re.search(r"ILi(\d+)E", m.group(1))
            cur = f"{name}<{d.group(1) if d else ''}>" if name else None
            if cur:
                kernels.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            kernels[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[cur]["registers"] = int(m.group(1))
    warnings = [x.strip() for x in text.splitlines()
                if "C7512" in x or ("wgmma" in x and "serializ" in x)]
    return dict(kernels=kernels, wgmma_warnings=warnings)


def phase_build() -> dict:
    from textflux_torch.ops.cuda_build import build, load_library

    t0 = time.perf_counter()
    path, nvcc_s, text = build()
    load_library()
    log(text)
    log(f"build: {os.path.relpath(path, REPO)} nvcc {nvcc_s:.1f} s, "
        f"total {time.perf_counter() - t0:.1f} s")
    report = ptxas_report(text)
    if not report["kernels"]:
        raise AssertionError(f"no ptxas report for {path.name}: delete it to rebuild")
    log("build kernels " + json.dumps(report))
    spilled = [k for k, v in report["kernels"].items()
               if "sm90" in k and (v.get("spill_stores", 0) or v.get("spill_loads", 0))]
    if spilled or report["wgmma_warnings"]:
        raise AssertionError(f"wgmma kernels spill ({spilled}) or serialise "
                             f"({report['wgmma_warnings']})")
    return report


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
        # the JAX package's multi-line serving shape: a 2048x1024 canvas,
        # 512 text + 8192 image tokens
        _attention_case("multiline_s8704", 1, 512, (128, 256), 24, 128, full_axes, gen=gen),
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
        # the first of its two launches alone, against its plain version
        prep_args = (c["q"], c["k"], *tables)
        qn_k, kn_k = FA.norm_rope_prep(*prep_args)
        qn_ref, kn_ref = FA._prep_reference(*prep_args, 1e-6, torch.bfloat16)
        prep_err = max((qn_k.float() - qn_ref.transpose(1, 2).float()).abs().max().item(),
                       (kn_k.float() - kn_ref.transpose(1, 2).float()).abs().max().item())
        del qn_k, kn_k, qn_ref, kn_ref
        prep_ms = cuda_ms(lambda: FA.norm_rope_prep(*prep_args))
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
        # the prep is inside kernel_ms; SDPA is beside the attention alone
        row = dict(case=c["name"], shape=list(c["q"].shape), kv_len=n, max_err=err,
                   tol=BF16_TOL, finite=finite, prep_err=prep_err, kernel_ms=kernel_ms,
                   prep_ms=prep_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log("kernel case " + json.dumps(row))
        if not (finite and err <= BF16_TOL and prep_err <= BF16_TOL):
            failed.append(c["name"])
        rows.append(row)
        del qn, kn, c
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version in cases {failed}")
    return rows


FLASH_KERNELS = ("flash_attention", "flash_attention_lse", "flash_attention_dq",
                 "flash_attention_dkv")
LSE_TOL = 1e-3     # fp32 output: only the summation order differs
REL_TOL = 2e-2     # bf16 outputs, relative to the largest |value| of the plain version


def _flash_case(name, b, s, h, d, *, kv_len=None, strided=False, gen):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    if strided:  # q/k/v as views of a fused [q | k | v | mlp] row, as linear1 gives them
        fused = randn(b, s, 7 * h * d)
        q, k, v = (fused[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
                   for i in range(3))
    else:
        q, k, v = (randn(b, s, h, d) for _ in range(3))
    return dict(name=name, q=q, k=k, v=v, do=randn(b, s, h, d),
                kv_len=s if kv_len is None else kv_len)


def _flash_bounds(b, s, h, d, kv) -> dict:
    """(bound_ms, bound_by) of each flash kernel: its products' FLOPs over the
    bf16 peak against each input read once and each output written once (k/v
    rows up to kv_len, q/dO/outputs at every row; L and Dvec fp32)."""
    row_q, row_kv, row_f32 = b * s * h * d * 2, b * kv * h * d * 2, b * h * s * 4
    work = {
        "flash_attention": (4, 2 * row_q + 2 * row_kv + row_f32),               # q, o; k, v; L
        "flash_attention_lse": (2, row_q + row_kv + row_f32),                   # q; k; L
        "flash_attention_dq": (6, 3 * row_q + 2 * row_kv + 2 * row_f32),        # q, dO, dq; k, v
        "flash_attention_dkv": (8, 4 * row_q + 2 * row_kv + 2 * row_f32),       # q, dO, dk, dv
    }
    out = {}
    for name, (mult, nbytes) in work.items():
        t_ops = mult * b * h * s * kv * d / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        out[name] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def _rel_err(out, ref) -> tuple:
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30), bool(torch.isfinite(out.float()).all())


def phase_flash_kernels() -> dict:
    """The four training kernels against their plain versions, per case; the
    autograd function's gradients against the same function on the plain
    versions at the training shape; SDPA forward and backward as yardsticks."""
    import torch.nn.functional as F

    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.ops.attention import FlashAttention

    gen = torch.Generator(device="cuda").manual_seed(1)
    specs = [
        ("train", 1, 4224, 24, 128, None, False),
        ("train_kv_len", 1, 4224, 24, 128, 4100, False),
        ("train_single_block", 1, 4224, 24, 128, None, True),
        ("s1408", 1, 1408, 24, 128, None, False),
        ("ragged_s1000", 1, 1000, 24, 128, None, False),
        # ragged query and key tiles, a batch stride in the tensor maps
        ("batch2_ragged_kv900", 2, 1000, 24, 128, 900, False),
        ("d64", 2, 320, 8, 64, None, False),
        ("multiline_s8704", 1, 8704, 24, 128, None, False),
    ]
    rows, failed = [], []
    for name, b, s, h, d, kv_len, strided in specs:
        c = _flash_case(name, b, s, h, d, kv_len=kv_len, strided=strided, gen=gen)
        q, k, v, do, n = c["q"], c["k"], c["v"], c["do"], c["kv_len"]
        o, lse_fwd = FA.flash_attention_fwd(q, k, v, kv_len=n)
        lse = FA.flash_attention_lse(q, k, kv_len=n)
        dvec = FA.attention_dvec(o, do)
        dq = FA.flash_attention_dq(q, k, v, do, lse, dvec, kv_len=n)
        dk, dv = FA.flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=n)
        torch.cuda.synchronize()
        ref_o = FA.flash_attention_reference(q, k, v, kv_len=n)
        ref_lse = FA.flash_attention_lse_reference(q, k, kv_len=n)
        ref_dq = FA.flash_attention_dq_reference(q, k, v, do, lse, dvec, kv_len=n)
        ref_dk, ref_dv = FA.flash_attention_dkv_reference(q, k, v, do, lse, dvec, kv_len=n)
        lse_err = (lse - ref_lse).abs().max().item()
        lse_from_fwd_err = (lse_fwd - ref_lse).abs().max().item()
        errs = {
            "flash_attention": _rel_err(o, ref_o),
            "flash_attention_lse": (lse_err, lse_err, bool(torch.isfinite(lse).all())),
            "flash_attention_dq": _rel_err(dq, ref_dq),
            "flash_attention_dkv": tuple(max(x, y) for x, y in zip(_rel_err(dk, ref_dk),
                                                                  _rel_err(dv, ref_dv))),
        }
        del ref_o, ref_lse, ref_dq, ref_dk, ref_dv
        # key rows >= kv_len get exactly zero gradients
        masked_rows_zero = bool((dk[:, n:] == 0).all() and (dv[:, n:] == 0).all())
        # no atomics: a second launch on the same inputs gives the same bits
        # (the forward without L too: the same kernel, O from the same sums)
        o2, lse_fwd2 = FA.flash_attention_fwd(q, k, v, kv_len=n)
        fwd_deterministic = bool(torch.equal(o, o2) and torch.equal(lse_fwd, lse_fwd2)
                                 and torch.equal(o, FA.flash_attention(q, k, v, kv_len=n)))
        del o2, lse_fwd2
        dq2 = FA.flash_attention_dq(q, k, v, do, lse, dvec, kv_len=n)
        dk2, dv2 = FA.flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=n)
        deterministic = bool(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                             and torch.equal(dv, dv2))
        del dq2, dk2, dv2
        calls = {
            "flash_attention": (lambda: FA.flash_attention_fwd(q, k, v, kv_len=n),
                                lambda: (FA.flash_attention_reference(q, k, v, kv_len=n),
                                         FA.flash_attention_lse_reference(q, k, kv_len=n))),
            "flash_attention_lse": (lambda: FA.flash_attention_lse(q, k, kv_len=n),
                                    lambda: FA.flash_attention_lse_reference(q, k, kv_len=n)),
            "flash_attention_dq": (
                lambda: FA.flash_attention_dq(q, k, v, do, lse, dvec, kv_len=n),
                lambda: FA.flash_attention_dq_reference(q, k, v, do, lse, dvec, kv_len=n)),
            "flash_attention_dkv": (
                lambda: FA.flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=n),
                lambda: FA.flash_attention_dkv_reference(q, k, v, do, lse, dvec, kv_len=n)),
        }
        bounds = _flash_bounds(b, s, h, d, n)
        per_kernel = {}
        for kname, (kernel_fn, plain_fn) in calls.items():
            err, rel, finite = errs[kname]
            tol = LSE_TOL if kname == "flash_attention_lse" else REL_TOL
            per_kernel[kname] = dict(
                max_err=err, rel_err=rel, tol=tol, finite=finite,
                kernel_ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, iters=3, warmup=1),
                bound_ms=bounds[kname][0], bound_by=bounds[kname][1])
            if not (finite and (err if kname == "flash_attention_lse" else rel) <= tol):
                failed.append(f"{name}/{kname}")
        if not (bool(torch.isfinite(lse_fwd).all()) and lse_from_fwd_err <= LSE_TOL):
            failed.append(f"{name}/lse_from_fwd")
        if not fwd_deterministic:
            failed.append(f"{name}/fwd_deterministic")
        if not masked_rows_zero:
            failed.append(f"{name}/masked_rows")
        if not deterministic:
            failed.append(f"{name}/deterministic")
        dvec_ms = cuda_ms(lambda: FA.attention_dvec(o, do))

        # yardsticks: SDPA forward, and one SDPA backward with the same dO
        mask = None
        if n < s:
            mask = (torch.arange(s, device="cuda") < n)[None, None, None, :]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        do_t = do.transpose(1, 2)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                                          retain_graph=True))
        del sdpa_out
        bwd_total = sum(per_kernel[x]["kernel_ms"] for x in FLASH_KERNELS[1:]) + dvec_ms
        row = dict(case=name, shape=[b, s, h, d], kv_len=n, strided=strided,
                   kernels=per_kernel, lse_from_fwd_err=lse_from_fwd_err,
                   fwd_deterministic=fwd_deterministic, masked_rows_zero=masked_rows_zero,
                   deterministic=deterministic, dvec_ms=dvec_ms,
                   bwd_total_ms=bwd_total, sdpa_ms=sdpa_ms, sdpa_bwd_ms=sdpa_bwd_ms)
        log("kernel case " + json.dumps(row))
        rows.append(row)

        if name == "train":
            # the autograd function on the card against the same function
            # composed from the plain versions; its backward takes the
            # forward's L and launches no LSE pass
            lse_before = FA.flash_attention_lse.launches
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out = FlashAttention.apply(qg, kg, vg, n)
            grads = torch.autograd.grad(out, (qg, kg, vg), do)
            lse_launches = FA.flash_attention_lse.launches - lse_before
            ref_out = FA.flash_attention_reference(q, k, v, kv_len=n)
            ref_lse = FA.flash_attention_lse_reference(q, k, kv_len=n)
            ref_dvec = FA.attention_dvec(ref_out, do)
            ref_grads = (FA.flash_attention_dq_reference(q, k, v, do, ref_lse, ref_dvec, kv_len=n),
                         *FA.flash_attention_dkv_reference(q, k, v, do, ref_lse, ref_dvec,
                                                           kv_len=n))
            grad_rel = [_rel_err(g_, r_)[1] for g_, r_ in zip(grads, ref_grads)]
            grad_row = dict(case="train_autograd", out_rel_err=_rel_err(out, ref_out)[1],
                            grad_rel_err=grad_rel, tol=REL_TOL, lse_launches=lse_launches)
            log("kernel case " + json.dumps(grad_row))
            if max(grad_rel + [grad_row["out_rel_err"]]) > REL_TOL or lse_launches:
                failed.append("train_autograd")
            del out, grads, ref_out, ref_grads
        del c, q, k, v, do, o, lse, lse_fwd, dvec, dq, dk, dv, qt, kt, vt
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash kernels disagree with their plain versions: {failed}")
    return {r["case"]: r for r in rows}


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


def profile_step(run, *, what: str = "denoise step", inference: bool = True,
                 top: int = 12) -> None:
    """Device time of one `run()` (a denoise step or a train step) by kernel
    (torch.profiler), and the device's idle share: 1 - traced device time /
    host wall time of the same work run unprofiled (the profiler's own
    overhead stretches the host side of the traced run)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode() if inference else contextlib.nullcontext():
        run()   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    # the port's hand-written kernels, whether or not they are in the top
    port = {k: dict(calls=sum(e.count for e in kernels if k in e.key),
                    ms=sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3)
            for k in KERNEL_NAMES}
    log("profile " + json.dumps(dict(
        what=what, wall_ms=wall_ms, device_busy_ms=busy_ms,
        launches=sum(e.count for e in kernels),
        # None: the profiler saw no device time, so the share is not measured
        idle_share=max(0.0, 1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        port_kernels=port,
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
    paths = EXAMPLE_PATHS
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
        profile_step(lambda: inner_step(*last_call["args"], **last_call["kwargs"]))
    return dict(runs=runs, max_memory_allocated=peak)


# ---------------------------------------------------------------------------
# 6. train: LoRA steps at full width through cli.train.train_lora
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
TRAIN_RESOLUTION = 1024   # the largest of the JAX dataset's PREFERRED_RESOLUTIONS


def training_sample(resolution: int = TRAIN_RESOLUTION) -> dict:
    """One collated batch (grad_accum 1, batch 1) from resource/example,
    composed as the JAX dataset's single-line sample: the dataset-style glyph
    strip above the scene, resized so the long side is `resolution`, snapped
    down to a multiple of 32, pixels in [-1, 1]. The example's mask PNG
    stands in for the polygon fill (no mask augmentation)."""
    from PIL import Image

    from textflux_torch.pipeline.prompts import GENERIC_TEMPLATE, read_words, words_prompt
    from textflux_torch.rendering import draw_glyph_strip, load_font

    img = Image.open(os.path.join(EXAMPLE, "ori", "ori_0001.png")).convert("RGB")
    mask = np.asarray(Image.open(os.path.join(EXAMPLE, "mask", "mask_0001.png")).convert("L"))
    text = " ".join(read_words(os.path.join(EXAMPLE, "txt", "words_0001.txt")))
    w, h = img.size
    strip = draw_glyph_strip(load_font(size=60), text, w, h).convert("RGB")
    combined = Image.fromarray(np.vstack((np.asarray(strip), np.asarray(img))))
    combined_mask = Image.fromarray(np.vstack((np.zeros((strip.height, w), np.uint8), mask)))
    cw, ch = combined.size   # image_resize: long side to `resolution`
    size = ((resolution, int(resolution / cw * ch)) if cw >= ch
            else (int(resolution / ch * cw), resolution))
    combined = combined.resize(size)
    combined = combined.resize(((combined.size[0] // 32) * 32, (combined.size[1] // 32) * 32))
    combined_mask = combined_mask.resize(combined.size)
    pixels = np.asarray(combined, np.float32) / 127.5 - 1.0
    mask_np = np.asarray(combined_mask, np.float32) / 255.0
    return {"pixel_values": pixels[None, None], "mask": mask_np[None, None],
            "prompts": [words_prompt([text])], "clip_prompts": [GENERIC_TEMPLATE]}


def phase_train(profile: bool = False) -> dict:
    """3 LoRA optimizer steps of full-width FLUX.1-Fill-dev (random bf16
    weights from seed 0) on the example sample through train_lora, with the
    launch counts, the factors' movement and the frozen base checked."""
    from textflux_torch.cli.train import encode_batch_text, train_lora
    from textflux_torch.config import clip_l_config, flux_fill_config, flux_vae_config, t5_xxl_config
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.training import train as TR

    gc.collect()
    torch.cuda.empty_cache()   # the serving phase's models are gone
    dev, dt = "cuda", torch.bfloat16
    flux_cfg = flux_fill_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    flux = FluxTransformer(flux_cfg, device=dev, dtype=dt, generator=gen)
    vae = FluxVAE(flux_vae_config(), device=dev, dtype=dt, generator=gen)
    clip = CLIPTextModel(clip_l_config(), device=dev, dtype=dt, generator=gen)
    t5 = T5Encoder(t5_xxl_config(), device=dev, dtype=dt, generator=gen)
    torch.cuda.synchronize()
    log(f"train init: {time.perf_counter() - t0:.1f} s, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    sample = training_sample()
    _, _, hp, wp, _ = sample["pixel_values"].shape
    joint_seq = 512 + (hp // 16) * (wp // 16)
    tc = TR.TrainConfig()   # the CLI's defaults; the batch carries grad_accum 1
    # forward + remat recompute per block; no LSE pass (the forward gives L)
    blocks = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    per_step = {"flash_attention": 2 * blocks, "flash_attention_lse": 0,
                "flash_attention_dq": blocks, "flash_attention_dkv": blocks}
    checksum0 = TR.base_checksum(flux)

    starts, ends, counts, snaps = [], [], [], []

    def batches():
        while True:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield sample

    def on_step(step, metrics, lora):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        counts.append({k: getattr(FA, k).launches for k in FLASH_KERNELS})
        if step <= 2:   # the factors after steps 1 and 2
            snaps.append({p: {k: f[k].detach().clone() for k in ("a", "b")}
                          for p, f in lora.items()})

    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora, history = train_lora(flux, vae, clip, t5, batches(), tc=tc,
                               clip_tokenize=clip_byte_tokenize, t5_tokenize=t5_byte_tokenize,
                               steps=TRAIN_STEPS, seed=0, log_every=1, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: getattr(FA, k).launches for k in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    prev = {k: 0 for k in FLASH_KERNELS}
    by_step = []
    for c in counts:
        by_step.append({k: c[k] - prev[k] for k in FLASH_KERNELS})
        prev = c

    after1, after2 = snaps
    b_moved = min(after1[p]["b"].abs().max().item() for p in after1)
    # step 2 moves a by ~lr; weight decay alone moves it by lr*wd*|a|
    decay_bound = 10 * tc.learning_rate * tc.weight_decay
    a_moved = [((after2[p]["a"] - after1[p]["a"]).abs().max().item()
                / max(after1[p]["a"].abs().max().item() * decay_bound, 1e-30)) for p in after2]
    checksum1 = TR.base_checksum(flux)
    rec = dict(steps=TRAIN_STEPS, joint_seq=joint_seq, image_hw=[hp, wp], seconds=seconds,
               step_ms=step_ms, history=history, launches=launches,
               launches_per_step=by_step, expected_per_step=per_step,
               max_memory_allocated=peak, lora_params=sum(p.numel() for p in
                                                         TR.lora_parameters(lora)),
               min_b_after_step1=b_moved, a_targets=len(a_moved),
               a_targets_moved_past_decay=sum(m > 1.0 for m in a_moved),
               base_checksum=[checksum0, checksum1])
    log("train " + json.dumps(rec))
    log(f"max_memory_allocated (train): {peak / 2**30:.2f} GiB")
    problems = []
    for e in history:
        if not (np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) and e["grad_norm"] > 0):
            problems.append(f"step {e['step']}: loss {e['loss']} grad_norm {e['grad_norm']}")
    if b_moved <= 0:
        problems.append("a b factor is still zero after step 1")
    if rec["a_targets_moved_past_decay"] != len(a_moved):
        problems.append(f"only {rec['a_targets_moved_past_decay']}/{len(a_moved)} a factors "
                        "moved past weight decay in step 2")
    if checksum1 != checksum0:
        problems.append(f"base weights changed: {checksum0} -> {checksum1}")
    for i, c in enumerate(by_step):
        if c != per_step:
            problems.append(f"step {i + 1} launched {c}, expected {per_step}")
    if problems:
        raise AssertionError("train phase: " + "; ".join(problems))

    if profile:
        pooled, txt = encode_batch_text(clip, t5, sample, clip_tokenize=clip_byte_tokenize,
                                        t5_tokenize=t5_byte_tokenize)
        batch = {"pixel_values": torch.as_tensor(sample["pixel_values"], device=dev).to(dt),
                 "mask": torch.as_tensor(sample["mask"], device=dev).to(dt),
                 "txt": txt, "pooled": pooled}
        opt = TR.make_optimizer(tc, TR.lora_named_parameters(lora))
        step_fn = TR.make_train_step(tc)
        profile_step(lambda: step_fn(flux, vae, opt, batch, generator=gen),
                     what="train step", inference=False)
    del flux, vae, clip, t5, lora
    return rec


# ---------------------------------------------------------------------------
# 7. checkpoint: write a full-size checkpoint, serve it through main()
# ---------------------------------------------------------------------------

CKPT_DIR = os.path.join(REPO, "build", "checkpoint_smoke")   # build/ is git-ignored
LORA_PATH = os.path.join(CKPT_DIR, "lora", "pytorch_lora_weights.safetensors")
MANIFEST = os.path.join(REPO, "tests", "golden", "checkpoint_manifest.json")
EXAMPLE_PATHS = (os.path.join(EXAMPLE, "ori", "ori_0001.png"),
                 os.path.join(EXAMPLE, "mask", "mask_0001.png"),
                 os.path.join(EXAMPLE, "txt", "words_0001.txt"))
LORA_RANK, LORA_ALPHA, LORA_SCALE = 128, 64.0, 1.0
# the stock FLUX.1-Fill-dev configs of the three components written from the manifest
HF_CONFIGS = {
    "vae": {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
            "block_out_channels": [128, 256, 512, 512], "layers_per_block": 2,
            "latent_channels": 16, "norm_num_groups": 32, "scaling_factor": 0.3611,
            "shift_factor": 0.1159, "use_quant_conv": False, "use_post_quant_conv": False},
    "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": 49408,
                     "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
                     "intermediate_size": 3072, "max_position_embeddings": 77,
                     "layer_norm_eps": 1e-5, "hidden_act": "quick_gelu", "eos_token_id": 2},
    "text_encoder_2": {"architectures": ["T5EncoderModel"], "vocab_size": 32128,
                       "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24,
                       "num_heads": 64, "relative_attention_num_buckets": 32,
                       "relative_attention_max_distance": 128,
                       "feed_forward_proj": "gated-gelu"},
}
COMPONENTS = {"vae": "vae", "text_encoder": "clip", "text_encoder_2": "t5"}
# generate_batch's sample 0 against the single-item call at its seed, in
# uint8 levels (mean and largest |difference|): the kernels are the same,
# cuBLAS may pick other GEMM kernels for twice the rows
BATCH_MEAN_TOL, BATCH_MAX_TOL = 2.0, 32


def _free_bytes(path: str) -> tuple:
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    return shutil.disk_usage(path).free, mem.get("MemAvailable", 0)


def manifest_tensors(shapes: dict, gen, dtype=torch.bfloat16) -> dict:
    """Random tensors on the card for every key of a manifest component:
    weights uniform in +-1/sqrt(fan_in), 1-D weights (norms) ones, biases
    zero; T5's tied embed_tokens is the same tensor as shared."""
    out = {}
    for key, shape in shapes.items():
        if key == "encoder.embed_tokens.weight":
            continue
        if key.endswith(".bias"):
            out[key] = torch.zeros(shape, device="cuda", dtype=dtype)
        elif len(shape) == 1:
            out[key] = torch.ones(shape, device="cuda", dtype=dtype)
        else:
            bound = 1.0 / float(np.sqrt(np.prod(shape[1:])))
            x = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)
            out[key] = ((2 * x - 1) * bound).to(dtype)
    if "encoder.embed_tokens.weight" in shapes:
        out["encoder.embed_tokens.weight"] = out["shared.weight"]
    return out


def lora_tensors(shapes: dict, gen) -> dict:
    """A peft LoRA over every manifest LoRA key: fp32 A (r, in) and B
    (out, r), both nonzero, and an alpha per module."""
    out = {}
    for key, shape in shapes.items():
        x = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)
        out[key] = (2 * x - 1) / float(np.sqrt(shape[1]))
        if key.endswith("lora_A.weight"):
            out[key[: -len("lora_A.weight")] + "alpha"] = torch.tensor(LORA_ALPHA)
    return out


def param_checksum(p: torch.Tensor) -> int:
    """A position-weighted sum of a parameter's float32 bit patterns (int64,
    wrapping): equal values in equal places give equal sums, whatever the
    stored dtype."""
    bits = p.detach().float().reshape(-1).view(torch.int32).to(torch.int64)
    weight = torch.arange(bits.numel(), device=p.device) % 1021 + 1
    return int((bits * weight).sum().item())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _models_bytes(pipe) -> int:
    """Bytes the pipeline's models hold on the device (parameters and the
    quantised linears' buffers)."""
    from textflux_torch.io.quantize import quantized_bytes

    return sum(quantized_bytes(m) for m in (pipe.flux, pipe.vae, pipe.clip, pipe.t5)
               if m is not None)


class _Recorder:
    """Wraps FillPipeline.from_pretrained for the runs of main(): resets the
    device's peak before the load and reads it after (the peak of loading
    alone, before any activation), then resets it again (what follows is
    serving), and keeps the pipeline. A deferred DiT's load_transformer()
    is measured the same way (`staged_load`). Each denoise step of the
    pipeline is timed with CUDA events (`steps`); `last_step` runs the last
    one again."""

    def __init__(self):
        from textflux_torch.pipeline.fill import FillPipeline

        self.cls, self.orig = FillPipeline, FillPipeline.__dict__["from_pretrained"]
        self.pipe, self.rec, self.steps, self.last_step = None, {}, [], None

    def step_ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.steps]

    def __enter__(self):
        orig = self.orig.__func__

        def peak_of(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            return out, peak

        def wrapped(cls, *a, **kw):
            pipe, peak = peak_of(lambda: orig(cls, *a, **kw))
            self.pipe = pipe
            self.rec = dict(load=pipe.load_stats, load_peak_bytes=peak,
                            models_bytes=_models_bytes(pipe))
            inner_step, inner_load = pipe._denoise_step, pipe.load_transformer

            def timed_step(*a, **kw):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = inner_step(*a, **kw)
                e.record()
                self.steps.append((s, e))
                self.last_step = partial(inner_step, *a, **kw)
                return out

            def measured_load():
                t0 = time.perf_counter()
                _, load_peak = peak_of(inner_load)
                self.rec["staged_load"] = dict(
                    seconds=time.perf_counter() - t0, load_peak_bytes=load_peak,
                    transformer=dict(pipe.load_stats["transformer"]),
                    models_bytes=_models_bytes(pipe))

            pipe._denoise_step, pipe.load_transformer = timed_step, measured_load
            return pipe

        self.cls.from_pretrained = classmethod(wrapped)
        return self

    def __exit__(self, *exc):
        self.cls.from_pretrained = self.orig


def _run_main(argv, recorder, steps, expected_per_step):
    import resource

    from textflux_torch.cli.run_inference import main as cli_main
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope

    torch.cuda.synchronize()
    flash_attention_qk_norm_rope.launches = 0
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    rec = dict(recorder.rec, seconds=time.perf_counter() - t0, steps=steps,
               launches=flash_attention_qk_norm_rope.launches,
               expected_launches=expected_per_step * steps,
               ru_maxrss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    rec["load_gb_per_s"] = {k: v["bytes"] / v["seconds"] / 1e9 for k, v in rec["load"].items()}
    return rec


def load_manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def write_checkpoint(manifest: dict) -> tuple:
    """Write the full-size checkpoint under CKPT_DIR (see phase 7). Returns
    (its record: bytes and seconds by part, the seed-0 DiT it was written
    from, still on the card)."""
    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.export import save_transformer_checkpoint
    from textflux_torch.io.safetensors import save_file
    from textflux_torch.models.transformer import FluxTransformer

    dit_bytes = 2 * sum(int(np.prod(s)) for s in manifest["transformer"].values())
    parts_bytes = {c: 2 * sum(int(np.prod(s)) for s in manifest[c].values())
                   for c in ("vae", "clip", "t5")}
    lora_bytes = 4 * sum(int(np.prod(s)) for s in manifest["lora"].values())
    needed = dit_bytes + sum(parts_bytes.values()) + lora_bytes
    os.makedirs(os.path.dirname(CKPT_DIR), exist_ok=True)
    disk_free, mem_free = _free_bytes(os.path.dirname(CKPT_DIR))
    log(f"checkpoint: needs {needed} bytes on disk (DiT {dit_bytes}, {parts_bytes}, "
        f"LoRA {lora_bytes}); disk free {disk_free}, host MemAvailable {mem_free}")
    if disk_free < needed * 1.02:
        raise AssertionError(f"the checkpoint needs {needed} bytes of disk under "
                             f"{os.path.dirname(CKPT_DIR)}, {disk_free} are free")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    stages = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flux = FluxTransformer(flux_fill_config(), device="cuda", dtype=torch.bfloat16,
                           generator=gen)
    torch.cuda.synchronize()
    stages["dit_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    written = {"transformer": save_transformer_checkpoint(
        flux, os.path.join(CKPT_DIR, "transformer"), shards=3)}
    stages["write_transformer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for sub, comp in COMPONENTS.items():
        tensors = manifest_tensors(manifest[comp], gen)
        written[comp] = save_file(tensors, os.path.join(CKPT_DIR, sub, "model.safetensors"))
        with open(os.path.join(CKPT_DIR, sub, "config.json"), "w") as f:
            json.dump(HF_CONFIGS[sub], f, indent=2)
        del tensors
    tensors = lora_tensors(manifest["lora"], gen)
    written["lora"] = save_file(tensors, LORA_PATH)
    del tensors
    torch.cuda.empty_cache()
    stages["write_parts_s"] = time.perf_counter() - t0
    log("checkpoint written " + json.dumps(dict(
        bytes=written, seconds={k: stages[k] for k in ("write_transformer_s",
                                                      "write_parts_s")},
        files=sorted(os.path.relpath(os.path.join(d, f), CKPT_DIR)
                     for d, _, fs in os.walk(CKPT_DIR) for f in fs))))
    return dict(written_bytes=written, stages=stages), flux


@contextlib.contextmanager
def byte_tokenizers(phase: str):
    """textflux_torch.pipeline.tokenizers.load_tokenizers patched with the
    byte stand-ins while the block runs (no tokenizer files in the repo, no
    transformers on the card), and said so."""
    import textflux_torch.pipeline.tokenizers as TK

    log(f"{phase}: textflux_torch.pipeline.tokenizers.load_tokenizers is patched with the "
        "byte tokenizer stand-ins (no tokenizer files in the repo, no transformers on the card)")
    orig = TK.load_tokenizers
    TK.load_tokenizers = lambda base, max_clip_length=77, max_t5_length=512: (
        partial(clip_byte_tokenize, length=max_clip_length),
        partial(t5_byte_tokenize, length=max_t5_length))
    try:
        yield
    finally:
        TK.load_tokenizers = orig


def _fold_check(lora_path: str, targets) -> dict:
    """Each (label, loaded rows, diffusers module, permuted rows or None) of
    `targets` against its base weight in CKPT_DIR's shards plus
    LORA_SCALE * alpha/r * B @ A from the LoRA file, in float32 with TF32
    off, as the loader folds. By label: the largest error (absolute and in
    bf16 ulps of the loaded weight; `within_ulp`), the largest |delta|, how
    many elements the fold changed (`changed`) and how many differ from
    the base + delta rounded to bf16 (`differ_from_rounded`)."""
    from textflux_torch.io.safetensors import SafetensorsFile

    shards = [SafetensorsFile(os.path.join(CKPT_DIR, "transformer", f)) for f in
              sorted(os.listdir(os.path.join(CKPT_DIR, "transformer")))
              if f.endswith(".safetensors")]
    lora_file = SafetensorsFile(lora_path)
    fold = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for label, loaded, mod, rows in targets:
            base = next(s for s in shards if f"{mod}.weight" in s.keys()).get_tensor(
                f"{mod}.weight").cuda().float()
            a = lora_file.get_tensor(f"transformer.{mod}.lora_A.weight").cuda()
            b = lora_file.get_tensor(f"transformer.{mod}.lora_B.weight").cuda()
            alpha = float(lora_file.get_tensor(f"transformer.{mod}.alpha"))
            delta = LORA_SCALE * (alpha / a.shape[0]) * (b @ a)
            if rows is not None:
                idx = torch.as_tensor(rows, device="cuda")
                base, delta = base[idx], delta[idx]
            err = ((loaded.float() - base) - delta).abs()
            ulp = _bf16_ulp(loaded)
            fold[label] = dict(
                max_abs_err=err.max().item(), max_err_in_ulps=(err / ulp).max().item(),
                max_abs_delta=delta.abs().max().item(), within_ulp=not bool((err > ulp).any()),
                elements=loaded.numel(), changed=int((loaded.float() != base).sum()),
                differ_from_rounded=int((loaded != (base + delta).to(loaded.dtype)).sum()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return fold


def phase_checkpoint() -> dict:
    """Phase 7. The checkpoint stays under CKPT_DIR for the train_main
    phase; main() removes it after the last phase."""
    from PIL import Image

    from textflux_torch.cli.run_inference import render_conditioning, run
    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.config_io import (clip_config_from, t5_config_from,
                                             vae_config_from)
    from textflux_torch.io.params import load_checkpoint_dir
    from textflux_torch.models.vae import (vae_decode, vae_decode_tiled, vae_encode,
                                           vae_encode_tiled)
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope
    from textflux_torch.ops.rope import half_permutation
    from textflux_torch.pipeline.fill import FillPipeline
    from textflux_torch.pipeline.prompts import read_words
    from textflux_torch.rendering import load_font

    gc.collect()
    torch.cuda.empty_cache()
    manifest = load_manifest()
    flux_cfg = flux_fill_config()
    per_step = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    problems, out = [], {}
    with byte_tokenizers("checkpoint"):
        # 1. write the checkpoint
        written, flux = write_checkpoint(manifest)
        stages = written["stages"]
        out["written_bytes"] = written["written_bytes"]

        # 2. the reference: the in-memory DiT, the rest loaded from the files
        t0 = time.perf_counter()
        parts = {}
        for sub, comp in COMPONENTS.items():
            path = os.path.join(CKPT_DIR, sub)
            cfg_from = {"vae": vae_config_from, "clip": clip_config_from,
                        "t5": t5_config_from}[comp]
            parts[comp] = load_checkpoint_dir(path, cfg_from(path), device="cuda")
        ref_pipe = FillPipeline(flux=flux, **parts, clip_tokenize=clip_byte_tokenize,
                                t5_tokenize=t5_byte_tokenize, device="cuda")
        ref_img = run(ref_pipe, *EXAMPLE_PATHS, steps=2, seed=0, sampler="euler")[0]
        # the pipeline half-permuted the DiT in place; main()'s is permuted too
        ref_sums = {k: param_checksum(p) for k, p in flux.named_parameters()}
        del ref_pipe, parts, flux
        gc.collect()
        torch.cuda.empty_cache()
        stages["reference_s"] = time.perf_counter() - t0

        # 3. main() without the LoRA
        outdir = os.path.join(CKPT_DIR, "out")
        argv = ["--model", CKPT_DIR, "--image", EXAMPLE_PATHS[0], "--mask", EXAMPLE_PATHS[1],
                "--words", EXAMPLE_PATHS[2], "--seed", "0", "--output-dir", outdir]
        with _Recorder() as recorder:
            rec = _run_main(argv + ["--steps", "2"], recorder, 2, per_step)
        pipe = recorder.pipe
        sums = {k: param_checksum(p) for k, p in pipe.flux.named_parameters()}
        rec["params_checked"] = len(sums)
        rec["params_differing"] = sorted(k for k in ref_sums if sums.get(k) != ref_sums[k])
        img = np.asarray(Image.open(os.path.join(outdir, "result_0001.png")), np.int32)
        rec["image_max_abs_diff_vs_reference"] = int(np.abs(img - np.asarray(ref_img,
                                                                             np.int32)).max())
        rec["image"] = _image_stats(Image.open(os.path.join(outdir, "result_0001.png")))
        log("checkpoint main " + json.dumps(rec))
        out["main"] = rec
        if rec["params_differing"] or len(sums) != len(ref_sums):
            problems.append(f"loaded DiT differs from the written one in "
                            f"{rec['params_differing'][:5]}")
        if rec["image_max_abs_diff_vs_reference"] != 0:
            problems.append("main() image differs from the in-memory reference by "
                            f"{rec['image_max_abs_diff_vs_reference']}")
        del pipe, recorder
        gc.collect()
        torch.cuda.empty_cache()

        # 4. main() with the LoRA folded in
        with _Recorder() as recorder:
            rec = _run_main(argv + ["--steps", "4", "--lora", os.path.dirname(LORA_PATH)],
                            recorder, 4, per_step)
        pipe = recorder.pipe
        d = flux_cfg.hidden_dim
        per_head = np.concatenate([h * flux_cfg.head_dim + half_permutation(flux_cfg.head_dim)
                                   for h in range(flux_cfg.num_heads)])
        targets = [  # (label, loaded rows, diffusers module, permuted rows)
            ("double_blocks.0.img_qkv[to_q]", pipe.flux.double_blocks[0].img_qkv.weight[:d],
             "transformer_blocks.0.attn.to_q", per_head),
            ("single_blocks.37.linear1[to_v]",
             pipe.flux.single_blocks[37].linear1.weight[2 * d:3 * d],
             "single_transformer_blocks.37.attn.to_v", None),
            ("double_blocks.18.txt_mlp.fc2", pipe.flux.double_blocks[18].txt_mlp.fc2.weight,
             "transformer_blocks.18.ff_context.net.2", None)]
        fold = _fold_check(LORA_PATH, targets)
        for label, f in fold.items():
            if not f["within_ulp"]:
                problems.append(f"LoRA fold of {label} is off by more than one bf16 ulp")
        rec["fold_check"] = fold
        img = Image.open(os.path.join(outdir, "result_0002.png"))
        rec["image"] = _image_stats(img)
        log("checkpoint main+lora " + json.dumps(rec))
        out["main_lora"] = rec
        for key in ("main", "main_lora"):
            r = out[key]
            if r["launches"] != r["expected_launches"]:
                problems.append(f"{key}: fused kernel launched {r['launches']} times, "
                                f"expected {r['expected_launches']}")
            if not r["image"]["finite"] or r["image"]["std"] <= 0:
                problems.append(f"{key}: image not finite/non-constant {r['image']}")
            # loading holds no full-size transient copy on the device
            if r["load_peak_bytes"] > r["models_bytes"] + 2 ** 30:
                problems.append(f"{key}: load peak {r['load_peak_bytes']} > models "
                                f"{r['models_bytes']} + 1 GiB")

        # 5. generate_batch: B=2, padded (kv_len), against the single-item call
        original = Image.open(EXAMPLE_PATHS[0]).convert("RGB")
        mask = Image.open(EXAMPLE_PATHS[1]).convert("RGB")
        words = [read_words(EXAMPLE_PATHS[2]), ["TEXTFLUX"]]
        canvases = [render_conditioning(original, mask, w, load_font(size=60))[:2]
                    for w in words]
        hw = dict(height=432, width=512)   # 27 x 32 = 864 image tokens, padded to 896
        t0 = time.perf_counter()
        flash_attention_qk_norm_rope.launches = 0
        batch = pipe.generate_batch([c[0] for c in canvases], [c[1] for c in canvases], words,
                                    num_inference_steps=2, seeds=[0, 1], seq_pad_multiple=64,
                                    **hw)
        torch.cuda.synchronize()
        batch_launches = flash_attention_qk_norm_rope.launches
        batch_s = time.perf_counter() - t0
        joint = pipe.last_joint_seq
        flash_attention_qk_norm_rope.launches = 0
        single = pipe(image=canvases[0][0], mask_image=canvases[0][1], words=words[0],
                      num_inference_steps=2, seed=0, seq_pad_multiple=64, **hw)[0]
        single_launches = flash_attention_qk_norm_rope.launches
        b0, b1, s0 = (np.asarray(x, np.int32) for x in (batch[0], batch[1], single))
        rec = dict(batch=2, steps=2, joint_seq=joint, kv_len=512 + 864, seconds=batch_s,
                   launches=batch_launches, single_launches=single_launches,
                   expected_launches=per_step * 2,
                   sample0_vs_single_max_abs_diff=int(np.abs(b0 - s0).max()),
                   sample0_vs_single_mean_abs_diff=float(np.abs(b0 - s0).mean()),
                   sample0_vs_sample1_mean_abs_diff=float(np.abs(b0 - b1).mean()),
                   images=[_image_stats(x) for x in batch])
        log("checkpoint generate_batch " + json.dumps(rec))
        out["generate_batch"] = rec
        if batch_launches != per_step * 2 or single_launches != per_step * 2:
            problems.append(f"generate_batch launches {batch_launches}/{single_launches}, "
                            f"expected {per_step * 2}")
        if joint != 512 + 896:
            problems.append(f"generate_batch ran a joint sequence of {joint}, expected 1408")
        if (rec["sample0_vs_single_mean_abs_diff"] > BATCH_MEAN_TOL
                or rec["sample0_vs_single_max_abs_diff"] > BATCH_MAX_TOL):
            problems.append(f"batched sample 0 is {rec['sample0_vs_single_mean_abs_diff']} "
                            f"(mean) / {rec['sample0_vs_single_max_abs_diff']} (largest) from "
                            f"the single-item call, over {BATCH_MEAN_TOL} / {BATCH_MAX_TOL}")
        if rec["sample0_vs_sample1_mean_abs_diff"] <= 1.0:
            problems.append("the two batched samples are the same image")
        if not all(st["finite"] and st["std"] > 0 for st in rec["images"]):
            problems.append("generate_batch image not finite/non-constant")

        # 6. tiled VAE at 1536 x 1536, full width, against the untiled pass
        big = original.resize((1536, 1536))
        x = torch.as_tensor(np.asarray(big, np.float32) / 127.5 - 1.0,
                            device="cuda")[None].to(torch.bfloat16)
        t0 = time.perf_counter()
        with torch.inference_mode():
            z_tiled = vae_encode_tiled(pipe.vae, x, tile=128)
            dec_tiled = vae_decode_tiled(pipe.vae, z_tiled, tile=128)
            torch.cuda.synchronize()
            tiled_s = time.perf_counter() - t0
            z_full = vae_encode(pipe.vae, x)
            dec_full = vae_decode(pipe.vae, z_tiled)
        torch.cuda.synchronize()
        rec = dict(canvas=[1536, 1536], latent=list(z_tiled.shape), tile=128, overlap=16,
                   tiled_s=tiled_s,
                   finite=bool(torch.isfinite(z_tiled).all() and torch.isfinite(dec_tiled).all()),
                   encode_max_abs_diff_vs_untiled=(z_tiled.float() - z_full.float()).abs().max().item(),
                   decode_max_abs_diff_vs_untiled=(dec_tiled.float() - dec_full.float()).abs().max().item(),
                   encode_latent_max_abs=z_full.float().abs().max().item())
        log("checkpoint tiled_vae " + json.dumps(rec))
        out["tiled_vae"] = rec
        if not rec["finite"]:
            problems.append("tiled VAE output is not finite")
        del pipe, x, z_tiled, dec_tiled, z_full, dec_full
    gc.collect()
    torch.cuda.empty_cache()
    out["stages"] = stages
    log("checkpoint stages " + json.dumps(stages))
    if problems:
        raise AssertionError("checkpoint phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 8. train_main: LoRA training from a data directory through cli.train.main
# ---------------------------------------------------------------------------

TRAIN_MAIN_STEPS = 4
# run A checkpoints at this step, run B resumes from it: one 7.17 GB Prodigy
# checkpoint (factors + four fp32 state copies) is what the GPU machine's
# disk-write budget (45 GiB per run of this script, deleted files included)
# leaves beside phase 7's 35.4 GB checkpoint and the two 1.43 GB exports
TRAIN_MAIN_CKPT_STEP = 3
# the example images with the bounding quad (x0, y0, x1, y1) of each one's
# mask and the word written there
TRAIN_MAIN_ITEMS = (("ori_0001.png", "OPEN", (102, 128, 409, 256)),
                    ("ori_0002.png", "CAFE 24H", (128, 160, 512, 320)))


class _TrainMainRecorder:
    """Instruments one cli.train.main() run from outside, while the block
    runs:
    - data.loader.BucketedLoader.__iter__: the host's seconds waiting in
      next() and each batch's bucket; a CUDA event when a batch is handed
      out (its step's start);
    - training.train.make_train_step: a CUDA event when each step returns
      (its end) and the flash kernels' launch counts after it;
    - io.params.load_checkpoint_dir: seconds and bytes by component;
    - training.train.lora_insert: the base checksum when the factors are
      attached, and each target's B checksum (the model and the factors
      are held only while the block runs);
    - training.train.make_optimizer: the optimizer;
    - cli.train.load_train_state: each target's B checksum after the copy,
      and the live state (factors, optimizer state, step) against
      `resume_file` bitwise;
    - training.checkpoint.CheckpointManager.save: its time on the training
      thread (the device synchronised first), by step;
    - CheckpointManager._write: the background write's seconds and, once
      the checkpoint of `link_step` is written, a hard-linked copy of it
      under `<link_to>/checkpoints/` (no second copy of its bytes on
      disk)."""

    def __init__(self, link_step=None, link_to=None, resume_file=None):
        self.link_step, self.link_to, self.resume_file = link_step, link_to, resume_file
        self.waits, self.buckets, self.starts, self.ends, self.counts = [], [], [], [], []
        self.load, self.model, self.checksum0 = {}, None, None
        self.lora, self.opt, self.b_sums, self.resume = None, None, {}, None
        self.saves, self.writes = [], []
        self._undo = []

    @staticmethod
    def _b_checksums(lora) -> dict:
        return {path: param_checksum(f["b"]) for path, f in lora.items()}

    def b_moved(self) -> list:
        """The targets whose B differs from its value after the init (or the
        resume's copy)."""
        return [p for p, s in self._b_checksums(self.lora).items() if s != self.b_sums[p]]

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        from textflux_torch.cli import train as CLI
        from textflux_torch.data.loader import BucketedLoader
        from textflux_torch.io import params as P
        from textflux_torch.ops import flash_attention as FA
        from textflux_torch.training import train as TR
        from textflux_torch.training.checkpoint import CheckpointManager

        def loader_iter(orig):
            def timed(loader):
                it = orig(loader)
                try:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        self.waits.append(time.perf_counter() - t0)
                        self.buckets.append(list(batch["bucket"]))
                        ev = torch.cuda.Event(enable_timing=True)
                        ev.record()
                        self.starts.append(ev)
                        yield batch
                finally:
                    it.close()
            return timed

        def make_step(orig):
            def make(tc, **kw):
                step = orig(tc, **kw)

                def timed(*a, **k):
                    metrics = step(*a, **k)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.ends.append(ev)
                    self.counts.append({n: getattr(FA, n).launches for n in FLASH_KERNELS})
                    return metrics
                return timed
            return make

        def load(orig):
            def timed(path, cfg, **kw):
                t0 = time.perf_counter()
                module = orig(path, cfg, **kw)
                torch.cuda.synchronize()
                self.load[os.path.basename(os.path.normpath(path))] = dict(
                    seconds=time.perf_counter() - t0, bytes=P.checkpoint_bytes(path))
                return module
            return timed

        def insert(orig):
            def checked(model, lora, scale):
                self.model, self.checksum0 = model, TR.base_checksum(model)
                self.lora, self.b_sums = lora, self._b_checksums(lora)
                return orig(model, lora, scale)
            return checked

        def make_opt(orig):
            def kept(tc, params):
                self.opt = orig(tc, params)
                return self.opt
            return kept

        def load_state(orig):
            def compared(lora, opt, state):
                step = orig(lora, opt, state)
                self.b_sums = self._b_checksums(lora)
                saved = torch.load(self.resume_file, map_location="cpu", mmap=True,
                                   weights_only=True)
                n, bad = _tree_mismatches(CLI.train_state(lora, opt, step), saved)
                self.resume = dict(step=step, compared_with=self.resume_file,
                                   tensors_compared=n, mismatches=bad[:5], equal=not bad)
                return step
            return compared

        def save(orig):
            def timed(mgr, step, state, *, wait=False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig(mgr, step, state, wait=wait)
                self.saves.append(dict(step=step, wait=wait,
                                       host_ms=1e3 * (time.perf_counter() - t0)))
            return timed

        def write(orig):
            def linked(mgr, step, host_state):
                t0 = time.perf_counter()
                orig(mgr, step, host_state)
                self.writes.append(dict(step=step, seconds=time.perf_counter() - t0))
                if step == self.link_step:
                    shutil.copytree(os.path.join(mgr.directory, str(step)),
                                    os.path.join(self.link_to, "checkpoints", str(step)),
                                    copy_function=os.link)
            return linked

        self._patch(BucketedLoader, "__iter__", loader_iter)
        self._patch(TR, "make_train_step", make_step)
        self._patch(P, "load_checkpoint_dir", load)
        self._patch(TR, "lora_insert", insert)
        self._patch(TR, "make_optimizer", make_opt)
        self._patch(CLI, "load_train_state", load_state)
        self._patch(CheckpointManager, "save", save)
        self._patch(CheckpointManager, "_write", write)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self.model = self.lora = self.opt = None

    def per_step_launches(self) -> list:
        prev, out = {n: 0 for n in FLASH_KERNELS}, []
        for c in self.counts:
            out.append({n: c[n] - prev[n] for n in FLASH_KERNELS})
            prev = c
        return out


def train_main_json(work: str) -> str:
    """The AnyWord json of TRAIN_MAIN_ITEMS under `work` (images: the
    example directory)."""
    data_json = os.path.join(work, "anyword.json")
    with open(data_json, "w") as f:
        json.dump({"data_list": [
            {"img_name": name, "annotations": [
                {"text": text, "polygon": [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]}]}
            for name, text, (x0, y0, x1, y1) in TRAIN_MAIN_ITEMS]}, f)
    return data_json


def _tree_mismatches(live, saved, path: str = "state") -> tuple:
    """(the tensors compared, the paths that differ) between a live nested
    state and a saved one: tensors bitwise (shape, dtype and every bit, on
    the live one's device), numbers by value, dicts and lists by
    structure."""
    if isinstance(live, torch.Tensor):
        same = (isinstance(saved, torch.Tensor) and saved.shape == live.shape
                and saved.dtype == live.dtype and torch.equal(live, saved.to(live.device)))
        return 1, [] if same else [path]
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            return 0, [path]
        pairs = [(live[k], saved[k], f"{path}.{k}") for k in live]
    elif isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            return 0, [path]
        pairs = [(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(live, saved))]
    else:
        return 0, [] if live == saved else [path]
    n, bad = 0, []
    for x, y, p in pairs:
        m, b = _tree_mismatches(x, y, p)
        n, bad = n + m, bad + b
    return n, bad


def _train_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train_main(smi: str, have_checkpoint: bool) -> dict:
    """LoRA training from a data directory through cli.train.main() at full
    width: an AnyWord json over the two example images, the checkpoint of
    phase 7 (written here when that phase did not run), Prodigy at lr 1.
    Run A trains 4 steps, checkpointing at step 3 (one kept); run B
    resumes a hard-linked copy of A's step-3 checkpoint to step 4; A's
    exported LoRA is then served for 2 steps. Launches per step, finite
    losses, the rotation, B's log, the export's keys and rank, the base
    checksum, the profile trace and the round trip's fused launches are
    checked."""
    from textflux_torch.cli import train as CLI
    from textflux_torch.cli.run_inference import run
    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.safetensors import SafetensorsFile
    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope
    from textflux_torch.pipeline.fill import FillPipeline
    from textflux_torch.training import train as TR
    from textflux_torch.training.checkpoint import STATE_FILE, CheckpointManager

    gc.collect()
    torch.cuda.empty_cache()
    manifest = load_manifest()
    if not have_checkpoint:
        _, flux = write_checkpoint(manifest)
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    work = os.path.join(CKPT_DIR, "train_main")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_json = train_main_json(work)
    out_a, out_b = os.path.join(work, "a"), os.path.join(work, "b")
    disk_free, mem_free = _free_bytes(work)
    factor_bytes = 4 * sum(int(np.prod(v)) for k, v in manifest["lora"].items()
                           if k.endswith(("lora_A.weight", "lora_B.weight")))
    log(f"train_main: writes ~{7 * factor_bytes} bytes (one Prodigy checkpoint of 5x the "
        f"{factor_bytes} bytes of factors, two exports); disk free {disk_free}, host "
        f"MemAvailable {mem_free}")
    flux_cfg = flux_fill_config()
    blocks = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    per_step = {"flash_attention": 2 * blocks, "flash_attention_lse": 0,
                "flash_attention_dq": blocks, "flash_attention_dkv": blocks}
    common = ["--model", CKPT_DIR, "--data-json", data_json,
              "--data-images", os.path.join(EXAMPLE, "ori"), "--mode", "lora",
              "--optimizer", "prodigy", "--learning-rate", "1",
              "--resolution", str(TRAIN_RESOLUTION), "--train-batch-size", "1",
              "--grad-accum", "1", "--max-train-steps", str(TRAIN_MAIN_STEPS),
              "--checkpointing-steps", str(TRAIN_MAIN_CKPT_STEP),
              "--checkpoints-total-limit", "1",
              "--log-every", "1", "--seed", "0"]
    problems, out = [], {}
    a_state = os.path.join(out_a, "checkpoints", str(TRAIN_MAIN_CKPT_STEP), STATE_FILE)
    with byte_tokenizers("train_main"):
        resumed = list(range(TRAIN_MAIN_CKPT_STEP + 1, TRAIN_MAIN_STEPS + 1))
        for name, extra, hooks, want_steps in (
                ("A", ["--output-dir", out_a, "--profile-steps", "1"],
                 dict(link_step=TRAIN_MAIN_CKPT_STEP, link_to=out_b),
                 list(range(1, TRAIN_MAIN_STEPS + 1))),
                ("B", ["--output-dir", out_b, "--resume-from-checkpoint",
                       str(TRAIN_MAIN_CKPT_STEP)], dict(resume_file=a_state), resumed)):
            for k in FLASH_KERNELS:
                getattr(FA, k).launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _TrainMainRecorder(**hooks) as rec:
                CLI.main(common + extra)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                checksum1 = TR.base_checksum(rec.model)
                # B starts at 0 (or at the resumed copy): an update that did
                # nothing leaves it there
                b_moved = rec.b_moved()
                estim_lr = (float(rec.opt.state["estim_lr"])
                            if isinstance(rec.opt, TR.ClippedProdigy) else None)
            train_log = _train_log(extra[1])
            by_step = rec.per_step_launches()
            r = dict(card=smi, seconds=seconds, steps=[e["step"] for e in train_log],
                     loss=[e["loss"] for e in train_log],
                     grad_norm=[e["grad_norm"] for e in train_log],
                     step_ms=[s.elapsed_time(e) for s, e in zip(rec.starts, rec.ends)],
                     data_wait_ms=[1e3 * w for w in rec.waits],
                     bucket_hw=rec.buckets,
                     joint_seq=[512 + (h // 16) * (w // 16) for h, w in rec.buckets],
                     load=rec.load, launches={k: getattr(FA, k).launches for k in FLASH_KERNELS},
                     launches_per_step=by_step, expected_per_step=per_step,
                     max_memory_allocated=torch.cuda.max_memory_allocated(),
                     base_checksum=[rec.checksum0, checksum1],
                     b_targets=len(rec.b_sums), b_targets_moved=len(b_moved),
                     prodigy_estim_lr=estim_lr, save=rec.saves, write=rec.writes,
                     resume=rec.resume,
                     checkpoints=CheckpointManager(os.path.join(extra[1], "checkpoints")).all_steps())
            if name == "A":
                prof = os.path.join(out_a, "profile")
                r["profile_files"] = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
            log(f"train_main {name} " + json.dumps(r))
            out[name] = r
            del rec
            gc.collect()
            torch.cuda.empty_cache()
            if r["steps"] != want_steps:
                problems.append(f"run {name} logged steps {r['steps']}, expected {want_steps}")
            if not all(np.isfinite(r["loss"])) or not all(np.isfinite(r["grad_norm"])):
                problems.append(f"run {name}: non-finite loss or grad norm")
            if len(by_step) != len(want_steps) or any(c != per_step for c in by_step):
                problems.append(f"run {name} launched {by_step}, expected {per_step} a step")
            if checksum1 != r["base_checksum"][0]:
                problems.append(f"run {name} changed the base weights")
            if not r["b_targets"] or r["b_targets_moved"] != r["b_targets"]:
                problems.append(f"run {name}: B of {r['b_targets'] - r['b_targets_moved']} of "
                                f"{r['b_targets']} LoRA targets did not move")
            if name == "B" and not (r["resume"] and r["resume"]["equal"]):
                problems.append(f"run B's state after the resume is not A's step-"
                                f"{TRAIN_MAIN_CKPT_STEP} checkpoint: {r['resume']}")
            if r["checkpoints"] != [TRAIN_MAIN_CKPT_STEP]:
                problems.append(f"run {name} left checkpoints {r['checkpoints']}, expected "
                                f"[{TRAIN_MAIN_CKPT_STEP}] alone")
        if not any(f.endswith(".json") for f in out["A"]["profile_files"]):
            problems.append("run A wrote no profile trace")

        # the export: the manifest's LoRA keys, rank 128; A against B
        exported = {}
        for name, path in (("A", out_a), ("B", out_b)):
            with SafetensorsFile(os.path.join(path, "pytorch_lora_weights.safetensors")) as f:
                exported[name] = {k: f.get_tensor(k).cuda() for k in f.keys()}
        keys = {k for k in exported["A"] if k.endswith(("lora_A.weight", "lora_B.weight"))}
        want_keys = {k for k in manifest["lora"] if k.endswith(("lora_A.weight", "lora_B.weight"))}
        shapes_ok = all(list(exported["A"][k].shape) == manifest["lora"][k] for k in keys & want_keys)
        ranks = sorted({int(exported["A"][k].shape[0]) for k in keys if k.endswith("lora_A.weight")})
        a_vs_b = max((exported["A"][k].float() - exported["B"][k].float()).abs().max().item()
                     for k in exported["A"])
        rec = dict(lora_keys=len(keys), manifest_lora_keys=len(want_keys),
                   keys_equal=keys == want_keys, shapes_equal=shapes_ok, ranks=ranks,
                   a_vs_b_max_abs_diff=a_vs_b)
        del exported
        if keys != want_keys or not shapes_ok or ranks != [LORA_RANK]:
            problems.append(f"exported LoRA: {rec}")

        # the round trip: A's export served through from_pretrained
        flash_attention_qk_norm_rope.launches = 0
        t0 = time.perf_counter()
        pipe = FillPipeline.from_pretrained(CKPT_DIR, lora_path=out_a, device="cuda")
        img = run(pipe, *EXAMPLE_PATHS, steps=2, seed=0, sampler="euler")[0]
        torch.cuda.synchronize()
        rec.update(round_trip_seconds=time.perf_counter() - t0,
                   round_trip_load=pipe.load_stats,
                   round_trip_launches=flash_attention_qk_norm_rope.launches,
                   round_trip_expected_launches=2 * blocks, image=_image_stats(img), card=smi)
        # the served DiT holds A's export: two unpermuted targets against the
        # base + scale * B @ A; B is small after 4 steps at Prodigy's first D,
        # so most elements round back to the base, but some must change
        d = flux_cfg.hidden_dim
        rec["fold_check"] = _fold_check(
            os.path.join(out_a, "pytorch_lora_weights.safetensors"),
            [("double_blocks.18.txt_mlp.fc2", pipe.flux.double_blocks[18].txt_mlp.fc2.weight,
              "transformer_blocks.18.ff_context.net.2", None),
             ("single_blocks.37.linear1[to_v]",
              pipe.flux.single_blocks[37].linear1.weight[2 * d:3 * d],
              "single_transformer_blocks.37.attn.to_v", None)])
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        log("train_main export " + json.dumps(rec))
        out["export"] = rec
        if rec["round_trip_launches"] != 2 * blocks:
            problems.append(f"round trip launched the fused kernel {rec['round_trip_launches']} "
                            f"times, expected {2 * blocks}")
        for label, f in rec["fold_check"].items():
            if (not f["within_ulp"] or f["changed"] == 0
                    or f["differ_from_rounded"] > f["changed"] // 100):
                problems.append(f"round trip: the served {label} is not the base with A's "
                                f"export folded in: {f}")
        if not rec["image"]["finite"] or rec["image"]["std"] <= 0:
            problems.append(f"round trip image not finite/non-constant {rec['image']}")
    if problems:
        raise AssertionError("train_main phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 9. quantized: serve the checkpoint quantised through cli.run_inference.main
# ---------------------------------------------------------------------------

QUANT_MODES = ("weight_only", "w8a8", "nf4", "mixed")
# the JAX package's bounds on the relative velocity error of a quantised
# full-width 1-double + 1-single stack against the same stack in bf16
# (tests/test_quantize.py); mixed must also stay under nf4's error / 3
QUANT_BOUNDS = {"weight_only": 0.02, "w8a8": 0.03, "nf4": 0.25, "mixed": 0.05}
QUANT_STEPS = 2


def _rel_l2(out, ref) -> float:
    a, b = out.double(), ref.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def stack_divergence() -> dict:
    """Each mode's relative velocity error on a full-width 1-double +
    1-single stack (random bf16 weights from seed 0) against the same stack
    in bf16, on the JAX test's inputs (32 text + 128 image tokens, seeded
    normal draws, timestep 0.5, guidance 30), plain attention."""
    import copy

    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.quantize import quantize_tree
    from textflux_torch.models.transformer import FluxTransformer, flux_apply
    from textflux_torch.ops import packing
    from textflux_torch.ops.rope import rope_tables

    cfg = dataclasses.replace(flux_fill_config(), num_double_layers=1, num_single_layers=1)
    base = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    ids = np.concatenate([packing.text_ids(32), packing.latent_image_ids(16, 32)], 0)
    cos, sin = (torch.as_tensor(x, device="cuda")
                for x in rope_tables(ids, cfg.axes_dims_rope, cfg.rope_theta))
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device="cuda").to(torch.bfloat16)

    args = (draw(1, 128, cfg.in_channels), draw(1, 32, cfg.joint_dim), draw(1, cfg.pooled_dim),
            torch.tensor([0.5], device="cuda", dtype=torch.bfloat16),
            torch.tensor([30.0], device="cuda"), cos, sin)
    with torch.inference_mode():
        ref = flux_apply(base, *args, attn_impl="plain")
    out = {}
    for mode in QUANT_MODES:
        q = quantize_tree(copy.deepcopy(base), mode=mode)
        with torch.inference_mode():
            out[mode] = _rel_l2(flux_apply(q, *args, attn_impl="plain"), ref)
        del q
    del base
    return out


def _full_depth_inputs(flux_cfg):
    """One full-depth DiT forward's inputs at the serving shape (512 text +
    896 image tokens), seeded, with the fused path's rotate-half tables."""
    from textflux_torch.ops import packing
    from textflux_torch.ops.rope import rope_tables_half

    ids = np.concatenate([packing.text_ids(512), packing.latent_image_ids(56, 64)], 0)
    cos, sin = (torch.as_tensor(x, device="cuda")
                for x in rope_tables_half(ids, flux_cfg.axes_dims_rope, flux_cfg.rope_theta))
    g = torch.Generator(device="cuda").manual_seed(7)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    return (draw(1, 896, flux_cfg.in_channels), draw(1, 512, flux_cfg.joint_dim),
            draw(1, flux_cfg.pooled_dim), torch.tensor([0.5], device="cuda", dtype=torch.bfloat16),
            torch.tensor([30.0], device="cuda"), cos, sin)


def phase_quantized(smi: str, have_checkpoint: bool, profile: bool = False) -> dict:
    """Phase 9. Phase 7's checkpoint (written here when no earlier phase
    did) served through cli.run_inference.main with --quantize-mode
    weight_only, w8a8, nf4 and mixed (T5 int8 weight-only with each), then
    with --staged-text (weight_only), 2 euler steps at the 512 px
    single-line shape. Per run: load seconds, GB/s and device bytes by
    component, the device's peak over the load and over serving, step ms,
    fused launches per step, and the relative velocity error of one
    full-depth forward of the served DiT against the bf16 DiT on the same
    inputs. Fails when a mode breaks the JAX package's divergence bound on
    the full-width 1+1 stack, when the weight_only load peaks more than
    1 GiB above the loaded models' bytes, or when a launch count, the
    quantised modules or an image are wrong. With `profile`, one more
    denoise step of each mode is traced (device time by kernel, idle
    share)."""
    from PIL import Image

    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.quantize import quantized_linears
    from textflux_torch.models.transformer import (FluxTransformer, flux_apply,
                                                   half_permute_flux_params)

    gc.collect()
    torch.cuda.empty_cache()
    if not have_checkpoint:
        _, flux = write_checkpoint(load_manifest())
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    flux_cfg = flux_fill_config()
    per_step = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    problems, out = [], {}

    t0 = time.perf_counter()
    stack = stack_divergence()
    log("quantized stack " + json.dumps(dict(card=smi, rel_err=stack, bounds=QUANT_BOUNDS,
                                             seconds=time.perf_counter() - t0)))
    out["stack_rel_err"] = stack
    for mode, bound in QUANT_BOUNDS.items():
        if not stack[mode] < bound:
            problems.append(f"{mode}: stack velocity error {stack[mode]} >= {bound}")
    if not stack["mixed"] < stack["nf4"] / 3:
        problems.append(f"mixed's stack error {stack['mixed']} is not under nf4's / 3")
    gc.collect()
    torch.cuda.empty_cache()

    # the bf16 reference of the full-depth forward: the checkpoint's DiT is
    # the seed-0 model, half-permuted as the served one is
    inputs = _full_depth_inputs(flux_cfg)
    ref_flux = half_permute_flux_params(FluxTransformer(
        flux_cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0)))
    with torch.inference_mode():
        ref_v = flux_apply(ref_flux, *inputs, attn_impl="fused")
    del ref_flux
    gc.collect()
    torch.cuda.empty_cache()

    outdir = os.path.join(CKPT_DIR, "quantized_out")
    shutil.rmtree(outdir, ignore_errors=True)   # result_000<i + 1> is run i's
    argv = ["--model", CKPT_DIR, "--image", EXAMPLE_PATHS[0], "--mask", EXAMPLE_PATHS[1],
            "--words", EXAMPLE_PATHS[2], "--seed", "0", "--steps", str(QUANT_STEPS),
            "--output-dir", outdir]
    with byte_tokenizers("quantized"):
        runs = [(mode, ["--quantize-mode", mode]) for mode in QUANT_MODES]
        runs.append(("staged_weight_only", ["--quantize-mode", "weight_only", "--staged-text"]))
        for i, (name, extra) in enumerate(runs):
            mode = extra[1]
            with _Recorder() as recorder:
                rec = _run_main(argv + extra, recorder, QUANT_STEPS, per_step)
            pipe = recorder.pipe
            rec.update(card=smi, mode=mode, step_ms=recorder.step_ms(),
                       serve_peak_bytes=torch.cuda.max_memory_allocated(),
                       launches_per_step=rec["launches"] / QUANT_STEPS,
                       dit_device_bytes=pipe.load_stats["transformer"]["device_bytes"],
                       t5_device_bytes=pipe.load_stats["t5"]["device_bytes"],
                       dit_modes=sorted(set(quantized_linears(pipe.flux).values())),
                       dit_quantized_linears=len(quantized_linears(pipe.flux)),
                       # a staged run has released T5: its load_stats remain
                       t5_modes=(None if pipe.t5 is None
                                 else sorted(set(quantized_linears(pipe.t5).values()))))
            with torch.inference_mode():
                rec["full_depth_rel_err"] = _rel_l2(
                    flux_apply(pipe.flux, *inputs, attn_impl="fused"), ref_v)
            rec["image"] = _image_stats(Image.open(os.path.join(outdir,
                                                                f"result_{i + 1:04d}.png")))
            log(f"quantized {name} " + json.dumps(rec))
            if profile and name in QUANT_MODES:
                profile_step(recorder.last_step, what=f"quantized {name} denoise step")
            out[name] = rec
            del pipe, recorder
            gc.collect()
            torch.cuda.empty_cache()
            # at full width every input is a multiple of 128: no nf4 fallback
            want_modes = ["nf4", "weight_only"] if mode == "mixed" else [mode]
            if rec["launches"] != rec["expected_launches"]:
                problems.append(f"{name}: fused kernel launched {rec['launches']} times, "
                                f"expected {rec['expected_launches']}")
            t5_stats = rec["load"]["t5"]
            if (rec["dit_modes"] != want_modes or rec["t5_modes"] not in (None, ["weight_only"])
                    or t5_stats["device_bytes"] > 0.55 * t5_stats["bytes"]):
                problems.append(f"{name}: DiT modes {rec['dit_modes']} (expected {want_modes}),"
                                f" T5 {rec['t5_modes']}, {t5_stats}")
            if not rec["image"]["finite"] or rec["image"]["std"] <= 0:
                problems.append(f"{name}: image not finite/non-constant {rec['image']}")
            if not np.isfinite(rec["full_depth_rel_err"]):
                problems.append(f"{name}: the full-depth forward is not finite")
        # loading holds no full-size transient copy on the device
        r = out["weight_only"]
        if r["load_peak_bytes"] > r["models_bytes"] + 2 ** 30:
            problems.append(f"weight_only: load peak {r['load_peak_bytes']} > models "
                            f"{r['models_bytes']} + 1 GiB")
    if problems:
        raise AssertionError("quantized phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 10. qlora: LoRA over a quantised base with 8-bit AdamW, in memory
# ---------------------------------------------------------------------------

QLORA_STEPS = 3


def _qlora_run(base_mode: str, steps: int, models, sample, per_step) -> dict:
    """`steps` LoRA steps (rank 128, alpha 128, adamw8bit at lr 2e-5, clip
    1.0) through train_lora over the seed-0 full-width DiT quantised in
    place with `base_mode`; launch counts, step ms, peak, the optimizer's
    state bytes, and each target's B against its zero init."""
    from textflux_torch.cli.train import train_lora
    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.quantize import quantize_tree, quantized_bytes, quantized_linears
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.training import train as TR
    from textflux_torch.training.optim8bit import state_bytes

    vae, clip, t5 = models
    t0 = time.perf_counter()
    flux = FluxTransformer(flux_fill_config(), device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    bf16_bytes = quantized_bytes(flux)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    quantize_tree(flux, mode=base_mode)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t1
    base_bytes = quantized_bytes(flux)   # before the factors are attached
    tc = TR.TrainConfig(optimizer="adamw8bit")   # lr 2e-5, clip 1.0, rank 128, alpha 128
    starts, ends, counts = [], [], []

    def batches():
        while True:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield sample

    def on_step(step, metrics, lora):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        counts.append({k: getattr(FA, k).launches for k in FLASH_KERNELS})

    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = {}
    lora, history = train_lora(flux, vae, clip, t5, batches(), tc=tc,
                               clip_tokenize=clip_byte_tokenize, t5_tokenize=t5_byte_tokenize,
                               steps=steps, seed=0, log_every=1, on_step=on_step, state=state)
    torch.cuda.synchronize()
    prev, by_step = {k: 0 for k in FLASH_KERNELS}, []
    for c in counts:
        by_step.append({k: c[k] - prev[k] for k in FLASH_KERNELS})
        prev = c
    n_params = sum(p.numel() for p in TR.lora_parameters(lora))
    rec = dict(base=base_mode, steps=steps, init_s=t1 - t0, quantize_s=quantize_s,
               dit_bf16_bytes=bf16_bytes, dit_device_bytes=base_bytes,
               dit_modes=sorted(set(quantized_linears(flux).values())),
               step_ms=[s.elapsed_time(e) for s, e in zip(starts, ends)],
               history=history, launches={k: getattr(FA, k).launches for k in FLASH_KERNELS},
               launches_per_step=by_step, expected_per_step=per_step,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               lora_params=n_params, state_bytes=state_bytes(state["opt_state"]),
               # torch's AdamW: two float32 moments and a float32 step per tensor
               adamw_state_bytes=8 * n_params + 4 * 2 * len(lora),
               b_targets=len(lora),
               b_targets_moved=sum(bool(f["b"].detach().abs().max() > 0) for f in lora.values()))
    del flux, lora, state
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_qlora(smi: str) -> dict:
    """Phase 10, in memory (like phase 6: weights made on the card from
    seed 0, nothing written to disk): 3 QLoRA steps over an nf4 base with
    adamw8bit at 4,224 tokens, then one step over a weight_only base.
    Fails on a non-finite loss, a launch count other than 114/0/57/57 a
    step, or a target whose B did not move."""
    from textflux_torch.config import clip_l_config, flux_fill_config, flux_vae_config, t5_xxl_config
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.vae import FluxVAE

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    models = (FluxVAE(flux_vae_config(), device="cuda", dtype=dt, generator=gen),
              CLIPTextModel(clip_l_config(), device="cuda", dtype=dt, generator=gen),
              T5Encoder(t5_xxl_config(), device="cuda", dtype=dt, generator=gen))
    sample = training_sample()
    _, _, hp, wp, _ = sample["pixel_values"].shape
    flux_cfg = flux_fill_config()
    blocks = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    per_step = {"flash_attention": 2 * blocks, "flash_attention_lse": 0,
                "flash_attention_dq": blocks, "flash_attention_dkv": blocks}
    out, problems = {}, []
    for base_mode, steps in (("nf4", QLORA_STEPS), ("weight_only", 1)):
        rec = _qlora_run(base_mode, steps, models, sample, per_step)
        rec.update(card=smi, joint_seq=512 + (hp // 16) * (wp // 16))
        log(f"qlora {base_mode} " + json.dumps(rec))
        out[base_mode] = rec
        for e in rec["history"]:
            if not (np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
                    and e["grad_norm"] > 0):
                problems.append(f"{base_mode} step {e['step']}: loss {e['loss']} "
                                f"grad_norm {e['grad_norm']}")
        if len(rec["launches_per_step"]) != steps or any(
                c != per_step for c in rec["launches_per_step"]):
            problems.append(f"{base_mode}: launched {rec['launches_per_step']}, "
                            f"expected {per_step} a step")
        if rec["b_targets_moved"] != rec["b_targets"]:
            problems.append(f"{base_mode}: B of {rec['b_targets'] - rec['b_targets_moved']} "
                            f"of {rec['b_targets']} targets did not move")
        if rec["dit_modes"] != [base_mode]:
            problems.append(f"{base_mode}: DiT modes {rec['dit_modes']}")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("qlora phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 11. eval: batch evaluation, the demo callbacks, t2i and the metric harnesses
# ---------------------------------------------------------------------------

EVAL_STEPS = 2
T2I_STEPS, T2I_SIZE = 4, 512
# (img_name, example image, words file, quad of the example's mask): the two
# example images, the first again under a second directory with the
# second's words, so one //32 bucket holds two items (a batch of 2 at
# --batch-size 2) and every img_name carries a subdirectory (safe_name)
EVAL_ITEMS = (("ex1/ori_0001.png", "ori_0001.png", "words_0001.txt", (102, 128, 409, 256)),
              ("ex2/ori_0001.png", "ori_0001.png", "words_0002.txt", (102, 128, 409, 256)),
              ("ex1/ori_0002.png", "ori_0002.png", "words_0002.txt", (128, 160, 512, 320)))
# the card (true float32) against the port on the CPU, same weights and
# inputs (tests/test_torch_cuda.py holds the same): Inception pool3 within
# EVAL_FEATURE_TOL of the largest |feature|, LPIPS within EVAL_LPIPS_RTOL,
# PP-OCR logits within EVAL_LOGIT_TOL (they are O(1)) with the same text
EVAL_FEATURE_TOL, EVAL_LPIPS_RTOL, EVAL_LOGIT_TOL = 1e-4, 1e-4, 1e-4
PPOCR_CHARS = 6623   # ppocr_keys_v1's lines: + 'sos' + ' ' = the 6625 classes
EVAL_BATCH_TOL = 1   # grey levels between --batch-size 1 and 2


def _eval_data(work: str) -> tuple:
    """The AnyWord json and the images directory of EVAL_ITEMS."""
    from textflux_torch.pipeline.prompts import read_words

    imgs = os.path.join(work, "imgs")
    data = {"data_list": []}
    for name, src, words, (x0, y0, x1, y1) in EVAL_ITEMS:
        os.makedirs(os.path.dirname(os.path.join(imgs, name)), exist_ok=True)
        shutil.copy(os.path.join(EXAMPLE, "ori", src), os.path.join(imgs, name))
        text = " ".join(read_words(os.path.join(EXAMPLE, "txt", words)))
        data["data_list"].append({"img_name": name, "annotations": [
            {"text": text, "polygon": [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]}]})
    path = os.path.join(work, "anyword.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path, imgs


def _run_eval_main(argv, recorder, expected_launches) -> dict:
    from textflux_torch.cli.run_eval import main as run_eval_main
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope

    torch.cuda.synchronize()
    flash_attention_qk_norm_rope.launches = 0
    t0 = time.perf_counter()
    run_eval_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out_dir = argv[argv.index("--output-dir") + 1]
    with open(os.path.join(out_dir, "failures.json")) as f:
        report = json.load(f)
    load_s = sum(v["seconds"] for v in recorder.rec.get("load", {}).values())
    step_ms = recorder.step_ms()
    return dict(seconds=seconds, load_seconds=load_s,
                s_per_item=(seconds - load_s) / max(report["done"], 1),
                step_ms=step_ms, mean_step_ms=float(np.mean(step_ms)) if step_ms else None,
                joint_seq_last=recorder.pipe.last_joint_seq if recorder.pipe else None,
                launches=flash_attention_qk_norm_rope.launches,
                expected_launches=expected_launches,
                serve_peak_bytes=torch.cuda.max_memory_allocated(),
                report={k: report[k] for k in ("total", "done", "failed", "skipped_existing")},
                failures=report["failures"])


def _images_diff(dir_a: str, dir_b: str) -> dict:
    out = {}
    for sub in ("full_images", "cropped_images"):
        names_a = sorted(os.listdir(os.path.join(dir_a, sub)))
        if names_a != sorted(os.listdir(os.path.join(dir_b, sub))):
            raise AssertionError(f"{sub}: {dir_a} and {dir_b} hold other files")
        diffs = [np.abs(np.asarray(_open_rgb(os.path.join(dir_a, sub, n)), np.int16)
                        - np.asarray(_open_rgb(os.path.join(dir_b, sub, n)), np.int16))
                 for n in names_a]
        out[sub] = dict(files=names_a, max_abs_diff=int(max(d.max() for d in diffs)),
                        mean_abs_diff=float(np.mean([d.mean() for d in diffs])))
    return out


def _open_rgb(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def _timed_steps(pipe) -> list:
    """CUDA events around each of `pipe`'s denoise steps from now on."""
    events, inner = [], pipe._denoise_step

    def timed(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(*a, **kw)
        e.record()
        events.append((s, e))
        return out

    pipe._denoise_step = timed
    return events


def _eval_demo(pipe, per_step: int) -> dict:
    """The demo callbacks on the loaded pipeline (the default overshoot
    sampler), with the example's mask as the sketch; check_gradio raises
    the JAX package's message (gradio is not installed on the card)."""
    from textflux_torch.cli import demo as D
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope

    original = _open_rgb(os.path.join(EXAMPLE, "ori", "ori_0001.png"))
    sketch = {"image": original, "mask": _open_rgb(os.path.join(EXAMPLE, "mask",
                                                                "mask_0001.png"))}
    out, problems = {}, []
    events = _timed_steps(pipe)
    for name, fn, words in (("custom_beta_1_line", D.demo_custom_beta, "OPEN"),
                            ("custom_beta_2_lines", D.demo_custom_beta, "OPEN\nCAFE 24H"),
                            ("custom", D.demo_custom, "OPEN")):
        events.clear()
        flash_attention_qk_norm_rope.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cropped, full, cond = fn(pipe, original, sketch, words, steps=EVAL_STEPS, seed=0)
        torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0, step_ms=[s.elapsed_time(e) for s, e in events],
                   launches=flash_attention_qk_norm_rope.launches,
                   expected_launches=per_step * EVAL_STEPS, joint_seq=pipe.last_joint_seq,
                   images={k: _image_stats(v) for k, v in
                           (("cropped", cropped), ("full", full), ("conditioning", cond))})
        out[name] = rec
        if rec["launches"] != rec["expected_launches"]:
            problems.append(f"demo {name}: {rec['launches']} fused launches, expected "
                            f"{rec['expected_launches']}")
        for k in ("cropped", "full"):
            if not rec["images"][k]["finite"] or rec["images"][k]["std"] <= 0:
                problems.append(f"demo {name}: {k} image {rec['images'][k]}")
    try:
        D.check_gradio()
        problems.append("check_gradio() did not raise")
    except RuntimeError as e:
        out["check_gradio"] = str(e)
        if not str(e).startswith("gradio ") or D.SUPPORTED_GRADIO not in str(e):
            problems.append(f"check_gradio() raised {e!r}")
    return out, problems


def _eval_t2i(vae, clip, t5, per_step: int, smi: str) -> dict:
    """Text2ImagePipeline at full FLUX.1-dev width (64 input channels, no
    cond concat; random bf16 weights from seed 2, made here) with the
    phase's VAE and text encoders: 512x512, euler, T2I_STEPS steps."""
    from textflux_torch.config import flux_fill_config
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope
    from textflux_torch.pipeline.t2i import Text2ImagePipeline

    cfg = dataclasses.replace(flux_fill_config(), in_channels=64, out_channels=64)
    t0 = time.perf_counter()
    flux = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = Text2ImagePipeline(flux=flux, vae=vae, clip=clip, t5=t5,
                              clip_tokenize=clip_byte_tokenize, t5_tokenize=t5_byte_tokenize)
    events = _timed_steps(pipe._fill)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_qk_norm_rope.launches = 0
    t0 = time.perf_counter()
    image = pipe(prompt="a shop sign that says 'OPEN'", height=T2I_SIZE, width=T2I_SIZE,
                 num_inference_steps=T2I_STEPS, seed=0, sampler="euler")[0]
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in events]
    rec = dict(card=smi, in_channels=cfg.in_channels, blocks=[cfg.num_double_layers,
                                                              cfg.num_single_layers],
               init_s=init_s, seconds=time.perf_counter() - t0, steps=T2I_STEPS,
               joint_seq=pipe._fill.last_joint_seq, step_ms=step_ms,
               mean_step_ms=float(np.mean(step_ms)), attn_impl=pipe._fill.attn_impl,
               launches=flash_attention_qk_norm_rope.launches,
               expected_launches=per_step * T2I_STEPS,
               peak_bytes=torch.cuda.max_memory_allocated(), image=_image_stats(image))
    del pipe, flux
    return rec


def _eval_ocr(work: str, data_json: str, crops: str, smi: str) -> tuple:
    """eval_ocr.main over `crops` with the PP-OCR entry point (random
    full-config RecModel weights and a 6,623-line char dict written here);
    the recognizer's logits on the card held against a CPU copy."""
    import contextlib
    import io

    from textflux_torch.cli import eval_ocr as EO
    from textflux_torch.cli.run_eval import safe_name
    from textflux_torch.evaluation import ppocr as TP
    from textflux_torch.evaluation.crop import crop_polygon_region
    from textflux_torch.device import true_fp32

    ckpt, cdict = os.path.join(work, "ppv3_rec.pth"), os.path.join(work, "ppocr_keys.txt")
    cfg = TP.PPOCRConfig()
    torch.save(TP.random_recmodel_state_dict(cfg, torch.Generator().manual_seed(3)), ckpt)
    with open(cdict, "w", encoding="utf-8") as f:
        f.write("".join(chr(0x4E00 + i) + "\n" for i in range(PPOCR_CHARS)))
    os.environ.update(PPOCR_CKPT=ckpt, PPOCR_DICT=cdict)
    TP._DEFAULT_RECOGNIZER = None
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        EO.main(["--images-dir", crops, "--json-path", data_json, "--recognizer",
                 "textflux_torch.evaluation.ppocr:recognize", "--charset", cdict,
                 "--report", os.path.join(work, "ocr_report.json")])
    seconds = time.perf_counter() - t0
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec_card = TP._DEFAULT_RECOGNIZER
    cpu = TP.PPOCRRecognizer(TP.RecModel(cfg, device="cpu"), rec_card.charset)
    cpu.model.load_state_dict({k: v.cpu() for k, v in rec_card.model.state_dict().items()})
    with open(data_json) as f:
        items = json.load(f)["data_list"]
    errs, same_text, crops_np = [], [], []
    for item in items:
        image = np.asarray(_open_rgb(os.path.join(crops, safe_name(item["img_name"]))))
        crop = crop_polygon_region(image, item["annotations"][0]["polygon"])
        crops_np.append(crop)
        errs.append(float(np.abs(rec_card.logits(crop) - cpu.logits(crop)).max()))
        same_text.append(rec_card(crop) == cpu(crop))
    x = torch.as_tensor(TP.preprocess_crop(crops_np[0], cfg.image_shape), device="cuda")
    with torch.inference_mode(), true_fp32():
        device_ms = cuda_ms(lambda: rec_card.model(x))
    t0 = time.perf_counter()
    for crop in crops_np:
        rec_card(crop)
    host_ms = 1e3 * (time.perf_counter() - t0) / len(crops_np)
    rec = dict(card=smi, metrics=metrics, seconds=seconds, crops=len(crops_np),
               logits_max_abs_err_vs_cpu=max(errs), tol=EVAL_LOGIT_TOL,
               same_text_as_cpu=all(same_text), recognizer_ms_per_crop=host_ms,
               recognizer_device_ms_per_crop=device_ms,
               params=sum(p.numel() for p in rec_card.model.parameters()))
    problems = []
    if metrics["count"] != len(items) or metrics["skipped"] != 0 or not (
            np.isfinite(metrics["seq_acc"]) and np.isfinite(metrics["ned"])):
        problems.append(f"eval_ocr metrics {metrics}")
    if not (max(errs) <= EVAL_LOGIT_TOL and all(same_text)):
        problems.append(f"PP-OCR logits on the card vs the CPU: {errs}, same text {same_text}")
    return rec, problems


def _eval_fid_lpips(work: str, data_json: str, crops: str, smi: str) -> tuple:
    """eval_fid_lpips.main over the example images (resized to each crop's
    size, under its safe_name) against `crops`, with random InceptionV3
    (torchvision names, BatchNorm statistics) and LPIPS-alex weights written
    here; features and distances on the card held against a CPU copy, and
    the features with TF32 allowed measured against the same (information:
    the extractors run in true float32)."""
    import contextlib
    import io

    from textflux_torch.cli import eval_fid_lpips as EF
    from textflux_torch.cli.run_eval import safe_name
    from textflux_torch.device import true_fp32
    from textflux_torch.evaluation import inception as TI, lpips as TL
    from textflux_torch.evaluation.fid import fid_from_features

    g = torch.Generator().manual_seed(4)
    inc_path, lp_path = os.path.join(work, "pt_inception.pth"), os.path.join(work, "alex.pth")
    torch.save(TI.random_torchvision_state_dict(g), inc_path)
    torch.save(TL.random_lpips_state_dict(g), lp_path)
    gt = os.path.join(work, "gt")
    os.makedirs(gt, exist_ok=True)
    with open(data_json) as f:
        items = json.load(f)["data_list"]
    for item, (_, src, _, _) in zip(items, EVAL_ITEMS):
        name = safe_name(item["img_name"])
        size = _open_rgb(os.path.join(crops, name)).size
        _open_rgb(os.path.join(EXAMPLE, "ori", src)).resize(size).save(os.path.join(gt, name))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        EF.main(["--gt-dir", gt, "--gen-dir", crops, "--inception-weights", inc_path,
                 "--lpips-weights", lp_path, "--log-dir", os.path.join(work, "fid_log")])
    seconds = time.perf_counter() - t0
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])

    pairs = EF.matched_pairs(gt, crops)
    x = np.stack([EF._load(p, 299) for pair in pairs for p in pair])   # gt, gen, gt, ...
    sd = TI.convert_inception_state_dict({k: v.numpy() for k, v in torch.load(inc_path).items()})
    inc_cpu, inc_card = TI.InceptionV3(device="cpu"), TI.InceptionV3(device="cuda")
    for m in (inc_cpu, inc_card):
        m.load_state_dict(sd)
        m.eval()
    ref = TI.make_fid_extractor(inc_cpu)(x)
    card = TI.make_fid_extractor(inc_card)(x)
    scale = float(np.abs(ref).max())
    feat_err = float(np.abs(card - ref).max()) / scale
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = inc_card(torch.as_tensor(x, device="cuda")).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    tf32_err = float(np.abs(tf32 - ref).max()) / scale
    n = len(pairs)
    fids = {k: fid_from_features(f[0::2], f[1::2])
            for k, f in (("card", card), ("cpu", ref), ("card_tf32", tf32))}

    lp_cpu = TL.load_lpips(lp_path, device="cpu")
    lp_card = TL.load_lpips(lp_path, device="cuda")
    lp_errs, lp_card_vals = [], []
    for gp, fp in pairs:
        a, b = EF._load(gp)[None], EF._load(fp)[None]
        v_card = float(TL.lpips_distance(lp_card, a, b)[0])
        v_cpu = float(TL.lpips_distance(lp_cpu, a, b)[0])
        lp_card_vals.append(v_card)
        lp_errs.append(abs(v_card - v_cpu) / abs(v_cpu))
    with torch.inference_mode(), true_fp32():
        xb = torch.as_tensor(x[:len(pairs)], device="cuda")
        inc_batch_ms = cuda_ms(lambda: inc_card(xb), iters=10)
        x32 = xb.repeat(-(-32 // len(xb)), 1, 1, 1)[:32]
        inc_32_ms = cuda_ms(lambda: inc_card(x32), iters=5)
        a, b = (torch.as_tensor(EF._load(p)[None], device="cuda") for p in pairs[0])
        lpips_pair_ms = cuda_ms(lambda: lp_card(a, b))
    rec = dict(card=smi, metrics=metrics, seconds=seconds, pairs=n,
               pair_sizes=[list(_open_rgb(f).size) for _, f in pairs],
               features_max_rel_err_vs_cpu=feat_err, tol=EVAL_FEATURE_TOL,
               features_tf32_max_rel_err_vs_cpu=tf32_err, fid_from_features=fids,
               lpips_max_rel_err_vs_cpu=max(lp_errs), lpips_tol=EVAL_LPIPS_RTOL,
               lpips_card=lp_card_vals,
               inception_ms_per_299_batch={str(len(xb)): inc_batch_ms, "32": inc_32_ms},
               lpips_ms_per_pair=lpips_pair_ms, lpips_pair_size=list(a.shape[1:3]))
    problems = []
    if not (np.isfinite(metrics.get("fid", np.nan)) and np.isfinite(metrics.get("lpips", np.nan))
            and metrics["pairs"] == len(items)):
        problems.append(f"eval_fid_lpips metrics {metrics}")
    if feat_err > EVAL_FEATURE_TOL or max(lp_errs) > EVAL_LPIPS_RTOL:
        problems.append(f"features {feat_err} / LPIPS {max(lp_errs)} on the card vs the CPU")
    return rec, problems


def phase_eval(smi: str, have_checkpoint: bool) -> dict:
    """Phase 11. Phase 7's checkpoint (written here when no earlier phase
    did) through cli.run_eval.main over EVAL_ITEMS: --batch-size 1, then 2
    into a second directory (images equal within EVAL_BATCH_TOL),
    --multiline, and --skip-existing on the first directory (does nothing);
    the demo callbacks on the last run's pipeline; Text2ImagePipeline at
    full FLUX.1-dev width after the Fill DiT is freed; eval_ocr.main over
    the first run's crops (PP-OCR entry point) and eval_fid_lpips.main
    against the example images, with the metric networks on the card held
    against the CPU."""
    from textflux_torch.config import flux_fill_config

    gc.collect()
    torch.cuda.empty_cache()
    if not have_checkpoint:
        _, flux = write_checkpoint(load_manifest())
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    # ~0.12 GB of weights and images under CKPT_DIR: inside the 45 GiB a
    # run may write beside phases 7-8's checkpoint and exports
    work = os.path.join(CKPT_DIR, "eval")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_json, imgs = _eval_data(work)
    flux_cfg = flux_fill_config()
    per_step = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    n = len(EVAL_ITEMS)
    # items by //32 bucket: two share ori_0001's canvas, one has ori_0002's
    chunks_at_2 = 2
    out, problems = {}, []
    dirs = {k: os.path.join(work, k) for k in ("b1", "b2", "multiline")}
    common = ["--model", CKPT_DIR, "--json-path", data_json, "--original-images-dir", imgs,
              "--steps", str(EVAL_STEPS), "--seed", "0"]
    runs = (("batch_1", dirs["b1"], ["--batch-size", "1"], per_step * EVAL_STEPS * n),
            ("batch_2", dirs["b2"], ["--batch-size", "2"], per_step * EVAL_STEPS * chunks_at_2),
            ("multiline", dirs["multiline"], ["--batch-size", "2", "--multiline"],
             per_step * EVAL_STEPS * chunks_at_2),
            ("skip_existing", dirs["b1"], ["--batch-size", "1", "--skip-existing"], 0))
    pipe = None
    with byte_tokenizers("eval"):
        for name, out_dir, extra, expected in runs:
            with _Recorder() as recorder:
                rec = _run_eval_main(common + ["--output-dir", out_dir] + extra, recorder,
                                     expected)
            rec["card"] = smi
            log(f"eval run_eval {name} " + json.dumps(rec))
            out[name] = rec
            if rec["launches"] != expected:
                problems.append(f"run_eval {name}: {rec['launches']} fused launches, "
                                f"expected {expected}")
            want = ({"total": 0, "done": 0, "failed": 0, "skipped_existing": n}
                    if name == "skip_existing" else
                    {"total": n, "done": n, "failed": 0, "skipped_existing": 0})
            if rec["report"] != want:
                problems.append(f"run_eval {name}: failures.json {rec['report']} "
                                f"{rec['failures']}, expected {want}")
            # the demo callbacks run on the last run's pipeline (loaded, no
            # image generated); one pipeline resident at a time
            pipe = recorder.pipe if name == "skip_existing" else None
            del recorder
            gc.collect()
            torch.cuda.empty_cache()
        diff = _images_diff(dirs["b1"], dirs["b2"])
        log("eval batch_1_vs_batch_2 " + json.dumps(diff))
        out["batch_1_vs_batch_2"] = diff
        for sub, d in diff.items():
            if d["max_abs_diff"] > EVAL_BATCH_TOL:
                problems.append(f"{sub}: batch 1 and 2 differ by {d['max_abs_diff']} levels")
        for sub in ("full_images", "cropped_images"):
            stats = [_image_stats(_open_rgb(os.path.join(dirs["multiline"], sub, f)))
                     for f in sorted(os.listdir(os.path.join(dirs["multiline"], sub)))]
            if len(stats) != n or not all(s["finite"] and s["std"] > 0 for s in stats):
                problems.append(f"multiline {sub}: {stats}")

        demo, demo_problems = _eval_demo(pipe, per_step)
        demo["card"] = smi
        log("eval demo " + json.dumps(demo))
        out["demo"], problems = demo, problems + demo_problems

    vae, clip, t5 = pipe.vae, pipe.clip, pipe.t5
    pipe.flux = None     # the Fill DiT goes before the dev DiT is made
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    t2i = _eval_t2i(vae, clip, t5, per_step, smi)
    log("eval t2i " + json.dumps(t2i))
    out["t2i"] = t2i
    if t2i["launches"] != t2i["expected_launches"]:
        problems.append(f"t2i: {t2i['launches']} fused launches, expected "
                        f"{t2i['expected_launches']}")
    if not t2i["image"]["finite"] or t2i["image"]["std"] <= 0:
        problems.append(f"t2i image {t2i['image']}")
    del vae, clip, t5
    gc.collect()
    torch.cuda.empty_cache()

    crops = os.path.join(dirs["b1"], "cropped_images")
    ocr, ocr_problems = _eval_ocr(work, data_json, crops, smi)
    log("eval eval_ocr " + json.dumps(ocr))
    fid, fid_problems = _eval_fid_lpips(work, data_json, crops, smi)
    log("eval eval_fid_lpips " + json.dumps(fid))
    out["eval_ocr"], out["eval_fid_lpips"] = ocr, fid
    problems += ocr_problems + fid_problems
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("eval phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 12. train_full: full-parameter training through cli.train.main and in memory
# ---------------------------------------------------------------------------

TRAIN_FULL_STEPS = 4
TRAIN_FULL_LR = "2e-5"
# the in-memory runs' depth (2 double + 4 single blocks, full width): at full
# depth fp32 AdamW over the attention unfreeze needs ~95 GB and --mode all
# with 8-bit moments ~119 GB, past one 80 GB card (they wait for sharding)
TRAIN_FULL_REDUCED_DEPTH = (2, 4)
TRAIN_FULL_REDUCED_STEPS = 2
TRAIN_FULL_REDUCED_RUNS = (("attn", "adamw"), ("all", "adamw8bit"))


def full_checksums(model, masks) -> dict:
    """param_checksum of every frozen parameter, and of the trainable and
    the masked elements of every trainable one."""
    out = {"frozen": {}, "trained": {}, "masked": {}}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name not in masks:
                out["frozen"][name] = param_checksum(p)
            elif masks[name] is None:
                out["trained"][name] = param_checksum(p)
            else:
                keep = torch.broadcast_to(masks[name] != 0, p.shape)
                out["trained"][name] = param_checksum(p[keep])
                if not bool(keep.all()):
                    out["masked"][name] = param_checksum(p[~keep])
    return out


def _checksum_report(before: dict, after: dict) -> dict:
    return dict(
        frozen=len(before["frozen"]),
        frozen_changed=[k for k, v in before["frozen"].items() if after["frozen"][k] != v],
        masked=len(before["masked"]),
        masked_changed=[k for k, v in before["masked"].items() if after["masked"][k] != v],
        trained=len(before["trained"]),
        trained_unmoved=[k for k, v in before["trained"].items() if after["trained"][k] == v])


def _state_parts(model, masks, opt_state) -> dict:
    """Device bytes of the training state by part."""
    from textflux_torch.training.optim8bit import state_bytes

    params = dict(model.named_parameters())
    return dict(
        frozen_bytes=sum(p.numel() * p.element_size() for k, p in params.items()
                         if k not in masks),
        master_bytes=sum(params[k].numel() * params[k].element_size() for k in masks),
        grad_bytes=sum(p.grad.numel() * p.grad.element_size() for p in params.values()
                       if p.grad is not None),
        optimizer_state_bytes=state_bytes(opt_state))


def _full_problems(label: str, r: dict, want_steps: list, per_step: dict) -> list:
    problems = []
    if r["steps"] != want_steps:
        problems.append(f"{label} logged steps {r['steps']}, expected {want_steps}")
    if not all(np.isfinite(r["loss"])) or not all(np.isfinite(r["grad_norm"])):
        problems.append(f"{label}: non-finite loss or grad norm")
    if len(r["launches_per_step"]) != len(want_steps) or any(
            c != per_step for c in r["launches_per_step"]):
        problems.append(f"{label} launched {r['launches_per_step']}, expected {per_step} a step")
    c = r["checksums"]
    if c["frozen_changed"] or c["masked_changed"]:
        problems.append(f"{label} changed frozen parameters {c['frozen_changed'][:3]} or "
                        f"masked rows {c['masked_changed'][:3]}")
    if not c["trained"] or c["trained_unmoved"]:
        problems.append(f"{label}: trainable parameters that did not move: "
                        f"{c['trained_unmoved'][:3]}")
    if r["max_memory_allocated"] > r["device_total_bytes"]:
        problems.append(f"{label}: peak {r['max_memory_allocated']} past the card")
    return problems


class _TrainFullRecorder:
    """Instruments one cli.train.main() run in --mode attn|all from outside,
    while the block runs:
    - data.loader.BucketedLoader.__iter__: each batch's bucket and a CUDA
      event when it is handed out (its step's start);
    - training.train.make_train_step: a CUDA event when each step returns
      (its end), the flash launch counts after it, and the step's function
      and arguments (for the profile after the run);
    - io.params.load_checkpoint_dir: seconds, checkpoint bytes and device
      bytes by component;
    - training.train.make_optimizer: the optimizer and masks, the checksums
      before the first step (of the model load_models built), and CUDA
      events around each optimizer step (mask, clip, update);
    - io.export.save_transformer_checkpoint: a sink that checks the export
      on the device (the manifest's keys and shapes, float32, the trained
      keys bitwise the live masters) and writes nothing."""

    def __init__(self, manifest_transformer: dict):
        self.manifest = manifest_transformer
        self.buckets, self.starts, self.ends, self.counts = [], [], [], []
        self.load, self.model, self.masks, self.opt, self.before = {}, None, None, None, None
        self.last_step, self.export, self.opt_events = None, None, []
        self._undo = []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def sink(self, model, out_dir, *, shards=1, dtype=None):
        from textflux_torch.io.export import export_flux_state_dict
        from textflux_torch.io.params import flux_key_map

        t0 = time.perf_counter()
        keys = flux_key_map(model)
        trained = {id(p) for p in self.opt.params}
        sd = export_flux_state_dict(model)
        r = dict(out_dir=os.path.relpath(out_dir, REPO), dtype=str(dtype), keys=len(sd),
                 keys_equal=set(sd) == set(self.manifest),
                 shapes_equal=all(list(v.shape) == self.manifest.get(k) for k, v in sd.items()),
                 not_float32=[], trained_keys=0, trained_differ=[], nonfinite=[],
                 bytes_it_would_write=0, bytes_written=0)
        with torch.no_grad():
            for k, v in sd.items():
                x = v.to(dtype) if dtype is not None else v
                r["bytes_it_would_write"] += x.numel() * x.element_size()
                if x.dtype != torch.float32:
                    r["not_float32"].append(k)
                if not bool(torch.isfinite(x).all()):
                    r["nonfinite"].append(k)
                param, rows = keys[k]
                if id(param) in trained:
                    r["trained_keys"] += 1
                    if not torch.equal(x, param if rows is None else param[rows]):
                        r["trained_differ"].append(k)
                del x
        r["seconds"] = time.perf_counter() - t0
        self.export = r
        return 0

    def __enter__(self):
        from textflux_torch.data.loader import BucketedLoader
        from textflux_torch.io import export as E
        from textflux_torch.io import params as P
        from textflux_torch.io.quantize import quantized_bytes
        from textflux_torch.ops import flash_attention as FA
        from textflux_torch.training import train as TR

        def loader_iter(orig):
            def timed(loader):
                for batch in orig(loader):
                    self.buckets.append(list(batch["bucket"]))
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.starts.append(ev)
                    yield batch
            return timed

        def make_step(orig):
            def make(tc, **kw):
                step = orig(tc, **kw)

                def timed(*a, **k):
                    metrics = step(*a, **k)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.ends.append(ev)
                    self.counts.append({n: getattr(FA, n).launches for n in FLASH_KERNELS})
                    self.last_step = (step, a)
                    return metrics
                return timed
            return make

        def load(orig):
            def timed(path, cfg, **kw):
                t0 = time.perf_counter()
                module = orig(path, cfg, **kw)
                torch.cuda.synchronize()
                name = os.path.basename(os.path.normpath(path))
                self.load[name] = dict(seconds=time.perf_counter() - t0,
                                       bytes=P.checkpoint_bytes(path),
                                       device_bytes=quantized_bytes(module))
                if name == "transformer":
                    self.model = module
                return module
            return timed

        def make_opt(orig):
            def kept(tc, params, masks=None):
                self.opt, self.masks = orig(tc, params, masks), masks
                self.before = full_checksums(self.model, masks)
                inner = self.opt.step

                def timed():   # the mask, clip and update of each step
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    norm = inner()
                    ev[1].record()
                    self.opt_events.append(ev)
                    return norm
                self.opt.step = timed
                return self.opt
            return kept

        self._patch(BucketedLoader, "__iter__", loader_iter)
        self._patch(TR, "make_train_step", make_step)
        self._patch(P, "load_checkpoint_dir", load)
        self._patch(TR, "make_optimizer", make_opt)
        self._patch(E, "save_transformer_checkpoint", lambda orig: self.sink)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)

    def per_step_launches(self) -> list:
        prev, out = {n: 0 for n in FLASH_KERNELS}, []
        for c in self.counts:
            out.append({n: c[n] - prev[n] for n in FLASH_KERNELS})
            prev = c
        return out


def _train_full_main(smi: str, manifest: dict, per_step: dict) -> dict:
    """--mode attn with 8-bit AdamW through cli.train.main at full depth on
    the checkpoint under CKPT_DIR; one more step profiled after the run."""
    from textflux_torch.cli import train as CLI
    from textflux_torch.ops import flash_attention as FA

    work = os.path.join(CKPT_DIR, "train_full")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out_dir = os.path.join(work, "out")
    argv = ["--model", CKPT_DIR, "--data-json", train_main_json(work),
            "--data-images", os.path.join(EXAMPLE, "ori"), "--mode", "attn",
            "--optimizer", "adamw8bit", "--learning-rate", TRAIN_FULL_LR,
            "--resolution", str(TRAIN_RESOLUTION), "--train-batch-size", "1",
            "--grad-accum", "1", "--max-train-steps", str(TRAIN_FULL_STEPS),
            "--checkpointing-steps", str(TRAIN_FULL_STEPS + 1), "--log-every", "1",
            "--seed", "0", "--output-dir", out_dir]
    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with byte_tokenizers("train_full"), _TrainFullRecorder(manifest["transformer"]) as rec:
        CLI.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: getattr(FA, k).launches for k in FLASH_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        after = full_checksums(rec.model, rec.masks)
    train_log = _train_log(out_dir)
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(out_dir) for f in fs)
    r = dict(card=smi, mode="attn", optimizer="adamw8bit", lr=float(TRAIN_FULL_LR),
             seconds=seconds, steps=[e["step"] for e in train_log],
             loss=[e["loss"] for e in train_log], grad_norm=[e["grad_norm"] for e in train_log],
             step_ms=[s.elapsed_time(e) for s, e in zip(rec.starts, rec.ends)],
             optimizer_ms=[s.elapsed_time(e) for s, e in rec.opt_events],
             bucket_hw=rec.buckets,
             joint_seq=[512 + (h // 16) * (w // 16) for h, w in rec.buckets],
             load=rec.load, launches=launches, launches_per_step=rec.per_step_launches(),
             expected_per_step=per_step, max_memory_allocated=peak,
             device_total_bytes=torch.cuda.mem_get_info()[1],
             state=_state_parts(rec.model, rec.masks, rec.opt.state_dict()),
             checksums=_checksum_report(rec.before, after), export=rec.export,
             output_bytes=written,
             transformer_dir_written=os.path.exists(os.path.join(out_dir, "transformer")))
    log("train_full main " + json.dumps(r))
    step, (model, vae, opt, batch) = rec.last_step
    gen = torch.Generator(device="cuda").manual_seed(0)
    profile_step(lambda: step(model, vae, opt, batch, generator=gen),
                 what="train_full step (attn, adamw8bit, full depth)", inference=False)
    del rec, step, model, vae, opt, batch
    return r


def _train_full_reduced(mode: str, optimizer: str, models, sample, smi: str) -> dict:
    """TRAIN_FULL_REDUCED_STEPS steps of train_full (lr 2e-5) over a
    full-width DiT of TRAIN_FULL_REDUCED_DEPTH blocks, bf16 weights made on
    the card from seed 0 (train_full makes the trainable ones float32
    masters)."""
    from textflux_torch.cli.train import train_full
    from textflux_torch.config import flux_fill_config
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.training import train as TR

    vae, clip, t5 = models
    n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
    cfg = dataclasses.replace(flux_fill_config(), num_double_layers=n_double,
                              num_single_layers=n_single)
    flux = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    tc = TR.TrainConfig(mode=mode, optimizer=optimizer)
    masks = TR.trainable_mask(flux, tc)
    before = full_checksums(flux, masks)
    starts, ends, counts = [], [], []

    def batches():
        while True:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield sample

    def on_step(step, metrics, model):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        counts.append({k: getattr(FA, k).launches for k in FLASH_KERNELS})

    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = {}
    flux, history = train_full(flux, vae, clip, t5, batches(), tc=tc,
                               clip_tokenize=clip_byte_tokenize, t5_tokenize=t5_byte_tokenize,
                               steps=TRAIN_FULL_REDUCED_STEPS, seed=0, log_every=1,
                               on_step=on_step, state=state)
    torch.cuda.synchronize()
    prev, by_step = {k: 0 for k in FLASH_KERNELS}, []
    for c in counts:
        by_step.append({k: c[k] - prev[k] for k in FLASH_KERNELS})
        prev = c
    r = dict(card=smi, mode=mode, optimizer=optimizer, lr=tc.learning_rate,
             depth=dict(double=n_double, single=n_single, hidden=cfg.hidden_dim),
             steps=[e["step"] for e in history], loss=[e["loss"] for e in history],
             grad_norm=[e["grad_norm"] for e in history],
             step_ms=[s.elapsed_time(e) for s, e in zip(starts, ends)],
             launches={k: getattr(FA, k).launches for k in FLASH_KERNELS},
             launches_per_step=by_step, max_memory_allocated=torch.cuda.max_memory_allocated(),
             device_total_bytes=torch.cuda.mem_get_info()[1],
             params=sum(p.numel() for p in flux.parameters()),
             trainable=sum(p.numel() for n, p in flux.named_parameters() if n in masks),
             state=_state_parts(flux, masks, state["opt_state"]),
             checksums=_checksum_report(before, full_checksums(flux, masks)))
    del flux, state
    gc.collect()
    torch.cuda.empty_cache()
    return r


def phase_train_full(smi: str, have_checkpoint: bool) -> dict:
    """Phase 12. Full-parameter training: --mode attn with 8-bit AdamW
    through cli.train.main at full depth on phase 7's checkpoint (written
    here when no earlier phase did), 4 steps at 4,224 tokens, the export
    checked by a sink that writes nothing, one more step profiled; then
    --mode attn with AdamW and --mode all with 8-bit AdamW through
    train_full at full width and reduced depth. Fails on a launch count
    other than 114/0/57/57 a full-depth step, a trainable parameter that
    did not move, a frozen parameter or masked row that did, a non-finite
    loss, or an export that is not the manifest's keys in float32 with the
    live masters' values."""
    from textflux_torch.config import clip_l_config, flux_fill_config, flux_vae_config, t5_xxl_config
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.vae import FluxVAE

    gc.collect()
    torch.cuda.empty_cache()
    manifest = load_manifest()
    if not have_checkpoint:
        _, flux = write_checkpoint(manifest)
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()

    def expected(blocks):
        return {"flash_attention": 2 * blocks, "flash_attention_lse": 0,
                "flash_attention_dq": blocks, "flash_attention_dkv": blocks}

    cfg = flux_fill_config()
    out, problems = {}, []
    r = _train_full_main(smi, manifest, expected(cfg.num_double_layers + cfg.num_single_layers))
    out["main"] = r
    problems += _full_problems("main", r, list(range(1, TRAIN_FULL_STEPS + 1)),
                               r["expected_per_step"])
    e = r["export"] or {}
    if not (e.get("keys_equal") and e.get("shapes_equal")) or e.get("not_float32") \
            or e.get("trained_differ") or e.get("nonfinite") or not e.get("trained_keys"):
        problems.append(f"main's export: {e}")
    if r["transformer_dir_written"] or e.get("bytes_written"):
        problems.append("main wrote its export to disk")
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    models = (FluxVAE(flux_vae_config(), device="cuda", dtype=dt, generator=gen),
              CLIPTextModel(clip_l_config(), device="cuda", dtype=dt, generator=gen),
              T5Encoder(t5_xxl_config(), device="cuda", dtype=dt, generator=gen))
    sample = training_sample()
    for mode, optimizer in TRAIN_FULL_REDUCED_RUNS:
        r = _train_full_reduced(mode, optimizer, models, sample, smi)
        r["expected_per_step"] = expected(sum(TRAIN_FULL_REDUCED_DEPTH))
        name = f"{mode}_{optimizer}"
        log(f"train_full {name} " + json.dumps(r))
        out[name] = r
        problems += _full_problems(name, r, list(range(1, TRAIN_FULL_REDUCED_STEPS + 1)),
                                   r["expected_per_step"])
    del models
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train_full phase: {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("train_full phase: " + "; ".join(problems))
    return out


def _ckpt_launches(ckpt_rec) -> dict:
    if not ckpt_rec:
        return {}
    g = ckpt_rec["generate_batch"]
    return {"checkpoint_main": ckpt_rec["main"]["launches"],
            "checkpoint_main_lora": ckpt_rec["main_lora"]["launches"],
            "checkpoint_generate_batch": g["launches"],
            "checkpoint_single_item": g["single_launches"]}


def _fused_entry(kernel_rows, main_rec, build_rec, ckpt_rec=None, tm_rec=None,
                 q_rec=None, eval_rec=None) -> dict:
    serving = next((r for r in kernel_rows if r["case"] == "serving"), None)
    by_run = {k: v["launches"] for k, v in main_rec["runs"].items()} if main_rec else {}
    by_run.update(_ckpt_launches(ckpt_rec))
    if tm_rec:
        by_run["train_main_round_trip"] = tm_rec["export"]["round_trip_launches"]
    for name, r in (q_rec or {}).items():
        if name != "stack_rel_err":
            by_run[f"quantized_{name}"] = r["launches"]
    if eval_rec:
        for name in ("batch_1", "batch_2", "multiline", "skip_existing", "t2i"):
            by_run[f"eval_{name}"] = eval_rec[name]["launches"]
        for name, r in eval_rec["demo"].items():
            if isinstance(r, dict):
                by_run[f"eval_demo_{name}"] = r["launches"]
    entry = dict(
        name="flash_attention_qk_norm_rope", route="cuda",
        source="textflux_torch/csrc/fused_attention.cu",
        # the prep pass is in `source`, the attention mainloop here
        mainloop_source="textflux_torch/csrc/flash_fwd_sm90.cu",
        build={k: v for k, v in build_rec.get("kernels", {}).items()
               if k.startswith(("norm_rope_kernel", "flash_fwd_sm90_kernel"))},
        replaces="textflux_tpu/ops/flash_attention.py:577",
        launches=sum(by_run.values()) if by_run else None,
        launches_by_run=by_run or None,
    )
    if serving:
        entry.update(max_abs_err=max(r["max_err"] for r in kernel_rows), tol=BF16_TOL,
                     ms=serving["kernel_ms"], prep_ms=serving["prep_ms"],
                     plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
                     bound_by=serving["bound_by"], library_ms=serving["library_ms"])
    return entry


# line of each Pallas kernel body in textflux_tpu/ops/flash_attention.py
FLASH_REPLACES = {"flash_attention": 33, "flash_attention_lse": 234,
                  "flash_attention_dq": 281, "flash_attention_dkv": 327}
# the CUDA source of each training kernel
FLASH_SOURCES = {"flash_attention": "textflux_torch/csrc/flash_fwd_sm90.cu",
                 "flash_attention_lse": "textflux_torch/csrc/flash_attention.cu",
                 "flash_attention_dq": "textflux_torch/csrc/flash_bwd_sm90.cu",
                 "flash_attention_dkv": "textflux_torch/csrc/flash_bwd_sm90.cu"}


# the kernel function behind each training wrapper
FLASH_FUNCTIONS = {"flash_attention": "flash_fwd_sm90_kernel",
                   "flash_attention_lse": "flash_lse_kernel",
                   "flash_attention_dq": "flash_dq_sm90_kernel",
                   "flash_attention_dkv": "flash_dkv_sm90_kernel"}


def _flash_entries(flash_rows, train_rec, build_rec, tm_rec=None, qlora_rec=None,
                   tf_rec=None) -> list:
    """One JSON entry per training kernel: times at the `train` case,
    launches from the train phase, the train_main phase's runs A and B, the
    qlora phase's runs and the train_full phase's (all steps, by run, and
    per step)."""
    train = flash_rows.get("train")
    runs = {}
    if train_rec:
        runs["train"] = train_rec
    for key in ("A", "B") if tm_rec else ():
        runs[f"train_main_{key}"] = tm_rec[key]
    for key, r in (qlora_rec or {}).items():
        runs[f"qlora_{key}"] = r
    for key, r in (tf_rec or {}).items():
        runs[f"train_full_{key}"] = r
    out = []
    for name in FLASH_KERNELS:
        by_run = {k: r["launches"][name] for k, r in runs.items()}
        entry = dict(name=name, route="cuda", source=FLASH_SOURCES[name],
                     build={k: v for k, v in build_rec.get("kernels", {}).items()
                            if k.startswith(FLASH_FUNCTIONS[name])},
                     replaces=f"textflux_tpu/ops/flash_attention.py:{FLASH_REPLACES[name]}",
                     launches=sum(by_run.values()) if runs else None,
                     launches_by_run=by_run or None,
                     launches_per_step={k: [c[name] for c in r["launches_per_step"]]
                                        for k, r in runs.items()} or None)
        if train:
            k = train["kernels"][name]
            entry.update(
                max_abs_err=max(r["kernels"][name]["max_err"] for r in flash_rows.values()),
                max_rel_err=max(r["kernels"][name]["rel_err"] for r in flash_rows.values()),
                tol=k["tol"], ms=k["kernel_ms"], plain_ms=k["plain_ms"],
                bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                # one library call computes the forward; none computes one
                # backward pass alone: SDPA's whole backward is beside the
                # sum of lse + Dvec + dq + dkv instead
                library_ms=train["sdpa_ms"] if name == "flash_attention" else None)
            if name != "flash_attention":
                entry.update(sdpa_bwd_ms=train["sdpa_bwd_ms"], bwd_total_ms=train["bwd_total_ms"])
        out.append(entry)
    return out


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
    build_rec = {}
    if set(PHASES[1:]) & set(phases):
        build_rec = phase_build()
    kernel_rows = phase_kernels() if "kernels" in phases else []
    flash_rows = phase_flash_kernels() if "kernels" in phases else {}
    main_rec = phase_main("profile" in phases) if "main" in phases else None
    train_rec = phase_train("profile" in phases) if "train" in phases else None
    smi = dev["nvidia_smi"]
    try:   # the checkpoint phases share the one under CKPT_DIR
        ckpt_rec = phase_checkpoint() if "checkpoint" in phases else None
        tm_rec = (phase_train_main(smi, have_checkpoint=ckpt_rec is not None)
                  if "train_main" in phases else None)
        q_rec = (phase_quantized(smi, have_checkpoint=bool(ckpt_rec or tm_rec),
                                 profile="profile" in phases)
                 if "quantized" in phases else None)
        qlora_rec = phase_qlora(smi) if "qlora" in phases else None
        eval_rec = (phase_eval(smi, have_checkpoint=bool(ckpt_rec or tm_rec or q_rec))
                    if "eval" in phases else None)
        tf_rec = (phase_train_full(smi, have_checkpoint=bool(ckpt_rec or tm_rec or q_rec
                                                              or eval_rec))
                  if "train_full" in phases else None)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)

    kernel_entries = [_fused_entry(kernel_rows, main_rec, build_rec, ckpt_rec, tm_rec, q_rec,
                                   eval_rec)]
    kernel_entries += _flash_entries(flash_rows, train_rec, build_rec, tm_rec, qlora_rec, tf_rec)
    log(dev["nvidia_smi"])
    print(json.dumps({"kernels": kernel_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
