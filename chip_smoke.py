"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: card name and power limit (nvidia-smi), CUDA version, TF32 flags;
  2. build: compile the CUDA kernels from textflux_torch/csrc/ (timed), with
     each kernel's registers and spills from ptxas (-Xptxas -v); a wgmma
     kernel that spills, or any wgmma serialisation warning, fails;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16, with times for the kernel, the plain version and one PyTorch
     library call computing the same function (yardstick only; for the LSE
     pass, FlashAttention-2's forward, whose logsumexp is held to the plain
     L first; for the int8 weight-only kernel, F.linear on the bf16
     weight), the int8 kernel at the serving step's, the conditioning's
     and T5's shapes, the AdaLN modulate kernel at FLUX's and Qwen-Image's
     token counts (its bytes bound beside it), one launch a call on the
     host and on the device;
  4. main path: full-width FLUX.1-Fill-dev + CLIP-L + T5-XXL + FLUX VAE with
     random bf16 weights made on the card from a seed, driven through
     textflux_torch.cli.run_inference.run on resource/example (euler, then
     overshoot), with the kernel launch counts checked (the AdaLN kernel's:
     115 a step on the device, 115 a forward not replayed on the host);
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
     and mask augmentation), Prodigy at lr 1, rank 128, 1024 px. First
     the loader's process mode alone (no model): two spawned workers over
     8 samples at 1024 px, a cold epoch, a warm one with SIGTERM sent to
     both workers (the epoch must stay whole), one with a worker SIGKILLed
     (the consumer must raise within 3 x worker_poll_s), no worker and no
     /dev/shm file left (the size of /dev/shm printed first). Run A
     trains 4 steps, checkpointing at step 3, profiling step 1; run B
     resumes a copy of A's step-3 checkpoint to step 4; run C trains 3
     steps with --loader-procs 2 (no checkpoint; the export to a sink that
     writes nothing), and its workers and their /dev/shm files must be
     gone when main() returns; A's export is
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
     load and over serving, step ms, fused launches per step, the int8
     kernel's launches on the device (each weight_only DiT linear once a
     step or, for the conditioning and modulations, once an image; each of
     T5's once) and the relative
     velocity error of one full-depth DiT forward against the bf16 DiT. Fails
     when a mode breaks the JAX package's divergence bounds on a full-width
     1-double + 1-single stack (2 / 3 / 25 / 5 %, mixed also under nf4's / 3)
     or the weight_only load peaks more than 1 GiB above the models' bytes;
 10. qlora: in memory (weights made on the card, nothing written): the
     full-width DiT quantised nf4 in place, rank-128 LoRA with 8-bit AdamW
     (lr 2e-5, clip 1.0), 3 steps at 4,224 tokens through train_lora, then
     one step over a weight_only base: step ms, the peak, launches per step
     (114/0/57/57; the int8 kernel's 618 over weight_only, with the
     blocks' recompute, 0 over nf4), the optimizer's state bytes beside
     AdamW's; every target's B must move;
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
 13. tp_serve: phase 7's checkpoint (written here when no earlier phase
     did) served over torch.distributed ranks sharing the one card (this
     script started again with --tp-child, one process a rank): a tp=1
     reference here (the single-item call and a batch of 3 with fixed noise,
     staged residency), then 2 ranks over gloo at mesh (1, 1, 2) through
     FillPipeline.from_pretrained(mesh=) (each rank loads its shard of the
     DiT; the single call and a batch of 2) against it (first-step velocity
     and images within TP_VELOCITY_TOL and the image bounds; 57 fused
     launches and 114 all-reduces a step per rank; each rank's DiT under
     TP_DIT_BYTES_MAX), 2 ranks at (2, 1, 1) with the ragged batch of 3
     (bitwise the reference batch), and cli.run_eval.main --mesh 1,1,1 as
     one NCCL rank. Two ranks share the card over gloo, as NCCL refuses
     two ranks on one device: their step times go through the host and
     are no multi-GPU number.
 14. fsdp_train: training over the fsdp axis, 2 ranks on the one card over
     gloo (this script started again with --fsdp-child): first the
     collectives FSDP2 calls (all_gather_into_tensor, reduce_scatter_tensor)
     on CUDA tensors of a block's size; then --mode lora (rank 128, AdamW)
     through textflux_torch.cli.train.main at full depth on phase 7's
     checkpoint (written here when no earlier phase did), mesh (1, 2, 1),
     2 steps of a global batch of 2 at 1024 px (joint 4,224, a row a rank),
     each rank loading its FSDP slice of the DiT from the files, the export
     checked by a sink that writes nothing: per rank the DiT bytes, the
     peak, the card in use, launches per step (114/0/57/57) and the FSDP
     all-gathers and reduce-scatters of a step (torch.profiler's FSDP
     ranges); then at full width and 2 + 4 blocks --mode attn with AdamW
     and 8-bit AdamW and --mode all with 8-bit AdamW through train_full,
     2 steps each, held against one rank on the same whole batch (loss,
     grad norm, the trained tensors' change, frozen and masked elements
     bitwise, each rank's masters and optimizer state half the one
     rank's); and each rank's bytes at full depth reckoned from the
     sharding plan at fsdp 1, 2 and 4, checked against the reduced runs'
     measured bytes. The ranks' step times go through the host (gloo):
     no multi-GPU number.
Phase 3 runs every kernel at its path's shapes, at the JAX package's
multi-line serving shape (S = 8704) and, for the fused kernel, at a
tensor-parallel rank's 12 and 6 heads. It also holds the four training
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
import functools
import gc
import json
import math
import os
import re
import shutil
import signal
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
          "train_main", "quantized", "qlora", "eval", "train_full", "tp_serve", "fsdp_train",
          "tp_train")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events).
    With `queued`, the calls are enqueued behind a sleep on the device, so
    that a kernel shorter than its host launch path is timed alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)   # ~60 ms, longer than the host's enqueueing
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
                "norm_rope_kernel", "w8a16_gemm_sm90_kernel", "adaln_modulate_kernel")


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel instantiation (name<D>, and
    name<D,lse> for the forward's LSE-only one) from an -Xptxas -v build
    log, and ptxas's wgmma serialisation warnings."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = next((k for k in KERNEL_NAMES if k in m.group(1)), None)
            d = re.search(r"ILi(\d+)E", m.group(1))
            lse = ",lse" if "ELb1E" in m.group(1) else ""
            cur = f"{name}<{d.group(1) if d else ''}{lse}>" if name else None
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
                    per_row=True, strided=False, txt_last=False, gen):
    """q, k, v, tables and norm scales of one case over [txt | img] (FLUX's
    ids), or with `txt_last` over [img | txt] (Qwen-Image's centred ids, the
    text padded to `t_txt`). `kv_len`: an int, or a list of each sample's
    key length, handed to the kernel as an int32 device tensor."""
    from textflux_torch.models import qwen_image
    from textflux_torch.ops import packing
    from textflux_torch.ops.rope import rope_tables_half

    if txt_last:
        ids = qwen_image.rope_ids(*lat_hw, t_txt)
    else:
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
        rows = (s - t_txt, t_txt) if txt_last else (t_txt, s - t_txt)
        qs = torch.cat([(1 + 0.1 * randn(d, dtype=torch.float32)).expand(n, d) for n in rows])
        ks = torch.cat([(1 + 0.1 * randn(d, dtype=torch.float32)).expand(n, d) for n in rows])
    else:
        qs = 1 + 0.1 * randn(d, dtype=torch.float32)
        ks = 1 + 0.1 * randn(d, dtype=torch.float32)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return dict(name=name, q=q, k=k, v=v, cos=cos, sin=sin, qs=qs, ks=ks,
                kv_len=s if kv_len is None else kv_len)


def _kv_lens(c) -> list:
    """Each sample's key length of a case."""
    n, b = c["kv_len"], c["q"].shape[0]
    return n.tolist() if isinstance(n, torch.Tensor) else [n] * b


def _bound_ms(c) -> tuple:
    b, s, h, d = c["q"].shape
    flops = 4 * h * s * sum(_kv_lens(c)) * d
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
        # a tensor-parallel rank's heads (24 / tp): tp=2 in both block kinds
        # (the single block's q/k/v as views of the rank's linear1 rows,
        # 7 x 12 x 128 wide), tp=4
        _attention_case("serving_tp2", 1, 512, (56, 64), 12, 128, full_axes, gen=gen),
        _attention_case("serving_tp2_single_block", 1, 512, (56, 64), 12, 128, full_axes,
                        per_row=False, strided=True, gen=gen),
        _attention_case("serving_tp4", 1, 512, (56, 64), 6, 128, full_axes, gen=gen),
        # Qwen-Image's 1:1 canvas at 1024 px: [img | txt], the text padded to
        # its bucket of 512 and masked by key lengths read on the device,
        # one sample and two of different lengths
        _attention_case("qwen_kv_lens", 1, 512, (74, 64), 24, 128, full_axes,
                        kv_len=[4736 + 391], txt_last=True, gen=gen),
        _attention_case("qwen_kv_lens_b2", 2, 512, (74, 64), 24, 128, full_axes,
                        kv_len=[4736 + 391, 4736 + 23], txt_last=True, gen=gen),
    ]
    rows = []
    failed = []
    for c in cases:
        raw = (c["q"], c["k"], c["v"], c["cos"], c["sin"], c["qs"], c["ks"])
        launched = FA.flash_attention_qk_norm_rope.launches
        out = FA.flash_attention_qk_norm_rope(*raw, kv_len=c["kv_len"])
        torch.cuda.synchronize()
        launches = FA.flash_attention_qk_norm_rope.launches - launched
        lens = _kv_lens(c)
        # per sample (an int key length each), as the kernel reads them
        ref = torch.cat([FA.flash_attention_qk_norm_rope_reference(
            *(x[i:i + 1] for x in raw[:3]), *raw[3:], kv_len=n) for i, n in enumerate(lens)])
        # times below are of the kernel alone, on tables folded once outside
        tables = FA.fold_tables(c["cos"], c["sin"], c["qs"], c["ks"])
        args = (c["q"], c["k"], c["v"], *tables)
        if isinstance(c["kv_len"], torch.Tensor):
            kernel_kw = dict(kv_len=c["q"].shape[1], kv_lens=c["kv_len"])
        else:
            kernel_kw = dict(kv_len=c["kv_len"])
        # rows >= kv_len are padding whose outputs a caller drops; compare the real rows
        err = max((out[i, :n].float() - ref[i, :n].float()).abs().max().item()
                  for i, n in enumerate(lens))
        finite = all(bool(torch.isfinite(out[i, :n].float()).all()) for i, n in enumerate(lens))
        kernel_ms = cuda_ms(lambda: FA.launch_folded(*args, **kernel_kw))
        # the first of its two launches alone, against its plain version
        prep_args = (c["q"], c["k"], *tables)
        qn_k, kn_k = FA.norm_rope_prep(*prep_args)
        qn_ref, kn_ref = FA._prep_reference(*prep_args, 1e-6, torch.bfloat16)
        prep_err = max((qn_k.float() - qn_ref.transpose(1, 2).float()).abs().max().item(),
                       (kn_k.float() - kn_ref.transpose(1, 2).float()).abs().max().item())
        del qn_k, kn_k, qn_ref, kn_ref
        prep_ms = cuda_ms(lambda: FA.norm_rope_prep(*prep_args))
        plain_ms = cuda_ms(lambda: FA._reference_folded(*args, kv_len=max(lens), eps=1e-6),
                           iters=5)
        # library yardstick: SDPA on q/k normed and roped outside the timing
        d = c["q"].shape[-1]
        qn = (FA._norm_rope(c["q"].float().transpose(1, 2), tables[0], tables[1], 1e-6)
              ).to(torch.bfloat16)
        kn = FA._norm_rope(c["k"].float().transpose(1, 2), tables[2], tables[3], 1e-6
                           ).to(torch.bfloat16)
        vh = c["v"].transpose(1, 2)
        mask = None
        if min(lens) < c["q"].shape[1]:
            mask = (torch.arange(c["q"].shape[1], device="cuda")[None]
                    < torch.tensor(lens, device="cuda")[:, None])[:, None, None, :]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qn, kn, vh, attn_mask=mask))
        bound_ms, bound_by = _bound_ms(c)
        # the prep is inside kernel_ms; SDPA is beside the attention alone
        row = dict(case=c["name"], shape=list(c["q"].shape), kv_len=lens, max_err=err,
                   tol=BF16_TOL, finite=finite, launches=launches, prep_err=prep_err,
                   kernel_ms=kernel_ms,
                   prep_ms=prep_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log("kernel case " + json.dumps(row))
        if not (finite and err <= BF16_TOL and prep_err <= BF16_TOL and launches == 1):
            failed.append(c["name"])
        rows.append(row)
        del qn, kn, c
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version in cases {failed}")
    return rows


BF16_U = 2.0 ** -8    # bf16's unit roundoff: a rounding moves a value by at most this share
# (name, K, N, bias) of the int8 weight_only linears timed and checked: the
# step's five main products (a single block's linear1 / linear2, a double
# block's qkv and MLP), the modulation of one block, and T5-XXL's three
# shapes (no bias)
INT8_LINEARS = (("linear1", 3072, 21504, True), ("linear2", 15360, 3072, True),
                ("qkv", 3072, 9216, True), ("mlp_in", 3072, 12288, True),
                ("mlp_out", 12288, 3072, True), ("mod", 3072, 18432, True))
INT8_T5_LINEARS = (("t5_qkvo", 4096, 4096, False), ("t5_wi", 4096, 10240, False),
                   ("t5_wo", 10240, 4096, False))
# rows: the 4:3 edit's joint sequence, the text (and T5's 512), a schedule's
# 30 modulation rows, the conditioning vector
INT8_ROWS = (1408, 512, 30, 1)


def _int8_bound_ms(m, n, k, bias) -> tuple:
    """(bound_ms, bound_by): the products' FLOPs at the bf16 peak against
    the bytes (codes, scale, bias, x read; y written) at HBM's."""
    nbytes = n * k + 4 * n + 2 * n * bias + 2 * m * k + 2 * m * n
    t_ops, t_bytes = 2 * m * n * k / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_int8_kernels() -> list:
    """The int8 weight-only kernel (``ops.int8_matmul``, which
    ``QuantLinear``'s weight_only product calls on CUDA) at the main path's
    shapes: each case is one call of ``int8_matmul``, which must count one
    host launch and run one ``w8a16_gemm_sm90_kernel`` on the device. Its
    output is held to a float32 product of the dequantised weight within
    the one rounding the kernel makes (BF16_U of each output, plus float32
    sums in another order), and to the plain version within the roundings
    the two make: each element of the plain version's bf16 weight (the
    scale's cast and the product's: 2 BF16_U of |x| @ |w|^T), its product's
    rounding (BF16_U of |x| @ |w|^T), its bias add's and the kernel's own
    (BF16_U of the output each). Times: the kernel, the plain version, and
    F.linear on the bf16 weight with the bias (cuBLAS; a yardstick the port
    does not call)."""
    import torch.nn.functional as F

    from textflux_torch.ops import int8_matmul as IM

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(f"{name}_m{m}", m, k, n, bias) for m in INT8_ROWS
             for name, k, n, bias in INT8_LINEARS]
    cases += [(f"{name}_m512", 512, k, n, bias) for name, k, n, bias in INT8_T5_LINEARS]
    # a tensor-parallel rank's row-parallel half of linear2: no bias
    cases.append(("linear2_tp2_m1408", 1408, 15360 // 2, 3072, False))
    rows, failed = [], []
    for name, m, k, n, with_bias in cases:
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                            dtype=torch.int8)
        scale = (0.06 + 0.02 * torch.rand(n, generator=gen, device="cuda")) / 127.0
        bias = (torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
                if with_bias else None)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        host = IM.int8_matmul.launches
        with DeviceLaunches() as ran:
            out = IM.int8_matmul(x, w_q, scale, bias)
        host = IM.int8_matmul.launches - host
        device = ran.counts["w8a16_gemm_sm90_kernel"]
        plain = IM.int8_matmul_reference(x, w_q, scale, bias).float()
        w = w_q.float() * scale[:, None]
        exact = x.float() @ w.t()
        absdot = x.float().abs() @ w.abs().t()
        if bias is not None:
            exact = exact + bias.float()
            absdot = absdot + bias.float().abs()
        del w
        slack = 1e-4 * exact.abs().max()        # float32 sums in another order
        err_f32 = (out.float() - exact).abs()
        tol_f32 = BF16_U * exact.abs() + slack
        err_plain = (out.float() - plain).abs()
        tol_plain = BF16_U * (3 * absdot + 2 * exact.abs()) + slack
        f32_ratio = (err_f32 / tol_f32).max().item()
        plain_ratio = (err_plain / tol_plain).max().item()
        finite = bool(torch.isfinite(out.float()).all())
        del exact, absdot, plain, err_f32, err_plain, tol_f32, tol_plain
        w_bf16 = (w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None])
        kernel_ms = cuda_ms(lambda: IM.launch(x, w_q, scale, bias))
        plain_ms = cuda_ms(lambda: IM.int8_matmul_reference(x, w_q, scale, bias), iters=5)
        library_ms = cuda_ms(lambda: F.linear(x, w_bf16, bias))
        bound_ms, bound_by = _int8_bound_ms(m, n, k, bias is not None)
        row = dict(case=name, m=m, n=n, k=k, bias=bias is not None,
                   tile=IM.token_tile(m, n, torch.cuda.get_device_properties(0)
                                      .multi_processor_count),
                   host_launches=host, device_launches=device, finite=finite,
                   # the largest error as a share of its tolerance (1 = at it)
                   err_over_tol_f32=f32_ratio, err_over_tol_plain=plain_ratio,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, of_bound=bound_ms / kernel_ms)
        log("int8 kernel case " + json.dumps(row))
        if not (finite and f32_ratio <= 1 and plain_ratio <= 1 and host == 1 and device == 1):
            failed.append(name)
        rows.append(row)
        del w_q, scale, bias, x, out, w_bf16
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"int8 kernel disagrees with its plain version or launched "
                             f"other than once in cases {failed}")
    return rows


# the AdaLN modulate at D = 3,072: (name, B, rows, leading tokens skipped,
# chunks of the modulation vector). FLUX's joint 1,216 to 1,664 tokens
# (1,408 the 4:3 edit's), the head's image tokens past 512 text tokens
# (a batch-strided slice, the (B, 2D) final modulation), a single block's
# (B, 3D) chunks; Qwen-Image's 3,008 to 5,248 tokens a forward
ADALN_D = 3072
ADALN_CASES = tuple((f"s{s}_b{b}", b, s, 0, 6) for s in (1216, 1408, 1664, 3008, 4224, 5248)
                    for b in (1, 2)) + (("head_s896_skip512_b1", 1, 896, 512, 2),
                                        ("head_s896_skip512_b2", 2, 896, 512, 2),
                                        ("single_s1408_b2", 2, 1408, 0, 3))
ADALN_BITWISE = 0.99     # least share of outputs bitwise the composition's
L2_BYTES = 50 << 20      # H100's L2


def _bf16_place(v: torch.Tensor) -> torch.Tensor:
    """One bf16 place (a unit in the last of 8 significant bits) of |v|."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def phase_adaln_kernels() -> list:
    """The AdaLN modulate kernel (``ops.adaln``, which the DiT's
    ``_modulate`` calls where no gradient flows through a bf16 call) at the
    main path's shapes (ADALN_CASES): each case is one ``adaln_modulate``
    call, which must count one host launch and run one
    ``adaln_modulate_kernel`` on the device. Held to the composition it
    replaces, run on the card: each element within one bf16 place of the
    composition's normalised value carried through the product and the sum,
    plus the one place each of those rounds to, and at least ADALN_BITWISE
    of them bitwise equal (tests/test_torch_adaln_cuda.py holds the same).
    Times by CUDA events over 20 calls enqueued behind a sleep on the device
    (``cuda_ms(queued=True)``: the host's launch path outlasts the kernel),
    with x cycled through copies that exceed twice the L2, so each call
    reads x from device memory: the kernel, the plain composition, and the
    bytes bound (x read and y written once in bf16,
    the two vectors once, at PEAK_BYTES)."""
    from textflux_torch.models.layers import layer_norm
    from textflux_torch.ops import adaln as AM

    gen = torch.Generator(device="cuda").manual_seed(0)
    d = ADALN_D
    rows, failed = [], []
    for name, b, s, skip, chunks in ADALN_CASES:
        spread = 0.5 + 4.0 * torch.rand(b, skip + s, 1, generator=gen, device="cuda")
        offset = torch.randn(b, skip + s, 1, generator=gen, device="cuda")
        copies = [(spread * torch.randn(b, skip + s, d, generator=gen, device="cuda") + offset)
                  .to(torch.bfloat16)[:, skip:]
                  for _ in range(max(1, -(-2 * L2_BYTES // (2 * b * (skip + s) * d))))]
        mod = (0.5 * torch.randn(b, chunks * d, generator=gen, device="cuda")).to(torch.bfloat16)
        shift, scale = mod.chunk(chunks, dim=-1)[:2]
        x = copies[0]
        host = AM.adaln_modulate.launches
        with torch.inference_mode(), DeviceLaunches() as ran:
            y = AM.adaln_modulate(x, shift, scale)
        host = AM.adaln_modulate.launches - host
        device = ran.counts["adaln_modulate_kernel"]
        n = layer_norm(x)
        g = 1.0 + scale[:, None]
        p = n * g
        want = p + shift[:, None]
        err = (y.float() - want.float()).abs()
        tol = _bf16_place(n) * g.float().abs() + _bf16_place(p) + _bf16_place(want)
        err_over_tol = (err / tol).max().item()
        bitwise = (y == want).float().mean().item()
        finite = bool(torch.isfinite(y.float()).all())
        del n, g, p, want, err, tol, y
        turn = {"i": 0}

        def next_x():
            turn["i"] = (turn["i"] + 1) % len(copies)
            return copies[turn["i"]]

        kernel_ms = cuda_ms(lambda: AM.launch(next_x(), shift, scale), queued=True)
        plain_ms = cuda_ms(lambda: AM.adaln_modulate_reference(next_x(), shift, scale),
                           queued=True)
        bound_ms = 1e3 * (2 * b * s * d + 2 * b * d) * 2 / PEAK_BYTES
        row = dict(case=name, b=b, s=s, d=d, skip=skip, chunks=chunks,
                   host_launches=host, device_launches=device, finite=finite,
                   err_over_tol=err_over_tol, bitwise_share=bitwise,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by="bytes", of_bound=bound_ms / kernel_ms,
                   speedup=plain_ms / kernel_ms)
        log("adaln kernel case " + json.dumps(row))
        if not (finite and err_over_tol <= 1 and bitwise >= ADALN_BITWISE and host == 1
                and device == 1):
            failed.append(name)
        rows.append(row)
        del copies, mod, shift, scale, x
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"AdaLN kernel disagrees with the composition or launched other "
                             f"than once in cases {failed}")
    return rows


def adaln_per_forward(cfg) -> int:
    """AdaLN modulates a DiT forward makes: 4 a double block (two streams,
    before the attention and before the MLP), 1 a single block, 1 the
    output head (115 at FLUX.1-Fill's depth)."""
    return 4 * cfg.num_double_layers + getattr(cfg, "num_single_layers", 0) + 1


FLASH_KERNELS =("flash_attention", "flash_attention_lse", "flash_attention_dq",
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
        # a tp = 2 rank's heads in training (tp_train)
        ("train_h12", 1, 4224, 12, 128, None, False),
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
        lse_library = None
        if n == s:
            # the one library call that returns this L (natural log, fp32
            # (B, H, S)): FlashAttention-2's forward, O beside it; held to
            # the plain version before it is timed
            qt_, kt_, vt_ = (x.transpose(1, 2) for x in (q, k, v))

            def lib():
                return torch.ops.aten._scaled_dot_product_flash_attention(qt_, kt_, vt_)

            lib_err = (lib()[1].float() - ref_lse).abs().max().item()
            lse_library = dict(max_err=lib_err, tol=LSE_TOL,
                               ms=cuda_ms(lib) if lib_err <= LSE_TOL else None)
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
                   bwd_total_ms=bwd_total, sdpa_ms=sdpa_ms, sdpa_bwd_ms=sdpa_bwd_ms,
                   lse_library=lse_library)
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


class DeviceLaunches:
    """The port's kernels (KERNEL_NAMES) the device ran inside a ``with``
    block, counted from torch.profiler's CUDA activity: ``counts`` by
    kernel, and ``fused``, the fused attention's launches (one
    norm_rope_kernel each). A serving forward replayed from a CUDA graph
    runs its kernels without their Python wrappers, whose ``.launches``
    count the host's launches alone."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        names = [e.name() for e in self._prof.profiler.kineto_results.events()
                 if e.device_type().name == "CUDA"]
        self.counts = {k: sum(k in n for n in names) for k in KERNEL_NAMES}
        self.fused = self.counts["norm_rope_kernel"]
        return False


def phase_main(profile: bool = False) -> dict:
    from textflux_torch.cli.run_inference import run
    from textflux_torch.config import (PipelineConfig, clip_l_config, flux_fill_config,
                                       flux_vae_config, t5_xxl_config)
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.ops.adaln import adaln_modulate
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
    per_forward = adaln_per_forward(flux_cfg)
    paths = EXAMPLE_PATHS
    runs = {}
    for sampler, steps in (("euler", 4), ("overshoot", 2)):
        step_events.clear()
        torch.cuda.synchronize()
        flash_attention_qk_norm_rope.launches = 0
        adaln_modulate.launches = 0
        graphs = pipe.flux.graphs
        captures, replays = graphs.captures, graphs.replays
        t0 = time.perf_counter()
        with DeviceLaunches() as ran:
            result, cropped, rendered, original, mask = run(
                pipe, *paths, steps=steps, seed=0, sampler=sampler)
        seconds = time.perf_counter() - t0
        # what the device ran, the graphs' replays included; the wrapper's
        # counter sees the host's launches (eager and captured steps) alone
        launches = ran.fused
        attn = ran.counts["flash_fwd_sm90_kernel"]
        step_ms = [s.elapsed_time(e) for s, e in step_events]
        stats = dict(result=_image_stats(result), crop=_image_stats(cropped))
        rec = dict(sampler=sampler, steps=steps, s_per_img=seconds,
                   mean_step_ms=float(np.mean(step_ms)), step_ms=step_ms,
                   joint_seq=pipe.last_joint_seq, launches=launches, attention_kernels=attn,
                   host_launches=flash_attention_qk_norm_rope.launches,
                   expected_launches=per_block * steps,
                   graph_captures=graphs.captures - captures,
                   graph_replays=graphs.replays - replays,
                   adaln_launches=ran.counts["adaln_modulate_kernel"],
                   adaln_host_launches=adaln_modulate.launches,
                   memory_reserved=torch.cuda.memory_reserved(), images=stats)
        # the device runs every step's modulates; the host launches those of
        # the eager and captured forwards, a replay none
        rec["expected_adaln"] = dict(device=per_forward * steps,
                                     host=per_forward * (steps - rec["graph_replays"]))
        log("main path " + json.dumps(rec))
        runs[sampler] = rec
        for k_, st in stats.items():
            if not st["finite"] or st["std"] <= 0.0:
                raise AssertionError(f"{sampler}: {k_} image is not finite/non-constant: {st}")
        if launches != per_block * steps or attn != per_block * steps:
            raise AssertionError(f"{sampler}: the device ran norm_rope_kernel {launches} and "
                                 f"flash_fwd_sm90_kernel {attn} times, expected "
                                 f"{per_block} x {steps}")
        if (rec["adaln_launches"], rec["adaln_host_launches"]) != (
                rec["expected_adaln"]["device"], rec["expected_adaln"]["host"]):
            raise AssertionError(f"{sampler}: adaln_modulate_kernel ran {rec['adaln_launches']} "
                                 f"times on the device and {rec['adaln_host_launches']} on the "
                                 f"host, expected {rec['expected_adaln']}")
    second = runs["overshoot"]
    if (second["graph_captures"], second["graph_replays"]) != (0, second["steps"]):
        raise AssertionError(f"the second image of a canvas should replay the first one's "
                             f"graph every step: {second['graph_captures']} captures, "
                             f"{second['graph_replays']} replays")
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
    from textflux_torch.ops.adaln import adaln_modulate
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope

    torch.cuda.synchronize()
    flash_attention_qk_norm_rope.launches = 0
    adaln_modulate.launches = 0
    t0 = time.perf_counter()
    with DeviceLaunches() as ran:
        cli_main(argv)
    rec = dict(recorder.rec, seconds=time.perf_counter() - t0, steps=steps,
               launches=ran.fused, host_launches=flash_attention_qk_norm_rope.launches,
               expected_launches=expected_per_step * steps,
               # the int8 weight_only kernel's launches on the device
               int8_launches=ran.counts["w8a16_gemm_sm90_kernel"],
               # the AdaLN kernel's on the device and the host's launches of it
               adaln_launches=ran.counts["adaln_modulate_kernel"],
               adaln_host_launches=adaln_modulate.launches,
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
        with DeviceLaunches() as ran:
            batch = pipe.generate_batch([c[0] for c in canvases], [c[1] for c in canvases],
                                        words, num_inference_steps=2, seeds=[0, 1],
                                        seq_pad_multiple=64, **hw)
        batch_launches = ran.fused
        batch_s = time.perf_counter() - t0
        joint = pipe.last_joint_seq
        with DeviceLaunches() as ran:
            single = pipe(image=canvases[0][0], mask_image=canvases[0][1], words=words[0],
                          num_inference_steps=2, seed=0, seq_pad_multiple=64, **hw)[0]
        single_launches = ran.fused
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
# run C: the same LoRA training with the samples prepped in this many
# spawned worker processes (cli.train --loader-procs)
TRAIN_MAIN_PROCS = 2
# the loader-only probe: samples an epoch (the two example items repeated)
# and the loader's liveness interval
LOADER_PROBE_ITEMS = 8
LOADER_PROBE_POLL_S = 2.0
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
      disk);
    - the loader's worker processes, in process mode: their pids, the
      prefix of their files in shared memory, the largest sample file;
    - with `sink`, io.export.save_safetensors: the LoRA export's keys and
      bytes, nothing written."""

    def __init__(self, link_step=None, link_to=None, resume_file=None, sink=False):
        self.link_step, self.link_to, self.resume_file = link_step, link_to, resume_file
        self.sink, self.export, self.pool = sink, None, None
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
                        pool = loader._pool
                        if pool is not None:
                            self.pool = dict(pids=[p.pid for p in pool.procs],
                                             prefix=pool.prefix,
                                             sample_bytes=pool.sample_bytes,
                                             shm_budget_bytes=pool.budget)
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
            def kept(tc, params, *a, **kw):
                self.opt = orig(tc, params, *a, **kw)
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
        if self.sink:
            from textflux_torch.io import export as E

            def sink(sd, path, dtype=None):
                self.export = dict(keys=sorted(sd), bytes_it_would_write=sum(
                    v.numel() * v.element_size() for v in sd.values()), bytes_written=0)
                return 0

            self._patch(E, "save_safetensors", lambda orig: sink)
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


def train_main_json(work: str, name: str = "anyword.json", copies: int = 1) -> str:
    """The AnyWord json of TRAIN_MAIN_ITEMS (`copies` times over) at
    `work`/`name` (images: the example directory)."""
    data_json = os.path.join(work, name)
    with open(data_json, "w") as f:
        json.dump({"data_list": [
            {"img_name": img, "annotations": [
                {"text": text, "polygon": [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]}]}
            for _ in range(copies)
            for img, text, (x0, y0, x1, y1) in TRAIN_MAIN_ITEMS]}, f)
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


def _alive_pids(pids) -> list:
    """The pids of `pids` that still name a process (psutil where it is
    installed, else /proc)."""
    try:
        import psutil
    except ImportError:
        return [p for p in pids if os.path.exists(f"/proc/{p}")]
    return [p for p in pids if psutil.pid_exists(p)]


def _shm_usage() -> dict:
    from textflux_torch.data.loader import SHM_DIR

    du = shutil.disk_usage(SHM_DIR)
    return dict(path=SHM_DIR, total_bytes=du.total, free_bytes=du.free)


def _loader_probe(work: str, smi: str) -> tuple:
    """The loader's process mode alone, no model: two workers over an
    AnyWord json of LOADER_PROBE_ITEMS samples at TRAIN_RESOLUTION, the
    dataset built as cli.train.main builds it. A cold epoch (spawn, the
    workers' imports and dataset, every batch), a warm one during which
    both workers get SIGTERM (the epoch must stay whole), then one in which
    worker 1 is SIGKILLed after the first batch: the consumer must raise
    within 3 x worker_poll_s. Afterwards no worker and no file in shared
    memory may be left. Returns (the record, the problems)."""
    from textflux_torch.cli import train as CLI
    from textflux_torch.data import BucketedLoader
    from textflux_torch.data.loader import SHM_DIR

    data_json = train_main_json(work, "probe.json", LOADER_PROBE_ITEMS // len(TRAIN_MAIN_ITEMS))
    args = CLI.parse_args(["--model", "unused", "--data-json", data_json,
                           "--data-images", os.path.join(EXAMPLE, "ori"), "--output-dir", work,
                           "--resolution", str(TRAIN_RESOLUTION), "--seed", "0"])
    factory = functools.partial(CLI.build_dataset, args)
    before = set(os.listdir(SHM_DIR))
    loader = BucketedLoader(factory(), num_procs=2, dataset_factory=factory, seed=0,
                            worker_poll_s=LOADER_PROBE_POLL_S)
    rec, problems, pids = dict(card=smi, shm=_shm_usage(), poll_s=LOADER_PROBE_POLL_S), [], []
    t_probe = time.perf_counter()
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        rec["cold_first_batch_s"] = time.perf_counter() - t0
        rec["cold_epoch_batches"] = 1 + sum(1 for _ in it)
        rec["cold_epoch_s"] = time.perf_counter() - t0
        pool = loader._pool
        pids = [p.pid for p in pool.procs]
        rec.update(pids=pids, sample_bytes=pool.sample_bytes, shm_budget_bytes=pool.budget,
                   samples_in_flight=pool._window(loader.prefetch * loader.samples_per_batch * 2))
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        rec["warm_first_batch_s"] = time.perf_counter() - t0
        for pid in pids:
            os.kill(pid, signal.SIGTERM)
        rec["sigterm_epoch_batches"] = 1 + sum(1 for _ in it)
        rec["alive_after_sigterm"] = [p.is_alive() for p in pool.procs]
        it = iter(loader)
        next(it)
        os.kill(pids[1], signal.SIGKILL)
        t0 = time.perf_counter()
        rec["killed_error"] = None
        try:
            for _ in it:
                pass
        except RuntimeError as e:
            rec["killed_error"] = str(e)
        rec["killed_raised_after_s"] = time.perf_counter() - t0
    finally:
        loader.close()
    rec["seconds"] = time.perf_counter() - t_probe
    rec["pids_left"] = _alive_pids(pids)
    rec["shm_files_left"] = sorted(set(os.listdir(SHM_DIR)) - before)
    log("train_main loader_probe " + json.dumps(rec))
    if rec["cold_epoch_batches"] != LOADER_PROBE_ITEMS:
        problems.append(f"loader probe: {rec['cold_epoch_batches']} batches in an epoch, "
                        f"expected {LOADER_PROBE_ITEMS}")
    if rec["sigterm_epoch_batches"] != LOADER_PROBE_ITEMS or not all(rec["alive_after_sigterm"]):
        problems.append(f"loader probe: SIGTERM to the workers cut the epoch "
                        f"({rec['sigterm_epoch_batches']} batches) or ended a worker")
    if (rec["killed_error"] is None or "worker process" not in rec["killed_error"]
            or rec["killed_raised_after_s"] >= 3 * LOADER_PROBE_POLL_S):
        problems.append(f"loader probe: a SIGKILLed worker gave {rec['killed_error']!r} after "
                        f"{rec['killed_raised_after_s']:.2f} s (bound {3 * LOADER_PROBE_POLL_S} s)")
    if not pids or rec["pids_left"] or rec["shm_files_left"]:
        problems.append(f"loader probe left workers {rec['pids_left']} or shared-memory files "
                        f"{rec['shm_files_left']}")
    return rec, problems


def phase_train_main(smi: str, have_checkpoint: bool) -> dict:
    """LoRA training from a data directory through cli.train.main() at full
    width: an AnyWord json over the two example images, the checkpoint of
    phase 7 (written here when that phase did not run), Prodigy at lr 1.
    First the loader's process mode alone (``_loader_probe``). Run A trains
    4 steps, checkpointing at step 3 (one kept); run B resumes a
    hard-linked copy of A's step-3 checkpoint to step 4; run C trains 3
    steps with the samples prepped in TRAIN_MAIN_PROCS worker processes
    (--loader-procs; no profile, no checkpoint, the export to a sink); A's
    exported LoRA is then served for 2 steps. Launches per step, finite
    losses, the rotation, B's log, the export's keys and rank, the base
    checksum, the profile trace, C's workers and shared-memory files gone
    after main() and the round trip's fused launches are checked."""
    from textflux_torch.cli import train as CLI
    from textflux_torch.cli.run_inference import run
    from textflux_torch.config import flux_fill_config
    from textflux_torch.data.loader import SHM_DIR
    from textflux_torch.io.safetensors import SafetensorsFile
    from textflux_torch.ops import flash_attention as FA
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
    out_a, out_b, out_c = (os.path.join(work, x) for x in ("a", "b", "c"))
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
    out = {}
    log("train_main: shared memory " + json.dumps(_shm_usage()))
    out["loader_probe"], problems = _loader_probe(work, smi)
    a_state = os.path.join(out_a, "checkpoints", str(TRAIN_MAIN_CKPT_STEP), STATE_FILE)
    with byte_tokenizers("train_main"):
        resumed = list(range(TRAIN_MAIN_CKPT_STEP + 1, TRAIN_MAIN_STEPS + 1))
        for name, extra, hooks, want_steps in (
                ("A", ["--output-dir", out_a, "--profile-steps", "1"],
                 dict(link_step=TRAIN_MAIN_CKPT_STEP, link_to=out_b),
                 list(range(1, TRAIN_MAIN_STEPS + 1))),
                ("B", ["--output-dir", out_b, "--resume-from-checkpoint",
                       str(TRAIN_MAIN_CKPT_STEP)], dict(resume_file=a_state), resumed),
                ("C", ["--output-dir", out_c, "--loader-procs", str(TRAIN_MAIN_PROCS),
                       "--max-train-steps", str(TRAIN_MAIN_CKPT_STEP),
                       "--checkpointing-steps", str(TRAIN_MAIN_STEPS + 1)], dict(sink=True),
                 list(range(1, TRAIN_MAIN_CKPT_STEP + 1)))):
            for k in FLASH_KERNELS:
                getattr(FA, k).launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            shm_before = set(os.listdir(SHM_DIR))
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
            if name == "C":
                r.update(pool=rec.pool, pids_left=_alive_pids((rec.pool or {}).get("pids", [])),
                         shm_files_left=sorted(set(os.listdir(SHM_DIR)) - shm_before),
                         export_keys=len((rec.export or {}).get("keys", [])),
                         export_bytes_it_would_write=(rec.export or {}).get(
                             "bytes_it_would_write"))
                want_lora = {k for k in manifest["lora"]
                             if k.endswith(("lora_A.weight", "lora_B.weight"))}
                got_lora = {k for k in (rec.export or {}).get("keys", [])
                            if k.endswith(("lora_A.weight", "lora_B.weight"))}
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
            want_ckpts = [] if name == "C" else [TRAIN_MAIN_CKPT_STEP]
            if r["checkpoints"] != want_ckpts:
                problems.append(f"run {name} left checkpoints {r['checkpoints']}, expected "
                                f"{want_ckpts}")
            if name == "C":
                if not r["pool"] or len(r["pool"]["pids"]) != TRAIN_MAIN_PROCS:
                    problems.append(f"run C did not read through {TRAIN_MAIN_PROCS} worker "
                                    f"processes: {r['pool']}")
                if r["pids_left"] or r["shm_files_left"]:
                    problems.append(f"run C left workers {r['pids_left']} or shared-memory "
                                    f"files {r['shm_files_left']} after main() returned")
                if got_lora != want_lora:
                    problems.append(f"run C's export has {len(got_lora)} LoRA keys, the "
                                    f"manifest {len(want_lora)}")
        log("train_main data_wait_ms " + json.dumps(dict(
            card=smi, threads_A=out["A"]["data_wait_ms"], processes_C=out["C"]["data_wait_ms"],
            buckets_C=out["C"]["bucket_hw"], step_ms_A=out["A"]["step_ms"],
            step_ms_C=out["C"]["step_ms"],
            probe_cold_first_batch_s=out["loader_probe"]["cold_first_batch_s"],
            probe_warm_first_batch_s=out["loader_probe"]["warm_first_batch_s"])))
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
        t0 = time.perf_counter()
        with DeviceLaunches() as ran:
            pipe = FillPipeline.from_pretrained(CKPT_DIR, lora_path=out_a, device="cuda")
            img = run(pipe, *EXAMPLE_PATHS, steps=2, seed=0, sampler="euler")[0]
        rec.update(round_trip_seconds=time.perf_counter() - t0,
                   round_trip_load=pipe.load_stats,
                   round_trip_launches=ran.fused,
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


# DiT linears that run once an image in serving (flux_vec's embedders and
# flux_mods' modulations, precomputed for the schedule); the rest run once
# a denoise step
_ONCE_AN_IMAGE = ("time_in.", "guidance_in.", "vector_in.")


def _int8_split(flux) -> tuple:
    """(paths of `flux`'s weight_only linears that run once an image in
    serving, paths of those that run once a step)."""
    from textflux_torch.io.quantize import quantized_linears

    paths = [p for p, m in quantized_linears(flux).items() if m == "weight_only"]
    once = [p for p in paths if p.startswith(_ONCE_AN_IMAGE) or p.endswith("mod")]
    return once, [p for p in paths if p not in once]


def _int8_expected(flux, t5_linears: int, steps: int) -> dict:
    """The int8 kernel's launches on the device in one image of `steps`
    steps: each weight_only DiT linear once a step or once an image, and
    each of T5's `t5_linears` once (full width: 231 a step, 83 an image,
    168 an encode)."""
    once, each = _int8_split(flux)
    return dict(per_step=len(each), per_image=len(once), t5=t5_linears,
                total=steps * len(each) + len(once) + t5_linears)


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
    1 GiB above the loaded models' bytes, or when a launch count (the fused
    kernel's, or the int8 kernel's on the device: ``_int8_expected``), the
    quantised modules or an image are wrong. With `profile`, one more
    denoise step of each mode is traced (device time by kernel, idle
    share)."""
    from PIL import Image

    from textflux_torch.config import flux_fill_config, t5_xxl_config
    from textflux_torch.io.quantize import quantize_tree, quantized_linears
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import (FluxTransformer, flux_apply,
                                                   half_permute_flux_params)
    from textflux_torch.ops import int8_matmul as IM

    gc.collect()
    torch.cuda.empty_cache()
    if not have_checkpoint:
        _, flux = write_checkpoint(load_manifest())
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    flux_cfg = flux_fill_config()
    per_step = flux_cfg.num_double_layers + flux_cfg.num_single_layers
    per_forward = adaln_per_forward(flux_cfg)
    problems, out = [], {}
    # T5 is weight_only in every mode (a staged run releases it: counted here)
    t5_int8 = len(quantized_linears(quantize_tree(
        T5Encoder(t5_xxl_config(), device="meta", dtype=torch.bfloat16), mode="weight_only")))

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
            int8_before = IM.int8_matmul.launches
            with _Recorder() as recorder:
                rec = _run_main(argv + extra, recorder, QUANT_STEPS, per_step)
            pipe = recorder.pipe
            rec.update(card=smi, mode=mode, step_ms=recorder.step_ms(),
                       # the wrapper's count: a graph's capture calls it, its
                       # replays do not
                       int8_host_launches=IM.int8_matmul.launches - int8_before,
                       expected_int8=_int8_expected(pipe.flux, t5_int8, QUANT_STEPS),
                       graph_replays=pipe.flux.graphs.replays,
                       # a step's modulates on the device; the host's of the
                       # forwards not replayed
                       expected_adaln=dict(
                           device=per_forward * QUANT_STEPS,
                           host=per_forward * (QUANT_STEPS - pipe.flux.graphs.replays)),
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
            if rec["int8_launches"] != rec["expected_int8"]["total"]:
                problems.append(f"{name}: the int8 kernel ran {rec['int8_launches']} times, "
                                f"expected {rec['expected_int8']}")
            if (rec["adaln_launches"], rec["adaln_host_launches"]) != (
                    rec["expected_adaln"]["device"], rec["expected_adaln"]["host"]):
                problems.append(f"{name}: adaln_modulate_kernel ran {rec['adaln_launches']} "
                                f"times on the device and {rec['adaln_host_launches']} on the "
                                f"host, expected {rec['expected_adaln']}")
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
    from textflux_torch.ops import int8_matmul as IM
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
    starts, ends, counts, int8_counts = [], [], [], []

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
        int8_counts.append(IM.int8_matmul.launches)

    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    int8_before = IM.int8_matmul.launches
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
    int8_by_step = [b - a for a, b in zip([int8_before] + int8_counts, int8_counts)]
    # no graph in training: each weight_only linear once a forward, and the
    # blocks' again in the backward's recompute
    once, each = _int8_split(flux)
    blocks = [p for p in once + each if p.startswith(("double_blocks.", "single_blocks."))]
    int8_expected = len(once) + len(each) + (len(blocks) if tc.remat else 0)
    n_params = sum(p.numel() for p in TR.lora_parameters(lora))
    rec = dict(base=base_mode, steps=steps, init_s=t1 - t0, quantize_s=quantize_s,
               dit_bf16_bytes=bf16_bytes, dit_device_bytes=base_bytes,
               dit_modes=sorted(set(quantized_linears(flux).values())),
               step_ms=[s.elapsed_time(e) for s, e in zip(starts, ends)],
               history=history, launches={k: getattr(FA, k).launches for k in FLASH_KERNELS},
               launches_per_step=by_step, expected_per_step=per_step,
               # the int8 kernel's forwards (a weight_only base's products,
               # through its autograd function where x needs a gradient)
               int8_launches_per_step=int8_by_step, int8_expected_per_step=int8_expected,
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
    step, an int8 kernel count other than each weight_only linear's once a
    forward and once a recompute, or a target whose B did not move."""
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
        if rec["int8_launches_per_step"] != [rec["int8_expected_per_step"]] * steps:
            problems.append(f"{base_mode}: int8 kernel launches {rec['int8_launches_per_step']}"
                            f", expected {rec['int8_expected_per_step']} a step")
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
    with DeviceLaunches() as ran:
        run_eval_main(argv)
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
                launches=ran.fused, host_launches=flash_attention_qk_norm_rope.launches,
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

    original = _open_rgb(os.path.join(EXAMPLE, "ori", "ori_0001.png"))
    sketch = {"image": original, "mask": _open_rgb(os.path.join(EXAMPLE, "mask",
                                                                "mask_0001.png"))}
    out, problems = {}, []
    events = _timed_steps(pipe)
    for name, fn, words in (("custom_beta_1_line", D.demo_custom_beta, "OPEN"),
                            ("custom_beta_2_lines", D.demo_custom_beta, "OPEN\nCAFE 24H"),
                            ("custom", D.demo_custom, "OPEN")):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with DeviceLaunches() as ran:
            cropped, full, cond = fn(pipe, original, sketch, words, steps=EVAL_STEPS, seed=0)
        rec = dict(seconds=time.perf_counter() - t0, step_ms=[s.elapsed_time(e) for s, e in events],
                   launches=ran.fused,
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
    t0 = time.perf_counter()
    with DeviceLaunches() as ran:
        image = pipe(prompt="a shop sign that says 'OPEN'", height=T2I_SIZE, width=T2I_SIZE,
                     num_inference_steps=T2I_STEPS, seed=0, sampler="euler")[0]
    step_ms = [s.elapsed_time(e) for s, e in events]
    rec = dict(card=smi, in_channels=cfg.in_channels, blocks=[cfg.num_double_layers,
                                                              cfg.num_single_layers],
               init_s=init_s, seconds=time.perf_counter() - t0, steps=T2I_STEPS,
               joint_seq=pipe._fill.last_joint_seq, step_ms=step_ms,
               mean_step_ms=float(np.mean(step_ms)), attn_impl=pipe._fill.attn_impl,
               launches=ran.fused, expected_launches=per_step * T2I_STEPS,
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
            def kept(tc, params, masks=None, **kw):
                self.opt, self.masks = orig(tc, params, masks, **kw), masks
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


# ---------------------------------------------------------------------------
# 13. tp_serve: serving over torch.distributed ranks on the one card
# ---------------------------------------------------------------------------

TP_STEPS = 2
# tp=2 against tp=1 on the same weights, inputs and noise (bf16): each
# row-parallel product is summed from two bf16 partials (one more rounding)
# and cuBLAS picks its kernels by shape, so the first step's velocity is
# held within TP_VELOCITY_TOL relative L2 and each image within
# BATCH_MEAN_TOL / BATCH_MAX_TOL grey levels (mean / largest |difference|);
# the data-parallel images must equal the single-rank batch's bitwise
TP_VELOCITY_TOL = 0.03
TP_DIT_BYTES_MAX = 12.1e9      # a tp=2 rank's DiT: half of 23.80 GB + the replicated linears
TP_TIMEOUT = 900               # seconds a group of ranks may take, loads included


def _tp_data(work: str) -> tuple:
    """Phase 11's items (json, images) and the serving inputs: three samples
    of one //32 bucket (the first example image, each example's words, the
    first again), prepared as run_eval prepares them."""
    from textflux_torch.cli.run_eval import load_items, prepare_item
    from textflux_torch.rendering import load_font

    data_json, imgs = _eval_data(work)
    items = load_items(data_json)
    font = load_font(None, 60)
    preps = [prepare_item(items[i], imgs, font, 0.15625) for i in (0, 1, 0)]
    if len({p["size"] for p in preps}) != 1:
        raise AssertionError(f"tp_serve samples span buckets: {[p['size'] for p in preps]}")
    return data_json, imgs, preps


def _tp_noise(preps) -> list:
    """Fixed draws per sample (latents, VAE posterior eps) from CPU
    generators: the same in every process."""
    w, h = preps[0]["size"]
    lat_h, lat_w = h // 16 * 16 // 8, w // 16 * 16 // 8
    out = []
    for i in range(len(preps)):
        g = torch.Generator().manual_seed(1000 + i)
        out.append({"latents": torch.randn(1, (lat_h // 2) * (lat_w // 2), 64, generator=g),
                    "vae": torch.randn(1, lat_h, lat_w, 16, generator=g)})
    return out


@contextlib.contextmanager
def _velocities(store: list):
    """Each denoise step's DiT velocity appended to `store` (float32, host)
    while the block runs."""
    from textflux_torch.pipeline import fill as TF

    orig = TF.flux_apply

    def recorded(*a, **kw):
        v = orig(*a, **kw)
        store.append(v.float().cpu())
        return v

    TF.flux_apply = recorded
    try:
        yield
    finally:
        TF.flux_apply = orig


def _tp_serve_calls(pipe, preps, noise, *, single: bool, batch: int) -> dict:
    """On a pipeline staged to its DiT: the single-item call (the first
    sample) and generate_batch over the first `batch` samples, with the
    fixed noise; per call the images (uint8), the first step's velocity,
    step ms (CUDA events around each denoise step), fused launches and the
    collectives it ran."""
    from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope as fused
    from textflux_torch.parallel import partitioning as PT

    w, h = preps[0]["size"]
    common = dict(height=h, width=w, num_inference_steps=TP_STEPS, sampler="euler")
    events = []
    inner = pipe._denoise_step

    def timed(*a, **kw):
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        out = inner(*a, **kw)
        e_.record()
        events.append((s_, e_))
        return out

    pipe._denoise_step = timed
    calls = {}
    if single:
        calls["single"] = lambda: [np.asarray(pipe(
            image=preps[0]["image"], mask_image=preps[0]["mask"], seed=0, noise=noise[0],
            text_embeds=pipe._tp_embeds["single"], **common)[0])]
    if batch:
        pooled, txt = pipe._tp_embeds["batch"]
        calls["batch"] = lambda: [np.asarray(x) for x in pipe.generate_batch(
            [p["image"] for p in preps[:batch]], [p["mask"] for p in preps[:batch]],
            [p["words"] for p in preps[:batch]], seeds=list(range(batch)),
            noise=noise[:batch], text_embeds=(pooled[:batch], txt[:batch]), **common)]
    out = {}
    for name, call in calls.items():
        vel = []
        events.clear()
        torch.cuda.synchronize()
        fused.launches = 0
        PT.reset_counts()
        t0 = time.perf_counter()
        with _velocities(vel):
            images = call()
        torch.cuda.synchronize()
        out[name] = dict(images=np.stack(images), velocity=vel[0].numpy(),
                         seconds=time.perf_counter() - t0,
                         step_ms=[a.elapsed_time(b) for a, b in events],
                         launches=fused.launches, collectives=PT.counts())
    pipe._denoise_step = inner
    return out


def _tp_load(mesh, preps, *, batch: int):
    """from_pretrained(mesh=) with staged residency: every prompt encoded
    (the single call's prompts and the batch's), the encoders released, the
    DiT (this rank's shard) loaded; with the load's seconds, bytes and the
    device's peak over it."""
    from textflux_torch.pipeline.fill import FillPipeline
    from textflux_torch.pipeline.prompts import build_prompts

    with byte_tokenizers("tp_serve"):
        pipe = FillPipeline.from_pretrained(CKPT_DIR, defer_transformer=True, mesh=mesh,
                                            device="cuda")
    embeds = {"single": pipe.encode_prompts(*build_prompts(preps[0]["words"])),
              "batch": pipe.encode_batch_prompts([p["words"] for p in preps[:batch]])}
    pipe.release_text_encoders()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.load_transformer()
    torch.cuda.synchronize()
    load = dict(seconds=time.perf_counter() - t0,
                dit_device_bytes=pipe.load_stats["transformer"]["device_bytes"],
                checkpoint_bytes=pipe.load_stats["transformer"]["bytes"],
                load_peak_bytes=torch.cuda.max_memory_allocated() - base,
                models_bytes=_models_bytes(pipe))
    pipe._tp_embeds = embeds
    return pipe, load


def tp_child(spec_path: str) -> int:
    """One rank of the tp_serve phase (``--tp-child``): "two" ranks join a
    gloo group on cuda:0 and serve on each mesh of the spec's runs in turn
    (tp, dp, fsdp), "int8" ranks the int8 DiT at (1, 2, 2); "nccl" runs
    cli.run_eval.main with --mesh 1,1,1 as torchrun would start it (an
    NCCL group of one). Writes its record beside the spec."""
    from datetime import timedelta

    import torch.distributed as dist

    from textflux_torch.parallel import partitioning as PT

    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(role=spec["role"], rank=spec["rank"])
    arrays = {}
    if spec["role"] == "nccl":
        from textflux_torch.cli.run_eval import main as run_eval_main
        from textflux_torch.ops.flash_attention import flash_attention_qk_norm_rope as fused

        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(spec["port"]))
        out_dir = os.path.join(spec["work"], "nccl_eval")
        with byte_tokenizers("tp_serve nccl"):
            run_eval_main(["--model", CKPT_DIR, "--json-path", spec["data_json"],
                           "--original-images-dir", spec["imgs"], "--output-dir", out_dir,
                           "--steps", str(TP_STEPS), "--limit", "1", "--mesh", "1,1,1"])
        with open(os.path.join(out_dir, "failures.json")) as f:
            report = json.load(f)
        rec.update(backend=dist.get_backend(), world_size=dist.get_world_size(),
                   launches=fused.launches,
                   report={k: report[k] for k in ("total", "done", "failed")})
        dist.destroy_process_group()
    elif spec["role"] == "int8":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                                rank=spec["rank"], world_size=spec["world"],
                                timeout=timedelta(seconds=TP_TIMEOUT))
        mesh = PT.make_mesh(tuple(spec["shape"]), device="cuda:0")
        rec.update(_int8_serve(spec, mesh, arrays))
        dist.barrier()
        dist.destroy_process_group()
    else:   # "two": each of spec["runs"] in turn, on a mesh of its own
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                                rank=spec["rank"], world_size=spec["world"],
                                timeout=timedelta(seconds=TP_TIMEOUT))
        _, _, preps = _tp_data(os.path.join(spec["work"], f"data_rank{spec['rank']}"))
        noise = _tp_noise(preps)
        for run in spec["runs"]:
            role = run["role"]
            mesh = PT.make_mesh(tuple(run["shape"]), device="cuda:0")
            batch = run["batch"]
            pipe, load = _tp_load(mesh, preps, batch=batch)
            torch.cuda.reset_peak_memory_stats()
            calls = _tp_serve_calls(pipe, preps, noise, single=role == "tp", batch=batch)
            r = dict(role=role, rank=spec["rank"], mesh=mesh.shape, coords=mesh.coords,
                     batch_rank=mesh.batch_rank, backend=dist.get_backend(),
                     device=str(mesh.device), load=load,
                     serve_peak_bytes=torch.cuda.max_memory_allocated(),
                     heads_per_rank=pipe.flux.double_blocks[0].img_qkv.out_features // 3 // 128)
            for name, c in calls.items():
                arrays[f"{role}_{name}_images"] = c.pop("images")
                arrays[f"{role}_{name}_velocity"] = c.pop("velocity")
                r[name] = c
            rec[role] = r
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
        try:   # what FSDP (ROADMAP item 6b) would need of gloo on the card
            shard = torch.empty(2, device="cuda:0")
            dist.reduce_scatter_tensor(shard, torch.ones(2 * spec["world"], device="cuda:0"))
            rec["gloo_reduce_scatter_cuda"] = f"ok, {shard.tolist()}"
        except Exception as e:   # the same on every rank: gloo refuses before any transfer
            rec["gloo_reduce_scatter_cuda"] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
        dist.destroy_process_group()
    np.savez(spec["out"] + ".npz", **arrays)
    with open(spec["out"] + ".json", "w") as f:
        json.dump(rec, f)
    return 0


TP_INT8_BATCH = 4     # __graft_entry__.py _dryrun_serving's batch at (2, 2, 2)


def _int8_pipeline(mesh):
    """A FillPipeline of a full-width DiT at TRAIN_FULL_REDUCED_DEPTH (seed
    0, bf16, the fused serving path) and the VAE, no text encoders (the
    prompts come in as embeddings), its DiT quantised int8 weight-only:
    sharded over `mesh`, or whole (None)."""
    from textflux_torch.config import flux_fill_config, flux_vae_config
    from textflux_torch.io.quantize import quantize_tree
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.pipeline.fill import FillPipeline

    n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
    cfg = dataclasses.replace(flux_fill_config(), num_double_layers=n_double,
                              num_single_layers=n_single)
    flux = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    vae = FluxVAE(flux_vae_config(), device="cuda", dtype=torch.bfloat16,
                  generator=torch.Generator(device="cuda").manual_seed(1))
    pipe = FillPipeline(flux=flux, vae=vae, clip=None, t5=None, device="cuda")
    if mesh is None:
        quantize_tree(pipe.flux, mode="weight_only")
    else:
        pipe.shard_for_serving(mesh, quantize="weight_only")
    return pipe


def _int8_serve(spec, mesh, arrays) -> dict:
    """generate_batch of TP_INT8_BATCH samples (2 euler steps, fixed noise
    and prompt embeddings) through the int8 DiT sharded over `mesh`: each
    rank's images, first-step velocity, step ms, launches, collectives and
    DiT bytes; then (rank 0, the others waiting) the same on one rank."""
    import torch.distributed as dist

    from textflux_torch.parallel import partitioning as PT

    _, _, preps = _tp_data(os.path.join(spec["work"], f"data_rank{spec['rank']}"))
    preps = (preps + preps)[:TP_INT8_BATCH]
    noise = _tp_noise(preps)
    g = torch.Generator().manual_seed(7)
    embeds = (torch.randn(TP_INT8_BATCH, 768, generator=g).cuda().bfloat16(),
              torch.randn(TP_INT8_BATCH, 512, 4096, generator=g).cuda().bfloat16())
    out = {}
    for label, m in (("sharded", mesh), ("single", None)):
        if label == "single":
            dist.barrier()
            if spec["rank"] != 0:
                break
        pipe = _int8_pipeline(m)
        pipe._tp_embeds = {"batch": embeds}
        torch.cuda.reset_peak_memory_stats()
        r = _tp_serve_calls(pipe, preps, noise, single=False, batch=TP_INT8_BATCH)["batch"]
        arrays[f"{label}_images"] = r.pop("images")
        arrays[f"{label}_velocity"] = r.pop("velocity")
        r.update(dit_bytes=(PT.storage_bytes(pipe.flux) if m is not None else
                            sum(t.numel() * t.element_size() for t in
                                list(pipe.flux.parameters()) + list(pipe.flux.buffers()))),
                 serve_peak_bytes=torch.cuda.max_memory_allocated())
        out[label] = r
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    out.update(mesh=mesh.shape, coords=mesh.coords, batch_rank=mesh.batch_rank)
    return out


def _run_ranks(work: str, role: str, world: int, *, child: str = "--tp-child",
               phase: str = "tp_serve", timeout: float = TP_TIMEOUT, **spec) -> list:
    """`world` processes of this script (`child`: --tp-child or
    --fsdp-child) in `role` on the card, each with its own log under
    `work`; waits up to `timeout` or until a rank fails, kills every one
    still alive then, and fails the phase (with each log's tail) if a rank
    failed."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs, outs = [], [], []
    try:
        for rank in range(world):
            base = os.path.join(work, f"{role}_rank{rank}")
            with open(base + ".spec.json", "w") as f:
                json.dump(dict(spec, role=role, rank=rank, world=world, port=port, out=base,
                               work=work), f)
            logs.append(open(base + ".log", "w"))
            outs.append(base)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), child, base + ".spec.json"],
                cwd=REPO, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break   # a rank failed: the others may be waiting in a collective
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.poll() != 0]
    if failed:
        for r in failed:
            with open(outs[r] + ".log") as f:
                log(f"{phase} {role} rank {r} (exit {procs[r].returncode}), log tail:\n"
                    + f.read()[-6000:])
        raise AssertionError(f"{phase}: {role} ranks {failed} failed")
    results = []
    for base in outs:
        with open(base + ".json") as f:
            rec = json.load(f)
        if os.path.exists(base + ".npz"):
            rec["arrays"] = dict(np.load(base + ".npz"))
        results.append(rec)
    return results


def _image_diff(a, b) -> dict:
    d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    return dict(max=int(d.max()), mean=float(d.mean()))


def phase_tp_serve(smi: str, have_checkpoint: bool) -> dict:
    """Phase 13. Phase 7's checkpoint (written here when no earlier phase
    did) served over torch.distributed ranks sharing the one card: a tp=1
    reference in this process (the single-item call and a batch of 3, fixed
    noise, staged residency), freed; then 2 ranks over gloo at mesh (1, 1,
    2) through FillPipeline.from_pretrained(mesh=) (the single call and a
    batch of 2) held to it within TP_VELOCITY_TOL and the image bounds, with
    57 fused launches and 114 all-reduces a step on each rank and each
    rank's DiT under TP_DIT_BYTES_MAX; 2 ranks at (2, 1, 1) with the ragged
    batch of 3, bitwise equal to the reference batch; and one rank of
    cli.run_eval.main --mesh 1,1,1 over NCCL (the group's init and its
    all-reduce on the card). Two ranks share the card over gloo (NCCL
    refuses two ranks on one device): their collectives go through the
    host, so their step times are not a multi-GPU number."""
    from textflux_torch.config import flux_fill_config

    gc.collect()
    torch.cuda.empty_cache()
    if not have_checkpoint:
        _, flux = write_checkpoint(load_manifest())
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    work = os.path.join(CKPT_DIR, "tp_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    data_json, imgs, preps = _tp_data(os.path.join(work, "data"))
    noise = _tp_noise(preps)
    cfg = flux_fill_config()
    per_step = cfg.num_double_layers + cfg.num_single_layers
    all_reduces = 4 * cfg.num_double_layers + cfg.num_single_layers
    log(f"tp_serve: velocity rel-L2 tol {TP_VELOCITY_TOL}, image tol mean {BATCH_MEAN_TOL} / "
        f"max {BATCH_MAX_TOL} levels (tp=2 vs tp=1), dp images bitwise; expect "
        f"{per_step} fused launches and {all_reduces} all-reduces a step per tp rank")

    pipe, ref_load = _tp_load(None, preps, batch=len(preps))
    torch.cuda.reset_peak_memory_stats()
    ref = _tp_serve_calls(pipe, preps, noise, single=True, batch=len(preps))
    ref_peak = torch.cuda.max_memory_allocated()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    problems = []
    out = {"reference": dict(load=ref_load, serve_peak_bytes=ref_peak,
                             **{k: {x: v[x] for x in ("seconds", "step_ms", "launches")}
                                for k, v in ref.items()})}
    log("tp_serve reference " + json.dumps(out["reference"]))

    # the 2-rank meshes in one spawn: tp=2 (vs tp=1), dp=2 (bitwise), fsdp=2
    two = _run_ranks(work, "two", 2, runs=[dict(role="tp", shape=[1, 1, 2], batch=2),
                                           dict(role="dp", shape=[2, 1, 1], batch=len(preps)),
                                           dict(role="fsdp", shape=[1, 2, 1], batch=2)])

    def ranks_of(role):
        """Each rank's record of one run of the spawn, its arrays unprefixed."""
        out = []
        for r in two:
            x = dict(r[role], gloo_reduce_scatter_cuda=r["gloo_reduce_scatter_cuda"])
            x["arrays"] = {k[len(role) + 1:]: v for k, v in r["arrays"].items()
                           if k.startswith(role + "_")}
            out.append(x)
        return out

    tp = ranks_of("tp")
    tp_out = []
    for r in tp:
        a = r.pop("arrays")
        rec = dict(r)
        for name, n_img in (("single", 1), ("batch", 2)):
            c = rec[name]
            steps = len(c["step_ms"])
            c.update(launches_per_step=c["launches"] / steps,
                     all_reduces_per_step=c["collectives"]["all_reduce_sum"] / steps,
                     velocity_rel_l2=_rel_l2(torch.from_numpy(a[f"{name}_velocity"]),
                                             torch.from_numpy(ref[name]["velocity"][:n_img])),
                     image_diff=[_image_diff(x, y) for x, y in
                                 zip(a[f"{name}_images"], ref[name]["images"][:n_img])])
            if c["launches"] != per_step * steps or (
                    c["collectives"]["all_reduce_sum"] != all_reduces * steps):
                problems.append(f"tp rank {r['rank']} {name}: {c['launches']} launches, "
                                f"{c['collectives']['all_reduce_sum']} all-reduces in {steps} "
                                "steps")
            if not c["velocity_rel_l2"] <= TP_VELOCITY_TOL:
                problems.append(f"tp rank {r['rank']} {name}: velocity rel-L2 "
                                f"{c['velocity_rel_l2']}")
            for d in c["image_diff"]:
                if d["mean"] > BATCH_MEAN_TOL or d["max"] > BATCH_MAX_TOL:
                    problems.append(f"tp rank {r['rank']} {name}: image diff {d}")
        if not rec["load"]["dit_device_bytes"] <= TP_DIT_BYTES_MAX:
            problems.append(f"tp rank {r['rank']}: DiT {rec['load']['dit_device_bytes']} bytes")
        rec["step_ms_note"] = ("2 ranks sharing one H100 over gloo: collectives through the "
                               "host, not a multi-GPU number")
        tp_out.append((rec, a))
        log("tp_serve tp " + json.dumps(rec))
    for name in ("single_images", "batch_images"):
        if not np.array_equal(tp_out[0][1][name], tp_out[1][1][name]):
            problems.append(f"tp ranks return different {name}")
    out["tp"] = [rec for rec, _ in tp_out]

    dp = ranks_of("dp")
    out["dp"] = []
    for r in dp:
        a = r.pop("arrays")
        diff = [_image_diff(x, y) for x, y in zip(a["batch_images"], ref["batch"]["images"])]
        r["batch"]["image_diff_vs_reference"] = diff
        r["batch"]["bitwise_equal"] = bool(np.array_equal(a["batch_images"],
                                                          ref["batch"]["images"]))
        if not r["batch"]["bitwise_equal"]:
            problems.append(f"dp rank {r['rank']}: images differ from the reference batch "
                            f"({diff})")
        out["dp"].append(r)
        log("tp_serve dp " + json.dumps(r))

    # over the fsdp axis: the DiT storage-sharded, a sample a rank, 0 all-reduces
    fsdp = ranks_of("fsdp")
    out["fsdp"] = []
    for r in fsdp:
        a = r.pop("arrays")
        rows = {"batch": slice(r["batch_rank"], r["batch_rank"] + 1)}
        for name in ("batch",):   # each block gathered through the host: one call
            c = r[name]
            steps = len(c["step_ms"])
            c.update(launches_per_step=c["launches"] / steps,
                     all_gather_storage_per_step=c["collectives"]["all_gather_storage"] / steps,
                     velocity_rel_l2=_rel_l2(torch.from_numpy(a[f"{name}_velocity"]),
                                             torch.from_numpy(ref[name]["velocity"][rows[name]])),
                     image_diff=[_image_diff(x, y) for x, y in
                                 zip(a[f"{name}_images"], ref[name]["images"][:2])])
            if c["launches"] != per_step * steps or c["collectives"]["all_reduce_sum"]:
                problems.append(f"fsdp rank {r['rank']} {name}: {c['launches']} launches, "
                                f"{c['collectives']['all_reduce_sum']} all-reduces")
            if not c["velocity_rel_l2"] <= TP_VELOCITY_TOL:
                problems.append(f"fsdp rank {r['rank']} {name}: velocity rel-L2 "
                                f"{c['velocity_rel_l2']}")
            for d in c["image_diff"]:
                if d["mean"] > BATCH_MEAN_TOL or d["max"] > BATCH_MAX_TOL:
                    problems.append(f"fsdp rank {r['rank']} {name}: image diff {d}")
        if not r["load"]["dit_device_bytes"] <= TP_DIT_BYTES_MAX:
            problems.append(f"fsdp rank {r['rank']}: DiT {r['load']['dit_device_bytes']} bytes")
        out["fsdp"].append(r)
        log("tp_serve fsdp " + json.dumps(r))

    # (1, 2, 2): an int8 DiT at 2 + 4 blocks, batch 4, against one rank
    int8 = _run_ranks(work, "int8", 4, shape=[1, 2, 2])
    single = int8[0]["single"]
    single_a = int8[0]["arrays"]
    out["int8_fsdp2_tp2"] = []
    for r in int8:
        a = r.pop("arrays")
        c = r["sharded"]
        b0 = r["batch_rank"] * (TP_INT8_BATCH // 2)
        c["velocity_rel_l2"] = _rel_l2(
            torch.from_numpy(a["sharded_velocity"]),
            torch.from_numpy(single_a["single_velocity"][b0:b0 + TP_INT8_BATCH // 2]))
        c["image_diff"] = [_image_diff(x, y) for x, y in
                           zip(a["sharded_images"], single_a["single_images"])]
        c["dit_bytes_ratio"] = c["dit_bytes"] / single["dit_bytes"]
        steps = len(c["step_ms"])
        n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
        if (c["launches"] != (n_double + n_single) * steps
                or c["collectives"]["all_reduce_sum"] != (4 * n_double + n_single) * steps):
            problems.append(f"int8 rank {r['rank']}: {c['launches']} launches, "
                            f"{c['collectives']} collectives in {steps} steps")
        if not c["velocity_rel_l2"] <= TP_VELOCITY_TOL:
            problems.append(f"int8 rank {r['rank']}: velocity rel-L2 {c['velocity_rel_l2']}")
        for d in c["image_diff"]:
            if d["mean"] > BATCH_MEAN_TOL or d["max"] > BATCH_MAX_TOL:
                problems.append(f"int8 rank {r['rank']}: image diff {d}")
        out["int8_fsdp2_tp2"].append(r)
        log("tp_serve int8 (1,2,2) " + json.dumps(r))

    nccl = _run_ranks(work, "nccl", 1, data_json=data_json, imgs=imgs)[0]
    nccl.pop("arrays")
    if nccl["backend"] != "nccl" or nccl["report"]["done"] != 1 or nccl["report"]["failed"]:
        problems.append(f"nccl run_eval: {nccl}")
    out["nccl"] = nccl
    log("tp_serve nccl " + json.dumps(nccl))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"tp_serve: {out['seconds']:.1f} s; {smi}")
    shutil.rmtree(work, ignore_errors=True)
    if problems:
        raise AssertionError("tp_serve phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 14. fsdp_train: training over the fsdp axis, ranks sharing the one card
# ---------------------------------------------------------------------------

FSDP_WORLD = 2
FSDP_STEPS = 2
FSDP_TIMEOUT = 1000            # seconds a group of ranks may take, loads included
# 2 ranks against one rank on the same global batch of 2, same card, bf16:
# each rank's gradient is reduced in float32 from its own row's bf16
# products (one batch of 2 on one rank rounds them together), so
FSDP_LOSS_RTOL = 1e-3          # the loss (the ranks' mean) relative
FSDP_NORM_RTOL = 1e-2          # the global grad norm relative
FSDP_DELTA_RTOL = 0.03         # the trained tensors' change p - p0, relative L2
# Adam's eps in the reduced runs: at the default 1e-8 every element steps by
# ~lr whatever its gradient's size (|g| ~ 4e-6 here), so a gradient that
# cancels to near zero and comes out with the other sign (two rows' bf16
# gradients summed in float32 on two ranks, one batch's on one) moves a
# whole step the other way: 3.8-4.1% relative L2 of p - p0 on an H100 80GB
# HBM3 at 700 W (PERF.md §6). At 1e-5 a step is lr * g / (|g| + 1e-5), smooth
# in g, so the change measures the gradients' agreement, as
# tests/test_torch_full_train.py holds its Adam steps to JAX's
FSDP_ADAM_EPS = 1e-5
FSDP_HALF_RTOL = 0.01          # a rank's masters / optimizer state: half the one rank's
FSDP_RECKON_RTOL = 0.01        # the reckoning against the measured bytes
FSDP_REDUCED_RUNS = (("attn", "adamw"), ("attn", "adamw8bit"), ("all", "adamw8bit"))
FSDP_RECKON_RUNS = (("lora", "adamw"), ("attn", "adamw8bit"), ("attn", "adamw"),
                    ("all", "adamw8bit"))
FSDP_MAIN_ITEMS = (("ori_0001.png", "OPEN", (102, 128, 409, 256)),
                   ("ori_0001.png", "SALE", (102, 128, 409, 256)))   # one bucket: a batch of 2


def _local_checksums(model, masks) -> dict:
    """full_checksums over each parameter's local slice (the whole tensor
    when it is not sharded), its mask cut to match."""
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training.train import _local_mask

    out = {"frozen": {}, "trained": {}, "masked": {}}
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = PT.local(p.detach())
            if name not in masks:
                out["frozen"][name] = param_checksum(x)
                continue
            m = _local_mask(masks[name], p, PT.shard_spec(p))
            if m is None:
                out["trained"][name] = param_checksum(x)
                continue
            keep = torch.broadcast_to(m != 0, x.shape)
            out["trained"][name] = param_checksum(x[keep])
            if not bool(keep.all()):
                out["masked"][name] = param_checksum(x[~keep])
    return out


def _local_bytes(model, names, opt) -> dict:
    """Device bytes a rank holds of the training state, by part: each
    parameter's local slice (trained masters, frozen weights), the local
    gradients and the optimizer's local state."""
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training.optim8bit import state_bytes

    def size(t):
        t = PT.local(t)
        return t.numel() * t.element_size()

    params = dict(model.named_parameters())
    inner = getattr(opt, "opt", None)
    return dict(
        master_bytes=sum(size(params[k]) for k in names),
        frozen_bytes=sum(size(p) for k, p in params.items() if k not in names),
        grad_bytes=sum(size(p.grad) for p in params.values() if p.grad is not None),
        optimizer_state_bytes=state_bytes(dict(inner.state) if inner is not None
                                          else opt.state))


def fsdp_reckoning(cfg, mode: str, optimizer: str, n: int, lora_rank: int = 128) -> dict:
    """Bytes one of `n` fsdp ranks holds of the training state, from the
    sharding plan alone (a DiT of `cfg` on the meta device): each
    parameter's local slice (torch.chunk's first, largest share; nn.Linear
    weights split along dim 1, every other tensor along dim 0) in its dtype
    (float32 masters, bf16 frozen weights), a float32 gradient per trained
    slice, and the optimizer's state per local element (AdamW: two float32
    moments and a step; 8-bit AdamW: two int8 codes and a float32 scale per
    256-block, per JAX leaf, a leaf whose slices are not whole blocks kept
    whole; Prodigy is not reckoned). LoRA: the frozen bf16 base and rank
    `lora_rank` float32 factors."""
    from torch import nn

    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.training import optim8bit as O
    from textflux_torch.training import train as TR

    model = FluxTransformer(cfg, device="meta", dtype=torch.bfloat16)
    if mode == "lora":
        TR.lora_insert(model, TR.lora_init(model, lora_rank, device="meta"), 1.0)
        trained = {n_ for n_, p in model.named_parameters() if p.requires_grad}
    else:
        trained = set(TR.trainable_mask(model, TR.TrainConfig(mode=mode)))
    weights = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}

    def chunk(p):
        dim = 1 if id(p) in weights else 0
        size = p.shape[dim]
        c = -(-size // n)
        return dim, c, [(min(r * c, size), min((r + 1) * c, size)) for r in range(n)]

    out = dict(master_bytes=0, frozen_bytes=0, grad_bytes=0, optimizer_state_bytes=0)
    leaves = {}
    for name, p in model.named_parameters():
        dim, c, parts = chunk(p)
        local = p.numel() // p.shape[dim] * (parts[0][1] - parts[0][0])
        if name not in trained:
            out["frozen_bytes"] += 2 * local
            continue
        out["master_bytes"] += 4 * local
        out["grad_bytes"] += 4 * local
        if optimizer == "adamw":
            out["optimizer_state_bytes"] += 8 * local + 4
            continue
        key, _, transpose = TR.jax_leaf(name)
        inner = p.numel() // p.shape[dim]
        runs_whole = all((a * inner) % O.BLOCK == 0 and (b * inner) % O.BLOCK == 0
                         for a, b in parts)
        leaf = leaves.setdefault(key, dict(local=True, local_numel=0, numel=0))
        leaf["local"] &= runs_whole
        leaf["local_numel"] += local
        leaf["numel"] += p.numel()
    for leaf in leaves.values():
        blocks = O.n_blocks(leaf["local_numel"] if leaf["local"] else leaf["numel"])
        out["optimizer_state_bytes"] += 2 * blocks * (O.BLOCK + 4)
    out["total_bytes"] = sum(out.values())
    return out


def _two_row_batch() -> dict:
    """A whole batch of 2 at 1024 px: the training sample and its mirror
    image (so the two rows differ)."""
    s = training_sample()
    return {"pixel_values": np.concatenate([s["pixel_values"],
                                            s["pixel_values"][:, :, :, ::-1]], axis=1),
            "mask": np.concatenate([s["mask"], s["mask"][:, :, :, ::-1]], axis=1),
            "prompts": s["prompts"] * 2, "clip_prompts": s["clip_prompts"] * 2}


def _fsdp_run(mode, optimizer, models, batch, mesh, keep_delta: bool) -> dict:
    """FSDP_STEPS steps of train_full at full width and
    TRAIN_FULL_REDUCED_DEPTH (weights from seed 0, bf16; train_full makes
    the trained ones float32 masters), sharded over `mesh` or (None) on
    this rank alone; with `keep_delta`, every trained tensor's change
    gathered whole to the host."""
    from textflux_torch.cli.train import train_full
    from textflux_torch.config import flux_fill_config
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import train as TR

    vae, clip, t5 = models
    n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
    cfg = dataclasses.replace(flux_fill_config(), num_double_layers=n_double,
                              num_single_layers=n_single)
    flux = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    tc = TR.TrainConfig(mode=mode, optimizer=optimizer, adam_eps=FSDP_ADAM_EPS)
    masks = TR.trainable_mask(flux, tc)
    p0 = ({n: p.detach().float().cpu() for n, p in flux.named_parameters() if n in masks}
          if keep_delta else None)
    seen, counts, ms = {}, [], []
    t = [None]

    def batches():
        while True:
            torch.cuda.synchronize()
            t[0] = time.perf_counter()
            yield batch

    def on_step(step, metrics, model):
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t[0]))
        counts.append({k: getattr(FA, k).launches for k in FLASH_KERNELS})

    orig = TR.make_optimizer

    def keep_opt(tc_, params, masks_=None, **kw):
        seen["opt"] = orig(tc_, params, masks_, **kw)
        seen["masks"] = masks_   # a tensor shard's masks are cut like its weights
        seen["before"] = _local_checksums(flux, masks_)
        return seen["opt"]

    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    TR.make_optimizer = keep_opt
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flux, history = train_full(flux, vae, clip, t5, batches(), tc=tc,
                                   clip_tokenize=clip_byte_tokenize,
                                   t5_tokenize=t5_byte_tokenize, steps=FSDP_STEPS, seed=0,
                                   log_every=1, on_step=on_step, mesh=mesh)
    finally:
        TR.make_optimizer = orig
    torch.cuda.synchronize()
    prev, by_step = {k: 0 for k in FLASH_KERNELS}, []
    for c in counts:
        by_step.append({k: c[k] - prev[k] for k in FLASH_KERNELS})
        prev = c
    r = dict(mode=mode, optimizer=optimizer, adam_eps=tc.adam_eps,
             mesh=None if mesh is None else mesh.shape,
             loss=[e["loss"] for e in history], grad_norm=[e["grad_norm"] for e in history],
             step_ms=ms, launches_per_step=by_step,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             bytes=_local_bytes(flux, set(masks), seen["opt"]),
             local_8bit_leaves=sum(getattr(seen["opt"], "local", [])),
             checksums=_checksum_report(seen["before"], _local_checksums(flux, seen["masks"])))
    delta = None
    for name, p in flux.named_parameters():   # every rank: a sharded tensor is gathered
        if name in masks:
            whole = PT.whole_tensor(flux, name, p)
            if keep_delta:
                whole = whole.float().cpu()
                delta = {} if delta is None else delta
                delta[name] = whole - p0[name]
    del flux, seen
    gc.collect()
    torch.cuda.empty_cache()
    return r, delta


def _rel_report(sharded, single, delta, ref) -> dict:
    """The agreement of a sharded run with one rank's on the same batch:
    the loss and grad norm relative, the trained tensors' change relative
    L2, and the share of elements that stepped the other way."""
    num = sum(float((delta[k] - ref[k]).square().sum()) for k in ref)
    den = sum(float(ref[k].square().sum()) for k in ref)
    flips = sum(int((torch.sign(delta[k]) * torch.sign(ref[k]) < 0).sum()) for k in ref)
    return dict(delta_rel_l2=(num / den) ** 0.5,
                sign_flip_share=flips / sum(ref[k].numel() for k in ref),
                loss_rel=[abs(a - b) / abs(b) for a, b in zip(sharded["loss"], single["loss"])],
                grad_norm_rel=[abs(a - b) / abs(b) for a, b in
                               zip(sharded["grad_norm"], single["grad_norm"])])


@functools.lru_cache(maxsize=None)
def _reduced_models():
    """The VAE, CLIP and T5 at full width (bf16, seed 1) of the reduced runs,
    made once a process."""
    from textflux_torch.config import clip_l_config, flux_vae_config, t5_xxl_config
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.vae import FluxVAE

    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    return (FluxVAE(flux_vae_config(), device="cuda", dtype=dt, generator=gen),
            CLIPTextModel(clip_l_config(), device="cuda", dtype=dt, generator=gen),
            T5Encoder(t5_xxl_config(), device="cuda", dtype=dt, generator=gen))


def _reduced_vs_one_rank(mesh, rank, runs) -> dict:
    """Each (mode, optimizer) of `runs` at full width and
    TRAIN_FULL_REDUCED_DEPTH over `mesh`, then (rank 0, the other ranks
    waiting) on rank 0 alone on the same whole batch of 2: the agreement
    (``_rel_report``) and the bytes against one rank's."""
    import torch.distributed as dist

    models = _reduced_models()
    batch = _two_row_batch()
    out = {}
    for mode, optimizer in runs:
        sharded, delta = _fsdp_run(mode, optimizer, models, batch, mesh, keep_delta=rank == 0)
        rec = dict(sharded=sharded)
        dist.barrier()
        if rank == 0:
            single, ref = _fsdp_run(mode, optimizer, models, batch, None, keep_delta=True)
            rec.update(single=single, **_rel_report(sharded, single, delta, ref),
                       bytes_ratio={k: sharded["bytes"][k] / single["bytes"][k]
                                    for k in ("master_bytes", "optimizer_state_bytes")})
            del delta, ref
            gc.collect()
        dist.barrier()
        out[f"{mode}_{optimizer}"] = rec
    return out


class _FsdpMainRecorder:
    """Instruments one cli.train.main() run over the mesh in a rank, while
    the block runs: each step's host seconds (synchronised) and flash
    launches, the FSDP all-gathers and reduce-scatters of the second step
    (torch.profiler's FSDP::all_gather / FSDP::post_backward_reduce
    ranges, CPU activity only), the sharded DiT load (seconds and the
    rank's bytes), the device in use after the last step, and the LoRA
    export through a sink that checks it and writes nothing. Where the
    loaded DiT holds no FSDP-sharded parameter the second step is not
    traced (no FSDP collective to count)."""

    def __init__(self):
        self.fsdp = False
        self.seconds, self.counts, self.collectives = [], [], None
        self.load, self.export, self.in_use = {}, None, None
        self.tensor_collectives = []   # parallel.partitioning's counts, a step
        self._undo = []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from textflux_torch.io import export as E
        from textflux_torch.io import params as P
        from textflux_torch.ops import flash_attention as FA
        from textflux_torch.parallel import partitioning as PT
        from textflux_torch.training import train as TR

        def make_step(orig):
            def make(tc, **kw):
                step = orig(tc, **kw)

                def timed(*a, **k):
                    torch.cuda.synchronize()
                    PT.reset_counts()
                    t0 = time.perf_counter()
                    if len(self.seconds) == 1 and self.fsdp:
                        with profile(activities=[ProfilerActivity.CPU]) as prof:
                            metrics = step(*a, **k)
                            torch.cuda.synchronize()
                        names = [e.name for e in prof.events()]
                        self.collectives = dict(
                            all_gather=sum(n.startswith("FSDP::all_gather") and
                                           not n.startswith("FSDP::all_gather_copy_out")
                                           for n in names),
                            reduce_scatter=sum(n.startswith("FSDP::post_backward_reduce")
                                               for n in names))
                    else:
                        metrics = step(*a, **k)
                    torch.cuda.synchronize()
                    self.seconds.append(time.perf_counter() - t0)
                    self.tensor_collectives.append(PT.counts())
                    self.counts.append({n: getattr(FA, n).launches for n in FLASH_KERNELS})
                    free, total = torch.cuda.mem_get_info()
                    self.in_use = total - free
                    return metrics
                return timed
            return make

        def load(orig):
            def timed(path, cfg, mesh, **kw):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                module = orig(path, cfg, mesh, **kw)
                torch.cuda.synchronize()
                sizes = {n: PT.local(p).numel() * p.element_size()
                         for n, p in module.named_parameters()}
                self.fsdp = any(PT.shard_spec(p) is not None for p in module.parameters())
                self.load = dict(seconds=time.perf_counter() - t0,
                                 dit_bytes=sum(v for n, v in sizes.items() if ".lora_" not in n),
                                 lora_bytes=sum(v for n, v in sizes.items() if ".lora_" in n),
                                 storage_bytes=PT.storage_bytes(module),
                                 # what the load left allocated, and the most it held at once
                                 held_bytes=torch.cuda.memory_allocated() - before,
                                 peak_bytes=torch.cuda.max_memory_allocated() - before)
                return module
            return timed

        def sink(sd, path, dtype=None):
            b_keys = [k for k in sd if k.endswith("lora_B.weight")]
            self.export = dict(path=os.path.relpath(path, REPO), keys=len(sd),
                               lora_keys=sorted(k for k in sd if k.endswith(
                                   ("lora_A.weight", "lora_B.weight"))),
                               bytes_it_would_write=sum(v.numel() * v.element_size()
                                                        for v in sd.values()),
                               nonfinite=[k for k, v in sd.items()
                                          if not bool(torch.isfinite(v).all())][:5],
                               b_targets=len(b_keys),
                               b_targets_moved=sum(bool(sd[k].abs().max() > 0) for k in b_keys),
                               bytes_written=0)
            return 0

        self._patch(TR, "make_train_step", make_step)
        self._patch(P, "load_flux_fsdp", load)
        self._patch(E, "save_safetensors", lambda orig: sink)
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


def _fsdp_lora_main(spec, rank) -> dict:
    """--mode lora (rank 128, AdamW, the reference's targets) through
    cli.train.main at full depth on the checkpoint under CKPT_DIR, over the
    default mesh (1, world, 1): a global batch of 2, a row a rank."""
    from textflux_torch.cli import train as CLI

    out_dir = os.path.join(spec["work"], "lora_out")
    argv = ["--model", CKPT_DIR, "--data-json", spec["data_json"],
            "--data-images", os.path.join(EXAMPLE, "ori"), "--mode", "lora",
            "--lora-rank", "128", "--lora-alpha", "128", "--optimizer", "adamw",
            "--learning-rate", "1e-4", "--resolution", str(TRAIN_RESOLUTION),
            "--train-batch-size", str(FSDP_WORLD), "--grad-accum", "1",
            "--max-train-steps", str(FSDP_STEPS), "--checkpointing-steps", str(FSDP_STEPS + 1),
            "--log-every", "1", "--seed", "0", "--output-dir", out_dir]
    torch.cuda.reset_peak_memory_stats()
    with byte_tokenizers(f"fsdp_train rank {rank}"), _FsdpMainRecorder() as rec:
        CLI.main(argv)
    export = dict(rec.export or {})
    export.pop("lora_keys", None)
    r = dict(load=rec.load, step_seconds=rec.seconds, launches_per_step=rec.per_step_launches(),
             collectives_step2=rec.collectives, export=export,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             device_in_use_bytes=rec.in_use, device_total_bytes=torch.cuda.mem_get_info()[1])
    if rank == 0:
        log_ = _train_log(out_dir)
        r.update(steps=[e["step"] for e in log_], loss=[e["loss"] for e in log_],
                 grad_norm=[e["grad_norm"] for e in log_])
    return r


def _fsdp_probe(world, rank) -> dict:
    """all_gather_into_tensor (bf16, the size of a full-width single
    block's parameters) and reduce_scatter_tensor (float32, FSDP's reduce
    dtype) over gloo on CUDA tensors: what FSDP2 calls."""
    import torch.distributed as dist

    from textflux_torch.config import flux_fill_config
    from textflux_torch.models.transformer import SingleBlock

    cfg = flux_fill_config()
    n = sum(p.numel() for p in SingleBlock(cfg, device="meta", dtype=torch.bfloat16,
                                           generator=None).parameters())
    n -= n % world
    out = {"elements": n}
    for name, dt, fn in (
            ("all_gather_into_tensor", torch.bfloat16,
             lambda x, y: dist.all_gather_into_tensor(y, x)),
            ("reduce_scatter_tensor", torch.float32,
             lambda x, y: dist.reduce_scatter_tensor(x, y))):
        small = torch.full((n // world,), float(rank + 1), device="cuda", dtype=dt)
        big = torch.full((n,), float(rank + 1), device="cuda", dtype=dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            fn(small, big)
        except RuntimeError as e:   # gloo refuses before any transfer, on every rank
            out[name] = dict(ok=False, error=f"{type(e).__name__}: {str(e)[:300]}")
            continue
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        if name == "all_gather_into_tensor":
            ok = bool((big[: n // world] == 1).all() and (big[-1] == world))
        else:
            ok = bool((small == world * (world + 1) / 2).all())
        out[name] = dict(ok=ok, seconds=s, gb_per_s=n * big.element_size() / s / 1e9,
                         dtype=str(dt))
        del small, big
    return out


def fsdp_child(spec_path: str) -> int:
    """One rank of the fsdp_train phase (``--fsdp-child``), in one process
    for the whole phase: "train" joins a gloo group on cuda:0 (NCCL
    refuses two ranks on one device), probes the collectives FSDP2 calls
    and, when they work, runs full-depth LoRA through cli.train.main, then
    the reduced-depth modes against one rank; "reduced" is the fallback,
    the reduced modes as one NCCL rank. Writes its record beside the spec."""
    from datetime import timedelta

    import torch.distributed as dist

    from textflux_torch.parallel import partitioning as PT

    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = spec["rank"], spec["world"]
    if spec.get("backend") == "nccl":   # the fallback: one NCCL rank, as torchrun starts it
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(spec["port"]))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=FSDP_TIMEOUT))
    rec = dict(role=spec["role"], rank=rank, world=world)
    if spec["role"] == "train":
        rec["probe"] = _fsdp_probe(world, rank)
    if spec["role"] == "reduced" or all(rec["probe"][k]["ok"] for k in (
            "all_gather_into_tensor", "reduce_scatter_tensor")):
        if spec["role"] == "train":
            rec["lora"] = _fsdp_lora_main(spec, rank)
            gc.collect()
            torch.cuda.empty_cache()
        mesh = PT.make_mesh((1, world, 1), device="cuda:0")
        rec.update(backend=dist.get_backend(),
                   reduced=_reduced_vs_one_rank(mesh, rank, FSDP_REDUCED_RUNS))
    dist.barrier()
    dist.destroy_process_group()
    with open(spec["out"] + ".json", "w") as f:
        json.dump(rec, f)
    return 0


def _fsdp_problems(name: str, r: dict) -> list:
    problems = []
    s, o = r["sharded"], r.get("single")
    if not all(np.isfinite(s["loss"])) or not all(np.isfinite(s["grad_norm"])):
        problems.append(f"{name}: non-finite loss or grad norm")
    c = s["checksums"]
    if c["frozen_changed"] or c["masked_changed"] or not c["trained"] or c["trained_unmoved"]:
        problems.append(f"{name}: frozen changed {c['frozen_changed'][:3]}, masked changed "
                        f"{c['masked_changed'][:3]}, unmoved {c['trained_unmoved'][:3]}")
    if o is None:
        return problems
    if max(r["loss_rel"]) > FSDP_LOSS_RTOL or max(r["grad_norm_rel"]) > FSDP_NORM_RTOL:
        problems.append(f"{name}: loss rel {r['loss_rel']}, grad norm rel {r['grad_norm_rel']}")
    if not r["delta_rel_l2"] <= FSDP_DELTA_RTOL:
        problems.append(f"{name}: change rel-L2 {r['delta_rel_l2']}")
    for k, v in r["bytes_ratio"].items():
        if abs(v * FSDP_WORLD - 1) > FSDP_HALF_RTOL:
            problems.append(f"{name}: a rank's {k} is {v:.4f} of one rank's")
    return problems


def phase_fsdp_train(smi: str, have_checkpoint: bool) -> dict:
    """Phase 14. Training over the fsdp axis: FSDP_WORLD ranks on the one
    card over gloo (this script again, --fsdp-child): the collectives FSDP2
    calls, probed first on CUDA tensors; --mode lora (rank 128, AdamW)
    through cli.train.main at full depth on phase 7's checkpoint (written
    here when no earlier phase did), FSDP_STEPS steps of a global batch of
    2 at 1024 px; then at full width and 2 + 4 blocks, --mode attn with
    AdamW and 8-bit AdamW and --mode all with 8-bit AdamW through
    train_full, each held against one rank on the same whole batch; and the
    bytes each rank holds at full depth reckoned from the sharding plan
    (checked against the reduced runs' measured bytes). Should gloo lack a
    collective on CUDA tensors, the reduced runs go through the FSDP path as
    one NCCL rank instead, and the phase says so. Two ranks share one card:
    every gathered weight goes through the host, so the step times are not a
    multi-GPU number."""
    from textflux_torch.config import flux_fill_config

    gc.collect()
    torch.cuda.empty_cache()
    if not have_checkpoint:
        _, flux = write_checkpoint(load_manifest())
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    work = os.path.join(CKPT_DIR, "fsdp_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    cfg = flux_fill_config()
    blocks = cfg.num_double_layers + cfg.num_single_layers
    per_step = {"flash_attention": 2 * blocks, "flash_attention_lse": 0,
                "flash_attention_dq": blocks, "flash_attention_dkv": blocks}
    # the root (embedders, head) is gathered once a step and kept for the
    # backward; each block is gathered for its forward and again for its
    # backward (remat's recompute runs inside that gather); LoRA trains no
    # root tensor, so only the blocks reduce-scatter
    expected_collectives = dict(all_gather=1 + 2 * blocks, reduce_scatter=blocks)
    log(f"fsdp_train: {FSDP_WORLD} gloo ranks on cuda:0; expect {per_step} launches and "
        f"{expected_collectives} FSDP collectives a step per rank (full depth, LoRA); reduced "
        f"runs vs one rank: loss {FSDP_LOSS_RTOL}, grad norm {FSDP_NORM_RTOL}, change rel-L2 "
        f"{FSDP_DELTA_RTOL}, halved bytes {FSDP_HALF_RTOL}")
    out, problems = {}, []
    ranks = partial(_run_ranks, work, child="--fsdp-child", phase="fsdp_train",
                    timeout=FSDP_TIMEOUT)

    data_json = os.path.join(work, "anyword.json")
    with open(data_json, "w") as f:
        json.dump({"data_list": [
            {"img_name": name, "annotations": [
                {"text": text, "polygon": [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]}]}
            for name, text, (x0, y0, x1, y1) in FSDP_MAIN_ITEMS]}, f)
    trained = ranks("train", FSDP_WORLD, data_json=data_json)
    out["probe"] = [r["probe"] for r in trained]
    log("fsdp_train probe " + json.dumps(out["probe"]))
    if "lora" not in trained[0]:
        log("fsdp_train: gloo lacks a collective FSDP2 needs on CUDA tensors; the reduced "
            "runs go through the FSDP path as one NCCL rank at (1, 1, 1)")
        nccl = ranks("reduced", 1, backend="nccl")[0]
        out["nccl_reduced"] = nccl["reduced"]
        for name, r in nccl["reduced"].items():
            log(f"fsdp_train nccl {name} " + json.dumps(r))
            problems += _fsdp_problems(name, {"sharded": r["sharded"]})
    else:
        out["lora"] = []
        for r in trained:
            x = r["lora"]
            x["card_in_use_note"] = "both ranks' processes and contexts, read by this rank"
            x["step_seconds_note"] = ("2 ranks sharing one H100 over gloo: every gathered "
                                      "weight goes through the host; not a multi-GPU number")
            if x["launches_per_step"] != [per_step] * FSDP_STEPS:
                problems.append(f"lora rank {r['rank']}: launches {x['launches_per_step']}")
            if x["collectives_step2"] != expected_collectives:
                problems.append(f"lora rank {r['rank']}: FSDP collectives "
                                f"{x['collectives_step2']}, expected {expected_collectives}")
            if r["rank"] == 0 and (x["steps"] != list(range(1, FSDP_STEPS + 1))
                                   or not all(np.isfinite(x["loss"])) or not x["export"]
                                   or x["export"]["nonfinite"]):   # rank 0 alone exports
                problems.append(f"lora: steps {x['steps']}, loss {x['loss']}, export "
                                f"{x['export']}")
            out["lora"].append(x)
            log(f"fsdp_train lora rank {r['rank']} " + json.dumps(x))
        out["reduced"] = {}
        for name in trained[0]["reduced"]:
            r = trained[0]["reduced"][name]
            r["rank1"] = trained[1]["reduced"][name]["sharded"]
            log(f"fsdp_train {name} " + json.dumps(r))
            problems += _fsdp_problems(name, r)
            out["reduced"][name] = r

    # the reckoning, checked at reduced depth against the measured bytes
    n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
    reduced_cfg = dataclasses.replace(cfg, num_double_layers=n_double,
                                      num_single_layers=n_single)
    checks = {}
    for name, r in (out.get("reduced") or {}).items():
        mode, optimizer = name.split("_")
        for label, n in (("sharded", FSDP_WORLD), ("single", 1)):
            want = fsdp_reckoning(reduced_cfg, mode, optimizer, n)
            got = r[label]["bytes"]
            rel = {k: abs(want[k] - got[k]) / max(got[k], 1) for k in got}
            checks[f"{name}_{label}"] = rel
            if max(rel.values()) > FSDP_RECKON_RTOL:
                problems.append(f"reckoning {name} {label}: {rel} (reckoned {want}, "
                                f"measured {got})")
    lora_rank0 = (out.get("lora") or [None])[0]
    overhead = None
    if lora_rank0:   # what a rank holds past its training state: encoders, activations, gathers
        held = fsdp_reckoning(cfg, "lora", "adamw", FSDP_WORLD)["total_bytes"]
        overhead = lora_rank0["max_memory_allocated"] - held
    reckoning = {}
    for mode, optimizer in FSDP_RECKON_RUNS:
        for n in (1, 2, 4):
            x = fsdp_reckoning(cfg, mode, optimizer, n)
            if overhead is not None:
                x["with_measured_overhead_bytes"] = x["total_bytes"] + overhead
                x["fits_80gb_card"] = x["with_measured_overhead_bytes"] <= (
                    torch.cuda.mem_get_info()[1])
            reckoning[f"{mode}_{optimizer}_fsdp{n}"] = x
    out.update(reckoning=reckoning, reckoning_checks=checks, overhead_bytes=overhead,
               seconds=time.perf_counter() - t_phase)
    log("fsdp_train reckoning " + json.dumps(dict(reckoning=reckoning, checks=checks,
                                                  overhead_bytes=overhead)))
    log(f"fsdp_train: {out['seconds']:.1f} s; {smi}")
    shutil.rmtree(work, ignore_errors=True)
    if problems:
        raise AssertionError("fsdp_train phase: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# 15. tp_train: training over the tensor axis, ranks sharing the one card
# ---------------------------------------------------------------------------

TP_TRAIN_STEPS = 2
TP_TRAIN_TIMEOUT = 1000        # seconds a group of ranks may take, loads included
TP_QLORA_MODES = ("weight_only", "nf4")
TP_QLORA_LR = 1e-4
# the most a sharded load may hold above what it keeps: the linear being
# filled and one chunk of its quantisation (io.quantize.QUANT_CHUNK
# elements, ~17 bytes each)
TP_LOAD_SLACK_BYTES = 1 << 30
# the full-depth reckoning's meshes (data, fsdp, tensor)
TP_RECKON_MESHES = ((1, 1, 2), (1, 2, 2), (1, 1, 4))


# the JAX package's 8-bit block: a leaf's elements, in its (in, out) order,
# in runs of this many (textflux_tpu/training/optim8bit.py)
JAX_8BIT_BLOCK = 256


@functools.lru_cache(maxsize=None)
def _whole_jax_blocks(sizes: tuple, split_axis, segs: tuple, tp: int, t: int, dim: int,
                      a: int, b: int, transpose: bool) -> bool:
    """Whether the elements that tensor rank `t` (of `tp`, its device-major
    share of axis `split_axis`, made of `segs`: every segment's t-th chunk)
    and fsdp slice [a, b) of axis `dim` hold of a tensor of `sizes` are
    whole JAX 8-bit blocks: each block of the leaf's order (transposed
    first with `transpose`) has all of its elements held, or none. Counted
    element by element, apart from the optimizer's own rule."""
    axes = [np.arange(n) for n in sizes]
    if split_axis is not None:
        offsets = np.concatenate([[0], np.cumsum(segs)[:-1]])
        axes[split_axis] = np.concatenate(
            [off + t * (seg // tp) + np.arange(seg // tp) for off, seg in zip(offsets, segs)])
    axes[dim] = axes[dim][a:b]
    shape = list(sizes)
    if transpose:
        axes, shape = axes[::-1], shape[::-1]
    held = np.zeros(shape, bool)
    held[np.ix_(*axes)] = True
    if held.size % JAX_8BIT_BLOCK:    # its last block runs on into the next layer's
        return False
    held = held.reshape(-1, JAX_8BIT_BLOCK)
    return bool((held.all(axis=1) | ~held.any(axis=1)).all())


def tp_reckoning(cfg, mode: str, optimizer: str, fsdp: int, tp: int,
                 lora_rank: int = 128) -> dict:
    """Bytes one rank holds of the training state at (1, `fsdp`, `tp`), from
    the sharding plan alone (a DiT of `cfg` on the meta device): each
    parameter's tensor share (``shard_linears``: column-parallel linears
    split their output rows, row-parallel ones their input columns, the
    rest whole), then its fsdp chunk (torch.chunk's first, largest share;
    nn.Linear weights along dim 1, the rest dim 0) in its dtype, a float32
    gradient per trained slice, and the optimizer's state as
    ``fsdp_reckoning`` counts it; 8-bit AdamW keeps a leaf local when
    every rank's elements are whole JAX blocks (``_whole_jax_blocks``, on
    the ranks that bound every rank's alignment). LoRA factors stay whole
    over tensor."""
    from torch import nn

    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import optim8bit as O
    from textflux_torch.training import train as TR

    model = FluxTransformer(cfg, device="meta", dtype=torch.bfloat16)
    if tp > 1:
        PT.shard_linears(model, PT.flux_param_specs(cfg), tp, 0)
        model.tp_rank, model.tp_layout = 0, tp
    if mode == "lora":
        TR.lora_insert(model, TR.lora_init(model, lora_rank, device="meta"), 1.0)
        trained = {n_ for n_, p in model.named_parameters() if p.requires_grad}
    else:
        trained = set(TR.trainable_mask(model, TR.TrainConfig(mode=mode)))
    weights = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}
    out = dict(master_bytes=0, frozen_bytes=0, grad_bytes=0, optimizer_state_bytes=0)
    leaves = {}
    for name, p in model.named_parameters():
        dim = 1 if id(p) in weights else 0
        c = -(-p.shape[dim] // fsdp)
        local = p.numel() // p.shape[dim] * min(c, p.shape[dim])
        if name not in trained:
            out["frozen_bytes"] += 2 * local
            continue
        out["master_bytes"] += 4 * local
        out["grad_bytes"] += 4 * local
        if optimizer == "adamw":
            out["optimizer_state_bytes"] += 8 * local + 4
            continue
        key, _, transpose = TR.jax_leaf(name)
        transpose = transpose and p.dim() == 2
        split = PT.tensor_split(model, name)
        sizes = list(p.shape)
        if split is not None:
            sizes[split[0]] = sum(split[1].segs)
        whole = math.prod(sizes)
        is_local = split is not None or fsdp > 1
        # the first and last fsdp slices and the first two tensor shares
        # cover every rank's alignment: the other slices start at multiples
        # of the first's length, the other shares at multiples of the second's
        for f in sorted({0, fsdp - 1}):
            for t in sorted({0, min(1, tp - 1)} if split is not None else {0}):
                a, b = min(f * c, p.shape[dim]), min((f + 1) * c, p.shape[dim])
                is_local = is_local and _whole_jax_blocks(
                    tuple(sizes), None if split is None else split[0],
                    () if split is None else split[1].segs, tp, t, dim, a, b, transpose)
        leaf = leaves.setdefault(key, dict(local=True, local_numel=0, numel=0))
        leaf["local"] &= is_local
        leaf["local_numel"] += local
        leaf["numel"] += whole
    for leaf in leaves.values():
        blocks = O.n_blocks(leaf["local_numel"] if leaf["local"] else leaf["numel"])
        out["optimizer_state_bytes"] += 2 * blocks * (O.BLOCK + 4)
    out["total_bytes"] = sum(out.values())
    return out


def _tp_lora_main(spec, rank) -> dict:
    """--mode lora (rank 128, AdamW) through cli.train.main at full depth
    on the checkpoint under CKPT_DIR at mesh (1, 1, 2): a batch of 1, the
    same row on both tensor ranks, each holding its tensor shard of the DiT
    and the factors whole."""
    from textflux_torch.cli import train as CLI

    out_dir = os.path.join(spec["work"], "lora_out")
    argv = ["--model", CKPT_DIR, "--data-json", spec["data_json"],
            "--data-images", os.path.join(EXAMPLE, "ori"), "--mode", "lora",
            "--lora-rank", "128", "--lora-alpha", "128", "--optimizer", "adamw",
            "--learning-rate", "1e-4", "--resolution", str(TRAIN_RESOLUTION),
            "--train-batch-size", "1", "--grad-accum", "1", "--mesh", "1,1,2",
            "--max-train-steps", str(TP_TRAIN_STEPS),
            "--checkpointing-steps", str(TP_TRAIN_STEPS + 1),
            "--log-every", "1", "--seed", "0", "--output-dir", out_dir]
    torch.cuda.reset_peak_memory_stats()
    with byte_tokenizers(f"tp_train rank {rank}"), _FsdpMainRecorder() as rec:
        CLI.main(argv)
    r = dict(load=rec.load, step_seconds=rec.seconds, launches_per_step=rec.per_step_launches(),
             collectives_per_step=rec.tensor_collectives, export=rec.export,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             device_in_use_bytes=rec.in_use, device_total_bytes=torch.cuda.mem_get_info()[1])
    if rank == 0:
        log_ = _train_log(out_dir)
        r.update(steps=[e["step"] for e in log_], loss=[e["loss"] for e in log_],
                 grad_norm=[e["grad_norm"] for e in log_])
    return r


def _tp_qlora_run(base_mode, models, batch, mesh) -> tuple:
    """TP_TRAIN_STEPS steps of train_lora (rank 128, AdamW) over a DiT of
    full width and TRAIN_FULL_REDUCED_DEPTH (seed 0, bf16) quantised as
    `base_mode`, sharded over `mesh` or (None) on this rank alone: the
    losses, norms, the rank's code bytes and the factors' change (whole,
    host)."""
    from textflux_torch.cli.train import train_lora
    from textflux_torch.config import flux_fill_config
    from textflux_torch.io.quantize import quantize_tree
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.ops import flash_attention as FA
    from textflux_torch.parallel import partitioning as PT
    from textflux_torch.training import train as TR

    vae, clip, t5 = models
    n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
    cfg = dataclasses.replace(flux_fill_config(), num_double_layers=n_double,
                              num_single_layers=n_single)
    flux = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    quantize_tree(flux, mode=base_mode)
    whole_code_bytes = sum(b.numel() * b.element_size() for b in flux.buffers())
    tc = TR.TrainConfig(mode="lora", optimizer="adamw", learning_rate=TP_QLORA_LR,
                        lora_rank=128, lora_alpha=128.0, adam_eps=FSDP_ADAM_EPS)
    counts, ms, t = [], [], [None]

    def batches():
        while True:
            torch.cuda.synchronize()
            t[0] = time.perf_counter()
            yield batch

    def on_step(step, metrics, lora):
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t[0]))
        counts.append({k: getattr(FA, k).launches for k in FLASH_KERNELS})

    for k in FLASH_KERNELS:
        getattr(FA, k).launches = 0
    torch.cuda.reset_peak_memory_stats()
    lora, history = train_lora(flux, vae, clip, t5, batches(), tc=tc,
                               clip_tokenize=clip_byte_tokenize, t5_tokenize=t5_byte_tokenize,
                               steps=TP_TRAIN_STEPS, seed=0, log_every=1, on_step=on_step,
                               mesh=mesh)
    torch.cuda.synchronize()
    code_bytes = (PT.storage_bytes(flux) if mesh is not None
                  else whole_code_bytes)
    prev, by_step = {k: 0 for k in FLASH_KERNELS}, []
    for c in counts:
        by_step.append({k: c[k] - prev[k] for k in FLASH_KERNELS})
        prev = c
    b = {f"{p}.b": PT.full_tensor(f["b"], host=True).float().cpu() for p, f in lora.items()}
    r = dict(base=base_mode, mesh=None if mesh is None else mesh.shape,
             loss=[e["loss"] for e in history], grad_norm=[e["grad_norm"] for e in history],
             step_ms=ms, launches_per_step=by_step, code_bytes=code_bytes,
             whole_code_bytes=whole_code_bytes,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             b_targets=len(b), b_targets_moved=sum(bool(x.abs().max() > 0) for x in b.values()))
    del flux, lora
    gc.collect()
    torch.cuda.empty_cache()
    return r, b   # B starts at zero: its value is its change


def _tp_qlora(mesh, rank) -> dict:
    import torch.distributed as dist

    models = _reduced_models()
    batch = _two_row_batch()
    out = {}
    for base_mode in TP_QLORA_MODES:
        sharded, delta = _tp_qlora_run(base_mode, models, batch, mesh)
        rec = dict(sharded=sharded)
        dist.barrier()
        if rank == 0:
            single, ref = _tp_qlora_run(base_mode, models, batch, None)
            rec.update(single=single, **_rel_report(sharded, single, delta, ref),
                       code_bytes_ratio=sharded["code_bytes"] / single["code_bytes"])
            del ref
            gc.collect()
        dist.barrier()
        out[f"qlora_{base_mode}"] = rec
    return out


def _tp_load_probe(mesh, quantize) -> dict:
    """The full-depth DiT of the checkpoint under CKPT_DIR loaded for
    training over `mesh` (``io.params.load_flux_fsdp``, bf16, quantised as
    `quantize` streams in): the seconds, the bytes this process's allocator
    holds after the load and the most it held during it, above what it held
    before."""
    from textflux_torch.io.config_io import flux_config_from
    from textflux_torch.io.params import load_flux_fsdp
    from textflux_torch.parallel import partitioning as PT

    path = os.path.join(CKPT_DIR, "transformer")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flux = load_flux_fsdp(path, flux_config_from(path), mesh, device=mesh.device,
                          quantize=quantize)
    torch.cuda.synchronize()
    r = dict(mesh=[mesh.shape[a] for a in PT.MESH_AXES], quantize=quantize,
             seconds=time.perf_counter() - t0,
             held_bytes=torch.cuda.memory_allocated() - before,
             peak_bytes=torch.cuda.max_memory_allocated() - before,
             storage_bytes=PT.storage_bytes(flux))
    del flux
    gc.collect()
    torch.cuda.empty_cache()
    return r


def tp_train_child(spec_path: str) -> int:
    """One rank of the tp_train phase (``--tp-train-child``): "two" runs
    full-depth LoRA through cli.train.main at (1, 1, 2), the reduced-depth
    modes at (1, 1, 2) and QLoRA at (1, 2, 1) against one rank, then the
    full-depth load over an NF4 base at (1, 2, 1); "four" runs --mode attn
    / 8-bit AdamW at (1, 2, 2) against one rank, then the full-depth bf16
    load at (1, 2, 2). Ranks join a
    gloo group on cuda:0 (NCCL refuses two ranks on one device). Writes its
    record beside the spec."""
    from datetime import timedelta

    import torch.distributed as dist

    from textflux_torch.parallel import partitioning as PT

    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = spec["rank"], spec["world"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TP_TRAIN_TIMEOUT))
    rec = dict(role=spec["role"], rank=rank, world=world)
    t0 = time.perf_counter()
    if spec["role"] == "two":
        rec["lora"] = _tp_lora_main(spec, rank)
        rec["lora_seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec["reduced"] = _reduced_vs_one_rank(PT.make_mesh((1, 1, 2), device="cuda:0"), rank,
                                              FSDP_REDUCED_RUNS)
        rec["reduced_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fsdp2 = PT.make_mesh((1, 2, 1), device="cuda:0")
        rec["qlora"] = _tp_qlora(fsdp2, rank)
        rec["qlora_seconds"] = time.perf_counter() - t0
        rec["load_probe"] = _tp_load_probe(fsdp2, "nf4")
    else:
        mesh = PT.make_mesh((1, 2, 2), device="cuda:0")
        rec["reduced"] = _reduced_vs_one_rank(mesh, rank, (("attn", "adamw8bit"),))
        rec["reduced_seconds"] = time.perf_counter() - t0
        rec["load_probe"] = _tp_load_probe(mesh, None)
    dist.barrier()
    dist.destroy_process_group()
    with open(spec["out"] + ".json", "w") as f:
        json.dump(rec, f)
    return 0


def _tp_train_problems(name: str, r: dict, *, shards: int) -> list:
    """_fsdp_problems' checks of a reduced run; a QLoRA rank's code bytes
    against 1/shards of one rank's (the reckoning checks the other bytes:
    replicated parameters keep a tensor rank above 1/shards)."""
    problems = []
    s, o = r["sharded"], r.get("single")
    if not all(np.isfinite(s["loss"])) or not all(np.isfinite(s["grad_norm"])):
        problems.append(f"{name}: non-finite loss or grad norm")
    c = s.get("checksums")
    if c and (c["frozen_changed"] or c["masked_changed"] or not c["trained"]
              or c["trained_unmoved"]):
        problems.append(f"{name}: frozen changed {c['frozen_changed'][:3]}, masked changed "
                        f"{c['masked_changed'][:3]}, unmoved {c['trained_unmoved'][:3]}")
    if o is None:
        return problems
    if max(r["loss_rel"]) > FSDP_LOSS_RTOL or max(r["grad_norm_rel"]) > FSDP_NORM_RTOL:
        problems.append(f"{name}: loss rel {r['loss_rel']}, grad norm rel {r['grad_norm_rel']}")
    if not r["delta_rel_l2"] <= FSDP_DELTA_RTOL:
        problems.append(f"{name}: change rel-L2 {r['delta_rel_l2']}")
    if "code_bytes_ratio" in r:
        if s["b_targets_moved"] != s["b_targets"]:
            problems.append(f"{name}: B of {s['b_targets'] - s['b_targets_moved']} targets "
                            "did not move")
        if abs(r["code_bytes_ratio"] * shards - 1) > FSDP_HALF_RTOL:
            problems.append(f"{name}: a rank's code bytes are {r['code_bytes_ratio']:.4f} of "
                            "one rank's")
    return problems


def phase_tp_train(smi: str, have_checkpoint: bool) -> dict:
    """Phase 15. Training over the tensor axis (and fsdp x tensor), ranks
    on the one card over gloo (this script again, --tp-train-child): --mode
    lora (rank 128, AdamW) through cli.train.main at full depth at (1, 1,
    2) on phase 7's checkpoint (written here when no earlier phase did), a
    batch of 1 at 1024 px, TP_TRAIN_STEPS steps; at full width and 2 + 4
    blocks, --mode attn with AdamW and 8-bit AdamW and --mode all with
    8-bit AdamW at (1, 1, 2), QLoRA over weight_only and nf4 bases at (1, 2,
    1), and --mode attn with 8-bit AdamW at (1, 2, 2) on four ranks, each
    against one rank on the same whole batch; the full-depth sharded load
    at (1, 2, 1) over an NF4 base and at (1, 2, 2) in bf16, its peak held
    to what it keeps plus one linear; and the full-depth bytes a rank holds
    at (1, 1, 2), (1, 2, 2) and (1, 1, 4) reckoned from the sharding plan. Ranks sharing one card: every collective goes through
    the host, so the step times are not a multi-GPU number. Writes no
    training checkpoint (the disk budget of a call)."""
    from textflux_torch.config import flux_fill_config

    gc.collect()
    torch.cuda.empty_cache()
    if not have_checkpoint:
        _, flux = write_checkpoint(load_manifest())
        del flux
        gc.collect()
        torch.cuda.empty_cache()
    work = os.path.join(CKPT_DIR, "tp_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    cfg = flux_fill_config()
    blocks = cfg.num_double_layers + cfg.num_single_layers
    per_step = {"flash_attention": 2 * blocks, "flash_attention_lse": 0,
                "flash_attention_dq": blocks, "flash_attention_dkv": blocks}
    # forward all-reduces: 4 a double block, 1 a single, again in remat's
    # recompute; the embedders' two outputs and each block's modulation
    # vectors gathered, again in the recompute
    row = 4 * cfg.num_double_layers + cfg.num_single_layers
    expected = dict(all_reduce_sum=2 * row,
                    all_gather_last=2 + 2 * (2 * cfg.num_double_layers + cfg.num_single_layers))
    manifest = load_manifest()
    want_keys = sorted(k for k in manifest["lora"]
                       if k.endswith(("lora_A.weight", "lora_B.weight")))
    log(f"tp_train: gloo ranks on cuda:0; expect {per_step} launches at H = "
        f"{cfg.num_heads // 2} and forward collectives {expected} a step per rank (full depth, "
        f"LoRA, (1, 1, 2)); the export's {len(want_keys)} LoRA keys; reduced runs vs one rank: "
        f"loss {FSDP_LOSS_RTOL}, grad norm {FSDP_NORM_RTOL}, change rel-L2 {FSDP_DELTA_RTOL}, "
        f"QLoRA code bytes 1/2 within {FSDP_HALF_RTOL}, bytes vs reckoning {FSDP_RECKON_RTOL}")
    out, problems = {}, []
    ranks = partial(_run_ranks, work, child="--tp-train-child", phase="tp_train",
                    timeout=TP_TRAIN_TIMEOUT)
    data_json = os.path.join(work, "anyword.json")
    with open(data_json, "w") as f:
        json.dump({"data_list": [
            {"img_name": name, "annotations": [
                {"text": text, "polygon": [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]}]}
            for name, text, (x0, y0, x1, y1) in FSDP_MAIN_ITEMS[:1]]}, f)

    two = ranks("two", 2, data_json=data_json)
    out["lora"] = []
    for r in two:
        x = r["lora"]
        x["seconds"] = r["lora_seconds"]
        x["step_seconds_note"] = ("2 ranks sharing one H100 over gloo: every all-reduce goes "
                                  "through the host; not a multi-GPU number")
        if x["launches_per_step"] != [per_step] * TP_TRAIN_STEPS:
            problems.append(f"lora rank {r['rank']}: launches {x['launches_per_step']}")
        for c in x["collectives_per_step"]:
            if any(c[k] != v for k, v in expected.items()) or not c["all_reduce_grad"]:
                problems.append(f"lora rank {r['rank']}: collectives {c}, expected {expected}")
        if r["rank"] == 0:   # rank 0 alone logs and exports
            e = x["export"] or {}
            x["export_keys_equal"] = e.get("lora_keys") == want_keys
            e.pop("lora_keys", None)
            if (x["steps"] != list(range(1, TP_TRAIN_STEPS + 1))
                    or not all(np.isfinite(x["loss"])) or not x["export_keys_equal"]
                    or e.get("nonfinite") or e.get("b_targets_moved") != e.get("b_targets")):
                problems.append(f"lora: steps {x['steps']}, loss {x['loss']}, export {e}, "
                                f"keys equal {x['export_keys_equal']}")
        out["lora"].append(x)
        log(f"tp_train lora rank {r['rank']} " + json.dumps(x))
    out["reduced"], out["seconds_by_part"] = {}, dict(
        lora=two[0]["lora_seconds"], reduced=two[0]["reduced_seconds"],
        qlora=two[0]["qlora_seconds"])
    for group, shards in (("reduced", 2), ("qlora", 2)):
        for name, r in two[0][group].items():
            r["rank1"] = two[1][group][name]["sharded"]
            log(f"tp_train {name} " + json.dumps(r))
            problems += _tp_train_problems(name, r, shards=shards)
            out["reduced"][name] = r

    four = ranks("four", 4)
    # the full-depth sharded loads: a rank never holds more than its share
    # and the one linear being filled
    out["load_probe"] = [r["load_probe"] for r in two + four]
    for r in two + four:
        x = r["load_probe"]
        log(f"tp_train load {x['mesh']} {x['quantize']} rank {r['rank']} " + json.dumps(x))
        if x["peak_bytes"] - x["held_bytes"] > TP_LOAD_SLACK_BYTES:
            problems.append(f"load {x['mesh']} {x['quantize']} rank {r['rank']}: peak "
                            f"{x['peak_bytes']} over the held {x['held_bytes']} by more than "
                            f"{TP_LOAD_SLACK_BYTES}")
    for name, r in four[0]["reduced"].items():
        r["other_ranks"] = [x["reduced"][name]["sharded"] for x in four[1:]]
        log(f"tp_train fsdp2_tp2 {name} " + json.dumps(r))
        problems += _tp_train_problems(f"fsdp2_tp2 {name}", r, shards=4)
        out["reduced"][f"fsdp2_tp2_{name}"] = r
    out["seconds_by_part"]["fsdp2_tp2"] = four[0]["reduced_seconds"]

    # the reckoning, checked at reduced depth against the measured bytes
    n_double, n_single = TRAIN_FULL_REDUCED_DEPTH
    reduced_cfg = dataclasses.replace(cfg, num_double_layers=n_double,
                                      num_single_layers=n_single)
    checks = {}
    for name, (fsdp, tp) in (("attn_adamw", (1, 2)), ("attn_adamw8bit", (1, 2)),
                             ("all_adamw8bit", (1, 2)), ("fsdp2_tp2_attn_adamw8bit", (2, 2))):
        r = out["reduced"].get(name)
        if not r:
            continue
        mode, optimizer = name.split("_")[-2:]
        want = tp_reckoning(reduced_cfg, mode, optimizer, fsdp, tp)
        got = r["sharded"]["bytes"]
        rel = {k: abs(want[k] - got[k]) / max(got[k], 1) for k in got}
        checks[name] = rel
        if max(rel.values()) > FSDP_RECKON_RTOL:
            problems.append(f"reckoning {name}: {rel} (reckoned {want}, measured {got})")
    reckoning = {}
    for mode, optimizer in FSDP_RECKON_RUNS:
        for shape in TP_RECKON_MESHES:
            reckoning[f"{mode}_{optimizer}_{'x'.join(map(str, shape))}"] = tp_reckoning(
                cfg, mode, optimizer, shape[1], shape[2])
    out.update(reckoning=reckoning, reckoning_checks=checks,
               seconds=time.perf_counter() - t_phase)
    log("tp_train reckoning " + json.dumps(dict(reckoning=reckoning, checks=checks)))
    log("tp_train seconds by part " + json.dumps(out["seconds_by_part"]))
    log(f"tp_train: {out['seconds']:.1f} s; {smi}")
    shutil.rmtree(work, ignore_errors=True)
    if problems:
        raise AssertionError("tp_train phase: " + "; ".join(problems))
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
                 q_rec=None, eval_rec=None, tp_rec=None) -> dict:
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
    if tp_rec:
        # every rank of each run launches the kernel on its own heads
        by_run.update({f"tp_serve_reference_{k}": v["launches"]
                       for k, v in tp_rec["reference"].items() if k in ("single", "batch")})
        for group in ("tp", "dp", "fsdp"):
            for r in tp_rec.get(group, []):
                for k in ("single", "batch"):
                    if k in r:
                        by_run[f"tp_serve_{group}_rank{r['rank']}_{k}"] = r[k]["launches"]
        for r in tp_rec.get("int8_fsdp2_tp2", []):
            for k in ("sharded", "single"):
                if k in r:
                    by_run[f"tp_serve_int8_rank{r['rank']}_{k}"] = r[k]["launches"]
        by_run["tp_serve_nccl_run_eval"] = tp_rec["nccl"]["launches"]
    entry = dict(
        name="flash_attention_qk_norm_rope", route="cuda",
        source="textflux_torch/csrc/fused_attention.cu",
        # the prep pass is in `source`, the attention mainloop here
        mainloop_source="textflux_torch/csrc/flash_fwd_sm90.cu",
        build={k: v for k, v in build_rec.get("kernels", {}).items()
               if k.startswith(("norm_rope_kernel",) + _FWD)},
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
                 "flash_attention_lse": "textflux_torch/csrc/flash_fwd_sm90.cu",
                 "flash_attention_dq": "textflux_torch/csrc/flash_bwd_sm90.cu",
                 "flash_attention_dkv": "textflux_torch/csrc/flash_bwd_sm90.cu"}


# the kernel instantiations behind each training wrapper (ptxas_report's keys)
_FWD = ("flash_fwd_sm90_kernel<64>", "flash_fwd_sm90_kernel<128>")
FLASH_FUNCTIONS = {"flash_attention": _FWD,
                   "flash_attention_lse": ("flash_fwd_sm90_kernel<64,lse>",
                                           "flash_fwd_sm90_kernel<128,lse>"),
                   "flash_attention_dq": ("flash_dq_sm90_kernel",),
                   "flash_attention_dkv": ("flash_dkv_sm90_kernel",)}


def _fsdp_runs(fsdp_rec) -> dict:
    """The fsdp_train phase's runs in _flash_entries' form: each rank of the
    full-depth LoRA run and each reduced run's ranks (and its one-rank
    reference), with their launches summed over the steps."""
    runs = {}
    if not fsdp_rec:
        return runs

    def add(key, per_step):
        runs[key] = {"launches": {k: sum(c[k] for c in per_step) for k in FLASH_KERNELS},
                     "launches_per_step": per_step}

    for r, x in enumerate(fsdp_rec.get("lora") or []):
        add(f"fsdp_lora_rank{r}", x["launches_per_step"])
    for name, r in (fsdp_rec.get("reduced") or {}).items():
        add(f"fsdp_{name}_rank0", r["sharded"]["launches_per_step"])
        add(f"fsdp_{name}_rank1", r["rank1"]["launches_per_step"])
        if r.get("single"):
            add(f"fsdp_{name}_one_rank", r["single"]["launches_per_step"])
    for name, r in (fsdp_rec.get("nccl_reduced") or {}).items():
        add(f"fsdp_{name}_nccl", r["sharded"]["launches_per_step"])
    return runs


def _tp_train_runs(tpt_rec) -> dict:
    """The tp_train phase's runs in _flash_entries' form (as _fsdp_runs)."""
    runs = {}
    if not tpt_rec:
        return runs

    def add(key, per_step):
        runs[key] = {"launches": {k: sum(c[k] for c in per_step) for k in FLASH_KERNELS},
                     "launches_per_step": per_step}

    for r, x in enumerate(tpt_rec.get("lora") or []):
        add(f"tp_lora_rank{r}", x["launches_per_step"])
    for name, r in (tpt_rec.get("reduced") or {}).items():
        add(f"tp_{name}_rank0", r["sharded"]["launches_per_step"])
        add(f"tp_{name}_rank1", r.get("rank1", r["sharded"])["launches_per_step"])
        for i, o in enumerate(r.get("other_ranks") or []):
            add(f"tp_{name}_rank{i + 1}", o["launches_per_step"])
        if r.get("single"):
            add(f"tp_{name}_one_rank", r["single"]["launches_per_step"])
    return runs


def _flash_entries(flash_rows, train_rec, build_rec, tm_rec=None, qlora_rec=None,
                   tf_rec=None, fsdp_rec=None, tpt_rec=None) -> list:
    """One JSON entry per training kernel: times at the `train` case,
    launches from the train phase, the train_main phase's runs A, B and C, the
    qlora phase's runs, the train_full phase's and the fsdp_train phase's
    ranks (all steps, by run, and per step)."""
    train = flash_rows.get("train")
    runs = {}
    if train_rec:
        runs["train"] = train_rec
    for key in ("A", "B", "C") if tm_rec else ():
        runs[f"train_main_{key}"] = tm_rec[key]
    for key, r in (qlora_rec or {}).items():
        runs[f"qlora_{key}"] = r
    for key, r in (tf_rec or {}).items():
        runs[f"train_full_{key}"] = r
    runs.update(_fsdp_runs(fsdp_rec))
    runs.update(_tp_train_runs(tpt_rec))
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
                # one library call computes the forward, and one (FA-2's
                # forward) returns the LSE; none computes dQ or dK/dV alone:
                # SDPA's whole backward is beside the sum of Dvec + dq + dkv
                library_ms={"flash_attention": train["sdpa_ms"],
                            "flash_attention_lse": (train["lse_library"] or {}).get("ms")
                            }.get(name))
            if name != "flash_attention":
                entry.update(sdpa_bwd_ms=train["sdpa_bwd_ms"], bwd_total_ms=train["bwd_total_ms"])
        h12 = flash_rows.get("train_h12")
        if h12:   # a tp = 2 rank's 12 heads, the shape tp_train launches
            k = h12["kernels"][name]
            entry["h12"] = dict(ms=k["kernel_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                                bound_by=k["bound_by"], rel_err=k["rel_err"],
                                library_ms={"flash_attention": h12["sdpa_ms"],
                                            "flash_attention_lse":
                                                (h12["lse_library"] or {}).get("ms")}.get(name))
        out.append(entry)
    return out


def _int8_entry(int8_rows, build_rec, q_rec=None, qlora_rec=None) -> dict:
    """The int8 weight-only kernel's JSON entry: launches on the device by
    run (the quantized phase's images, the qlora phase's steps), its build,
    and its errors and times at every case of phase 3, those of the step's
    linear1 at 1,408 rows on the entry itself."""
    by_run = {f"quantized_{k}": r["int8_launches"] for k, r in (q_rec or {}).items()
              if k != "stack_rel_err"}
    by_run.update({f"qlora_{k}": sum(r["int8_launches_per_step"])
                   for k, r in (qlora_rec or {}).items()})
    entry = dict(name="int8_matmul", route="cuda",
                 source="textflux_torch/csrc/w8a16_gemm_sm90.cu",
                 build={k: v for k, v in build_rec.get("kernels", {}).items()
                        if k.startswith("w8a16_gemm_sm90_kernel")},
                 # the JAX package dequantises inside XLA's dot
                 replaces=None,
                 launches=sum(by_run.values()) if by_run else None,
                 launches_by_run=by_run or None)
    main_case = next((r for r in int8_rows if r["case"] == "linear1_m1408"), None)
    if main_case:
        entry.update(max_err_over_tol=max(max(r["err_over_tol_f32"], r["err_over_tol_plain"])
                                          for r in int8_rows),
                     ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
                     library_ms=main_case["library_ms"], bound_ms=main_case["bound_ms"],
                     bound_by=main_case["bound_by"],
                     by_case={r["case"]: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                                             "bound_ms", "tile")}
                              for r in int8_rows})
    return entry


def _adaln_entry(adaln_rows, build_rec, main_rec=None, q_rec=None) -> dict:
    """The AdaLN modulate kernel's JSON entry: launches on the device by run
    (the main phase's images, the quantized phase's), its build, and its
    errors and times at every case of phase 3, those of FLUX's 1,408 joint
    tokens on the entry itself."""
    by_run = {f"main_{k}": r["adaln_launches"] for k, r in ((main_rec or {}).get("runs") or {})
              .items()}
    by_run.update({f"quantized_{k}": r["adaln_launches"] for k, r in (q_rec or {}).items()
                   if k != "stack_rel_err"})
    entry = dict(name="adaln_modulate", route="cuda",
                 source="textflux_torch/csrc/adaln_modulate.cu",
                 build={k: v for k, v in build_rec.get("kernels", {}).items()
                        if k.startswith("adaln_modulate_kernel")},
                 # the JAX package's composition is fused by XLA
                 replaces=None,
                 launches=sum(by_run.values()) if by_run else None,
                 launches_by_run=by_run or None)
    main_case = next((r for r in adaln_rows if r["case"] == "s1408_b1"), None)
    if main_case:
        entry.update(max_err_over_tol=max(r["err_over_tol"] for r in adaln_rows),
                     min_bitwise_share=min(r["bitwise_share"] for r in adaln_rows),
                     ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
                     bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
                     by_case={r["case"]: {k: r[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                                             "of_bound")}
                              for r in adaln_rows})
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--tp-child", default=None, help=argparse.SUPPRESS)   # a tp_serve rank
    ap.add_argument("--fsdp-child", default=None, help=argparse.SUPPRESS)   # a fsdp_train rank
    ap.add_argument("--tp-train-child", default=None, help=argparse.SUPPRESS)   # a tp_train rank
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "textflux_torch")):
        print(f"chip_smoke: no textflux_torch/ beside {__file__}; run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.tp_child:
        return tp_child(args.tp_child)
    if args.fsdp_child:
        return fsdp_child(args.fsdp_child)
    if args.tp_train_child:
        return tp_train_child(args.tp_train_child)
    phases = args.phases.split(",")
    t_start = time.perf_counter()
    seconds = {}

    def run(name, fn, *a, **kw):
        """fn(*a, **kw) as phase `name`, its seconds logged and kept."""
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            seconds[name] = time.perf_counter() - t0
            log(f"phase {name}: {seconds[name]:.1f} s")

    dev = run("device", phase_device)
    build_rec = {}
    if set(PHASES[1:]) & set(phases):
        build_rec = run("build", phase_build)
    kernel_rows = run("kernels", phase_kernels) if "kernels" in phases else []
    flash_rows = run("kernels_flash", phase_flash_kernels) if "kernels" in phases else {}
    int8_rows = run("kernels_int8", phase_int8_kernels) if "kernels" in phases else []
    adaln_rows = run("kernels_adaln", phase_adaln_kernels) if "kernels" in phases else []
    main_rec = run("main", phase_main, "profile" in phases) if "main" in phases else None
    train_rec = run("train", phase_train, "profile" in phases) if "train" in phases else None
    smi = dev["nvidia_smi"]
    try:   # the checkpoint phases share the one under CKPT_DIR
        ckpt_rec = run("checkpoint", phase_checkpoint) if "checkpoint" in phases else None
        tm_rec = (run("train_main", phase_train_main, smi,
                      have_checkpoint=ckpt_rec is not None)
                  if "train_main" in phases else None)
        q_rec = (run("quantized", phase_quantized, smi, have_checkpoint=bool(ckpt_rec or tm_rec),
                     profile="profile" in phases)
                 if "quantized" in phases else None)
        qlora_rec = run("qlora", phase_qlora, smi) if "qlora" in phases else None
        eval_rec = (run("eval", phase_eval, smi,
                        have_checkpoint=bool(ckpt_rec or tm_rec or q_rec))
                    if "eval" in phases else None)
        tf_rec = (run("train_full", phase_train_full, smi,
                      have_checkpoint=bool(ckpt_rec or tm_rec or q_rec or eval_rec))
                  if "train_full" in phases else None)
        tp_rec = (run("tp_serve", phase_tp_serve, smi,
                      have_checkpoint=bool(ckpt_rec or tm_rec or q_rec or eval_rec or tf_rec))
                  if "tp_serve" in phases else None)
        fsdp_rec = (run("fsdp_train", phase_fsdp_train, smi,
                        have_checkpoint=bool(ckpt_rec or tm_rec or q_rec or eval_rec or tf_rec
                                             or tp_rec))
                    if "fsdp_train" in phases else None)
        tpt_rec = (run("tp_train", phase_tp_train, smi,
                       have_checkpoint=bool(ckpt_rec or tm_rec or q_rec or eval_rec or tf_rec
                                            or tp_rec or fsdp_rec))
                   if "tp_train" in phases else None)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log("phase seconds " + json.dumps(dict(seconds, total=time.perf_counter() - t_start)))

    kernel_entries = [_fused_entry(kernel_rows, main_rec, build_rec, ckpt_rec, tm_rec, q_rec,
                                   eval_rec, tp_rec)]
    kernel_entries += _flash_entries(flash_rows, train_rec, build_rec, tm_rec, qlora_rec, tf_rec,
                                     fsdp_rec, tpt_rec)
    kernel_entries.append(_int8_entry(int8_rows, build_rec, q_rec, qlora_rec))
    kernel_entries.append(_adaln_entry(adaln_rows, build_rec, main_rec, q_rec))
    log(dev["nvidia_smi"])
    print(json.dumps({"kernels": kernel_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
