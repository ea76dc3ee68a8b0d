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
     the same for one train step when the train phase runs);
  6. train: the serving models freed, full-width models built anew from the
     seed, then 3 LoRA optimizer steps (rank 128) through
     textflux_torch.cli.train.train_lora on one 1024-px sample composed
     from resource/example, with the flash kernels' launch counts per step,
     the factors' movement and the frozen base checked.
Phase 3 also holds the four training kernels (flash forward, LSE, dQ,
dK/dV) against their plain versions, the L that the forward writes against
the plain LSE, and the fused kernel's norm+rope pass (timed alone) against
its plain version; it checks that a second launch of the forward, dQ and
dK/dV on the same inputs gives bitwise the same outputs. The train phase
expects 114 / 0 / 57 / 57 launches of forward / LSE / dQ / dK/dV per step:
the forward hands its L to the backward. The line before the last holds the
kernel table as JSON; the last line is {"ok": true, "device": {...}}.

`--phases` picks a subset (default: all of them).
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
PHASES = ("device", "build", "kernels", "main", "profile", "train")


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
    import gc

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
        opt = TR.make_optimizer(tc, TR.lora_parameters(lora))
        step_fn = TR.make_lora_train_step(tc)
        profile_step(lambda: step_fn(flux, vae, opt, batch, generator=gen),
                     what="train step", inference=False)
    del flux, vae, clip, t5, lora
    return rec


def _fused_entry(kernel_rows, main_rec, build_rec) -> dict:
    serving = next((r for r in kernel_rows if r["case"] == "serving"), None)
    entry = dict(
        name="flash_attention_qk_norm_rope", route="cuda",
        source="textflux_torch/csrc/fused_attention.cu",
        # the prep pass is in `source`, the attention mainloop here
        mainloop_source="textflux_torch/csrc/flash_fwd_sm90.cu",
        build={k: v for k, v in build_rec.get("kernels", {}).items()
               if k.startswith(("norm_rope_kernel", "flash_fwd_sm90_kernel"))},
        replaces="textflux_tpu/ops/flash_attention.py:577",
        launches=(sum(r["launches"] for r in main_rec["runs"].values())
                  if main_rec else None),
        launches_by_run=({k: v["launches"] for k, v in main_rec["runs"].items()}
                         if main_rec else None),
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


def _flash_entries(flash_rows, train_rec, build_rec) -> list:
    """One JSON entry per training kernel: times at the `train` case,
    launches from the train phase (all steps, and per step)."""
    train = flash_rows.get("train")
    out = []
    for name in FLASH_KERNELS:
        entry = dict(name=name, route="cuda", source=FLASH_SOURCES[name],
                     build={k: v for k, v in build_rec.get("kernels", {}).items()
                            if k.startswith(FLASH_FUNCTIONS[name])},
                     replaces=f"textflux_tpu/ops/flash_attention.py:{FLASH_REPLACES[name]}",
                     launches=train_rec["launches"][name] if train_rec else None,
                     launches_per_step=([c[name] for c in train_rec["launches_per_step"]]
                                        if train_rec else None))
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
    if {"build", "kernels", "main", "train"} & set(phases):
        build_rec = phase_build()
    kernel_rows = phase_kernels() if "kernels" in phases else []
    flash_rows = phase_flash_kernels() if "kernels" in phases else {}
    main_rec = phase_main("profile" in phases) if "main" in phases else None
    train_rec = phase_train("profile" in phases) if "train" in phases else None

    kernel_entries = [_fused_entry(kernel_rows, main_rec, build_rec)]
    kernel_entries += _flash_entries(flash_rows, train_rec, build_rec)
    log(dev["nvidia_smi"])
    print(json.dumps({"kernels": kernel_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
