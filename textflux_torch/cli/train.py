"""LoRA fine-tuning of the fill DiT: the LoRA branch of the JAX trainer.

The port of ``textflux_tpu/cli/train.py``'s LoRA path (``--mode lora``):
per batch, the prompts are encoded (CLIP pooled + T5), then one optimizer
step runs ``training.train.make_lora_train_step`` over a frozen base with
LoRA factors attached; every ``log_every`` steps the JAX trainer's JSON log
line is printed. ``train_lora`` takes already-built models and batches in
``BucketedLoader._collate``'s format. The command-line ``main()``, the
dataset and loader, checkpointing and LoRA export are not ported yet.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from textflux_torch.models.clip import CLIPTextModel, clip_encode
from textflux_torch.models.t5 import T5Encoder, t5_encode
from textflux_torch.models.transformer import FluxTransformer
from textflux_torch.models.vae import FluxVAE
from textflux_torch.training import train as TR


@torch.no_grad()
def encode_batch_text(clip: CLIPTextModel, t5: T5Encoder, batch: Mapping, *,
                      clip_tokenize: Callable, t5_tokenize: Callable,
                      dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP pooled (A, B, pooled) and T5 (A, B, L, joint) embeddings of a
    collated batch's prompts, shaped like its (A, B) grad-accum layout."""
    a, b = batch["pixel_values"].shape[:2]
    dev = next(clip.parameters()).device
    cids = np.concatenate([np.asarray(clip_tokenize(p)) for p in batch["clip_prompts"]])
    tids = np.concatenate([np.asarray(t5_tokenize(p)) for p in batch["prompts"]])
    pooled = clip_encode(clip, torch.as_tensor(cids, device=dev), dtype=dtype)[1]
    txt = t5_encode(t5, torch.as_tensor(tids, device=dev), dtype=dtype)
    return pooled.reshape(a, b, -1), txt.reshape(a, b, *txt.shape[1:])


def train_lora(
    flux: FluxTransformer,
    vae: FluxVAE,
    clip: CLIPTextModel,
    t5: T5Encoder,
    batches: Iterable[Mapping],
    *,
    tc: TR.TrainConfig,
    clip_tokenize: Callable,
    t5_tokenize: Callable,
    steps: int,
    seed: int = 42,
    log_every: int = 10,
    generator: Optional[torch.Generator] = None,
    on_step: Optional[Callable[[int, dict, TR.Lora], None]] = None,
) -> Tuple[TR.Lora, List[dict]]:
    """Train LoRA factors on `flux` (frozen, in place: the factors are
    attached to it) for `steps` optimizer steps.

    batches: dicts with "pixel_values" (A, B, H, W, 3) in [-1, 1], "mask"
    (A, B, H, W), "prompts" and "clip_prompts" (A*B strings each), as the
    JAX loader collates them; numpy or tensors. `generator` draws the LoRA
    init and every step's noise (default: seeded with `seed` on the DiT's
    device). `on_step(step, metrics, factors)` is called after each step,
    before its metrics are read back to the host.

    Returns (the factors, one {"step", "loss", "grad_norm", "elapsed_s"}
    dict per step)."""
    dev = next(flux.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    lora = TR.lora_init(flux, tc.lora_rank, generator=generator)
    TR.lora_insert(flux, lora, tc.lora_alpha / tc.lora_rank)
    opt = TR.make_optimizer(tc, TR.lora_parameters(lora))
    step_fn = TR.make_lora_train_step(tc)
    cdt = getattr(torch, tc.compute_dtype)

    history = []
    t_start = time.time()
    for batch in batches:
        if len(history) >= steps:
            break
        pooled, txt = encode_batch_text(clip, t5, batch, clip_tokenize=clip_tokenize,
                                        t5_tokenize=t5_tokenize, dtype=cdt)
        device_batch = {
            "pixel_values": torch.as_tensor(batch["pixel_values"], device=dev).to(cdt),
            "mask": torch.as_tensor(batch["mask"], device=dev).to(cdt),
            "txt": txt, "pooled": pooled,
        }
        metrics = step_fn(flux, vae, opt, device_batch, generator=generator)
        step = len(history) + 1
        if on_step is not None:
            on_step(step, metrics, lora)
        entry = {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "elapsed_s": round(time.time() - t_start, 1)}
        history.append(entry)
        if step % log_every == 0:
            print(json.dumps(entry), flush=True)
    return lora, history
