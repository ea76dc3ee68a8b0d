"""Fine-tuning of the fill DiT: the training CLI.

The port of ``textflux_tpu/cli/train.py``:

  python -m textflux_torch.cli.train \\
      --model /path/to/FLUX.1-Fill-dev [--transformer path] \\
      --data-json data.json --data-images imgs/      (AnyWord single-line)
      | --data-dir combined/ [--multi-dataset]       (pre-combined folders)
      --output-dir out/ [--mode attn|all|lora] [--lora-rank 128]
      [--optimizer adamw|adamw8bit|prodigy] [--use-8bit-adam]
      [--quantize-base none|weight_only|nf4]
      [--learning-rate 2e-5] [--train-batch-size 1] [--grad-accum 8]
      [--max-train-steps 10000] [--checkpointing-steps 5000]
      [--resume-from-checkpoint latest] [--pretrained-lora file]
      [--profile-steps N] [--device cuda|cpu] [--mesh dp,fsdp,tp]

Per optimizer step: the batch's prompts are encoded (CLIP pooled + T5,
frozen), then one step of ``training.train.make_train_step`` runs.
``--mode attn`` (the default) trains the reference's attention unfreeze
(``attn_only_mask``: the double blocks' qkv and out projections, the single
blocks' q|k|v rows of linear1, the q/k norm scales), ``--mode all`` every
DiT weight: the trainable parameters load as float32 masters, the frozen
ones in the compute dtype where the checkpoint stores them so (bf16 under
``--mixed-precision bf16``), else in float32, and the trained DiT is
written as ``<output>/transformer/`` in float32 (the checkpoint's
interleaved q/k layout), which ``FillPipeline.from_pretrained(
transformer_path=...)`` serves. ``--mode lora`` trains LoRA factors over
the frozen base (``--quantize-base`` stores it int8 weight-only or NF4,
quantised as it loads: QLoRA) and writes them as
``<output>/pytorch_lora_weights.safetensors``, which
``FillPipeline.from_pretrained(lora_path=...)`` serves. ``--optimizer
adamw8bit`` (or ``--use-8bit-adam``, the reference's full-parameter
optimizer) keeps Adam's moments in blockwise int8. Each step draws its
noise from a generator seeded from (seed, step), as the JAX trainer folds
the step into its key, so a resumed run continues the stream. Checkpoints
(the trained tensors, optimizer state, step) rotate under
``<output>/checkpoints/``; SIGTERM finishes the step, saves and exits.

Runs on CUDA unless ``--device cpu`` is asked. Under ``torchrun
--nproc-per-node N`` (or with ``--mesh dp,fsdp,tp``) it trains over a mesh,
every rank on the fsdp axis by default, as the JAX trainer: each rank loads
its shard of the DiT (``io.params.load_flux_fsdp``: its tensor shard,
permuted device-major, then its FSDP slice of that; a ``--quantize-base``
base's codes as storage shards), the optimizer state shards with it, every
rank reads the same batches and trains on its rows of each (the batch over
data x fsdp; the ranks of a tensor group on the same rows), LoRA factors
stay whole over the tensor axis, and rank 0 alone logs, writes the
checkpoints (in the whole tensors' natural layout, so they resume on any
mesh) and exports. The JAX flags parse unchanged. ``--loader-procs N``
preps the samples in N spawned worker processes (each rebuilds the dataset
from the arguments; ``data.loader``'s process mode, whose order does not
depend on timing, so over a mesh every rank's own pool gives the same
batches), else in threads; the workers end on every way out of ``main()``.
``train_lora`` and ``train_full`` are the in-memory entries: built models
and collated batches in, the trained factors or model out.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import math
import os
import signal
import time
from typing import Callable, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from textflux_torch.models.clip import CLIPTextModel, clip_encode
from textflux_torch.models.t5 import T5Encoder, t5_encode
from textflux_torch.models.transformer import FluxTransformer, tp_permute_flux_params
from textflux_torch.models.vae import FluxVAE
from textflux_torch.parallel import partitioning as PT
from textflux_torch.training import train as TR
from textflux_torch.training.checkpoint import copy_into
from textflux_torch.utils.tracking import span


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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of optimizer step `step` (0 for the first, counted over
    resumes): seeded from (seed, step) alone, as the JAX trainer's per-step
    key is fold_in(PRNGKey(seed), step)."""
    entropy = [seed % 2 ** 32, seed // 2 ** 32 % 2 ** 32, step]
    s = int(np.random.SeedSequence(entropy).generate_state(2, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(s)


def batch_part(mesh: PT.Mesh, b: int) -> slice:
    """This rank's rows of a batch of `b` over the mesh's (data, fsdp)."""
    n = mesh.batch_shards
    if b % n:
        raise ValueError(f"a batch of {b} does not split over the {n} ranks of data x fsdp")
    return slice(mesh.batch_rank * b // n, (mesh.batch_rank + 1) * b // n)


def local_rows(batch: Mapping, part: slice) -> dict:
    """Rows `part` of each microbatch of a collated batch (its arrays
    (A, B, ...), its prompts A*B in (A, B) order)."""
    b = batch["pixel_values"].shape[1]
    pick = [i * b + r for i in range(batch["pixel_values"].shape[0])
            for r in range(part.start, part.stop)]
    return dict(batch, pixel_values=batch["pixel_values"][:, part],
                mask=batch["mask"][:, part],
                prompts=[batch["prompts"][k] for k in pick],
                clip_prompts=[batch["clip_prompts"][k] for k in pick])


def train_steps(flux: FluxTransformer, vae: FluxVAE, clip: CLIPTextModel, t5: T5Encoder,
                batches: Iterable[Mapping], opt: TR.ClippedOptimizer, *, tc: TR.TrainConfig,
                clip_tokenize: Callable, t5_tokenize: Callable, seed: int,
                start_step: int = 0, mesh: Optional[PT.Mesh] = None
                ) -> Iterator[Tuple[int, dict]]:
    """The step loop every entry point shares: one optimizer step of
    ``make_train_step`` per batch of `batches` (``BucketedLoader._collate``'s
    format), yielding (the step count after it, its metrics as 0-d device
    tensors). The caller stops by leaving the loop; no batch is fetched
    past the last step it takes.

    With `mesh` (`flux` sharded over it), every rank is given the same
    batches and trains on its rows of each (``batch_part``), drawing the
    whole batch's noise from the step's generator."""
    dev = next(flux.parameters()).device
    step_fn = TR.make_train_step(tc, mesh=mesh)
    cdt = getattr(torch, tc.compute_dtype)
    step = start_step
    batches = iter(batches)
    while True:
        # the step's spans close before the yield: the caller's time is not the step's
        with span("train.step", step=step):
            with span("train.data_wait"):
                batch = next(batches, None)
            if batch is None:
                return
            rows = None
            if mesh is not None:
                b = batch["pixel_values"].shape[1]
                part = batch_part(mesh, b)
                batch, rows = local_rows(batch, part), (part.start, b)
            with span("train.text_encode"):
                pooled, txt = encode_batch_text(clip, t5, batch, clip_tokenize=clip_tokenize,
                                                t5_tokenize=t5_tokenize, dtype=cdt)
            device_batch = {
                "pixel_values": torch.as_tensor(batch["pixel_values"], device=dev).to(cdt),
                "mask": torch.as_tensor(batch["mask"], device=dev).to(cdt),
                "txt": txt, "pooled": pooled,
            }
            metrics = step_fn(flux, vae, opt, device_batch,
                              generator=step_generator(seed, step, dev), batch_rows=rows)
        step += 1
        yield step, metrics


def tensor_shard(flux: FluxTransformer, mesh: Optional[PT.Mesh]) -> FluxTransformer:
    """A whole `flux` cut, in place, to this rank's shard over the tensor
    axis of `mesh` (permuted device-major, then sliced); as it is without
    one, or when it holds a shard already."""
    if mesh is not None and mesh.tensor > 1 and flux.tp_rank is None:
        tp_permute_flux_params(flux, mesh.tensor)
        PT.shard_module(flux, PT.flux_param_specs(flux.cfg), mesh)
    return flux


def _cut(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A sharded LoRA factor's slice of a whole tensor (the whole tensor
    for a plain one: the factors stay whole over a tensor axis)."""
    spec = PT.shard_spec(p)
    return whole if spec is None else spec.cut(whole)


def train_state(lora: TR.Lora, opt: TR.ClippedOptimizer, step: int) -> dict:
    """What a LoRA checkpoint holds: the factors, the optimizer state, the
    step; sharded ones whole, on the host (gathered: every rank calls
    this)."""
    return {"lora": {p: {k: PT.full_tensor(f[k], host=True) for k in ("a", "b")}
                     for p, f in lora.items()},
            "opt_state": opt.state_dict(), "step": step}


def load_train_state(lora: TR.Lora, opt: TR.ClippedOptimizer, state: Mapping) -> int:
    """Copy a checkpoint's factors and optimizer state into the live ones
    (same targets and shapes, or it raises; a sharded factor takes its
    slice); returns its step."""
    if set(state["lora"]) != set(lora):
        raise ValueError("the checkpoint's LoRA targets differ from the model's")
    with torch.no_grad():
        for path, f in lora.items():
            for k in ("a", "b"):
                if f[k].shape != state["lora"][path][k].shape:
                    raise ValueError(f"checkpoint factor {path}.{k} has shape "
                                     f"{tuple(state['lora'][path][k].shape)}, the model "
                                     f"{tuple(f[k].shape)}")
                PT.local(f[k]).copy_(_cut(f[k], state["lora"][path][k]))
    opt.load_state_dict(state["opt_state"])
    return int(state["step"])


def full_train_state(flux: FluxTransformer, opt: TR.ClippedOptimizer, step: int) -> dict:
    """What a full-parameter checkpoint holds, as the JAX trainer's does:
    every DiT parameter (frozen ones too) in its dtype, the optimizer
    state, the step; sharded ones whole in the natural layout, on the host
    (gathered: every rank calls this)."""
    return {"params": {n: PT.whole_tensor(flux, n, p, host=True)
                       for n, p in flux.named_parameters()},
            "opt_state": opt.state_dict(), "step": step}


def load_full_train_state(flux: FluxTransformer, opt: TR.ClippedOptimizer,
                          state: Mapping) -> int:
    """Copy a full-parameter checkpoint into the live model and optimizer,
    in place and in their dtypes (``checkpoint.copy_into``: the names,
    shapes and dtypes must match; a sharded parameter takes its slice);
    returns its step."""
    named = dict(flux.named_parameters())
    saved = {n: PT.cut_whole(flux, n, named[n], v) if n in named else v
             for n, v in state["params"].items()}
    copy_into({n: PT.local(p.detach()) for n, p in named.items()}, saved, "params")
    opt.load_state_dict(state["opt_state"])
    return int(state["step"])


def _run_steps(steps: Iterator[Tuple[int, dict]], n: int, start: int, log_every: int,
               on_step: Optional[Callable], trained) -> Tuple[int, List[dict]]:
    """Take `n` steps of `steps`, logging each; returns (the last step, the
    history)."""
    history, step, t_start = [], start, time.time()
    if n <= 0:
        return step, history
    for step, metrics in steps:
        if on_step is not None:
            on_step(step, metrics, trained)
        entry = {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "elapsed_s": round(time.time() - t_start, 1)}
        history.append(entry)
        if step % log_every == 0:
            print(json.dumps(entry), flush=True)
        if step - start >= n:
            break
    return step, history


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
    state: Optional[dict] = None,
    mesh: Optional[PT.Mesh] = None,
) -> Tuple[TR.Lora, List[dict]]:
    """Train LoRA factors on `flux` (frozen, in place: the factors are
    attached to it) for `steps` optimizer steps.

    batches: dicts with "pixel_values" (A, B, H, W, 3) in [-1, 1], "mask"
    (A, B, H, W), "prompts" and "clip_prompts" (A*B strings each), as the
    loader collates them; numpy or tensors. `generator` draws the LoRA init
    (default: seeded with `seed` on the DiT's device); step s draws from
    ``step_generator(seed, s)``. `on_step(step, metrics, factors)` is called
    after each step, before its metrics are read back to the host.

    `state`, when given, is a training state ({"lora", "opt_state",
    "step"}, as a checkpoint holds it) to continue from; an empty dict
    starts afresh. Either way it holds the state after the last step (the
    live tensors) when the call returns, so a second call continues the
    first.

    With `mesh`, `flux` (whole, or this rank's tensor shard) is cut to this
    rank's tensor shard when the mesh has a tensor axis, the factors (drawn
    whole, as on one device) are attached, and the module is sharded over
    the fsdp axis with them (``shard_for_training``: a quantised base's
    codes as storage shards); each rank trains on its rows of each batch.

    Returns (the factors, one {"step", "loss", "grad_norm", "elapsed_s"}
    dict per step)."""
    tc = dataclasses.replace(tc, mode="lora")
    dev = next(itertools.chain(flux.parameters(), flux.buffers())).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    tensor_shard(flux, mesh)
    lora = TR.lora_init(flux, tc.lora_rank, generator=generator)
    TR.lora_insert(flux, lora, tc.lora_alpha / tc.lora_rank)
    if mesh is not None:   # FSDP keeps each rank's slice of the attached values
        PT.shard_for_training(flux, mesh, compute_dtype=getattr(torch, tc.compute_dtype))
        lora = TR.attached_lora(flux, lora)
    opt = TR.make_optimizer(tc, TR.lora_named_parameters(lora), model=flux, mesh=mesh)
    start = load_train_state(lora, opt, state) if state else 0
    step, history = _run_steps(
        train_steps(flux, vae, clip, t5, batches, opt, tc=tc, clip_tokenize=clip_tokenize,
                    t5_tokenize=t5_tokenize, seed=seed, start_step=start, mesh=mesh),
        steps, start, log_every, on_step, lora)
    if state is not None:
        state.update(train_state(lora, opt, step))
    return lora, history


def train_full(
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
    on_step: Optional[Callable[[int, dict, FluxTransformer], None]] = None,
    state: Optional[dict] = None,
    mesh: Optional[PT.Mesh] = None,
) -> Tuple[FluxTransformer, List[dict]]:
    """Train `flux` itself, in place, for `steps` optimizer steps:
    ``tc.mode`` "attn" (the attention unfreeze) or "all". The trainable
    parameters become float32 masters; a frozen one stays in the compute
    dtype where it is in it already, else it is kept float32
    (``frozen_dtype``), and stops requiring gradients.

    `batches`, `on_step(step, metrics, flux)` and step s's draws are as in
    ``train_lora``. `state`, when given, is a training state ({"params",
    "opt_state", "step"}, as a checkpoint holds it) to continue from, copied
    in place; an empty dict starts afresh. Either way it holds the state
    after the last step (the live tensors) when the call returns.

    With `mesh`, `flux` (whole) is first cut to this rank's tensor shard
    when the mesh has a tensor axis (``tp_permute_flux_params``,
    ``shard_module``), then sharded over its fsdp axis
    (``shard_for_training``) after the cast, with the optimizer state, and
    each rank trains on its rows of each batch (``train_steps``).

    Returns (the model, one {"step", "loss", "grad_norm", "elapsed_s"} dict
    per step)."""
    tensor_shard(flux, mesh)
    masks = TR.trainable_mask(flux, tc)
    compute = getattr(torch, tc.compute_dtype)
    stored = {name: p.dtype for name, p in flux.named_parameters()}
    TR.cast_params(flux, TR.mask_dtypes(masks, lambda name: TR.frozen_dtype(compute,
                                                                         stored[name])))
    named = TR.freeze_to_mask(flux, masks)
    if mesh is not None:
        PT.shard_for_training(flux, mesh, compute_dtype=compute)
        named = {n: p for n, p in flux.named_parameters() if n in masks}
    opt = TR.make_optimizer(tc, named, masks, model=flux, mesh=mesh)
    start = load_full_train_state(flux, opt, state) if state else 0
    step, history = _run_steps(
        train_steps(flux, vae, clip, t5, batches, opt, tc=tc, clip_tokenize=clip_tokenize,
                    t5_tokenize=t5_tokenize, seed=seed, start_step=start, mesh=mesh),
        steps, start, log_every, on_step, flux)
    if state is not None:
        state.update(full_train_state(flux, opt, step))
    return flux, history


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="textflux trainer (PyTorch)")
    p.add_argument("--model", required=True)
    p.add_argument("--transformer", default=None)
    p.add_argument("--data-json", default=None)
    p.add_argument("--data-images", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--multi-dataset", action="store_true")
    p.add_argument("--caption-type", default="txt")
    p.add_argument("--resolution", type=int, nargs="*", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mode", choices=["attn", "all", "lora"], default="attn",
                   help="attn: the attention unfreeze (the reference's full-parameter "
                        "recipe); all: every DiT weight; lora: LoRA factors")
    p.add_argument("--lora-rank", type=int, default=128)
    p.add_argument("--lora-alpha", type=float, default=128.0)
    p.add_argument("--quantize-base", choices=["none", "weight_only", "nf4"],
                   default="none",
                   help="LoRA mode only: quantise the frozen base DiT as it loads "
                        "(int8 weight-only or NF4; QLoRA); the LoRA factors train in fp32")
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--adam-beta1", type=float, default=0.9)
    p.add_argument("--adam-beta2", type=float, default=0.999)
    p.add_argument("--adam-epsilon", type=float, default=1e-8)
    p.add_argument("--adam-weight-decay", type=float, default=1e-2)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--logit-mean", type=float, default=0.0,
                   help="timestep-density sampling (weighting-scheme "
                        "logit_normal)")
    p.add_argument("--logit-std", type=float, default=1.0)
    p.add_argument("--mode-scale", type=float, default=1.29)
    p.add_argument("--font-path", default=None,
                   help="glyph font for the AnyWord dataset (default: "
                        "bundled/DejaVu fallback)")
    p.add_argument("--pretrained-lora", default=None,
                   help="warm-start LoRA training from an existing "
                        "pytorch_lora_weights.safetensors (reference "
                        "train_lora.py:536-553)")
    p.add_argument("--optimizer", choices=["adamw", "adamw8bit", "prodigy"],
                   default="adamw")
    p.add_argument("--use-8bit-adam", action="store_true",
                   help="int8 blockwise Adam moments (reference --use_8bit_adam)")
    p.add_argument("--prodigy-beta3", type=float, default=None,
                   help="prodigy D-estimate momentum (default sqrt(beta2), "
                        "reference --prodigy_beta3)")
    p.add_argument("--prodigy-safeguard-warmup", action="store_true",
                   help="remove lr from the prodigy D-estimate denominator "
                        "during warmup (reference --prodigy_safeguard_warmup)")
    p.add_argument("--lr-scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "cosine",
                            "cosine_with_restarts", "linear", "polynomial"])
    p.add_argument("--lr-warmup-steps", type=int, default=0)
    p.add_argument("--lr-num-cycles", type=int, default=1,
                   help="hard restarts in cosine_with_restarts")
    p.add_argument("--lr-power", type=float, default=1.0,
                   help="polynomial schedule exponent")
    p.add_argument("--scale-lr", action="store_true",
                   help="multiply the lr by grad_accum * train_batch_size "
                        "(reference --scale_lr; one device, so no device-count factor)")
    p.add_argument("--train-batch-size", type=int, default=1)
    p.add_argument("--bucket-quant", type=int, default=None,
                   help="short-side snap multiple for resolution buckets "
                        "(default: 32 at B=1 = exact reference sizing, 128 "
                        "at B>1 so shape-uniform batches fill)")
    p.add_argument("--loader-procs", type=int, default=0,
                   help="sample-prep worker PROCESSES (a persistent spawn pool, "
                        "arrays through /dev/shm, in an order that does not depend "
                        "on timing); 0 = thread prefetch")
    p.add_argument("--grad-accum", type=int, default=8)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--weighting-scheme", default="none")
    p.add_argument("--schedule-shift", type=float, default=3.0,
                   help="static timestep-schedule shift for the training "
                        "noise density (the reference reads it from the "
                        "scheduler config, scripts/train.py:975-981; FLUX "
                        "ships 3.0)")
    p.add_argument("--cond-dropout-prob", type=float, default=0.0,
                   help="dropout on the packed 320-ch conditioning "
                        "(reference --dropout_prob)")
    p.add_argument("--mixed-precision", choices=["bf16", "no"], default="bf16",
                   help="model compute dtype (reference --mixed_precision; "
                        "fp16 is not offered)")
    p.add_argument("--no-gradient-checkpointing", action="store_true",
                   help="disable per-block remat (reference trains WITH "
                        "--gradient_checkpointing)")
    p.add_argument("--max-train-steps", type=int, default=None,
                   help="total optimizer steps (default: derived from "
                        "--num-train-epochs like the reference when unset)")
    p.add_argument("--num-train-epochs", type=int, default=1,
                   help="used only when --max-train-steps is unset: steps = "
                        "epochs * ceil(len(dataset) / (batch * accum)) "
                        "(reference parser_helper.py:228-233)")
    p.add_argument("--checkpointing-steps", type=int, default=5000)
    p.add_argument("--checkpoints-total-limit", type=int, default=3)
    p.add_argument("--resume-from-checkpoint", default=None)
    p.add_argument("--max-sequence-length", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh", default=None,
                   help="dp,fsdp,tp over the ranks (default under torchrun: 1,<world>,1, "
                        "every rank on fsdp)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--report-to", default="jsonl", choices=["jsonl", "wandb"])
    p.add_argument("--profile-steps", type=int, default=0,
                   help="capture a torch.profiler trace of the first N steps "
                        "under <output-dir>/profile")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def mesh_shape(args) -> Optional[Tuple[int, int, int]]:
    """The training mesh (data, fsdp, tensor): ``--mesh``, else the JAX
    trainer's default (1, world, 1) when the process is one of several
    ranks (torchrun's WORLD_SIZE, or an initialised process group); None
    for one device without ``--mesh``."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if not args.mesh:
        return (1, world, 1) if world > 1 else None
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"--mesh {args.mesh!r}: expected three positive sizes dp,fsdp,tp")
    if world > 1 and math.prod(shape) != world:
        raise ValueError(f"--mesh {args.mesh} spans {math.prod(shape)} ranks, the run has "
                         f"{world}")
    return shape


def check_ported(args) -> None:
    """Exit on a choice the JAX trainer refuses, with its message (and on a
    malformed --mesh)."""
    if args.quantize_base != "none" and args.mode != "lora":
        raise SystemExit("--quantize-base requires --mode lora (full-param "
                         "training cannot update a quantized base)")
    mesh_shape(args)


def build_dataset(args):
    from textflux_torch.data import (
        PREFERRED_RESOLUTIONS,
        AnyWordSingleLineDataset,
        CombinedFolderDataset,
        UnionDataset,
    )

    resolutions = args.resolution or PREFERRED_RESOLUTIONS
    # B>1 batches must be shape-uniform; coarsen the aspect lattice so
    # buckets fill (data/dataset.py _snap_bucket). B=1 keeps exact sizing.
    quant = args.bucket_quant
    if quant is None:
        quant = 128 if args.train_batch_size > 1 else 32
    if args.data_json:
        return AnyWordSingleLineDataset(
            [(args.data_json, args.data_images)], resolutions=resolutions,
            seed=args.seed, bucket_quant=quant, font_path=args.font_path)
    if args.multi_dataset:
        return UnionDataset(args.data_dir, img_size=resolutions,
                            caption_type=args.caption_type, seed=args.seed,
                            bucket_quant=quant)
    return CombinedFolderDataset(args.data_dir, img_size=resolutions,
                                 caption_type=args.caption_type,
                                 seed=args.seed, bucket_quant=quant)


def resume_step(want: str, ckpt) -> Optional[int]:
    """--resume-from-checkpoint's value as a step: None for 'latest', else a
    bare step number or a checkpoint path ending in the step number (a
    specific step must not silently load the latest). A step without a
    checkpoint exits, listing the ones there are."""
    if want == "latest":
        return None
    base = os.path.basename(os.path.normpath(want))
    if not base.isdigit():
        raise SystemExit(
            f"--resume-from-checkpoint expects 'latest', a step "
            f"number, or a checkpoint path ending in the step "
            f"number; got {want!r}")
    step = int(base)
    if step not in ckpt.all_steps():
        raise SystemExit(f"no checkpoint at step {step} under {ckpt.directory} "
                         f"(available: {ckpt.all_steps()})")
    return step


def load_models(args, dev: torch.device, tc: TR.TrainConfig, mesh: Optional[PT.Mesh] = None,
                prepare: Optional[Callable] = None):
    """The models from a diffusers-layout directory: the DiT in the
    checkpoint's interleaved q/k layout (the training attention takes it as
    it is) -- in bf16 for LoRA (quantised as it streams in with
    ``--quantize-base``), and for ``--mode attn|all`` with its trainable
    parameters (``trainable_mask`` of a DiT on the meta device) in float32
    and each frozen one in the compute dtype where the checkpoint stores it
    so, else in float32 (``frozen_dtype``: a float32 checkpoint's frozen
    weights come back unchanged in the export, as the JAX trainer's do),
    each loaded once in its dtype; the VAE, CLIP and T5 in bf16; and the
    tokenizers. With `mesh`, the DiT is this rank's shard, read from the
    mapped files (``io.params.load_flux_fsdp``, which hands the module to
    `prepare` before sharding it over fsdp)."""
    from textflux_torch.io.config_io import (clip_config_from, flux_config_from,
                                             t5_config_from, vae_config_from)
    from textflux_torch.io.params import (checkpoint_dtypes, load_checkpoint_dir,
                                          load_flux_fsdp, load_flux_transformer)
    from textflux_torch.pipeline.tokenizers import load_tokenizers

    t_path = args.transformer or os.path.join(args.model, "transformer")
    flux_cfg = flux_config_from(t_path)
    dtype = torch.bfloat16
    compute = getattr(torch, tc.compute_dtype)
    if tc.mode != "lora":
        masks = TR.trainable_mask(FluxTransformer(flux_cfg, device="meta"), tc)
        stored = checkpoint_dtypes(t_path, flux_cfg)
        dtype = TR.mask_dtypes(masks, lambda name: TR.frozen_dtype(compute, stored[name]))
    if mesh is not None:
        flux = load_flux_fsdp(t_path, flux_cfg, mesh, dtype=dtype, device=dev,
                              compute_dtype=compute, prepare=prepare,
                              quantize=None if args.quantize_base == "none"
                              else args.quantize_base)
    else:
        flux = load_flux_transformer(
            t_path, flux_cfg, dtype=dtype, device=dev,
            quantize=None if args.quantize_base == "none" else args.quantize_base)
    parts = []
    for sub, cfg_from in (("vae", vae_config_from), ("text_encoder", clip_config_from),
                          ("text_encoder_2", t5_config_from)):
        path = os.path.join(args.model, sub)
        parts.append(load_checkpoint_dir(path, cfg_from(path), dtype=torch.bfloat16,
                                         device=dev))
    tokenizers = load_tokenizers(args.model, max_t5_length=args.max_sequence_length)
    return (flux_cfg, flux, *parts, *tokenizers)


def any_rank(flag: bool, mesh: Optional[PT.Mesh], dev) -> bool:
    """`flag` OR-ed over every rank (a collective), so the ranks decide
    together and none waits in a collective that another has left."""
    if mesh is None:
        return flag
    t = torch.tensor([float(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    from textflux_torch.data import BucketedLoader
    from textflux_torch.device import resolve_device
    from textflux_torch.io.export import (export_lora_state_dict, gathered_flux,
                                          save_safetensors, save_transformer_checkpoint)
    from textflux_torch.io.params import load_safetensors_dir
    from textflux_torch.training.checkpoint import CheckpointManager
    from textflux_torch.utils.tracking import Tracker, profile_trace

    dev = resolve_device(args.device)
    # the dataset is host-side and cheap to index; built before the config so
    # --num-train-epochs can derive the step budget like the reference
    dataset = build_dataset(args)
    if args.max_train_steps is None:
        steps_per_epoch = math.ceil(len(dataset) / (args.train_batch_size * args.grad_accum))
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
        print(f"derived max_train_steps={args.max_train_steps} "
              f"({args.num_train_epochs} epochs x {steps_per_epoch} steps)")
    if args.scale_lr:
        args.learning_rate *= args.grad_accum * args.train_batch_size

    tc = TR.TrainConfig(
        learning_rate=args.learning_rate,
        optimizer="adamw8bit" if args.use_8bit_adam else args.optimizer,
        lr_scheduler=("constant" if args.lr_scheduler == "constant_with_warmup"
                      else args.lr_scheduler),
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
        adam_b1=args.adam_beta1,
        adam_b2=args.adam_beta2,
        adam_eps=args.adam_epsilon,
        weight_decay=args.adam_weight_decay,
        max_grad_norm=args.max_grad_norm,
        guidance_scale=args.guidance_scale,
        weighting_scheme=args.weighting_scheme,
        schedule_shift=args.schedule_shift,
        logit_mean=args.logit_mean,
        logit_std=args.logit_std,
        mode_scale=args.mode_scale,
        mode=args.mode,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        cond_dropout_prob=args.cond_dropout_prob,
        compute_dtype="bfloat16" if args.mixed_precision == "bf16" else "float32",
        remat=not args.no_gradient_checkpointing,
        prodigy_beta3=args.prodigy_beta3,
        prodigy_safeguard_warmup=args.prodigy_safeguard_warmup,
        lr_num_cycles=args.lr_num_cycles,
        lr_power=args.lr_power,
    )

    # the mesh (the JAX trainer's exit when the batch does not split over it)
    shape, mesh = mesh_shape(args), None
    if shape is not None:
        dp = shape[0] * shape[1]
        if args.train_batch_size % dp:
            raise SystemExit(
                f"--train-batch-size {args.train_batch_size} must be divisible by "
                f"the mesh's data x fsdp product ({shape[0]}x{shape[1]}={dp}): "
                f"the batch axis shards over both mesh axes")
        if math.prod(shape) > 1:
            mesh = PT.make_mesh(shape, device=dev)
    rank0 = mesh is None or dist.get_rank() == 0

    def make_lora(model):
        lora = TR.lora_init(model, tc.lora_rank, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed))
        if args.pretrained_lora:
            # warm start (reference train_lora.py:536-553): imported targets
            # replace their fresh init; grouped targets keep their file's rank
            from textflux_torch.io.lora import import_lora_factors, resolve_lora_path

            imported = import_lora_factors(
                load_safetensors_dir(resolve_lora_path(args.pretrained_lora)), model.cfg,
                tc.lora_alpha / tc.lora_rank)
            for path, f in imported.items():
                lora[path] = {k: torch.nn.Parameter(v.to(dev)) for k, v in f.items()}
            if rank0:
                n_targets = len({path.split(".", 2)[2] for path in imported})
                print(f"warm-started {n_targets} LoRA targets from {args.pretrained_lora}")
        return lora

    made = {}

    def prepare(model):
        """Before FSDP shards it (on the meta device, or the rank's tensor
        shard or quantised base on its device): attach empty LoRA factors,
        or freeze what does not train."""
        if args.mode == "lora":
            made["lora"] = make_lora(model)
            where = next(itertools.chain(model.parameters(), model.buffers())).device
            TR.lora_insert(model, {p: {k: torch.empty_like(v, device=where)
                                       for k, v in f.items()}
                                   for p, f in made["lora"].items()},
                           tc.lora_alpha / tc.lora_rank)
        else:
            TR.freeze_to_mask(model, TR.trainable_mask(model, tc))

    flux_cfg, flux, vae, clip, t5, clip_tok, t5_tok = load_models(
        args, dev, tc, **({} if mesh is None else {"mesh": mesh, "prepare": prepare}))
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                             max_to_keep=args.checkpoints_total_limit)

    if args.mode == "lora":
        if mesh is None:
            lora = make_lora(flux)
            TR.lora_insert(flux, lora, tc.lora_alpha / tc.lora_rank)
        else:   # this rank's slices of the factors drawn whole
            lora = TR.attached_lora(flux, made["lora"])
            with torch.no_grad():
                for path, f in lora.items():
                    for k in ("a", "b"):
                        PT.local(f[k]).copy_(_cut(f[k], made["lora"][path][k]))
            del made["lora"]
        opt = TR.make_optimizer(tc, TR.lora_named_parameters(lora), model=flux, mesh=mesh)

        def state_at(step):
            return train_state(lora, opt, step)

        def load_state(state):
            return load_train_state(lora, opt, state)
    else:
        masks = TR.trainable_mask(flux, tc)
        named = (TR.freeze_to_mask(flux, masks) if mesh is None else
                 {n: p for n, p in flux.named_parameters() if n in masks})
        opt = TR.make_optimizer(tc, named, masks, model=flux, mesh=mesh)

        def state_at(step):
            return full_train_state(flux, opt, step)

        def load_state(state):
            return load_full_train_state(flux, opt, state)

    step = 0
    if args.resume_from_checkpoint:
        restored = ckpt.restore(resume_step(args.resume_from_checkpoint, ckpt))
        if restored is not None:
            step = load_state(restored)
            del restored
            if rank0:
                print(f"resumed from step {step}")

    samples_per_batch = args.train_batch_size * args.grad_accum
    if len(dataset) < samples_per_batch:
        # without this the epoch loop below spins forever: every epoch yields
        # zero full batches (partials are dropped) and no step ever runs
        raise SystemExit(
            f"dataset has {len(dataset)} sample(s) but one optimizer "
            f"step needs --train-batch-size x --grad-accum = "
            f"{samples_per_batch}; reduce them or add data (and note "
            f"per-bucket batches must FILL — mixed-resolution data "
            f"needs enough samples per bucket, see --bucket-quant)")
    # over a mesh every rank must read the same batches: one worker thread,
    # whose order is the shuffle's alone, or the worker processes, whose
    # order does not depend on timing either (each rank has its own pool)
    loader = BucketedLoader(dataset, batch_size=args.train_batch_size,
                            grad_accum=args.grad_accum, seed=args.seed,
                            num_procs=args.loader_procs,
                            # spawn-picklable: a module-level function and the Namespace
                            dataset_factory=(functools.partial(build_dataset, args)
                                             if args.loader_procs else None),
                            **({} if mesh is None else {"num_workers": 1}))
    if step:
        # position the data order too: the completed-epoch count (the exact
        # position inside an epoch is undefined under racing prefetch
        # workers, but the resumed epochs must not replay epoch 0)
        loader.set_epoch(step // max(1, len(dataset) // samples_per_batch))

    # preemption safety: on SIGTERM, finish the in-flight step, checkpoint
    # and exit cleanly so `--resume-from-checkpoint latest` continues; over
    # a mesh the ranks agree after each step on whether any saw it
    preempt = {"seen": False}

    def on_sigterm(signum, frame):
        preempt["seen"] = True

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread (an in-process harness)
        prev_sigterm = None

    log_path = os.path.join(args.output_dir, "train_log.jsonl")
    os.makedirs(args.output_dir, exist_ok=True)
    tracker = (Tracker(args.output_dir, use_wandb=(args.report_to == "wandb"),
                       config=vars(args)) if rank0 else None)
    # the trace covers this run's first --profile-steps steps (rank 0's)
    profiler, first_step = None, step
    if args.profile_steps and step < args.max_train_steps and rank0:
        profiler = profile_trace(os.path.join(args.output_dir, "profile"))
        profiler.__enter__()
    t_start = time.time()
    stop = False
    try:
        while step < args.max_train_steps:
            epoch_batches = 0
            for step, metrics in train_steps(flux, vae, clip, t5, loader, opt, tc=tc,
                                             clip_tokenize=clip_tok, t5_tokenize=t5_tok,
                                             seed=args.seed, start_step=step, mesh=mesh):
                epoch_batches += 1
                if profiler is not None and step - first_step == args.profile_steps:
                    profiler.__exit__(None, None, None)
                    profiler = None
                if step % args.log_every == 0 and rank0:
                    entry = {"step": step, "loss": float(metrics["loss"]),
                             "grad_norm": float(metrics["grad_norm"]),
                             "elapsed_s": round(time.time() - t_start, 1)}
                    print(json.dumps(entry), flush=True)
                    with open(log_path, "a") as f:
                        f.write(json.dumps(entry) + "\n")
                    tracker.log({"loss": entry["loss"], "grad_norm": entry["grad_norm"]},
                                step)
                stop = any_rank(preempt["seen"], mesh, dev)
                if step % args.checkpointing_steps == 0 or stop:
                    state = state_at(step)   # every rank: sharded tensors are gathered
                    if rank0:
                        ckpt.save(step, state, wait=stop)
                    del state
                if stop or step >= args.max_train_steps:
                    break
            if stop:
                break
            if epoch_batches == 0:
                # enough samples overall, but no (H, W) bucket ever filled a
                # batch: the same endless loop as the too-small case above
                raise SystemExit(
                    "a full data epoch produced zero full batches: no "
                    "resolution bucket reached --train-batch-size x "
                    "--grad-accum samples; coarsen --bucket-quant, reduce "
                    "the batch settings, or add data per bucket")
    finally:
        loader.close()   # the worker processes end on every way out of the loop
        if profiler is not None:
            profiler.__exit__(None, None, None)
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if tracker is not None:
            tracker.finish()

    if stop:
        if rank0:
            entry = {"step": step, "preempted": True}
            print(json.dumps(entry))
            with open(log_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
            print("preempted: checkpoint saved; resume with "
                  "--resume-from-checkpoint latest")
        if mesh is not None:
            dist.barrier()
        return

    if args.mode == "lora":   # the trained factors in the diffusers/peft layout
        whole = {p: {k: PT.full_tensor(f[k]) for k in ("a", "b")} for p, f in lora.items()}
        if rank0:
            sd = export_lora_state_dict(whole, flux_cfg, tc.lora_alpha, rank=tc.lora_rank)
            save_safetensors(sd, os.path.join(args.output_dir,
                                              "pytorch_lora_weights.safetensors"))
    else:   # the DiT in the diffusers layout, float32 as the JAX trainer writes it
        whole = flux if mesh is None else gathered_flux(flux, keep=rank0)
        if rank0:
            save_transformer_checkpoint(whole, os.path.join(args.output_dir, "transformer"),
                                        dtype=torch.float32)
    del whole
    ckpt.wait()  # drain an in-flight checkpoint write before exit
    if mesh is not None:
        dist.barrier()
    if rank0:
        print("training complete")


if __name__ == "__main__":
    main()
