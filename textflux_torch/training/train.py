"""Flow-matching training for the fill DiT: full-parameter (the attention
unfreeze, or every weight) and LoRA.

The port of ``textflux_tpu/training/train.py``: the train config, the
trainable masks (``attn_only_mask``, ``all_trainable_mask``, one mask per
``nn.Parameter``), the LoRA targets and factors (``lora_init``,
``lora_insert``, ``lora_merge``), the learning-rate schedules, AdamW, 8-bit
AdamW (``training.optim8bit``) and Prodigy (``optax.contrib.prodigy``)
behind optax's global-norm clipping, with the masks applied to the
gradients before the clip and to the updates after it,
``flow_matching_loss`` and ``make_train_step`` (for every mode: the JAX
``make_lora_train_step`` too) with its gradient accumulation written out as
a loop.

The factors live beside a frozen base: ``lora_insert`` attaches them to the
target linears (``nn.Linear``, or a weight_only / nf4 ``io.quantize.
QuantLinear``: QLoRA) as fp32 parameters, and ``models.layers.dense`` adds
the parallel branch y += (x @ A*s) @ B. The full-parameter modes train the
DiT's own parameters: fp32 masters for the trainable ones, the frozen ones
in any dtype (``dense`` casts every weight to the activation dtype per
product). Randomness comes from a ``torch.Generator`` or is handed in
(``flow_matching_loss(noise=...)``), so a test can give the port the JAX
package's draws.

Over the fsdp axis (``parallel.partitioning.shard_for_training``) each
parameter is a ``DTensor`` holding this rank's slice: the optimizers update
the local slices (their masks sliced to match), sum the global norm's
squares and Prodigy's two sums over the fsdp ranks, and give and take their
state in the whole tensors' layout (``state_dict``), so a checkpoint does
not depend on the mesh. The step draws each microbatch's noise for the
whole batch and keeps this rank's rows (``flow_matching_loss(batch_rows=)``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from textflux_torch.io.quantize import QuantLinear
from textflux_torch.models.transformer import FluxTransformer, flux_apply
from textflux_torch.models.vae import FluxVAE, vae_encode
from textflux_torch.ops import packing, samplers
from textflux_torch.ops.rope import rope_tables
from textflux_torch.parallel import partitioning as PT
from textflux_torch.training import optim8bit


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's TrainConfig that the train steps and
    the training CLI read, with its defaults (scripts/train.sh +
    parser_helper.py of the reference). The step takes the gradient
    accumulation count from the batch's leading axis, as the JAX step does,
    so the JAX field ``grad_accum`` has no place here."""

    learning_rate: float = 2e-5
    optimizer: str = "adamw"              # "adamw" | "adamw8bit" | "prodigy"
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 10000
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    guidance_scale: float = 1.0
    weighting_scheme: str = "none"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    schedule_shift: float = 3.0
    remat: bool = True
    mode: str = "attn"                    # "attn" | "all" | "lora"
    lora_rank: int = 128
    lora_alpha: float = 128.0
    compute_dtype: str = "bfloat16"
    cond_dropout_prob: float = 0.0
    # Prodigy's D-estimate momentum (None: sqrt(adam_b2)) and its warmup
    # safeguard (reference --prodigy_beta3 / --prodigy_safeguard_warmup)
    prodigy_beta3: Optional[float] = None
    prodigy_safeguard_warmup: bool = False
    lr_num_cycles: int = 1
    lr_power: float = 1.0


# ---------------------------------------------------------------------------
# Trainable masks
# ---------------------------------------------------------------------------

# parameter name -> its mask: None, the whole tensor trains; a 0/1 float
# tensor that broadcasts onto it, the elements that train. A parameter
# without an entry is frozen.
Masks = Dict[str, Optional[torch.Tensor]]

ATTN_DOUBLE = ("img_qkv", "txt_qkv", "img_proj", "txt_proj",
               "img_q_scale", "img_k_scale", "txt_q_scale", "txt_k_scale")
ATTN_SINGLE = ("linear1", "q_scale", "k_scale")


def jax_leaf(name: str) -> Tuple[str, Optional[int], bool]:
    """Where a port parameter lives in the JAX package's trees: (the leaf's
    dotted path, the layer in its stacked (L, ...) leaf or None, whether
    the port stores it transposed). "double_blocks.3.img_qkv.weight" ->
    ("double.img_qkv.w", 3, True); a LoRA factor "single_blocks.0.linear1.a"
    -> ("single.linear1.a", 0, False)."""
    parts = name.split(".")
    layer = None
    if parts[0] in ("double_blocks", "single_blocks"):
        layer, parts = int(parts[1]), [parts[0].split("_")[0]] + parts[2:]
    transpose = parts[-1] == "weight"   # nn.Linear keeps (out, in)
    parts[-1] = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    return ".".join(parts), layer, transpose


def attn_only_mask(model: FluxTransformer) -> Masks:
    """The reference's "attn"-substring unfreeze (the JAX attn_only_mask,
    which unfreezes every layer): the double blocks' qkv and out
    projections and q/k norm scales train whole; each single block's fused
    linear1 trains its leading 3*hidden output rows (q | k | v; the MLP
    rows are masked), with its q/k scales. Masks are made on the
    parameters' device (the CPU for a model on the meta device, whose masks
    serve to name the trainable parameters)."""
    d, m = model.cfg.hidden_dim, model.cfg.mlp_dim
    masks: Masks = {}
    for name, p in model.named_parameters():
        group, _, target = jax_leaf(name)[0].partition(".")
        target = target.split(".")[0]
        if group == "double" and target in ATTN_DOUBLE:
            masks[name] = None
        elif group == "single" and target == "linear1":
            rows = torch.zeros(3 * d + m, device="cpu" if p.is_meta else p.device)
            rows[:3 * d] = 1.0
            masks[name] = rows[:, None] if p.dim() == 2 else rows
        elif group == "single" and target in ATTN_SINGLE:
            masks[name] = None
    return masks


def all_trainable_mask(model: nn.Module) -> Masks:
    return {name: None for name, _ in model.named_parameters()}


def trainable_mask(model: FluxTransformer, tc: TrainConfig) -> Masks:
    """The mask of ``tc.mode``: "attn" or "all"."""
    if tc.mode == "attn":
        return attn_only_mask(model)
    if tc.mode == "all":
        return all_trainable_mask(model)
    raise ValueError(f"no parameter mask for mode {tc.mode!r}")


@torch.no_grad()
def apply_mask(tensors: Sequence[Optional[torch.Tensor]],
               masks: Sequence[Optional[torch.Tensor]]) -> None:
    """tensor *= mask, in place, for each pair with a mask (None tensors
    are skipped)."""
    for x, m in zip(tensors, masks, strict=True):
        if x is not None and m is not None:
            x.mul_(m)


def freeze_to_mask(model: nn.Module, masks: Masks) -> Dict[str, torch.Tensor]:
    """requires_grad on the parameters with a mask entry and off on every
    other (the JAX ``trainable_leaves`` stop-gradient: a frozen weight
    emits no weight-gradient product). Returns the trainable parameters by
    name, in the model's order."""
    for name, p in model.named_parameters():
        p.requires_grad_(name in masks)
    return {name: p for name, p in model.named_parameters() if name in masks}


@torch.no_grad()
def cast_params(model: nn.Module, dtype_of: Callable[[str], torch.dtype]) -> None:
    """Give each parameter the dtype ``dtype_of(name)``, in place (the
    ``nn.Parameter`` stays, its data is replaced)."""
    for name, p in model.named_parameters():
        if p.dtype != dtype_of(name):
            p.data = p.data.to(dtype_of(name))


def mask_dtypes(masks: Masks, frozen: Callable[[str], torch.dtype]) -> Callable[[str], torch.dtype]:
    """The per-parameter dtype of full-parameter training: float32 masters
    for the parameters of `masks`, ``frozen(name)`` for the rest."""
    return lambda name: torch.float32 if name in masks else frozen(name)


def frozen_dtype(compute: torch.dtype, stored: torch.dtype) -> torch.dtype:
    """The dtype a frozen weight stored in `stored` is kept in: the compute
    dtype where it is already stored in it (``dense`` casts every weight to
    the activation dtype per product, so nothing is lost), float32
    otherwise, so the float32 export writes it back unchanged, as the JAX
    trainer (which holds the whole DiT in float32) does."""
    return compute if stored == compute else torch.float32


# ---------------------------------------------------------------------------
# LoRA parameterisation
# ---------------------------------------------------------------------------

# The reference's 12 peft target modules (train_lora.py:511-524): qkv and out
# projections of both streams and both streams' MLPs on the double blocks;
# on the single blocks only attn.to_q/k/v, which live in the leading 3d
# output columns of the fused linear1.
LORA_TARGETS_DOUBLE = ("img_qkv", "txt_qkv", "img_proj", "txt_proj",
                       "img_mlp.fc1", "img_mlp.fc2",
                       "txt_mlp.fc1", "txt_mlp.fc2")
LORA_TARGETS_SINGLE = ("linear1",)
# Fused projections whose reference counterparts are independent per-module
# adapters (to_q, to_k, to_v): grouped factors a (M, in, r) / b (M, r, d)
# on the leading M*d output columns (layers.dense "lora_ga" / "lora_gb").
LORA_GROUPED = {"img_qkv": 3, "txt_qkv": 3, "linear1": 3}

Lora = Dict[str, Dict[str, torch.Tensor]]


def lora_targets(model: FluxTransformer) -> Dict[str, nn.Module]:
    """Every LoRA target linear by module path ("double_blocks.3.img_mlp.fc1"),
    target by target and layer by layer, as the JAX tree stacks them."""
    out = {}
    for group, names in (("double_blocks", LORA_TARGETS_DOUBLE),
                         ("single_blocks", LORA_TARGETS_SINGLE)):
        for name in names:
            for i, blk in enumerate(getattr(model, group)):
                out[f"{group}.{i}.{name}"] = blk.get_submodule(name)
    return out


def lora_target_dims(lin: nn.Module) -> Tuple[int, int]:
    """(d_in, d_out) of a target linear in any base layout: an ``nn.Linear``
    or a ``QuantLinear`` (its unpacked dims, whatever its codes' shape)."""
    return lin.in_features, lin.out_features


def lora_init(model: FluxTransformer, rank: int, *,
              generator: Optional[torch.Generator] = None, device=None) -> Lora:
    """Per-target fp32 factors: A ~ N(0, 1/r^2) (the JAX package's
    normal / rank), B = 0, on `device` (default: each target's). Grouped
    targets (LORA_GROUPED) get M independent per-module factors. Returns
    {path: {"a": Parameter, "b": Parameter}}."""
    d = model.cfg.hidden_dim
    lora = {}
    for path, lin in lora_targets(model).items():
        d_in, d_out = lora_target_dims(lin)
        dev = device if device is not None else next(
            itertools.chain(lin.parameters(), lin.buffers())).device
        m = LORA_GROUPED.get(path.split(".", 2)[2])   # "double_blocks.3.img_qkv" -> "img_qkv"
        a_shape, b_shape = ((m, d_in, rank), (m, rank, d)) if m else ((d_in, rank), (rank, d_out))
        a = torch.randn(a_shape, generator=generator, device=dev, dtype=torch.float32) / rank
        lora[path] = {"a": nn.Parameter(a),
                      "b": nn.Parameter(torch.zeros(b_shape, device=dev, dtype=torch.float32))}
    return lora


def attached_lora(model: FluxTransformer, paths: Iterable[str]) -> Lora:
    """The factors ``lora_insert`` attached at `paths`, as the module holds
    them now ({path: {"a", "b"}}; after ``shard_for_training``, the
    sharded parameters that replaced the ones inserted)."""
    out = {}
    for path in paths:
        lin = model.get_submodule(path)
        grouped = getattr(lin, "lora_ga", None) is not None
        out[path] = {"a": lin.lora_ga if grouped else lin.lora_a,
                     "b": lin.lora_gb if grouped else lin.lora_b}
    return out


def lora_parameters(lora: Lora) -> List[torch.Tensor]:
    return list(lora_named_parameters(lora).values())


def lora_named_parameters(lora: Lora) -> Dict[str, torch.Tensor]:
    """{"double_blocks.3.img_qkv.a": A, ...}: the factors under names that
    ``jax_leaf`` places in the JAX factor tree."""
    return {f"{path}.{k}": f[k] for path, f in lora.items() for k in ("a", "b")}


def lora_insert(model: FluxTransformer, lora: Lora, scale: float) -> FluxTransformer:
    """Freeze the base (every parameter of `model` gets requires_grad=False)
    and attach the factors to their target linears as the parallel branch
    ``dense`` computes: ``lora_a``/``lora_b`` (or grouped ``lora_ga``/
    ``lora_gb``) plus ``lora_scale`` = alpha/rank, folded into A at use.
    The base is never merged with the factors, so it may be quantised
    (weight_only or nf4; a w8a8 base raises, as in the JAX package). In
    place; returns `model`."""
    for p in model.parameters():
        p.requires_grad_(False)
    for path in lora:
        lin = model.get_submodule(path)
        if isinstance(lin, QuantLinear) and lin.mode == "w8a8":
            raise ValueError(
                "LoRA over a w8a8 base is unsupported: the activation-quant "
                "round() has zero gradient, so the base matmul would pass no "
                "dL/dx. Quantize the frozen base as weight_only or nf4.")
    for path, f in lora.items():
        lin = model.get_submodule(path)
        names = ("lora_ga", "lora_gb") if f["a"].dim() == 3 else ("lora_a", "lora_b")
        for name, x in zip(names, (f["a"], f["b"])):
            setattr(lin, name, x if isinstance(x, nn.Parameter) else nn.Parameter(x))
        lin.lora_scale = float(scale)
    return model


@torch.no_grad()
def lora_merge(model: FluxTransformer, lora: Lora, scale: float) -> FluxTransformer:
    """Fold the factors into the base weights: w += scale * A@B on every
    target (grouped factors on the leading M*d output columns), for serving.
    In place, unlike the JAX version (a copy of the 12B DiT would not fit
    beside it); returns `model`."""
    for path, f in lora.items():
        lin = model.get_submodule(path)
        a, b = f["a"].float(), f["b"].float()
        if a.dim() == 3:   # (M, in, r) @ (M, r, d) -> (in, M*d)
            delta = torch.einsum("mir,mrd->imd", a, b).flatten(1) * scale
        else:
            delta = (a @ b) * scale
        # nn.Linear keeps (out, in)
        lin.weight[:delta.shape[1]] += delta.T.to(lin.weight.dtype)
    return model


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[float], float]:
    """optax.linear_schedule: init -> end over `steps`, then held."""
    if steps <= 0:
        return lambda s: init
    return lambda s: (init - end) * (1.0 - min(max(s, 0.0), steps) / steps) + end


def _cosine(init: float, decay_steps: int) -> Callable[[float], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")
    return lambda s: init * 0.5 * (1.0 + math.cos(math.pi * min(s, decay_steps) / decay_steps))


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[float], float]:
    """optax.join_schedules over one boundary."""
    return lambda s: first(s) if s < boundary else second(s - boundary)


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the optimizer step (0 for the
    first update): constant / cosine / cosine_with_restarts / linear /
    polynomial with optional warmup, the JAX package's (and optax's)
    formulas."""
    lr0, warm = tc.learning_rate, tc.lr_warmup_steps
    if tc.lr_scheduler in ("cosine_with_restarts", "polynomial"):
        total = max(tc.max_train_steps, 1)
        cycles, power, lr_end = tc.lr_num_cycles, tc.lr_power, 1e-7
        restarts = tc.lr_scheduler == "cosine_with_restarts"

        def sched(step):
            s = float(step)
            prog = min(max((s - warm) / max(total - warm, 1), 0.0), 1.0)
            if restarts:
                main = 0.0 if prog >= 1.0 else lr0 * 0.5 * (
                    1.0 + math.cos(math.pi * ((cycles * prog) % 1.0)))
            else:
                main = (lr0 - lr_end) * (1.0 - prog) ** power + lr_end
            return lr0 * s / max(warm, 1) if s < warm else main

        return sched
    if tc.lr_scheduler == "cosine":
        if warm:
            return _join(_linear(0.0, lr0, warm), _cosine(lr0, tc.max_train_steps - warm), warm)
        return _cosine(lr0, tc.max_train_steps)
    if tc.lr_scheduler == "linear":
        decay = _linear(lr0, 0.0, max(tc.max_train_steps - warm, 1))
        return _join(_linear(0.0, lr0, warm), decay, warm) if warm else decay
    if warm:
        return _linear(0.0, lr0, warm)
    return lambda s: lr0


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _local_mask(m: Optional[torch.Tensor], p: torch.Tensor,
                spec: Optional[PT.ShardSpec]) -> Optional[torch.Tensor]:
    """A parameter's mask for its local slice: sliced along the sharded dim
    where it is not broadcast there (a (rows, 1) mask on a weight split
    along dim 1 stays as it is)."""
    if m is None or spec is None:
        return m
    dim = spec.dim - (p.dim() - m.dim())
    if dim < 0 or m.shape[dim] == 1:
        return m
    return m.narrow(dim, spec.start, spec.stop - spec.start)


class ClippedOptimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), <update>(schedule))
    over parameters by name (names ``jax_leaf`` places in the JAX trees)
    whose gradients are in ``.grad``; subclasses give the update
    (``_update(lr)``) and its state.

    `masks` (by name, None for a tensor that trains whole) are applied as
    the JAX full-parameter step applies its mask tree: to the gradients
    before the global norm and the clip, and to the updates after, so a
    masked element stays bitwise as it was (weight decay included).
    A parameter without a gradient gets a zero one, as in JAX.

    The clip is optax's: gradients are scaled by max/||g|| only when
    ||g|| > max (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).
    The learning rate is the schedule's at the update count.

    A parameter sharded by ``shard_for_training`` is updated through its
    local slice (``params[i]``, a leaf sharing its storage; ``sources[i]``
    is the parameter, whose ``.grad`` FSDP fills): the norm's squares are
    summed over the fsdp ranks, and ``state_dict`` / ``load_state_dict``
    speak of the whole tensors."""

    def __init__(self, params: Mapping[str, torch.Tensor], tc: TrainConfig,
                 masks: Optional[Masks] = None):
        self.names = list(params)
        self.sources = list(params.values())
        self.specs = [PT.shard_spec(p) for p in self.sources]
        self.params = [p if s is None else nn.Parameter(PT.local(p.detach()), requires_grad=False)
                       for p, s in zip(self.sources, self.specs)]
        self.masks = [None if masks is None else _local_mask(masks[name], p, s)
                      for name, p, s in zip(self.names, self.sources, self.specs)]
        # the fsdp ranks the sums run over (shard_for_training shards every
        # parameter of a model over one mesh)
        self.group = next((s.group for s in self.specs if s is not None), None)
        self.schedule = make_lr_schedule(tc)
        self.max_grad_norm = tc.max_grad_norm
        self.weight_decay = tc.weight_decay
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.sources + self.params:
            p.grad = None

    def _total(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of per-parameter partial sums (0-d) over the whole
        tensors: the sharded parameters' parts summed over the fsdp ranks
        (data replicas hold the same slices, so they count once)."""
        if self.group is None:
            return torch.stack(list(parts)).sum()
        sharded = [x for x, s in zip(parts, self.specs) if s is not None]
        total = torch.stack(sharded).sum()
        dist.all_reduce(total, group=self.group)
        whole = [x for x, s in zip(parts, self.specs) if s is None]
        return total + torch.stack(whole).sum() if whole else total

    def _full(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """A tensor shaped like parameter i's local slice, made whole (on
        the host) over the fsdp ranks."""
        spec = self.specs[i]
        return t if spec is None else spec.full(t).cpu()

    def _cut(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter i's slice of a tensor shaped like the whole parameter."""
        spec = self.specs[i]
        return t if spec is None else spec.cut(t)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Mask, clip, update, advance the schedule. Returns the global norm
        of the masked gradients before clipping (a 0-d tensor, no host
        sync)."""
        for src, p in zip(self.sources, self.params):
            if p is not src:
                p.grad = None if src.grad is None else PT.local(src.grad)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        apply_mask(grads, self.masks)
        if self.group is None:
            norm = global_norm(grads)
        else:
            norms = torch._foreach_norm([g.float() for g in grads])
            norm = torch.sqrt(self._total(torch._foreach_mul(norms, norms)))
        factor = torch.where(norm > self.max_grad_norm, self.max_grad_norm / norm,
                             torch.ones_like(norm))
        torch._foreach_mul_(grads, factor)
        self._update(self.schedule(self.count))
        self.count += 1
        return norm

    def _update(self, lr: float) -> None:
        raise NotImplementedError

    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, state: Mapping) -> None:
        raise NotImplementedError


class ClippedAdamW(ClippedOptimizer):
    """Clipped AdamW: ``torch.optim.AdamW``'s decoupled decay, p <- p -
    lr*wd*p, and its bias corrections equal optax's adamw. The masked
    tensors sit in a group without torch's decay and take it here, on
    their trainable elements only; their masked elements have zero moments,
    so Adam's step leaves them as they are."""

    MOMENTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, tc: TrainConfig, masks=None):
        super().__init__(params, tc, masks)
        whole = [p for p, m in zip(self.params, self.masks) if m is None]
        masked = [p for p, m in zip(self.params, self.masks) if m is not None]
        groups = [{"params": ps, "weight_decay": wd}
                  for ps, wd in ((whole, tc.weight_decay), (masked, 0.0)) if ps]
        self.opt = torch.optim.AdamW(groups, lr=self.schedule(0),
                                     betas=(tc.adam_b1, tc.adam_b2), eps=tc.adam_eps,
                                     weight_decay=tc.weight_decay)
        # torch's state index -> the parameter's index here
        index = {id(p): i for i, p in enumerate(self.params)}
        self._order = [index[id(p)] for g in self.opt.param_groups for p in g["params"]]

    def _update(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr
        for p, m in zip(self.params, self.masks):
            if m is not None:
                p.mul_(1 - lr * self.weight_decay * m)
        self.opt.step()

    def _moments(self, state: Mapping, fn) -> dict:
        return {k: {key: fn(self._order[k], v) if key in self.MOMENTS else v
                    for key, v in s.items()} for k, s in state.items()}

    def state_dict(self) -> dict:
        sd = self.opt.state_dict()
        if self.group is not None:
            sd = dict(sd, state=self._moments(sd["state"], self._full))
        return {"count": self.count, "adamw": sd}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        sd = state["adamw"]
        if self.group is not None:
            sd = dict(sd, state=self._moments(sd["state"], self._cut))
        self.opt.load_state_dict(sd)


class ClippedAdamW8bit(ClippedOptimizer):
    """Clipped 8-bit AdamW: the JAX package's ``optim8bit.adamw8bit`` (Adam
    with both moments stored as blockwise log-domain int8, blocks of
    ``optim8bit.BLOCK``; optax's decoupled decay p <- p - lr*(u + wd*p)).
    Each step dequantises the moments to float32 (the second with its
    floor), updates them, computes the step from those fresh float32
    values and requantises them after.

    The blocks hold the elements the JAX optimizer's hold: it quantises each
    leaf of its tree, flattened in the JAX layout (stacked over layers,
    linears stored (in, out)). The moments are kept per JAX leaf
    (``jax_leaf`` of each parameter's name), each parameter's elements in
    that order (transposed where the port stores (out, in)); a leaf whose
    per-layer slices are whole blocks is updated layer by layer, any other
    is stacked for its update (no stacked copy of a large leaf is made: at
    FLUX width every matrix and bias is whole blocks, only the 128-wide
    q/k scales stack).

    Sharded (``shard_for_training``): a rank's slice of a layer is one
    contiguous run of the leaf's elements (``ShardSpec.run``). Where every
    rank's run is whole blocks, the rank keeps and updates only its blocks,
    which then equal the JAX leaf's same blocks; any other leaf's gradients
    are gathered whole, every rank updates the whole leaf as above (its
    moments whole on each) and keeps its slice of the update. Either way
    ``state_dict`` gives each leaf's whole (n_blocks, 256) codes."""

    def __init__(self, params, tc: TrainConfig, masks=None):
        super().__init__(params, tc, masks)
        self.betas = (tc.adam_b1, tc.adam_b2)
        self.eps = tc.adam_eps
        leaves: Dict[str, list] = {}
        for i, p in enumerate(self.sources):
            key, layer, transpose = jax_leaf(self.names[i])
            leaves.setdefault(key, []).append((layer or 0, i, transpose and p.dim() == 2))
        # (parameter indices in layer order, transposed, updated layer by
        # layer), and whether only the local blocks are kept
        self.leaves, self.local = [], []
        for members in leaves.values():
            idx = [i for _, i, _ in sorted(members)]
            transpose = members[0][2]
            local = all(self._whole_block_runs(i, transpose) for i in idx)
            per_layer = local or all(self.sources[i].numel() % optim8bit.BLOCK == 0 for i in idx)
            self.leaves.append((idx, transpose, per_layer))
            self.local.append(local)
        self.state = {k: [] for k in ("mu_q", "mu_scale", "nu_q", "nu_scale")}
        for (idx, _, _), local in zip(self.leaves, self.local):
            size = (self.params if local else self.sources)
            nb = optim8bit.n_blocks(sum(size[i].numel() for i in idx))
            dev = self.params[idx[0]].device
            for m in ("mu", "nu"):
                self.state[f"{m}_q"].append(torch.zeros((nb, optim8bit.BLOCK), dtype=torch.int8,
                                                        device=dev))
                self.state[f"{m}_scale"].append(torch.zeros(nb, dtype=torch.float32,
                                                            device=dev))

    def _runs(self, i: int, transpose: bool) -> List[Tuple[int, int]]:
        """Every fsdp rank's run of parameter i's elements in the JAX order."""
        spec = self.specs[i]
        return [dataclasses.replace(spec, start=a, stop=b).run(transpose) for a, b in
                PT.chunk_bounds(spec.shape[spec.dim], dist.get_world_size(spec.group))]

    def _whole_block_runs(self, i: int, transpose: bool) -> bool:
        return self.specs[i] is not None and all(
            a % optim8bit.BLOCK == 0 and b % optim8bit.BLOCK == 0
            for a, b in self._runs(i, transpose))

    @staticmethod
    def _flat(tensors: Sequence[torch.Tensor], transpose: bool) -> torch.Tensor:
        """The tensors' elements in the JAX leaf's order, float32."""
        parts = [(t.T if transpose else t).reshape(-1).float() for t in tensors]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _update(self, lr: float) -> None:
        st = self.state
        b1, b2 = self.betas
        # the bias corrections in float32, as the JAX step computes them
        k = torch.tensor(float(self.count + 1), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** k)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** k)
        for j, ((idx, transpose, per_layer), local) in enumerate(zip(self.leaves, self.local)):
            # the elements updated here: the local slices, or the whole
            # parameters (gathered where sharded)
            grad = ((lambda i: self.params[i].grad) if local else
                    (lambda i: self._whole_grad(i)))
            shape = ((lambda i: self.params[i].shape) if local else
                     (lambda i: self.sources[i].shape))
            start = 0
            for chunk in ([[i] for i in idx] if per_layer else [idx]):
                g = self._flat([grad(i) for i in chunk], transpose)
                blocks = slice(start, start + optim8bit.n_blocks(g.numel()))
                start = blocks.stop
                mu = optim8bit.dequantize_dynamic((st["mu_q"][j][blocks],
                                                   st["mu_scale"][j][blocks]), g.shape)
                nu = optim8bit.dequantize_dynamic((st["nu_q"][j][blocks],
                                                   st["nu_scale"][j][blocks]), g.shape,
                                                  floor=True)
                mu = b1 * mu + (1.0 - b1) * g
                nu = b2 * nu + (1.0 - b2) * torch.square(g)
                upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
                for m, x in (("mu", mu), ("nu", nu)):
                    q, scale = optim8bit.quantize_dynamic(x)
                    st[f"{m}_q"][j][blocks] = q
                    st[f"{m}_scale"][j][blocks] = scale
                del g, mu, nu
                offset = 0
                for i in chunk:
                    p, n = self.params[i], math.prod(shape(i))
                    u = upd[offset:offset + n]
                    offset += n
                    u = u.view(shape(i)[::-1]).T if transpose else u.view(shape(i))
                    if not local:
                        u = self._cut(i, u)
                    u = u + self.weight_decay * p
                    if self.masks[i] is not None:
                        u = u * self.masks[i]
                    p.add_(u.to(p.dtype), alpha=-lr)

    def _whole_grad(self, i: int) -> torch.Tensor:
        spec = self.specs[i]
        return self.params[i].grad if spec is None else spec.full(self.params[i].grad)

    def _layer_blocks(self, j: int):
        """(parameter index, its local blocks' slice of leaf j's state, the
        fsdp ranks' block runs of it) for each layer of a leaf kept local."""
        idx, transpose, _ = self.leaves[j]
        start, out = 0, []
        for i in idx:
            runs = [(a // optim8bit.BLOCK, b // optim8bit.BLOCK)
                    for a, b in self._runs(i, transpose)]
            n = self.params[i].numel() // optim8bit.BLOCK
            out.append((i, slice(start, start + n), runs))
            start += n
        return out

    def state_dict(self) -> dict:
        if self.group is None:
            return {"count": self.count, "adamw8bit": self.state}
        out = {k: [] for k in self.state}
        for j, local in enumerate(self.local):
            for key, arrays in self.state.items():
                x = arrays[j]
                if local:
                    x = torch.cat([PT.all_gather_parts(x[sl], runs, self.group).cpu()
                                   for _, sl, runs in self._layer_blocks(j)])
                out[key].append(x)
        return {"count": self.count, "adamw8bit": out}

    def _local_state(self, saved: Mapping) -> dict:
        """A whole-layout state cut to this rank's blocks."""
        rank = dist.get_rank(self.group)
        out = {k: list(v) for k, v in saved.items()}
        for j, local in enumerate(self.local):
            if not local:
                continue
            for key in out:
                x, start, parts = saved[key][j], 0, []
                for i, _, runs in self._layer_blocks(j):
                    a, b = runs[rank]
                    parts.append(x[start + a:start + b])
                    start += runs[-1][1]
                if start != x.shape[0]:
                    raise ValueError(f"8-bit AdamW state {key}[{j}] has {x.shape[0]} blocks, "
                                     f"its leaf {start}")
                out[key][j] = torch.cat(parts)
        return out

    def load_state_dict(self, state: Mapping) -> None:
        """Restore a state this layout saved; one blocked otherwise (another
        set of parameters, or moments kept per parameter rather than per
        JAX leaf) raises."""
        saved = state["adamw8bit"]
        if self.group is not None and set(saved) == set(self.state) and all(
                len(saved[k]) == len(self.state[k]) for k in saved):
            saved = self._local_state(saved)
        if set(saved) != set(self.state) or any(
                len(saved[k]) != len(self.state[k])
                or any(x.shape != y.shape for x, y in zip(self.state[k], saved[k]))
                for k in self.state):
            raise ValueError(
                f"the 8-bit AdamW state holds {len(saved.get('mu_q', []))} moment "
                f"arrays, this optimizer {len(self.state['mu_q'])} (one per JAX leaf) of "
                f"other shapes: it was saved over other parameters, or with its moments "
                f"kept per parameter, and cannot be resumed here")
        self.count = int(state["count"])
        with torch.no_grad():
            for key, value in saved.items():
                for x, y in zip(self.state[key], value, strict=True):
                    x.copy_(y)


class ClippedProdigy(ClippedOptimizer):
    """Clipped Prodigy: ``optax.contrib.prodigy``'s update (betas, beta3 =
    sqrt(b2) unless given, eps, estim_lr0 1e-6, estim_lr_coef 1, AdamW-style
    decoupled weight decay, safeguard_warmup, the lr schedule as a
    multiplier of the D estimate), in float32. A masked element's gradient
    is zero, so its moments stay zero and it takes no step; the decay
    skips it.

    The state is the Adam moments of the D-scaled gradients, the weighted
    gradient sum, a copy of the initial parameters (a copy, not an alias of
    them: the JAX wrapper copies for the same reason) and the scalar D
    estimate and weighted numerator, kept on the parameters' device so no
    step waits for the host. Sharded, the two sums over every tensor (the
    numerator's inner product and the denominator's L1 norm) run over the
    whole tensors."""

    estim_lr0 = 1e-6
    estim_lr_coef = 1.0
    PER_PARAMETER = ("exp_avg", "exp_avg_sq", "grad_sum", "params0")

    def __init__(self, params, tc: TrainConfig, masks=None):
        super().__init__(params, tc, masks)
        self.betas = (tc.adam_b1, tc.adam_b2)
        self.beta3 = tc.adam_b2 ** 0.5 if tc.prodigy_beta3 is None else tc.prodigy_beta3
        self.eps = tc.adam_eps
        self.safeguard_warmup = tc.prodigy_safeguard_warmup
        dev = self.params[0].device
        self.state = {
            "exp_avg": [torch.zeros_like(p) for p in self.params],
            "exp_avg_sq": [torch.zeros_like(p) for p in self.params],
            "grad_sum": [torch.zeros_like(p) for p in self.params],
            "params0": [p.detach().clone() for p in self.params],
            "estim_lr": torch.tensor(self.estim_lr0, dtype=torch.float32, device=dev),
            "numerator_weighted": torch.zeros((), dtype=torch.float32, device=dev),
        }

    def _update(self, lr: float) -> None:
        st, params = self.state, self.params
        grads = [p.grad for p in params]
        b1, b2 = self.betas
        b3, d0 = self.beta3, self.estim_lr0
        k = self.count + 1
        bc = math.sqrt(1 - b2 ** k) / (1 - b1 ** k)
        d = st["estim_lr"]
        dlr = d * lr * bc
        # <g, p0 - p> over every tensor (optax.tree.vdot)
        diffs = torch._foreach_sub(st["params0"], params)
        numerator = self._total([torch.vdot(g.reshape(-1), x.reshape(-1))
                                 for g, x in zip(grads, diffs)])
        del diffs
        dg = torch._foreach_mul(grads, d)
        torch._foreach_mul_(st["exp_avg"], b1)
        torch._foreach_add_(st["exp_avg"], dg, alpha=1 - b1)
        torch._foreach_mul_(st["exp_avg_sq"], b2)
        torch._foreach_addcmul_(st["exp_avg_sq"], dg, dg, value=1 - b2)
        torch._foreach_mul_(dg, (d if self.safeguard_warmup else dlr) / d0)
        torch._foreach_mul_(st["grad_sum"], b3)
        torch._foreach_add_(st["grad_sum"], dg)
        del dg
        denominator = self._total(torch._foreach_norm(st["grad_sum"], 1))
        st["numerator_weighted"] = (b3 * st["numerator_weighted"]
                                    + (d / d0) * dlr * numerator)
        d_new = torch.maximum(d, self.estim_lr_coef * st["numerator_weighted"] / denominator)
        st["estim_lr"] = d_new
        # p <- p - wd*dlr*p - dlr*m / (sqrt(v) + d_new*eps), dlr a device
        # scalar folded into the denominator as torch's capturable Adam does
        denom = torch._foreach_sqrt(st["exp_avg_sq"])
        torch._foreach_add_(denom, d_new * self.eps)
        torch._foreach_div_(denom, -dlr)
        whole = [p for p, m in zip(params, self.masks) if m is None]
        if whole:
            torch._foreach_mul_(whole, 1 - self.weight_decay * dlr)
        for p, m in zip(params, self.masks):
            if m is not None:
                p.mul_(1 - self.weight_decay * dlr * m)
        torch._foreach_addcdiv_(params, st["exp_avg"], denom)

    def state_dict(self) -> dict:
        st = self.state
        if self.group is not None:
            st = {k: [self._full(i, x) for i, x in enumerate(v)] if k in self.PER_PARAMETER
                  else v for k, v in st.items()}
        return {"count": self.count, "prodigy": st}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for key, value in state["prodigy"].items():
                if isinstance(value, torch.Tensor):
                    self.state[key].copy_(value)
                else:
                    for i, (x, y) in enumerate(zip(self.state[key], value, strict=True)):
                        x.copy_(self._cut(i, y))


OPTIMIZERS = {"adamw": ClippedAdamW, "adamw8bit": ClippedAdamW8bit, "prodigy": ClippedProdigy}


def make_optimizer(tc: TrainConfig, params: Mapping[str, torch.Tensor],
                   masks: Optional[Masks] = None) -> ClippedOptimizer:
    """AdamW, 8-bit AdamW or Prodigy (the reference's LoRA optimizer) with
    global-norm clipping, as the JAX ``make_optimizer(tc, mask)`` chains
    them, over `params` by name (names ``jax_leaf`` places in the JAX
    trees: 8-bit AdamW blocks its moments as the JAX leaves do). With
    `masks` (``trainable_mask``'s) the optimizer takes the parameters that
    have a mask entry (the JAX optimizer allocates state for the leaves
    with any trainable entry) and applies each mask to its gradient and
    update."""
    if tc.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    if masks is not None:
        params = {name: params[name] for name in masks}
    return OPTIMIZERS[tc.optimizer](params, tc, masks)


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------

NOISE_KEYS = ("vae", "cond_vae", "u", "noise")


def flow_matching_loss(
    model: FluxTransformer,
    vae: FluxVAE,
    tc: TrainConfig,
    batch: Mapping[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Mapping[str, torch.Tensor]] = None,
    batch_rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One microbatch loss (fp32 scalar). batch: pixel_values (B,H,W,3) in
    [-1,1], mask (B,H,W) in {0,1}, txt (B,L,joint), pooled (B,pooled).

    Draws (each a tensor in `noise` when given, else from `generator`):
    "vae" and "cond_vae", the posterior eps of the two VAE encodes (shaped
    like the latents); "u", the raw timestep-density draw (B,); "noise", the
    flow-matching noise (like the latents, fp32). The conditioning dropout
    (cond_dropout_prob > 0) always draws from `generator`.

    `batch_rows` = (first, total): `batch` is rows [first, first + B) of a
    batch of `total` spread over ranks; each draw from `generator` is made
    for the whole batch, in the same order, and this rank keeps its rows,
    so the draws do not depend on how the batch is split (`noise`, when
    given, holds this rank's rows already).

    The VAE encodes and the inputs run without gradient in the compute
    dtype, as the JAX loss casts them; norms and softmax stay fp32 inside
    the model and the loss is fp32."""
    noise = dict(noise or {})
    unknown = set(noise) - set(NOISE_KEYS)
    if unknown:
        raise ValueError(f"unknown noise keys {sorted(unknown)}")
    if generator is None and (set(NOISE_KEYS) - set(noise) or tc.cond_dropout_prob > 0):
        raise ValueError("flow_matching_loss draws what `noise` lacks from a generator; "
                         "pass one")
    if attn_impl == "auto":
        attn_impl = "flash" if batch["pixel_values"].device.type == "cuda" else "plain"
    cdt = getattr(torch, tc.compute_dtype)
    f = vae.cfg.spatial_factor

    def rows(shape, draw=torch.randn):
        """This rank's rows of the whole batch's draw."""
        first, total = batch_rows
        whole = draw((total, *shape[1:]), generator=generator, device=dev, dtype=torch.float32)
        return whole[first:first + shape[0]]

    def given(key, shape, draw=torch.randn):
        x = noise.get(key)
        if x is not None:
            return torch.as_tensor(x, device=dev)
        return None if batch_rows is None else rows(shape, draw)

    with torch.no_grad():
        pixels = batch["pixel_values"].to(cdt)
        dev = pixels.device
        mask = batch["mask"]
        txt = batch["txt"].to(cdt)
        pooled = batch["pooled"].to(cdt)
        b, h, w = pixels.shape[:3]
        latent = (b, h // f, w // f, vae.cfg.latent_channels)
        x = vae_encode(vae, pixels, noise=given("vae", latent), generator=generator).to(cdt)
        masked = pixels * (1.0 - mask[..., None]).to(cdt)
        z_cond = vae_encode(vae, masked, noise=given("cond_vae", latent),
                            generator=generator).to(cdt)
        cond = torch.cat([packing.pack_latents(z_cond),
                          packing.pack_mask(mask.to(z_cond.dtype), f)], dim=-1)
        if tc.cond_dropout_prob > 0:
            drop = (torch.rand(cond.shape, generator=generator, device=dev)
                    if batch_rows is None else rows(cond.shape, torch.rand))
            keep = drop >= tc.cond_dropout_prob
            cond = cond * keep.to(cond.dtype) / (1.0 - tc.cond_dropout_prob)

        raw = torch.randn if tc.weighting_scheme == "logit_normal" else torch.rand
        u = samplers.sample_timestep_density(
            b, tc.weighting_scheme, tc.logit_mean, tc.logit_std, tc.mode_scale,
            generator=generator, u=given("u", (b,), raw))
        sigmas = samplers.train_sigmas(u, shift=tc.schedule_shift)
        eps = given("noise", x.shape)
        if eps is None:
            eps = torch.randn(x.shape, generator=generator, device=dev, dtype=torch.float32)
        eps = eps.to(x.dtype)
        sig = sigmas.to(x.dtype)[:, None, None, None]
        noisy = (1.0 - sig) * x + sig * eps

        # the serving tables (fp64 on the host, rounded to fp32); the JAX
        # trainer computes the same interleaved tables in fp32 inside its step
        ids = np.concatenate([packing.text_ids(txt.shape[1]),
                              packing.latent_image_ids(x.shape[1], x.shape[2])])
        cos, sin = (torch.as_tensor(a, device=dev)
                    for a in rope_tables(ids, model.cfg.axes_dims_rope, model.cfg.rope_theta))
        guidance = (torch.full((b,), tc.guidance_scale, dtype=torch.float32, device=dev)
                    if model.cfg.guidance_embeds else None)
        tokens = torch.cat([packing.pack_latents(noisy), cond], dim=-1)
        target = packing.pack_latents(eps - x)

    pred = flux_apply(model, tokens, txt, pooled, sigmas, guidance, cos, sin,
                      attn_impl=attn_impl, remat=tc.remat)
    w = samplers.loss_weighting(tc.weighting_scheme, sigmas)[:, None, None]
    err = (pred.float() - target.float()) ** 2
    return torch.mean(w * err)


def make_train_step(tc: TrainConfig, *, attn_impl: str = "auto"):
    """The train step (the JAX ``make_train_step``): gradients flow into
    the parameters that require one and `opt` (``make_optimizer`` over
    them) masks, clips and updates them. In the full-parameter modes those
    are ``freeze_to_mask``'s trainable parameters (a frozen weight emits no
    weight-gradient product, the JAX ``trainable_leaves``); in LoRA mode the
    factors that ``lora_insert`` attached (the JAX ``make_lora_train_step``).

    step(model, vae, opt, batch, *, generator=None, noise=None, batch_rows=None)
    -> metrics. ``batch`` leaves carry a leading grad-accum axis (A, B, ...);
    `noise`, when given, is one ``flow_matching_loss`` noise dict per
    microbatch. Each microbatch's loss / A is backpropagated in turn (the
    JAX scan's sum of gradients / A), then `opt` steps. The parameters are
    updated in place; metrics are 0-d device tensors: {"loss": mean
    microbatch loss, "grad_norm": global norm of the masked gradients
    before clipping}. The gradients stay in ``.grad`` until the next step.

    Over the fsdp axis every rank of the default group calls this on its
    rows of each microbatch (`batch_rows`, see ``flow_matching_loss``):
    FSDP averages the gradients of the ranks' mean losses, which over equal
    slices is the whole batch's mean gradient, and the loss reported is the
    mean over the ranks."""

    def step(model, vae, opt: ClippedOptimizer, batch, *, generator=None, noise=None,
             batch_rows=None):
        accum = batch["pixel_values"].shape[0]
        if noise is not None and len(noise) != accum:
            raise ValueError(f"noise has {len(noise)} microbatches, the batch {accum}")
        opt.zero_grad()
        loss_sum = None
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss = flow_matching_loss(model, vae, tc, mb, attn_impl=attn_impl,
                                      generator=generator,
                                      noise=None if noise is None else noise[i],
                                      batch_rows=batch_rows)
            (loss / accum).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grad_norm = opt.step()
        loss = loss_sum / accum
        if batch_rows is not None:
            dist.all_reduce(loss)
            loss /= dist.get_world_size()
        return {"loss": loss, "grad_norm": grad_norm}

    return step


CHECKSUM_MODULES = ("img_in", "double_blocks.0.img_qkv", "single_blocks.0.linear1",
                    "final_proj")


def base_checksum(model: FluxTransformer) -> float:
    """A float64 sum over the weights (or quantised codes and scales) of a
    few base linears, to show a step left them as they were."""
    return sum(t.detach().double().sum().item() for name in CHECKSUM_MODULES
               for key, t in model.get_submodule(name).state_dict().items()
               if not key.startswith("lora_"))
