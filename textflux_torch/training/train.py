"""Flow-matching LoRA training for the fill DiT.

The port of the LoRA path of ``textflux_tpu/training/train.py``: the train
config, the LoRA targets and factors (``lora_init``, ``lora_insert``,
``lora_merge``), the learning-rate schedules, AdamW, 8-bit AdamW
(``training.optim8bit``) and Prodigy (``optax.contrib.prodigy``) behind
optax's global-norm clipping, ``flow_matching_loss`` and
``make_lora_train_step`` with its gradient accumulation written out as a
loop. The full-parameter masked path (``make_train_step``, ``--mode
attn|all``) is not ported yet: ROADMAP Queue 1 item 2.

The factors live beside a frozen base: ``lora_insert`` attaches them to the
target linears (``nn.Linear``, or a weight_only / nf4 ``io.quantize.
QuantLinear``: QLoRA) as fp32 parameters, and ``models.layers.dense`` adds
the parallel branch y += (x @ A*s) @ B. Randomness comes from a
``torch.Generator`` or is handed in (``flow_matching_loss(noise=...)``), so
a test can give the port the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from textflux_torch.io.quantize import QuantLinear
from textflux_torch.models.transformer import FluxTransformer, flux_apply
from textflux_torch.models.vae import FluxVAE, vae_encode
from textflux_torch.ops import packing, samplers
from textflux_torch.ops.rope import rope_tables
from textflux_torch.training import optim8bit


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's TrainConfig that the LoRA step and the
    training CLI read, with its defaults (scripts/train.sh + parser_helper.py
    of the reference). The step takes the gradient accumulation count from
    the batch's leading axis, as the JAX step does, and trains LoRA factors
    only, so the JAX fields ``grad_accum`` and ``mode`` have no place here."""

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
              generator: Optional[torch.Generator] = None) -> Lora:
    """Per-target fp32 factors: A ~ N(0, 1/r^2) (the JAX package's
    normal / rank), B = 0. Grouped targets (LORA_GROUPED) get M independent
    per-module factors. Returns {path: {"a": Parameter, "b": Parameter}}."""
    d = model.cfg.hidden_dim
    lora = {}
    for path, lin in lora_targets(model).items():
        d_in, d_out = lora_target_dims(lin)
        dev = next(itertools.chain(lin.parameters(), lin.buffers())).device
        m = LORA_GROUPED.get(path.split(".", 2)[2])   # "double_blocks.3.img_qkv" -> "img_qkv"
        a_shape, b_shape = ((m, d_in, rank), (m, rank, d)) if m else ((d_in, rank), (rank, d_out))
        a = torch.randn(a_shape, generator=generator, device=dev, dtype=torch.float32) / rank
        lora[path] = {"a": nn.Parameter(a),
                      "b": nn.Parameter(torch.zeros(b_shape, device=dev, dtype=torch.float32))}
    return lora


def lora_parameters(lora: Lora) -> List[torch.Tensor]:
    return [f[k] for f in lora.values() for k in ("a", "b")]


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


class ClippedOptimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), <update>(schedule))
    over parameters whose gradients are in ``.grad``; subclasses give the
    update (``_update(lr)``) and its state.

    The clip is optax's: gradients are scaled by max/||g|| only when
    ||g|| > max (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).
    The learning rate is the schedule's at the update count."""

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        self.params = list(params)
        self.schedule = make_lr_schedule(tc)
        self.max_grad_norm = tc.max_grad_norm
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, advance the schedule. Returns the global norm of the
        gradients before clipping (a 0-d tensor, no host sync)."""
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
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
    lr*wd*p, and its bias corrections equal optax's adamw."""

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        super().__init__(params, tc)
        self.opt = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                     betas=(tc.adam_b1, tc.adam_b2), eps=tc.adam_eps,
                                     weight_decay=tc.weight_decay)

    def _update(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["adamw"])


class ClippedAdamW8bit(ClippedOptimizer):
    """Clipped 8-bit AdamW: the JAX package's ``optim8bit.adamw8bit`` (Adam
    with both moments stored as blockwise log-domain int8, blocks of
    ``optim8bit.BLOCK``; optax's decoupled decay p <- p - lr*(u + wd*p)).
    Each step dequantises the moments to float32 (the second with its
    floor), updates them, computes the step from those fresh float32
    values and requantises them after."""

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        super().__init__(params, tc)
        self.betas = (tc.adam_b1, tc.adam_b2)
        self.eps = tc.adam_eps
        self.weight_decay = tc.weight_decay
        self.state = {k: [] for k in ("mu_q", "mu_scale", "nu_q", "nu_scale")}
        for p in self.params:
            nb = optim8bit.n_blocks(p.numel())
            for m in ("mu", "nu"):
                self.state[f"{m}_q"].append(torch.zeros((nb, optim8bit.BLOCK), dtype=torch.int8,
                                                        device=p.device))
                self.state[f"{m}_scale"].append(torch.zeros(nb, dtype=torch.float32,
                                                            device=p.device))

    def _update(self, lr: float) -> None:
        st = self.state
        b1, b2 = self.betas
        # the bias corrections in float32, as the JAX step computes them
        k = torch.tensor(float(self.count + 1), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** k)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** k)
        for i, p in enumerate(self.params):
            g = p.grad.float()
            mu = optim8bit.dequantize_dynamic((st["mu_q"][i], st["mu_scale"][i]), p.shape)
            nu = optim8bit.dequantize_dynamic((st["nu_q"][i], st["nu_scale"][i]), p.shape,
                                              floor=True)
            mu = b1 * mu + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * torch.square(g)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            st["mu_q"][i], st["mu_scale"][i] = optim8bit.quantize_dynamic(mu)
            st["nu_q"][i], st["nu_scale"][i] = optim8bit.quantize_dynamic(nu)
            p.add_((upd + self.weight_decay * p).to(p.dtype), alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw8bit": self.state}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for key, value in state["adamw8bit"].items():
                for x, y in zip(self.state[key], value, strict=True):
                    x.copy_(y)


class ClippedProdigy(ClippedOptimizer):
    """Clipped Prodigy: ``optax.contrib.prodigy``'s update (betas, beta3 =
    sqrt(b2) unless given, eps, estim_lr0 1e-6, estim_lr_coef 1, AdamW-style
    decoupled weight decay, safeguard_warmup, the lr schedule as a
    multiplier of the D estimate), in float32.

    The state is the Adam moments of the D-scaled gradients, the weighted
    gradient sum, a copy of the initial parameters (a copy, not an alias of
    them: the JAX wrapper copies for the same reason) and the scalar D
    estimate and weighted numerator, kept on the parameters' device so no
    step waits for the host."""

    estim_lr0 = 1e-6
    estim_lr_coef = 1.0

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        super().__init__(params, tc)
        self.betas = (tc.adam_b1, tc.adam_b2)
        self.beta3 = tc.adam_b2 ** 0.5 if tc.prodigy_beta3 is None else tc.prodigy_beta3
        self.eps = tc.adam_eps
        self.weight_decay = tc.weight_decay
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
        numerator = torch.stack([torch.vdot(g.reshape(-1), x.reshape(-1))
                                 for g, x in zip(grads, diffs)]).sum()
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
        denominator = torch.stack(torch._foreach_norm(st["grad_sum"], 1)).sum()
        st["numerator_weighted"] = (b3 * st["numerator_weighted"]
                                    + (d / d0) * dlr * numerator)
        d_new = torch.maximum(d, self.estim_lr_coef * st["numerator_weighted"] / denominator)
        st["estim_lr"] = d_new
        # p <- p - wd*dlr*p - dlr*m / (sqrt(v) + d_new*eps), dlr a device
        # scalar folded into the denominator as torch's capturable Adam does
        denom = torch._foreach_sqrt(st["exp_avg_sq"])
        torch._foreach_add_(denom, d_new * self.eps)
        torch._foreach_div_(denom, -dlr)
        torch._foreach_mul_(params, 1 - self.weight_decay * dlr)
        torch._foreach_addcdiv_(params, st["exp_avg"], denom)

    def state_dict(self) -> dict:
        return {"count": self.count, "prodigy": self.state}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for key, value in state["prodigy"].items():
                if isinstance(value, torch.Tensor):
                    self.state[key].copy_(value)
                else:
                    for x, y in zip(self.state[key], value, strict=True):
                        x.copy_(y)


def make_optimizer(tc: TrainConfig, params: Sequence[torch.Tensor]) -> ClippedOptimizer:
    """AdamW, 8-bit AdamW or Prodigy (the reference's LoRA optimizer) with
    global-norm clipping over `params`, as the JAX ``make_optimizer``
    chains them."""
    if tc.optimizer == "prodigy":
        return ClippedProdigy(params, tc)
    if tc.optimizer == "adamw8bit":
        return ClippedAdamW8bit(params, tc)
    if tc.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    return ClippedAdamW(params, tc)


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
) -> torch.Tensor:
    """One microbatch loss (fp32 scalar). batch: pixel_values (B,H,W,3) in
    [-1,1], mask (B,H,W) in {0,1}, txt (B,L,joint), pooled (B,pooled).

    Draws (each a tensor in `noise` when given, else from `generator`):
    "vae" and "cond_vae", the posterior eps of the two VAE encodes (shaped
    like the latents); "u", the raw timestep-density draw (B,); "noise", the
    flow-matching noise (like the latents, fp32). The conditioning dropout
    (cond_dropout_prob > 0) always draws from `generator`.

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

    def given(key):
        x = noise.get(key)
        return None if x is None else torch.as_tensor(x, device=dev)

    with torch.no_grad():
        pixels = batch["pixel_values"].to(cdt)
        dev = pixels.device
        mask = batch["mask"]
        txt = batch["txt"].to(cdt)
        pooled = batch["pooled"].to(cdt)
        b = pixels.shape[0]
        x = vae_encode(vae, pixels, noise=given("vae"), generator=generator).to(cdt)
        masked = pixels * (1.0 - mask[..., None]).to(cdt)
        z_cond = vae_encode(vae, masked, noise=given("cond_vae"), generator=generator).to(cdt)
        cond = torch.cat([packing.pack_latents(z_cond),
                          packing.pack_mask(mask.to(z_cond.dtype), f)], dim=-1)
        if tc.cond_dropout_prob > 0:
            keep = torch.rand(cond.shape, generator=generator, device=dev) >= tc.cond_dropout_prob
            cond = cond * keep.to(cond.dtype) / (1.0 - tc.cond_dropout_prob)

        u = samplers.sample_timestep_density(
            b, tc.weighting_scheme, tc.logit_mean, tc.logit_std, tc.mode_scale,
            generator=generator, u=given("u"))
        sigmas = samplers.train_sigmas(u, shift=tc.schedule_shift)
        eps = given("noise")
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


def make_lora_train_step(tc: TrainConfig, *, attn_impl: str = "auto"):
    """The LoRA train step: gradients flow only into the factors that
    ``lora_insert`` attached to `model`.

    step(model, vae, opt, batch, *, generator=None, noise=None) -> metrics.
    ``batch`` leaves carry a leading grad-accum axis (A, B, ...); `noise`,
    when given, is one ``flow_matching_loss`` noise dict per microbatch.
    Each microbatch's loss / A is backpropagated in turn (the JAX scan's
    sum of gradients / A), then `opt` (``make_optimizer``) clips and steps.
    The factors are updated in place; metrics are 0-d device tensors:
    {"loss": mean microbatch loss, "grad_norm": global norm before clipping}.
    The gradients stay in ``.grad`` until the next step."""

    def step(model, vae, opt: ClippedOptimizer, batch, *, generator=None, noise=None):
        accum = batch["pixel_values"].shape[0]
        if noise is not None and len(noise) != accum:
            raise ValueError(f"noise has {len(noise)} microbatches, the batch {accum}")
        for p in opt.params:
            p.grad = None
        loss_sum = None
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss = flow_matching_loss(model, vae, tc, mb, attn_impl=attn_impl,
                                      generator=generator,
                                      noise=None if noise is None else noise[i])
            (loss / accum).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grad_norm = opt.step()
        return {"loss": loss_sum / accum, "grad_norm": grad_norm}

    return step


CHECKSUM_MODULES = ("img_in", "double_blocks.0.img_qkv", "single_blocks.0.linear1",
                    "final_proj")


def base_checksum(model: FluxTransformer) -> float:
    """A float64 sum over the weights (or quantised codes and scales) of a
    few base linears, to show a step left them as they were."""
    return sum(t.detach().double().sum().item() for name in CHECKSUM_MODULES
               for key, t in model.get_submodule(name).state_dict().items()
               if not key.startswith("lora_"))
