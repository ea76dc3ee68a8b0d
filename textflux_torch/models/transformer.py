"""FLUX-style MM-DiT: 19 double-stream + 38 single-stream blocks.

The port of ``textflux_tpu/models/transformer.py``. Parameters live in
``FluxTransformer``, an ``nn.Module`` with one submodule per block (any
linear of which may be an ``io.quantize.QuantLinear``); the forward pass is
the plain functions below, mirroring the JAX package's: fused q|k|v
projections per stream, a fused qkv+mlp-in projection (``linear1``) and
attn-out+mlp-out projection (``linear2``) in the single blocks,
norms/AdaLN/softmax in float32, matmuls in the activation dtype.

Tensor parallelism (``mesh`` with a tensor axis tp > 1, serving and
training): the module holds one rank's shard (``parallel.partitioning.shard_module``, or
the sharded checkpoint load) of weights permuted device-major
(``tp_permute_flux_params``): the fused projections' local output is the
rank's [q_r | k_r | v_r (| mlp_r)], which splits without communication;
attention runs on the rank's H / tp heads; the single block's local
[attn_r | gelu(mlp_r)] meets the rank's rows of linear2. The collectives are
the Megatron schedule's: an all-reduce after each row-parallel projection
(img_proj, txt_proj, the fc2s, linear2: 4 per double block and 1 per single
block, 114 a step at full depth), and an all-gather of each column-parallel
output that must be whole (the modulation vectors, once per image with
``flux_mods``, and the input embedders' outputs, twice a step). Where
gradients flow they are autograd functions (``parallel.partitioning``'s
``reduce_from_tensor`` and ``gather_from_tensor``), and each column-parallel
product's input passes ``copy_to_tensor``, whose backward all-reduces its
gradient; ``remat``'s recompute replays the forward's collectives in the
backward, in the same order on every rank. A module storage-sharded over
fsdp (``parallel.partitioning.shard_storage``) gathers each block as it is
called.

Attention paths (``attn_impl``):
  "plain": interleaved RoPE and ``ops.attention.plain_attention`` on the
           checkpoint's q/k feature order (the JAX package's "xla");
  "flash": the same RMSNorm and interleaved RoPE, then
           ``ops.attention.dot_product_attention(impl="flash")``: the Hopper
           flash kernels with their hand-written backward (the JAX
           package's "pallas"; the training path);
  "fused": q/k weights half-permuted once at load
           (``half_permute_flux_params``), rotate-half tables, and
           ``flash_attention_qk_norm_rope`` (the Hopper kernel on CUDA; the
           serving path, which has no backward).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from textflux_torch.config import FluxConfig
from textflux_torch.device import resolve_device
from textflux_torch.io.quantize import OUT_AXIS_KEYS, QuantLinear
from textflux_torch.models.graphs import ForwardGraphs, key_of
from textflux_torch.models.layers import (
    MLP,
    dense,
    gelu_tanh,
    make_linear,
    ones_param,
    rms_norm,
    silu,
    timestep_embedding,
)
from textflux_torch.ops.adaln import adaln_modulate, adaln_modulate_reference
from textflux_torch.ops.attention import dot_product_attention
from textflux_torch.ops.flash_attention import (SUPPORTED_HEAD_DIMS, attn_cross, attn_self,
                                                flash_attention_qk_norm_rope)
from textflux_torch.ops.rope import apply_rope_bshd, half_permutation, rope_tables, rope_tables_half
from textflux_torch.parallel import partitioning as PT
from textflux_torch.parallel.partitioning import LORA_KEYS
from textflux_torch.utils.tracking import span

ATTN_IMPLS = ("plain", "flash", "fused")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class DoubleBlock(nn.Module):
    """One double-stream block's parameters; calling it runs the block
    (``double_block``) with its own modulation linears, so a wrapper that
    hooks the module's call (FSDP's gather of the block's weights) sees
    every use of them."""

    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        self.cfg = cfg
        d, m, hd = cfg.hidden_dim, cfg.mlp_dim, cfg.head_dim
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.img_mod = make_linear(d, 6 * d, **kw)
        self.txt_mod = make_linear(d, 6 * d, **kw)
        self.img_qkv = make_linear(d, 3 * d, **kw)
        self.txt_qkv = make_linear(d, 3 * d, **kw)
        self.img_q_scale = ones_param(hd, **pkw)
        self.img_k_scale = ones_param(hd, **pkw)
        self.txt_q_scale = ones_param(hd, **pkw)
        self.txt_k_scale = ones_param(hd, **pkw)
        self.img_proj = make_linear(d, d, **kw)
        self.txt_proj = make_linear(d, d, **kw)
        self.img_mlp = MLP(d, m, d, **kw)
        self.txt_mlp = MLP(d, m, d, **kw)

    def forward(self, txt, img, sv, mods, rope_cos, rope_sin, attn_impl: str,
                kv_len: Optional[int] = None, mesh=None, img_first: bool = False):
        """(txt, img) after the block. `mods` is the block's (img, txt)
        modulation vectors, or None to compute them here from `sv` =
        silu(vec)."""
        with span("flux.double_block"):
            if mods is None:
                mods = (_whole(self.img_mod, sv, mesh), _whole(self.txt_mod, sv, mesh))
            return double_block(self, self.cfg, txt, img, mods, rope_cos, rope_sin, attn_impl,
                                kv_len, mesh, img_first=img_first)


class SingleBlock(nn.Module):
    """One single-stream block's parameters; calling it runs the block
    (``single_block``) with its own modulation linear (see DoubleBlock)."""

    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        self.cfg = cfg
        d, m, hd = cfg.hidden_dim, cfg.mlp_dim, cfg.head_dim
        pkw = {k: kw[k] for k in ("device", "dtype")}
        self.mod = make_linear(d, 3 * d, **kw)
        self.linear1 = make_linear(d, 3 * d + m, **kw)
        self.q_scale = ones_param(hd, **pkw)
        self.k_scale = ones_param(hd, **pkw)
        self.linear2 = make_linear(d + m, d, **kw)

    def forward(self, x, sv, mod, rope_cos, rope_sin, attn_impl: str,
                kv_len: Optional[int] = None, mesh=None):
        """x after the block; `mod` is its modulation vector, or None to
        compute it here from `sv` = silu(vec)."""
        with span("flux.single_block"):
            if mod is None:
                mod = _whole(self.mod, sv, mesh)
            return single_block(self, self.cfg, x, mod, rope_cos, rope_sin, attn_impl, kv_len,
                                mesh)


class FluxTransformer(nn.Module):
    """MM-DiT parameters, initialised with the JAX package's distributions
    (``init_flux_params``) from `generator` (default: seed 0 on `device`).

    ``rope_layout`` records the q/k feature order: "interleaved" as built or
    loaded, "half" after ``half_permute_flux_params``; ``fused_layout`` is
    the order the fused attention reads, "half". ``tp_layout`` is the
    tensor-parallel degree the fused projections are permuted for (1: not
    permuted, ``tp_permute_flux_params``); ``tp_rank`` the rank whose shard
    the module holds (None: it is whole)."""

    def __init__(self, cfg: FluxConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dit_init(self, cfg, device, dtype, generator)
        d = cfg.hidden_dim
        self.img_in = make_linear(cfg.in_channels, d, **kw)
        self.txt_in = make_linear(cfg.joint_dim, d, **kw)
        self.time_in = MLP(cfg.time_embed_channels, d, d, **kw)
        self.vector_in = MLP(cfg.pooled_dim, d, d, **kw)
        self.guidance_in = (MLP(cfg.time_embed_channels, d, d, **kw)
                            if cfg.guidance_embeds else None)
        self.final_mod = make_linear(d, 2 * d, **kw)
        self.final_proj = make_linear(d, cfg.out_channels, **kw)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(cfg, **kw) for _ in range(cfg.num_double_layers))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, **kw) for _ in range(cfg.num_single_layers))

    def forward(self, img_tokens, txt_tokens, pooled, timestep, guidance, rope_cos, rope_sin,
                *, attn_impl: str, remat: bool = False, kv_len: Optional[int] = None,
                mods=None, mesh=None) -> torch.Tensor:
        """The velocity (see ``flux_apply``, which checks the arguments and
        calls this): the embedders and the output head run here, each block
        through its own module call, so a wrapper hooking the calls (FSDP's
        gathers) sees every use of every weight. With `remat`, each block
        call is checkpointed (non-reentrant): its recompute in the backward
        calls the block again.

        A serving call (CUDA tensors, gradients off, `mods` given, no mesh,
        no `remat`) runs from a CUDA graph of this module's (``self.graphs``,
        ``models.graphs.ForwardGraphs``), one per input shape; every other
        call runs eagerly."""
        args = dict(img_tokens=img_tokens, txt_tokens=txt_tokens, rope_cos=rope_cos,
                    rope_sin=rope_sin, attn_impl=attn_impl, remat=remat, kv_len=kv_len, mesh=mesh)
        if _graphed(img_tokens, remat=remat, mods=mods, mesh=mesh):
            # the modulation vectors given, the graph takes no conditioning
            return graph_call(self, mods, pooled=None, timestep=None, guidance=None, **args)
        return self._forward(pooled=pooled, timestep=timestep, guidance=guidance, **args,
                             mods=mods)

    def _forward(self, img_tokens, txt_tokens, pooled, timestep, guidance, rope_cos, rope_sin,
                 *, attn_impl: str, remat: bool, kv_len: Optional[int], mods, mesh):
        cfg = self.cfg
        n_txt = txt_tokens.shape[1]
        dtype = img_tokens.dtype
        if mods is None:
            # each block computes its modulation from sv as it runs
            sv = silu(flux_vec(self, timestep, guidance, pooled, dtype))
            double_mods = [None] * len(self.double_blocks)
            single_mods = [None] * len(self.single_blocks)
            final = dense(self.final_mod, sv)
        else:
            sv = None
            double_mods, single_mods, final = mods["double"], mods["single"], mods["final"]

        img = _whole(self.img_in, img_tokens, mesh)
        txt = _whole(self.txt_in, txt_tokens.to(dtype), mesh)
        rope_cos, rope_sin = rope_cos.float(), rope_sin.float()

        def call(blk, *args):
            if remat:
                return checkpoint(blk, *args, use_reentrant=False)
            return blk(*args)

        for blk, m in zip(self.double_blocks, double_mods):
            txt, img = call(blk, txt, img, sv, m, rope_cos, rope_sin, attn_impl, kv_len, mesh)
        x = torch.cat([txt, img], dim=1)
        for blk, m in zip(self.single_blocks, single_mods):
            x = call(blk, x, sv, m, rope_cos, rope_sin, attn_impl, kv_len, mesh)
        return output_head(self, x[:, n_txt:], final)


def dit_init(model: nn.Module, cfg, device, dtype, generator, *,
             fused_layout: str = "half") -> dict:
    """Set what serving reads of a DiT as built (its config, the q/k layout
    "interleaved", the layout its "fused" attention reads, whole: tp_layout
    1, tp_rank None; its forward's CUDA graphs) and return its parameters'
    factory arguments (`generator` default: seed 0 on `device`)."""
    device = resolve_device(device, allow_meta=True)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    model.cfg, model.rope_layout, model.tp_layout, model.tp_rank = cfg, "interleaved", 1, None
    model.fused_layout = fused_layout
    model.graphs = ForwardGraphs()
    return dict(device=device, dtype=dtype, generator=generator)


def _graphed(x: torch.Tensor, *, remat: bool, mods, mesh) -> bool:
    """Whether a forward on image tokens `x` may run from a CUDA graph: a
    serving call (CUDA, gradients off, per-step modulation vectors given)
    that runs no collective or storage gather (no mesh) and no checkpoint."""
    return (mods is not None and mesh is None and not remat and not torch.is_grad_enabled()
            and x.is_cuda)


def graph_call(model: nn.Module, mods, **args):
    """``model._forward(**args, mods=mods)`` run from ``model.graphs``: the
    tensors of `args` and ``flux_mods``' per-step vectors (flattened) are
    the graph's inputs, read anew by a replay; the other arguments are baked
    into its launches. Its key (``graphs.key_of``) is derived from both."""
    names = [k for k, v in args.items() if isinstance(v, torch.Tensor)]
    static = {k: v for k, v in args.items() if k not in names}
    inputs = [args[k] for k in names] + _flat_mods(mods)
    n, n_double = len(names), len(model.double_blocks)
    return model.graphs.run(key_of(inputs, static), model.graphs.signature(model),
                            lambda x: model._forward(**dict(zip(names, x)), **static,
                                                     mods=_unflat_mods(x[n:], n_double)),
                            inputs)


def _flat_mods(mods) -> list:
    """``flux_mods``' per-step structure as one list: each double block's
    (img, txt), each single block's vector, the final one."""
    return [t for pair in mods["double"] for t in pair] + list(mods["single"]) + [mods["final"]]


def _unflat_mods(flat, n_double: int) -> dict:
    """``_flat_mods`` undone, for a model of `n_double` double blocks."""
    pairs = flat[:2 * n_double]
    return {"double": list(zip(pairs[0::2], pairs[1::2])), "single": list(flat[2 * n_double:-1]),
            "final": flat[-1]}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def output_head(model: nn.Module, x: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    """The AdaLN-continuous output head on image tokens `x` (`final`'s chunk
    order is scale, shift). ``final_proj`` runs per sample: a product this
    narrow gets a split reduction from cuBLAS whose factor depends on the
    row count, so a batch's rows are bitwise the single-sample call's."""
    scale, shift = final.chunk(2, dim=-1)
    x = _modulate(x, shift, scale)
    return torch.cat([dense(model.final_proj, x[i:i + 1]) for i in range(x.shape[0])])


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN: LayerNorm(x) * (1 + scale) + shift. Where a gradient flows
    through the call (training, remat's recompute) or the model is not bf16,
    the plain composition, which autograd differentiates and which is
    bitwise what the DiT ran before the kernel; else ``adaln_modulate``: the
    kernel on a CUDA tensor (raising on a layout it does not take), the
    composition on the CPU."""
    if x.dtype != torch.bfloat16 or (
            torch.is_grad_enabled() and any(t.requires_grad for t in (x, shift, scale))):
        return adaln_modulate_reference(x, shift, scale)
    return adaln_modulate(x, shift, scale)


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tensor


def _col(lin: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """A column-parallel linear on an input every rank holds whole: the
    rank's output columns (with tp > 1 the input's gradient is summed over
    the tensor axis in the backward)."""
    return dense(lin, x if _tp(mesh) == 1 else PT.copy_to_tensor(x, mesh))


def _whole(lin: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """A column-parallel linear's output made whole (all-gathered over the
    tensor axis when tp > 1)."""
    y = _col(lin, x, mesh)
    return y if _tp(mesh) == 1 else PT.gather_from_tensor(y, mesh)


def _row(lin: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel linear. With tp > 1, on the rank's input columns: its
    partial product without the bias (a LoRA branch's part included),
    summed over the tensor axis, then the bias once; a w8a8 linear
    quantises its activations with the token's scale over the whole feature
    row (the max over the ranks)."""
    if _tp(mesh) == 1:
        return dense(lin, x)
    y = PT.reduce_from_tensor(dense(lin, x, bias=False,
                                    amax_reduce=lambda a: PT.all_reduce_max(a, mesh)), mesh)
    return y if lin.bias is None else y + lin.bias.to(y.dtype)


def double_block(blk: DoubleBlock, cfg: FluxConfig, txt, img, mods, rope_cos, rope_sin,
                 attn_impl: str, kv_len: Optional[int], mesh=None, img_first: bool = False):
    """One double-stream block: separate img/txt QKV + MLPs, joint attention.

    mods = (img_mod (B, 6D), txt_mod (B, 6D)) — the block's AdaLN modulation
    vectors (per step, or precomputed for the whole schedule by flux_mods),
    whole on every rank. With a tensor axis, `blk` is the rank's shard: its
    H / tp heads' q|k|v, and the output projections and fc2s summed over
    the ranks. The joint sequence is [txt | img], or with `img_first`
    [img | txt] (the RoPE tables in the same order): attention does not see
    the order, and text last lets `kv_len` mask a padded text's tail."""
    n_txt, n_img = txt.shape[1], img.shape[1]

    def joint(t, i, dim=1):
        return torch.cat([i, t] if img_first else [t, i], dim=dim)

    img_mod, txt_mod = mods
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = img_mod.chunk(6, dim=-1)
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = txt_mod.chunk(6, dim=-1)

    img_n = _modulate(img, i_shift1, i_scale1)
    txt_n = _modulate(txt, t_shift1, t_scale1)
    iq, ik, iv = _col(blk.img_qkv, img_n, mesh).chunk(3, dim=-1)
    tq, tk, tv = _col(blk.txt_qkv, txt_n, mesh).chunk(3, dim=-1)
    h, hd = cfg.num_heads // _tp(mesh), cfg.head_dim

    if attn_impl == "fused":
        # raw q/k: RMSNorm + rotate-half RoPE run inside the attention kernel,
        # with per-row scale tables (txt rows, then img rows)
        q = _heads(joint(tq, iq), h)
        k = _heads(joint(tk, ik), h)
        v = _heads(joint(tv, iv), h)
        qs = joint(blk.txt_q_scale.expand(n_txt, hd), blk.img_q_scale.expand(n_img, hd), 0)
        ks = joint(blk.txt_k_scale.expand(n_txt, hd), blk.img_k_scale.expand(n_img, hd), 0)
        out = flash_attention_qk_norm_rope(q, k, v, rope_cos, rope_sin, qs, ks, kv_len=kv_len)
    else:
        iq = rms_norm(_heads(iq, h), blk.img_q_scale)
        ik = rms_norm(_heads(ik, h), blk.img_k_scale)
        tq = rms_norm(_heads(tq, h), blk.txt_q_scale)
        tk = rms_norm(_heads(tk, h), blk.txt_k_scale)
        q = apply_rope_bshd(joint(tq, iq), rope_cos, rope_sin)
        k = apply_rope_bshd(joint(tk, ik), rope_cos, rope_sin)
        v = joint(_heads(tv, h), _heads(iv, h))
        out = dot_product_attention(q, k, v, impl=attn_impl, kv_len=kv_len)

    out = out.reshape(out.shape[0], out.shape[1], -1)
    if img_first:
        img_attn, txt_attn = out[:, :n_img], out[:, n_img:]
    else:
        txt_attn, img_attn = out[:, :n_txt], out[:, n_txt:]

    img = img + i_gate1[:, None] * _row(blk.img_proj, img_attn, mesh)
    img_mlp_in = _modulate(img, i_shift2, i_scale2)
    img = img + i_gate2[:, None] * _row(blk.img_mlp.fc2,
                                        gelu_tanh(_col(blk.img_mlp.fc1, img_mlp_in, mesh)), mesh)

    txt = txt + t_gate1[:, None] * _row(blk.txt_proj, txt_attn, mesh)
    txt_mlp_in = _modulate(txt, t_shift2, t_scale2)
    txt = txt + t_gate2[:, None] * _row(blk.txt_mlp.fc2,
                                        gelu_tanh(_col(blk.txt_mlp.fc1, txt_mlp_in, mesh)), mesh)
    return txt, img


def single_block(blk: SingleBlock, cfg: FluxConfig, x, mod, rope_cos, rope_sin,
                 attn_impl: str, kv_len: Optional[int], mesh=None):
    """One single-stream block: parallel attention + MLP over the joint sequence.

    mod: (B, 3D) AdaLN modulation vector (see double_block). With a tensor
    axis, linear1's local output is [q_r | k_r | v_r | mlp_r] and the local
    [attn_r | gelu(mlp_r)] meets the rank's (device-major) rows of linear2,
    summed over the ranks."""
    tp = _tp(mesh)
    d, h = cfg.hidden_dim // tp, cfg.num_heads // tp
    shift, scale, gate = mod.chunk(3, dim=-1)
    x_n = _modulate(x, shift, scale)

    fused = _col(blk.linear1, x_n, mesh)
    q, k, v, mlp = fused.split([d, d, d, fused.shape[-1] - 3 * d], dim=-1)
    # q/k/v stay strided views of `fused`; the kernel takes the row stride
    q, k, v = _heads(q, h), _heads(k, h), _heads(v, h)
    if attn_impl == "fused":
        attn = flash_attention_qk_norm_rope(q, k, v, rope_cos, rope_sin,
                                            blk.q_scale, blk.k_scale, kv_len=kv_len)
    else:
        q = apply_rope_bshd(rms_norm(q, blk.q_scale), rope_cos, rope_sin)
        k = apply_rope_bshd(rms_norm(k, blk.k_scale), rope_cos, rope_sin)
        attn = dot_product_attention(q, k, v, impl=attn_impl, kv_len=kv_len)
    attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
    out = _row(blk.linear2, torch.cat([attn, gelu_tanh(mlp)], dim=-1), mesh)
    return x + gate[:, None] * out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def flux_vec(model: FluxTransformer, timestep, guidance, pooled, dtype=torch.bfloat16):
    """The AdaLN conditioning vector (B, D) from timestep + guidance + pooled
    CLIP embedding."""
    with PT.gathered(model):
        return _flux_vec(model, timestep, guidance, pooled, dtype)


def _flux_vec(model: FluxTransformer, timestep, guidance, pooled, dtype):
    cfg = model.cfg
    vec = dense(model.time_in.fc2, silu(dense(
        model.time_in.fc1,
        timestep_embedding(timestep * 1000.0, cfg.time_embed_channels).to(dtype))))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("model expects guidance embeddings")
        vec = vec + dense(model.guidance_in.fc2, silu(dense(
            model.guidance_in.fc1,
            timestep_embedding(guidance * 1000.0, cfg.time_embed_channels).to(dtype))))
    vec = vec + dense(model.vector_in.fc2, silu(dense(model.vector_in.fc1, pooled.to(dtype))))
    return vec


def flux_mods(model: FluxTransformer, vec: torch.Tensor, mesh=None):
    """All AdaLN modulation vectors for conditioning vec (N, D).

    The modulation weights are ~27% of the DiT's parameters but their inputs
    depend only on (timestep, guidance, pooled). For a whole denoise schedule,
    call with vec of shape (steps*B, D): every modulation weight is then read
    once per image instead of once per step.

    Returns {"double": [(img (N, 6D), txt (N, 6D)) per block],
             "single": [(N, 3D) per block], "final": (N, 2D)}, whole on
    every rank of a tensor axis (each column-parallel output all-gathered).
    """
    sv = silu(vec)

    def whole(blk, *names):
        with PT.gathered(blk):
            return tuple(_whole(blk.get_submodule(n), sv, mesh) for n in names)

    with PT.gathered(model):
        final = dense(model.final_mod, sv)
    return {
        "double": [whole(b, "img_mod", "txt_mod") for b in model.double_blocks],
        "single": [whole(b, "mod")[0] for b in model.single_blocks],
        "final": final,
    }


def step_mods(mods_all: dict, i: int, b: int) -> dict:
    """Step `i`'s `b` rows of ``flux_mods`` over (steps * b) rows."""
    rows = slice(i * b, (i + 1) * b)
    return {"double": [(im[rows], tm[rows]) for im, tm in mods_all["double"]],
            "single": [m[rows] for m in mods_all["single"]], "final": mods_all["final"][rows]}


def resolve_attn_impl(attn_impl: str, head_dim: int, device: torch.device) -> str:
    """A serving pipeline's attention path: "auto" is "fused" on CUDA for a
    head_dim the Hopper kernel takes (``SUPPORTED_HEAD_DIMS``), else
    "plain" (the CPU runs the plain path unless asked for the fused one)."""
    if attn_impl == "auto":
        attn_impl = "fused" if device.type == "cuda" and head_dim in SUPPORTED_HEAD_DIMS else "plain"
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be 'auto' or one of {ATTN_IMPLS}")
    return attn_impl


def _layout_for(model: nn.Module, attn_impl: str) -> str:
    """The q/k layout `attn_impl` reads in `model`: the model's
    ``fused_layout`` for "fused", else "interleaved"."""
    return model.fused_layout if attn_impl == "fused" else "interleaved"


def to_attn_layout(model: nn.Module, attn_impl: str) -> nn.Module:
    """`model`, its q/k weights half-permuted in place where `attn_impl`
    reads the "half" layout and they are not in it yet
    (``half_permute_flux_params``)."""
    if _layout_for(model, attn_impl) == "half" and model.rope_layout == "interleaved":
        half_permute_flux_params(model)
    return model


def wan_attention(q, k, v, q_scale, k_scale, attn_impl: str, *, rope=None,
                  eps: float = 1e-6) -> torch.Tensor:
    """Wan's two attention forms (``models.wan``) over BSHD q/k/v: q and k
    RMS-normed across each token's heads with the (H*D,) scales, then the
    self-attention's interleaved RoPE (`rope` = (cos, sin)) or, without
    `rope`, the cross-attention's none (k and v the text's rows), softmax
    over every key. "fused": ``attn_self`` / ``attn_cross`` (the Hopper
    kernels on CUDA, their plain versions on the CPU), which read the
    checkpoint's interleaved q/k order (a Wan model's ``fused_layout``);
    "plain": the composition (``rms_norm`` over the whole
    row, ``apply_rope_bshd``, ``plain_attention``)."""
    if attn_impl == "fused":
        if rope is None:
            return attn_cross(q, k, v, q_scale, k_scale, eps=eps)
        return attn_self(q, k, v, q_scale, k_scale, *rope, eps=eps)
    if attn_impl != "plain":
        raise ValueError(f"Wan's attention runs 'fused' or 'plain', not {attn_impl!r}")
    h = q.shape[2]
    q = rms_norm(q.flatten(2), q_scale, eps).unflatten(2, (h, -1))
    k = rms_norm(k.flatten(2), k_scale, eps).unflatten(2, (h, -1))
    if rope is not None:
        q, k = apply_rope_bshd(q, *rope), apply_rope_bshd(k, *rope)
    return dot_product_attention(q, k, v, impl="plain")


def check_attn_layout(model: nn.Module, attn_impl: str) -> None:
    """Raise unless `attn_impl` is a path and `model`'s q/k weights are in
    the layout it reads."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    want = _layout_for(model, attn_impl)
    if model.rope_layout != want:
        raise ValueError(f"attn_impl={attn_impl!r} needs q/k weights in the {want!r} "
                         f"layout, the model is {model.rope_layout!r} "
                         "(see half_permute_flux_params)")


def model_rope_tables(model: nn.Module, ids: np.ndarray, device) -> tuple:
    """(cos, sin) on `device` for RoPE ids (S, n_axes) in the layout of
    `model`'s q/k weights: rotate-half for "half", else interleaved."""
    fn = rope_tables_half if model.rope_layout == "half" else rope_tables
    return tuple(torch.as_tensor(t, device=device)
                 for t in fn(ids, model.cfg.axes_dims_rope, model.cfg.rope_theta))


def check_tp(model: FluxTransformer, mesh) -> None:
    """Raise unless `model` holds what a forward over `mesh` needs: for tp >
    1, this rank's shard of weights permuted for that tp (a forward on
    naturally ordered columns would read them as device-major: silently
    scrambled attention, hence the check); for tp = 1, a whole module."""
    tp = _tp(mesh)
    if tp > 1 and (model.tp_layout != tp or model.tp_rank != mesh.tensor_rank):
        raise ValueError(
            f"a forward at tp={tp} needs this rank's shard of tp_permute_flux_params'd "
            f"weights (the model has tp_layout={model.tp_layout}, tp_rank={model.tp_rank}); "
            "FillPipeline.shard_for_serving or from_pretrained(mesh=) applies both")
    if tp == 1 and (model.tp_layout != 1 or model.tp_rank is not None):
        raise ValueError(f"the model is permuted / sharded for tp={model.tp_layout}: pass "
                         "the mesh it was sharded over")


def flux_apply(
    model: FluxTransformer,
    img_tokens: torch.Tensor,      # (B, T_img, in_channels)
    txt_tokens: torch.Tensor,      # (B, T_txt, joint_dim)
    pooled: torch.Tensor,          # (B, pooled_dim)
    timestep: torch.Tensor,        # (B,) sigma in [0, 1]
    guidance: Optional[torch.Tensor],  # (B,) guidance scale or None
    rope_cos: torch.Tensor,        # (T_txt + T_img, head_dim)
    rope_sin: torch.Tensor,
    *,
    attn_impl: str = "plain",
    remat: bool = False,
    kv_len: Optional[int] = None,
    mods=None,                     # optional precomputed flux_mods(...) output
    mesh=None,                     # parallel.partitioning.Mesh: tensor parallelism
) -> torch.Tensor:
    """Predict the flow velocity for packed image tokens. Returns (B, T_img, out_channels).

    remat: checkpoint every block (``torch.utils.checkpoint``, non-reentrant),
    as the JAX package's ``jax.checkpoint`` of its scan bodies: a block keeps
    only its inputs for the backward and runs its forward again there.

    mesh: with a tensor axis tp > 1, `model` is this rank's shard (see the
    module docstring) and every rank of the tensor sub-group calls this on
    the same inputs; the output is whole on each, and so is the gradient of
    every input. Over the fsdp axis, FSDP
    (``parallel.partitioning.shard_for_training``) or the storage shards
    (``shard_storage``) gather each module's weights as it is called."""
    check_tp(model, mesh)
    check_attn_layout(model, attn_impl)
    return model(img_tokens, txt_tokens, pooled, timestep, guidance, rope_cos, rope_sin,
                 attn_impl=attn_impl, remat=remat, kv_len=kv_len, mods=mods, mesh=mesh)


def _fused_tensors(lin: nn.Module):
    return list(lin.named_parameters(recurse=False)) + list(lin.named_buffers(recurse=False))


def _permute_out(lin: nn.Module, idx: torch.Tensor, what: str, lora: bool = True) -> None:
    """Gather the output rows of every output-axis tensor of a fused
    projection by `idx`, in place: the weight and bias of an ``nn.Linear``,
    every buffer of a ``QuantLinear`` (``io.quantize.OUT_AXIS_KEYS``: the NF4
    codes pack along the input axis and their absmax groups it, so the
    output rows move whole), and, with `lora`, a parallel LoRA's B along its
    last axis (A acts on the input and stays; grouped factors raise).
    Without `lora` the factors stay in their natural layout (the tensor
    permutation: a shard's forward takes its share of them through its
    ``TensorShare``). A tensor of unknown layout raises."""
    for name, t in _fused_tensors(lin):
        if name in OUT_AXIS_KEYS:
            t.copy_(t.index_select(0, idx.to(t.device)))
        elif name in LORA_KEYS and not lora:
            continue
        elif name == "lora_b":
            t.copy_(t.index_select(-1, idx.to(t.device)))
        elif name in ("lora_ga", "lora_gb"):
            raise ValueError(
                f"grouped per-module LoRA factors cannot be permuted for {what}: fold them "
                "first (training.train.lora_merge or io.lora's load-time folding)")
        elif name != "lora_a":   # never drop one silently
            raise KeyError(f"unknown tensor {name!r} of a fused projection in {what}: add it "
                           "to io.quantize.OUT_AXIS_KEYS (output axis first) or handle it here")


def _shards(model: FluxTransformer) -> int:
    """How many ways the module's heads are split: its tp when it holds one
    rank's shard, else 1."""
    return model.tp_layout if model.tp_rank is not None else 1


@torch.no_grad()
def half_permute_flux_params(model: FluxTransformer) -> FluxTransformer:
    """Permute q/k feature columns into the rotate-half layout the fused
    attention kernel needs (attn_impl="fused").

    The permutation is a similarity transform on the attention logits (q and
    k permuted identically), so outputs are unchanged; it folds the
    interleaved RoPE pairing into the weights once at load time. v and all
    other parameters are untouched (see ``_permute_out`` for the tensors
    gathered). It moves features within each head, so it commutes with the
    tensor-parallel permutation, which moves whole heads: a rank's shard is
    permuted over its own heads. Unlike the JAX package, which returns a
    new tree, this permutes the module IN PLACE (a copy of the 12B DiT would
    not fit beside it) and returns it."""
    if model.rope_layout != "interleaved":
        raise ValueError(f"model is already in the {model.rope_layout!r} layout")
    if model.tp_layout != 1 and model.tp_rank is None:
        raise ValueError("half-permute before tp_permute_flux_params, or permute a rank's "
                         "shard: the whole model's columns are device-major")
    cfg = model.cfg
    n = _shards(model)
    d, heads = cfg.hidden_dim // n, cfg.num_heads // n
    perm = half_permutation(cfg.head_dim)
    per_head = np.concatenate([h * cfg.head_dim + perm for h in range(heads)])

    def permute_rows(lin: nn.Module, extra: int = 0) -> None:
        idx = torch.as_tensor(np.concatenate([per_head, d + per_head,
                                              2 * d + np.arange(d + extra)]))
        _permute_out(lin, idx, "the fused kernel")

    p = torch.as_tensor(perm)
    for blk in model.double_blocks:
        permute_rows(blk.img_qkv)
        permute_rows(blk.txt_qkv)
        for prm in (blk.img_q_scale, blk.img_k_scale, blk.txt_q_scale, blk.txt_k_scale):
            prm.copy_(prm[p.to(prm.device)])
    for blk in model.single_blocks:
        permute_rows(blk.linear1, extra=cfg.mlp_dim // n)
        for prm in (blk.q_scale, blk.k_scale):
            prm.copy_(prm[p.to(prm.device)])
    model.rope_layout = "half"
    return model


def tp_permutations(cfg: FluxConfig, tp: int) -> dict:
    """{linear name within a block: (axis, index)} of the device-major
    permutation of each fused projection (axis 0: output rows, 1: input
    columns): img_qkv / txt_qkv out rows in segments (d, d, d), linear1 out
    rows (d, d, d, mlp), linear2 in columns (d, mlp), matching the local
    [attn_r | gelu(mlp_r)] a rank's single block feeds it."""
    d, m, h = cfg.hidden_dim, cfg.mlp_dim, cfg.num_heads
    if any(x % tp for x in (d, m, h)):
        raise ValueError(f"hidden={d}, mlp={m}, heads={h} must all be divisible by tp={tp}")
    return {name: (axis, PT.devmajor_index(segs, tp))
            for name, (axis, segs) in PT.fused_segments(cfg).items()}


@torch.no_grad()
def tp_permute_flux_params(model: FluxTransformer, tp: int) -> FluxTransformer:
    """Permute the fused projections into device-major layout for tensor
    parallelism (``tp_permutations``), in place, and mark the module
    (``tp_layout``). Contiguous shares of the permuted axes then line up
    with head-parallel attention: the q|k|v split, the heads and the single
    block's [attn | mlp] -> linear2 all stay on their rank, and the only
    collectives are the row-parallel projections' all-reduces. Composes with
    (and in the JAX package is applied after) half_permute_flux_params.

    Attached LoRA factors stay in their natural layout (``TensorShare``
    takes a shard's part of them). Re-permuting raises (it would scramble
    the layout with no error at apply time: reload to change tp). NF4: permuting output rows is safe
    (the codes pack along the input axis), but linear2's input rows are
    nibble-packed and absmax-blocked, so a module with an NF4 linear2
    raises: quantise after this permutation (``shard_module`` and the
    sharded load order it so)."""
    if model.tp_layout != 1:
        raise ValueError(f"params are already tp-permuted (tp={model.tp_layout}); reload "
                         f"the checkpoint to change the tensor-parallel degree to {tp}")
    if model.tp_rank is not None:
        raise ValueError("the model holds one rank's shard; permute before sharding")
    perms = tp_permutations(model.cfg, tp)
    for blk in model.single_blocks:
        if isinstance(blk.linear2, QuantLinear) and blk.linear2.mode == "nf4":
            raise ValueError(
                "cannot tp-permute the in rows of an NF4-packed linear2: rows are "
                "nibble-packed and absmax-blocked. Quantize AFTER tp_permute_flux_params "
                "(shard_for_serving(..., quantize=...) and from_pretrained(mesh=...) order "
                "this correctly).")
    for blk in list(model.double_blocks) + list(model.single_blocks):
        for name, (axis, idx) in perms.items():
            lin = getattr(blk, name, None)
            if lin is None:
                continue
            idx = torch.as_tensor(idx)
            if axis == 0:
                _permute_out(lin, idx, "tensor parallelism", lora=False)
                continue
            for tname, t in _fused_tensors(lin):
                if tname in ("weight", "w_q", "w_q8a8"):
                    t.copy_(t.index_select(1, idx.to(t.device)))
                elif tname not in ("bias", "scale") + LORA_KEYS:
                    raise KeyError(f"unknown tensor {tname!r} of linear2 in "
                                   "tp_permute_flux_params")
    model.tp_layout = tp
    return model
