"""The plain float32 reference of Qwen-Image's DiT, its schedule, true CFG and the blend.

Plain PyTorch, written from the published model (diffusers'
``QwenImageTransformer2DModel``, ``QwenImagePipeline`` and the inpaint
pipelines' latent blend) in the layout of the program's parameters, so
that one state dict of names fills both sides: the double block is FLUX's,
named as ``models.DoubleBlock`` (imported, not edited). Every product runs
in float32 with TF32 off; attention is an explicit softmax over [txt | img]
at the text's own length, with no padding. Nothing here imports the
program.

The benchmark judges the DiT stage by stage (``stage_gaps``): the
embedders, the parts of a block and the head, each run on the program's
own input to it; ``velocities`` runs it whole. In float32 the DiT is 82 GB,
more than the card holds, so both run it block by block: each group of
weights (``weights.draw_group``, the program's bf16 values) is drawn again
from the seed, widened to float32, rounded for the control when asked, run
for every job and freed.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from h100_bench import weights
from h100_bench.reference import models as M

MODEL = "qwen_dit"


class QwenDiT(nn.Module):
    """The parameters' names and shapes (on the meta device)."""

    def __init__(self, cfg: dict):
        super().__init__()
        hd = cfg["attention_head_dim"]
        d = cfg["num_attention_heads"] * hd
        m = 4 * d
        self.cfg = cfg
        self.img_in = M._lin(cfg["in_channels"], d)
        self.txt_norm = M._vec(cfg["joint_attention_dim"])
        self.txt_in = M._lin(cfg["joint_attention_dim"], d)
        self.time_in = M.MLP(256, d, d)
        self.final_mod = M._lin(d, 2 * d)
        self.final_proj = M._lin(d, cfg["out_channels"] * cfg["patch_size"] ** 2)
        self.double_blocks = nn.ModuleList(M.DoubleBlock(d, m, hd)
                                           for _ in range(cfg["num_layers"]))


def rope_ids(grid_h: int, grid_w: int, n_txt: int, device) -> tuple:
    """(text ids, image ids), float64, as ``QwenEmbedRope(scale_rope=True)``
    places them: the image centred, (0, r - (H - H // 2), c - (W - W // 2));
    text token j at m + j on every axis, m = max(H // 2, W // 2)."""
    r = torch.arange(grid_h, dtype=torch.float64, device=device) - (grid_h - grid_h // 2)
    c = torch.arange(grid_w, dtype=torch.float64, device=device) - (grid_w - grid_w // 2)
    img = torch.zeros(grid_h, grid_w, 3, dtype=torch.float64, device=device)
    img[..., 1] = r[:, None]
    img[..., 2] = c[None, :]
    m = max(grid_h // 2, grid_w // 2)
    txt = (m + torch.arange(n_txt, dtype=torch.float64, device=device))[:, None].repeat(1, 3)
    return txt, img.reshape(-1, 3)


def model_timestep(sigma: float) -> float:
    """What the published pipeline hands the DiT: the scheduler's float32
    timestep sigma * 1000, in the model's dtype (bf16), divided by 1000 in
    bf16."""
    t = torch.tensor(np.float32(sigma) * np.float32(1000.0)).to(M.TIMESTEP_DTYPE)
    return float(t / 1000)


def timestep_embedding(t: float, device) -> torch.Tensor:
    """diffusers' ``Timesteps(256, flip_sin_to_cos=True, shift=0, scale=1000)``:
    [cos | sin] of 1000 * (t * freqs), float32, (1, 256)."""
    half = 128
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=device) / half)
    args = 1000.0 * (torch.tensor([t], dtype=torch.float32, device=device)[:, None] * freqs)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def schedule(steps: int, image_seq_len: int, base_seq=256, max_seq=8192, base_shift=0.5,
             max_shift=0.9, shift_terminal=0.02) -> np.ndarray:
    """The scheduler's sigmas (diffusers' FlowMatchEulerDiscreteScheduler
    with Qwen-Image's config, ``use_dynamic_shifting``, exponential time
    shift, ``shift_terminal``): steps + 1 float32 values, 0 last."""
    m = (max_shift - base_shift) / (max_seq - base_seq)
    mu = image_seq_len * m + (base_shift - m * base_seq)
    sig = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    sig = math.exp(mu) / (math.exp(mu) + (1.0 / sig - 1.0) ** 1.0)
    one_minus_z = 1.0 - sig
    scale_factor = one_minus_z[-1] / (1.0 - shift_terminal)
    sig = 1.0 - (one_minus_z / scale_factor)
    return np.append(sig, 0.0).astype(np.float32)


def guide(v_cond, v_uncond, scale: float):
    """QwenImagePipeline's true CFG: v_u + s (v_c - v_u), rescaled per token
    to the norm of v_c (over the packed channels), float32."""
    c, u = v_cond.float(), v_uncond.float()
    comb = u + scale * (c - u)
    return comb * (torch.norm(c, dim=-1, keepdim=True) / torch.norm(comb, dim=-1, keepdim=True))


def euler_blend(x, v, sigma, sigma_next, mask, z0, noise):
    """The Euler step, then the inpaint pipelines' blend: float32."""
    x = x.float() + (float(sigma_next) - float(sigma)) * v.float()
    s = float(sigma_next)
    kept = (1.0 - s) * z0.float() + s * noise.float()
    return (1.0 - mask.float()) * kept + mask.float() * x


def _load(module: nn.Module, seed: int, group: str, leaves, device, rounding: str,
          prefix: str = "") -> nn.Module:
    """`module` holding group `group`'s weights in float32 (names less
    `prefix`), rounded for `rounding`."""
    sd = {name[len(prefix):]: t.float()
          for name, t in weights.draw_group(seed, MODEL, group, leaves, device).items()}
    module.load_state_dict(sd, assign=True, strict=True)
    module.requires_grad_(False)
    M.round_weights(module, rounding)
    return module


@torch.inference_mode()
def velocities(cfg: dict, seed: int, jobs: list, device, rounding: str = "fp32") -> list:
    """The DiT's velocity (1, T_img, 64) for each job, a dict of x (packed
    latents (1, T_img, 64)), txt (text embeddings (1, L, 3584) at their own
    length), sigma and grid ((H, W) of image tokens); block by block
    (module docstring)."""
    dev = torch.device(device)
    spec = weights.groups(QwenDiT(cfg))
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    # the DiT without blocks holds exactly the group "rest"
    rest = _load(QwenDiT(dict(cfg, num_layers=0)), seed, "rest", spec["rest"], dev, rounding)

    def mlp(p, x):
        return M.dense(p.fc2, F.silu(M.dense(p.fc1, x)))

    states = []
    for job in jobs:
        emb = timestep_embedding(model_timestep(job["sigma"]), dev)
        txt_ids, img_ids = rope_ids(*job["grid"], job["txt"].shape[1], dev)
        cos, sin = M.rope_tables(torch.cat([txt_ids, img_ids]), cfg["axes_dims_rope"])
        states.append(dict(
            sv=F.silu(mlp(rest.time_in, emb)), cos=cos, sin=sin,
            img=M.dense(rest.img_in, job["x"].float()),
            txt=M.dense(rest.txt_in, M.rms_norm(job["txt"].float(), rest.txt_norm, 1e-6))))
    for i in range(cfg["num_layers"]):
        group = f"double_blocks.{i}"
        blk = _load(M.DoubleBlock(heads * hd, 4 * heads * hd, hd), seed, group, spec[group],
                    dev, rounding, prefix=group + ".")
        for st in states:
            st["txt"], st["img"] = double_block(blk, st, heads, hd)
        del blk
    out = []
    for st in states:
        scale, shift = M.dense(rest.final_mod, st["sv"]).chunk(2, -1)
        out.append(M.dense(rest.final_proj, M._modulate(st["img"], shift, scale)))
    return out


def _gap(got, want, base=0.0) -> float:
    """||got - want|| / ||want - base||: relative to `want`, or with a
    `base` to the change from it."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.to(want.device).float() - want)
                 / torch.linalg.vector_norm(want - base))


def _joint(pair):
    """A (txt, img) pair as one (L + T, D) float32 tensor."""
    return torch.cat([t.flatten(0, 1).float() for t in pair])


@torch.inference_mode()
def stage_gaps(cfg: dict, seed: int, jobs: list, device, rounding: str = "fp32") -> list:
    """Per job, the DiT's stages judged one at a time on the program's own
    input to each: a list of (stage, gap of the program, gap of the control
    or None), each gap the relative L2 gap to the float32 reference over
    both streams. A job is a dict of x (the packed latents the DiT got),
    txt (the text embedding at its own length), sigma, grid ((H, W) of
    image tokens), v (the program's velocity), first (the program's (txt,
    img) streams before the first block), last (its image stream after the
    last) and blocks: for each judged block i, the program's mods (its
    (img, txt) modulation vectors) and (txt, img) pairs at its input (in),
    after the attention's output projections (attn), at the MLPs' input
    (mlp_in) and after the MLPs' fc2 (mlp), the text at its own length.

    The stages: "embed" (``img_in``, and ``txt_norm`` then ``txt_in``),
    "mod" (block i's modulation vectors from the timestep), "attn" (its
    modulation, q/k/v, their norms, RoPE, joint attention and output
    projections on the program's input to the block), "mlp_in" (the
    gated attention added to that input, modulated), "mlp" (the MLPs on the
    program's modulated input) and "head". The residual stream itself is
    the program's bf16 sum of these parts (``qwen_check``'s
    ``glue_ulp``). With a control's `rounding`, the control runs beside the
    float32 reference on the same inputs, and its gap to the reference is
    the control's."""
    dev = torch.device(device)
    spec = weights.groups(QwenDiT(cfg))
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]

    def load(group, module, prefix=""):
        """[the group in float32] and, for a control, its rounded copy."""
        ref = _load(module, seed, group, spec[group], dev, "fp32", prefix=prefix)
        if rounding == "fp32":
            return [ref]
        ctl = copy.deepcopy(ref)
        M.round_weights(ctl, rounding)
        return [ref, ctl]

    def judged(stage, prog, outs):
        return (stage, _gap(prog, outs[0]), _gap(outs[1], outs[0]) if len(outs) > 1 else None)

    def on(pair):
        return [t.to(dev).float() for t in pair]

    # the DiT without blocks holds exactly the group "rest"
    rests = load("rest", QwenDiT(dict(cfg, num_layers=0)))
    out, conds = [], []
    for job in jobs:
        emb = timestep_embedding(model_timestep(job["sigma"]), dev)
        txt_ids, img_ids = rope_ids(*job["grid"], job["txt"].shape[1], dev)
        cos, sin = M.rope_tables(torch.cat([txt_ids, img_ids]), cfg["axes_dims_rope"])
        txt, x = job["txt"].to(dev).float(), job["x"].to(dev).float()
        conds.append([dict(cos=cos, sin=sin, sv=F.silu(M.dense(
            r.time_in.fc2, F.silu(M.dense(r.time_in.fc1, emb))))) for r in rests])
        embedded = [_joint((M.dense(r.txt_in, M.rms_norm(txt, r.txt_norm, 1e-6)),
                            M.dense(r.img_in, x))) for r in rests]
        out.append([judged("embed", _joint(job["first"]), embedded)])
    for i in sorted({i for job in jobs for i in job["blocks"]}):
        group = f"double_blocks.{i}"
        blks = load(group, M.DoubleBlock(heads * hd, 4 * heads * hd, hd), prefix=group + ".")
        for job, row, cs in zip(jobs, out, conds):
            if i not in job["blocks"]:
                continue
            got = job["blocks"][i]
            txt, img = on(got["in"])
            mods = [block_mods(blk, c["sv"]) for blk, c in zip(blks, cs)]
            row.append(judged(f"mod.{i}", torch.cat([m.flatten() for m in got["mods"]]),
                              [torch.cat([torch.cat(ch, -1).flatten() for ch in pair])
                               for pair in mods]))
            row.append(judged(f"attn.{i}", _joint(got["attn"]), [_joint(attention_branch(
                blk, txt, img, m, c["cos"], c["sin"], heads, hd))
                for blk, m, c in zip(blks, mods, cs)]))
            t_attn, i_attn = on(got["attn"])
            # chunks 2, 3, 4: gate1, shift2, scale2
            row.append(judged(f"mlp_in.{i}", _joint(got["mlp_in"]), [_joint((
                M._modulate(txt + tm[2][:, None] * t_attn, tm[3], tm[4]),
                M._modulate(img + im[2][:, None] * i_attn, im[3], im[4])))
                for im, tm in mods]))
            t_in, i_in = on(got["mlp_in"])
            row.append(judged(f"mlp.{i}", _joint(got["mlp"]), [_joint((
                M.mlp_gelu(blk.txt_mlp, t_in), M.mlp_gelu(blk.img_mlp, i_in))) for blk in blks]))
        del blks
    for job, row, cs in zip(jobs, out, conds):
        img = job["last"].to(dev).float()
        outs = []
        for r, c in zip(rests, cs):
            scale, shift = M.dense(r.final_mod, c["sv"]).chunk(2, -1)
            outs.append(M.dense(r.final_proj, M._modulate(img, shift, scale)))
        row.append(judged("head", job["v"], outs))
    return out


def block_mods(blk, sv) -> tuple:
    """A block's (img, txt) modulation vectors from sv = silu(temb), each
    chunked shift1, scale1, gate1, shift2, scale2, gate2."""
    return M.dense(blk.img_mod, sv).chunk(6, -1), M.dense(blk.txt_mod, sv).chunk(6, -1)


def attention_branch(blk, txt, img, mods, cos, sin, heads: int, hd: int) -> tuple:
    """(txt, img) out of the output projections of the joint attention over
    [txt | img], before the gates; float32."""
    (i1, i2, *_), (t1, t2, *_) = mods
    b, n_txt = img.shape[0], txt.shape[1]

    def qkv(lin, x, qs, ks):
        q, k, v = M.dense(lin, x).reshape(b, x.shape[1], 3, heads, hd).unbind(2)
        return M.rms_norm(q, qs), M.rms_norm(k, ks), v

    iq, ik, iv = qkv(blk.img_qkv, M._modulate(img, i1, i2), blk.img_q_scale, blk.img_k_scale)
    tq, tk, tv = qkv(blk.txt_qkv, M._modulate(txt, t1, t2), blk.txt_q_scale, blk.txt_k_scale)
    q = M.apply_rope(torch.cat([tq, iq], 1), cos, sin)
    k = M.apply_rope(torch.cat([tk, ik], 1), cos, sin)
    out = M.attention(q, k, torch.cat([tv, iv], 1), hd ** -0.5)
    return M.dense(blk.txt_proj, out[:, :n_txt]), M.dense(blk.img_proj, out[:, n_txt:])


def double_block(blk, st, heads: int, hd: int):
    """FLUX's double-stream block over [txt | img], float32."""
    txt, img = st["txt"], st["img"]
    mods = block_mods(blk, st["sv"])
    t_attn, i_attn = attention_branch(blk, txt, img, mods, st["cos"], st["sin"], heads, hd)
    (_, _, i3, i4, i5, i6), (_, _, t3, t4, t5, t6) = mods
    img = img + i3[:, None] * i_attn
    img = img + i6[:, None] * M.mlp_gelu(blk.img_mlp, M._modulate(img, i4, i5))
    txt = txt + t3[:, None] * t_attn
    txt = txt + t6[:, None] * M.mlp_gelu(blk.txt_mlp, M._modulate(txt, t4, t5))
    return txt, img
