"""The plain float32 reference of Wan2.1-VACE's DiT, its schedule and guidance.

Plain PyTorch, written from the published model (Wan's ``VaceWanModel``
and diffusers' ``WanVACETransformer3DModel``, ``WanVACEPipeline``) in the
layout of the program's parameters, so that one state dict of names fills
both sides (``groups``: one draw per block of each stack). Every product in
float32 with TF32 off; attention is an explicit softmax, a few heads at a
time. Nothing here imports the program. Departures from the published
code, each kept where the comparison cannot see it or noted:

* RoPE's angles are computed in float64 and the tables rounded to float32
  (Wan's own code rotates in float64 complex numbers);
* the program rounds each block's modulation vectors, the stream, the
  hints and every product's output to bf16, where the published model
  keeps the modulation and the residual additions in float32; here all of
  it is float32;
* the timestep embedding runs in float32 (the published pipeline casts the
  sinusoid to the model's bf16);
* the sampler is Euler over the static shift (the published solver is
  UniPC), and guidance is plain CFG in float32.

The DiT in float32 is 69 GB, so every function here runs it block by block:
each group of weights (``weights.draw_group``, the program's bf16 values)
is drawn again from the seed, widened to float32, rounded for the control
when asked, run for every job and freed. ``stage_gaps`` judges the DiT part
by part on the program's own inputs; ``velocity`` runs it whole.
"""

from __future__ import annotations

import copy
import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from h100_bench import weights
from h100_bench.reference import models as M

MODEL = "wan_dit"
STACKS = ("blocks", "vace_blocks")
ATTN_HEADS = 4           # heads whose (Sq, Sk) scores are held at once


def _patch(c_out, c_in, patch):
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty((c_out, c_in, *patch), device="meta"))
    m.bias = nn.Parameter(torch.empty(c_out, device="meta"))
    return m


class Norm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight, self.bias = M._vec(d), M._vec(d)


class Block(nn.Module):
    def __init__(self, cfg: dict, vace: int = -1):
        super().__init__()
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        self.modulation = nn.Parameter(torch.empty(6, d, device="meta"))
        self.self_qkv, self.self_o = M._lin(d, 3 * d), M._lin(d, d)
        self.self_q_scale, self.self_k_scale = M._vec(d), M._vec(d)
        self.cross_norm = Norm(d)
        self.cross_q, self.cross_kv, self.cross_o = M._lin(d, d), M._lin(d, 2 * d), M._lin(d, d)
        self.cross_q_scale, self.cross_k_scale = M._vec(d), M._vec(d)
        self.ffn = M.MLP(d, cfg["ffn_dim"], d)
        if vace == 0:
            self.proj_in = M._lin(d, d)
        if vace >= 0:
            self.proj_out = M._lin(d, d)


class WanDiT(nn.Module):
    """The parameters' names and shapes (on the meta device)."""

    def __init__(self, cfg: dict, blocks: bool = True):
        super().__init__()
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        patch = tuple(cfg["patch_size"])
        self.cfg = cfg
        self.patch_embed = _patch(d, cfg["in_channels"], patch)
        self.vace_patch_embed = _patch(d, cfg["vace_in_channels"], patch)
        self.time_in = M.MLP(cfg["freq_dim"], d, d)
        self.time_proj = M._lin(d, 6 * d)
        self.text_in = M.MLP(cfg["text_dim"], d, d)
        self.head_mod = nn.Parameter(torch.empty(2, d, device="meta"))
        self.head = M._lin(d, cfg["out_channels"] * int(np.prod(patch)))
        n, nv = (cfg["num_layers"], len(cfg["vace_layers"])) if blocks else (0, 0)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(n))
        self.vace_blocks = nn.ModuleList(Block(cfg, j) for j in range(nv))


def groups(model: nn.Module) -> "OrderedDict[str, list]":
    """{group: [(leaf name, shape), ...]}: each block of ``blocks`` and of
    ``vace_blocks`` one group, the rest one; names sorted."""
    out = OrderedDict()
    for name, p in sorted(model.named_parameters()):
        parts = name.split(".")
        key = ".".join(parts[:2]) if parts[0] in STACKS else "rest"
        out.setdefault(key, []).append((name, tuple(p.shape)))
    return out


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def patchify(x, patch):
    """NTHWC -> (B, S, C*pt*ph*pw) tokens in (t, h, w) order, features in
    the 3-D convolution's (C, pt, ph, pw) order."""
    b, t, h, w, c = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, t // pt, pt, h // ph, ph, w // pw, pw, c)
    return x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, -1, c * pt * ph * pw)


def unpatchify(tokens, shape, patch):
    """(B, S, pt*ph*pw*C) with features in (pt, ph, pw, C) order -> NTHWC."""
    b, t, h, w, c = shape
    pt, ph, pw = patch
    x = tokens.reshape(b, t // pt, h // ph, w // pw, pt, ph, pw, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t, h, w, c)


def embed_patches(p, x, patch):
    w = p.weight.reshape(p.weight.shape[0], -1)
    toks = patchify(x.float(), patch)
    if getattr(p, "fp8_inputs", False):
        toks = M.fp8_rows(toks)
    return F.linear(toks, w, p.bias)


def rope_tables(grid, head_dim: int, theta: float = 10000.0):
    """Interleaved (S, D) tables over (frame, row, column) ids from 0, the
    head split (D - 4 (D // 6), 2 (D // 6), 2 (D // 6)), angles in float64."""
    t, h, w = grid
    dims = (head_dim - 4 * (head_dim // 6), 2 * (head_dim // 6), 2 * (head_dim // 6))
    f, r, c = torch.meshgrid(torch.arange(t), torch.arange(h), torch.arange(w), indexing="ij")
    ids = torch.stack([f, r, c], -1).reshape(-1, 3)
    return M.rope_tables(ids, dims, theta)


def timestep_embedding(sigma: float, dim: int, device):
    """[cos | sin] of the scheduler's float32 timestep 1000 sigma, (1, dim)."""
    t = torch.tensor([np.float32(sigma) * np.float32(1000.0)], dtype=torch.float32,
                     device=device)
    return M.timestep_embedding(t, dim)


def temb_of(rest, sigma: float, cfg: dict, device):
    emb = timestep_embedding(sigma, cfg["freq_dim"], device)
    return M.dense(rest.time_in.fc2, F.silu(M.dense(rest.time_in.fc1, emb)))


def e0_of(rest, temb):
    return M.dense(rest.time_proj, F.silu(temb)).reshape(temb.shape[0], 6, -1)


def norm_across(x, scale, eps):
    """RMSNorm of (B, S, H*D) rows over all H*D features."""
    return M.rms_norm(x, scale, eps)


def attention(q, k, v, heads: int):
    """softmax(q k^T / sqrt(D)) v over (B, S, H*D) rows, ATTN_HEADS heads
    at a time; (B, Sq, H*D)."""
    b, sq, _ = q.shape
    q, k, v = (t.reshape(b, t.shape[1], heads, -1) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    out = [M.attention(q[:, :, h:h + ATTN_HEADS], k[:, :, h:h + ATTN_HEADS],
                       v[:, :, h:h + ATTN_HEADS], scale) for h in range(0, heads, ATTN_HEADS)]
    return torch.cat(out, -1)


def _rope(x, cos, sin, heads: int):
    b, s, _ = x.shape
    return M.apply_rope(x.reshape(b, s, heads, -1), cos, sin).reshape(b, s, -1)


def self_branch(blk: Block, x, mod, cos, sin, cfg: dict):
    """The self-attention branch out of its projection, before the gate."""
    heads, eps = cfg["num_attention_heads"], cfg["eps"]
    y = M._modulate(x, mod[:, 0], mod[:, 1])
    q, k, v = M.dense(blk.self_qkv, y).chunk(3, -1)
    q = _rope(norm_across(q, blk.self_q_scale, eps), cos, sin, heads)
    k = _rope(norm_across(k, blk.self_k_scale, eps), cos, sin, heads)
    return M.dense(blk.self_o, attention(q, k, v, heads))


def cross_branch(blk: Block, x, txt, cfg: dict):
    """The cross-attention branch: affine LayerNorm, q from the stream, k
    and v from the text's rows, no RoPE."""
    heads, eps = cfg["num_attention_heads"], cfg["eps"]
    y = F.layer_norm(x, x.shape[-1:], blk.cross_norm.weight, blk.cross_norm.bias, eps)
    q = norm_across(M.dense(blk.cross_q, y), blk.cross_q_scale, eps)
    k, v = M.dense(blk.cross_kv, txt).chunk(2, -1)
    k = norm_across(k, blk.cross_k_scale, eps)
    return M.dense(blk.cross_o, attention(q, k, v, heads))


def ffn_branch(blk: Block, x, mod):
    return M.mlp_gelu(blk.ffn, M._modulate(x, mod[:, 3], mod[:, 4]))


def block(blk: Block, x, txt, mod, cos, sin, cfg: dict):
    x = x + mod[:, 2][:, None] * self_branch(blk, x, mod, cos, sin, cfg)
    x = x + cross_branch(blk, x, txt, cfg)
    return x + mod[:, 5][:, None] * ffn_branch(blk, x, mod)


def head(rest, x, temb):
    m = rest.head_mod[None] + temb[:, None]
    return M.dense(rest.head, M._modulate(x, m[:, 0], m[:, 1]))


def _load(module: nn.Module, seed: int, group: str, leaves, device, rounding: str,
          prefix: str = "") -> nn.Module:
    sd = {name[len(prefix):]: t.float()
          for name, t in weights.draw_group(seed, MODEL, group, leaves, device).items()}
    module.load_state_dict(sd, assign=True, strict=True)
    module.requires_grad_(False)
    round_weights(module, rounding)
    return module


def round_weights(module: nn.Module, rounding: str) -> None:
    """``models.round_weights``, and the patch embeddings' 3-D convolution
    weights rounded as a linear's (``embed_patches`` runs them as one)."""
    M.round_weights(module, rounding)
    if rounding != "fp8":
        return
    for m in module.modules():
        w = m._parameters.get("weight")
        if w is not None and w.dim() == 5:
            m.weight.data = M.fp8_rows(w.data.reshape(w.shape[0], -1)).reshape(w.shape)
            m.fp8_inputs = True


def _block_module(cfg, group: str):
    kind, j = group.split(".")
    return Block(cfg, int(j) if kind == "vace_blocks" else -1)


# ---------------------------------------------------------------------------
# the whole forward, and the stages
# ---------------------------------------------------------------------------

@torch.inference_mode()
def velocity(cfg: dict, seed: int, jobs: list, device, rounding: str = "fp32") -> list:
    """The DiT's velocity (NTHWC) for each job, a dict of latents (B, T', h,
    w, 16), control (B, T', h, w, 96), text (B, 512, text_dim) and sigma;
    block by block (module docstring)."""
    dev = torch.device(device)
    spec = groups(WanDiT(cfg))
    patch = tuple(cfg["patch_size"])
    rest = _load(WanDiT(cfg, blocks=False), seed, "rest", spec["rest"], dev, rounding)
    states = []
    for job in jobs:
        shape = job["latents"].shape
        grid = (shape[1] // patch[0], shape[2] // patch[1], shape[3] // patch[2])
        temb = temb_of(rest, job["sigma"], cfg, dev)
        cos, sin = rope_tables(grid, cfg["attention_head_dim"])
        states.append(dict(
            shape=shape, temb=temb, e0=e0_of(rest, temb), cos=cos.to(dev), sin=sin.to(dev),
            x=embed_patches(rest.patch_embed, job["latents"].to(dev), patch),
            c=embed_patches(rest.vace_patch_embed, job["control"].to(dev), patch),
            txt=M.mlp_gelu(rest.text_in, job["text"].to(dev).float()), hints=[]))
    for j in range(len(cfg["vace_layers"])):
        group = f"vace_blocks.{j}"
        blk = _load(Block(cfg, j), seed, group, spec[group], dev, rounding, prefix=group + ".")
        for st in states:
            if j == 0:
                st["c"] = M.dense(blk.proj_in, st["c"]) + st["x"]
            st["c"] = block(blk, st["c"], st["txt"], blk.modulation[None] + st["e0"],
                            st["cos"], st["sin"], cfg)
            st["hints"].append(M.dense(blk.proj_out, st["c"]))
        del blk
    for i in range(cfg["num_layers"]):
        group = f"blocks.{i}"
        blk = _load(Block(cfg), seed, group, spec[group], dev, rounding, prefix=group + ".")
        for st in states:
            st["x"] = block(blk, st["x"], st["txt"], blk.modulation[None] + st["e0"],
                            st["cos"], st["sin"], cfg)
            if i in cfg["vace_layers"]:
                st["x"] = st["x"] + st["hints"][cfg["vace_layers"].index(i)]
        del blk
    return [unpatchify(head(rest, st["x"], st["temb"]), st["shape"], patch) for st in states]


def _gap(got, want) -> float:
    """||got - want|| / ||want||."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.to(want.device).float() - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def _flat(*ts):
    return torch.cat([t.float().flatten() for t in ts])


@torch.inference_mode()
def stage_gaps(cfg: dict, seed: int, jobs: list, device, rounding: str = "fp32") -> list:
    """Per job, the DiT's stages judged one at a time on the program's own
    input to each: a list of (stage, gap of the program, gap of the control
    or None), each the relative L2 gap to the float32 reference. A job is
    a dict of latents, control, text and sigma (what the program's forward
    got), v (its velocity), first (its x, c and text streams after their
    embedders), last (its stream before the head), and blocks / vace: for
    each judged main / branch block, the program's taps (``models.wan``'s
    ``wan_block``: mods, in, self, mid1, cross, mid2, ffn, out; a branch
    block's hint, the first's proj_in_in).

    The stages: "embed" (the three embedders), then per judged block
    "mod" (its six vectors from the timestep), "self" (the self-attention
    branch on the program's input to the block, with the reference's
    vectors), "cross" (on the program's stream after the self-attention),
    "ffn" (on the program's stream after the cross-attention), for the
    branch's first block "proj_in" and for each judged branch block "hint";
    then "head". With a control's `rounding`, the control runs beside the
    reference on the same inputs, and its gap to the reference is the
    control's."""
    dev = torch.device(device)
    spec = groups(WanDiT(cfg))
    patch = tuple(cfg["patch_size"])

    def load(group, module, prefix=""):
        ref = _load(module, seed, group, spec[group], dev, "fp32", prefix=prefix)
        if rounding == "fp32":
            return [ref]
        ctl = copy.deepcopy(ref)
        round_weights(ctl, rounding)
        return [ref, ctl]

    def judged(stage, prog, outs):
        return (stage, _gap(prog, outs[0]), _gap(outs[1], outs[0]) if len(outs) > 1 else None)

    def on(t):
        return t.to(dev).float()

    rests = load("rest", WanDiT(cfg, blocks=False))
    out, conds = [], []
    for job in jobs:
        shape = job["latents"].shape
        grid = (shape[1] // patch[0], shape[2] // patch[1], shape[3] // patch[2])
        cos, sin = (t.to(dev) for t in rope_tables(grid, cfg["attention_head_dim"]))
        cs = []
        for r in rests:
            temb = temb_of(r, job["sigma"], cfg, dev)
            cs.append(dict(temb=temb, e0=e0_of(r, temb), cos=cos, sin=sin))
        conds.append(cs)
        lat, ctl, text = on(job["latents"]), on(job["control"]), on(job["text"])
        out.append([judged("embed", _flat(*job["first"]), [
            _flat(embed_patches(r.patch_embed, lat, patch),
                  embed_patches(r.vace_patch_embed, ctl, patch), M.mlp_gelu(r.text_in, text))
            for r in rests])])
    judged_groups = sorted({(kind, i) for job in jobs for kind in ("vace", "blocks")
                            for i in job[kind]})
    for kind, i in judged_groups:
        group = f"{'vace_blocks' if kind == 'vace' else 'blocks'}.{i}"
        blks = load(group, _block_module(cfg, group), prefix=group + ".")
        tag = f"v{i}" if kind == "vace" else str(i)
        for job, row, cs in zip(jobs, out, conds):
            got = job[kind].get(i)
            if got is None:
                continue
            txt = on(job["first"][2])
            mods = [blk.modulation[None] + c["e0"] for blk, c in zip(blks, cs)]
            row.append(judged(f"mod.{tag}", got["mods"], mods))
            if kind == "vace" and i == 0:
                x0 = on(job["first"][0])
                row.append(judged("proj_in", got["in"], [
                    M.dense(blk.proj_in, on(got["proj_in_in"])) + x0 for blk in blks]))
            row.append(judged(f"self.{tag}", got["self"], [
                self_branch(blk, on(got["in"]), m, c["cos"], c["sin"], cfg)
                for blk, m, c in zip(blks, mods, cs)]))
            row.append(judged(f"cross.{tag}", got["cross"], [
                cross_branch(blk, on(got["mid1"]), txt, cfg) for blk in blks]))
            row.append(judged(f"ffn.{tag}", got["ffn"], [
                ffn_branch(blk, on(got["mid2"]), m) for blk, m in zip(blks, mods)]))
            if kind == "vace":
                row.append(judged(f"hint.{tag}", got["hint"], [
                    M.dense(blk.proj_out, on(got["out"])) for blk in blks]))
        del blks
    for job, row, cs in zip(jobs, out, conds):
        row.append(judged("head", job["v"], [
            unpatchify(head(r, on(job["last"]), c["temb"]), job["latents"].shape, patch)
            for r, c in zip(rests, cs)]))
    return out


def glue_ulps(job: dict, vace_layers) -> float:
    """The worst residual sum of a job's judged blocks, in bf16 last places
    at the largest of the sum and its terms: mid1 against in + gate self,
    mid2 against mid1 + cross, out against mid2 + gate2 ffn, and for a main
    block that takes a hint, hinted against out + the (judged) hint."""
    worst = 0.0

    def ulps(got, *terms):
        exact = sum(terms)
        top = exact.abs()
        for t in terms:
            top = torch.maximum(top, t.abs())
        _, e = torch.frexp(top)
        return float(((got.float() - exact).abs() / torch.ldexp(torch.ones_like(top), e - 8))
                     .max())

    for kind in ("blocks", "vace"):
        for i, got in job[kind].items():
            m = got["mods"].float()
            worst = max(worst,
                        ulps(got["mid1"], got["in"].float(),
                             m[:, 2][:, None] * got["self"].float()),
                        ulps(got["mid2"], got["mid1"].float(), got["cross"].float()),
                        ulps(got["out"], got["mid2"].float(),
                             m[:, 5][:, None] * got["ffn"].float()))
            if kind == "blocks" and "hinted" in got:
                hint = job["vace"][list(vace_layers).index(i)]["hint"].float()
                worst = max(worst, ulps(got["hinted"], got["out"].float(), hint))
    return worst


def schedule(steps: int, shift: float) -> np.ndarray:
    """Flow-matching sigmas linspace(1, 1/N, N) under the static shift
    s' = shift s / (1 + (shift - 1) s), then 0: steps + 1 float32 values."""
    s = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    return np.append(shift * s / (1.0 + (shift - 1.0) * s), 0.0).astype(np.float32)


def guide(v_cond, v_uncond, scale: float):
    """Classifier-free guidance v_u + s (v_c - v_u), float32."""
    c, u = v_cond.float(), v_uncond.float()
    return u + scale * (c - u)


def euler(x, v, sigma, sigma_next):
    return x.float() + (float(sigma_next) - float(sigma)) * v.float()


def mask_control(mask, frames_out: int, f: int = 8):
    """(T, H, W) pixel mask -> (1, T', H/f, W/f, f*f) float32: each f x f
    block's pixels as channels (row-major within the block), the frames
    picked by nearest-exact interpolation from T to T'."""
    t, h, w = mask.shape
    m = mask.reshape(t, h // f, f, w // f, f).permute(0, 1, 3, 2, 4).reshape(t, h // f, w // f,
                                                                           f * f)
    idx = [min(int(math.floor((j + 0.5) * t / frames_out)), t - 1) for j in range(frames_out)]
    return m[idx][None].float()
