"""The plain float32 reference of Qwen2.5-VL-7B-Instruct's language model as a text encoder.

Plain PyTorch, written from ``transformers``' ``Qwen2_5_VLTextModel`` in
the layout of the program's parameters: token embedding; per layer
x += o(attn(rmsnorm(x))), x += down(silu(gate(y)) * up(y)) with y =
rmsnorm(x); causal grouped-query attention (q/k/v bias, no o bias),
rotate-half RoPE at theta 1e6 over positions 0..L-1 (M-RoPE with equal
t/h/w ids, which a text prompt has); the final RMSNorm's output. float32,
TF32 off, an explicit softmax; layer by layer, each layer's weights drawn
again from the seed. Nothing here imports the program.

Departures from the published pipeline: the prompt's tokens are the UTF-8
bytes of the templated prompt (``byte_ids``; the repository ships no
tokenizer files), so the dropped system prefix is its byte length
(``TEMPLATE_DROP``) where Qwen's tokenizer drops 34 tokens; the vision
tower is not held (a text prompt never reaches it).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from h100_bench import weights
from h100_bench.reference import models as M

MODEL = "qwen_text"
TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, size, texture, "
    "quantity, text, spatial relationships of the objects and background:<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n")
TEMPLATE_DROP = len(TEMPLATE.split("{}")[0].encode("utf-8"))
MAX_TOKENS = 1024


def byte_ids(prompt: str) -> np.ndarray:
    """The templated prompt's UTF-8 bytes, (1, L) int64, at most
    TEMPLATE_DROP + MAX_TOKENS."""
    body = list(TEMPLATE.format(prompt).encode("utf-8"))[:TEMPLATE_DROP + MAX_TOKENS]
    return np.asarray(body, np.int64)[None]


class Layer(nn.Module):
    def __init__(self, d, nh, nkv, hd, ff):
        super().__init__()
        self.attn_norm, self.mlp_norm = M._vec(d), M._vec(d)
        self.q, self.k, self.v = M._lin(d, nh * hd), M._lin(d, nkv * hd), M._lin(d, nkv * hd)
        self.o = M._lin(nh * hd, d, False)
        self.gate, self.up = M._lin(d, ff, False), M._lin(d, ff, False)
        self.down = M._lin(ff, d, False)


class QwenText(nn.Module):
    def __init__(self, cfg: dict, layers: int = None):
        super().__init__()
        c = dict(cfg, **cfg.get("text_config", {}))
        self.cfg = c
        d = c["hidden_size"]
        self.embed_tokens = nn.Parameter(torch.empty(c["vocab_size"], d, device="meta"))
        self.layers = nn.ModuleList(self.layer() for _ in range(
            c["num_hidden_layers"] if layers is None else layers))
        self.final_norm = M._vec(d)

    def layer(self) -> Layer:
        c = self.cfg
        nh = c["num_attention_heads"]
        return Layer(c["hidden_size"], nh, c["num_key_value_heads"], c["hidden_size"] // nh,
                     c["intermediate_size"])


def rope(x, theta: float):
    """Rotate-half RoPE over positions 0..L-1 on (B, L, H, D), float64
    angles, float32 out."""
    d, n = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.outer(torch.arange(n, dtype=torch.float64, device=x.device), inv)
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().float()[None, :, None], ang.sin().float()[None, :, None]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rotated * sin


def layer_forward(p: Layer, h, cfg: dict):
    b, s, _ = h.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["hidden_size"] // nh, cfg["rms_norm_eps"]
    y = M.rms_norm(h, p.attn_norm, eps)
    q = rope(M.dense(p.q, y).reshape(b, s, nh, hd), cfg["rope_theta"])
    k = rope(M.dense(p.k, y).reshape(b, s, nkv, hd), cfg["rope_theta"])
    v = M.dense(p.v, y).reshape(b, s, nkv, hd)
    k, v = k.repeat_interleave(nh // nkv, 2), v.repeat_interleave(nh // nkv, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    logits = logits + torch.full((s, s), float("-inf"), device=h.device).triu(1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v).reshape(b, s, -1)
    h = h + M.dense(p.o, o)
    y = M.rms_norm(h, p.mlp_norm, eps)
    return h + M.dense(p.down, F.silu(M.dense(p.gate, y)) * M.dense(p.up, y))


def _load(module, seed, group, leaves, device, rounding, prefix=""):
    sd = {n[len(prefix):]: t.float()
          for n, t in weights.draw_group(seed, MODEL, group, leaves, device).items()}
    module.load_state_dict(sd, assign=True, strict=True)
    M.round_weights(module, rounding)
    return module


@torch.inference_mode()
def encode(cfg: dict, seed: int, prompts: list, device, rounding: str = "fp32") -> list:
    """Each prompt's embedding (1, L - TEMPLATE_DROP, hidden), float32:
    the final RMSNorm's output over the templated prompt, the system
    prefix dropped; layer by layer."""
    dev = torch.device(device)
    spec = weights.groups(QwenText(cfg))
    rest = _load(QwenText(cfg, layers=0), seed, "rest", spec["rest"], dev, rounding)
    c = rest.cfg
    hs = [rest.embed_tokens[torch.as_tensor(byte_ids(p), device=dev)] for p in prompts]
    for i in range(c["num_hidden_layers"]):
        group = f"layers.{i}"
        layer = _load(rest.layer(), seed, group, spec[group], dev, rounding, prefix=group + ".")
        hs = [layer_forward(layer, h, c) for h in hs]
        del layer
    return [M.rms_norm(h, rest.final_norm, c["rms_norm_eps"])[:, TEMPLATE_DROP:] for h in hs]
