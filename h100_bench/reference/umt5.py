"""The plain float32 reference of UMT5-XXL, Wan's text encoder.

Plain PyTorch, written from transformers' ``UMT5EncoderModel`` and Wan's
``T5Encoder(shared_pos=False)`` in the layout of the program's parameters
(``models.T5``'s names, with a relative-position bias in every layer
instead of one shared): pre-RMSNorm layers, bias-free projections,
unscaled logits plus the layer's own bucketed relative bias, gated
GELU-tanh MLPs, a final RMSNorm. As the published pipeline encodes a
prompt: its byte ids (``canvas.t5_ids``: the bytes + 3, EOS, zero padding
to 512) run with the attention mask over the whole 512, and the rows past
the prompt's own tokens (EOS included) are set to zero. Every product in
float32 with TF32 off; nothing here imports the program. Layer by layer:
each layer's weights are drawn again from the seed, widened to float32,
rounded for a control when asked, run for every prompt and freed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench import weights
from h100_bench.reference import canvas, models as M

MODEL = "umt5"
TEXT_LEN = 512


class Layer(M.T5Layer):
    def __init__(self, cfg: dict):
        super().__init__(cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"])
        self.rel_bias = nn.Parameter(torch.empty(cfg["relative_attention_num_buckets"],
                                                 cfg["num_heads"], device="meta"))


class UMT5(nn.Module):
    """The parameters' names and shapes (on the meta device)."""

    def __init__(self, cfg: dict, layers: int = None):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(cfg["vocab_size"], cfg["d_model"],
                                                  device="meta"))
        n = cfg["num_layers"] if layers is None else layers
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(n))
        self.final_norm = M._vec(cfg["d_model"])


def layer_forward(p: Layer, h, keep, buckets, cfg: dict):
    """One layer over h (B, S, d) with key mask `keep` (B, S)."""
    b, s, _ = h.shape
    nh, eps = cfg["num_heads"], cfg["layer_norm_epsilon"]
    bias = p.rel_bias[buckets].permute(2, 0, 1)[None]
    bias = bias.masked_fill(~keep[:, None, None, :], torch.finfo(torch.float32).min)
    y = M.rms_norm(h, p.attn_norm, eps)
    q, k, v = (M.dense(lin, y).reshape(b, s, nh, -1) for lin in (p.q, p.k, p.v))
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) + bias, dim=-1)
    h = h + M.dense(p.o, torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1))
    y = M.rms_norm(h, p.mlp_norm, eps)
    return h + M.dense(p.wo, F.gelu(M.dense(p.wi_0, y), approximate="tanh") * M.dense(p.wi_1, y))


def _load(module, seed, group, leaves, device, rounding, prefix=""):
    sd = {n[len(prefix):]: t.float()
          for n, t in weights.draw_group(seed, MODEL, group, leaves, device).items()}
    module.load_state_dict(sd, assign=True, strict=True)
    module.requires_grad_(False)
    M.round_weights(module, rounding)
    return module


@torch.inference_mode()
def encode(cfg: dict, seed: int, prompts: list, device, rounding: str = "fp32") -> list:
    """Each prompt's embedding (1, 512, d_model), float32, zero past its
    own tokens (module docstring)."""
    dev = torch.device(device)
    spec = weights.groups(UMT5(cfg))
    rest = _load(UMT5(cfg, layers=0), seed, "rest", spec["rest"], dev, rounding)
    ids = [torch.as_tensor(canvas.t5_ids(p, TEXT_LEN), device=dev) for p in prompts]
    keeps = [i > 0 for i in ids]     # the prompt's bytes and EOS; 0 is the padding
    buckets = M.t5_buckets(TEXT_LEN, cfg["relative_attention_num_buckets"],
                           cfg["relative_attention_max_distance"], dev)
    hs = [rest.embedding[i] for i in ids]
    for i in range(cfg["num_layers"]):
        group = f"layers.{i}"
        layer = _load(Layer(cfg), seed, group, spec[group], dev, rounding, prefix=group + ".")
        hs = [layer_forward(layer, h, keep, buckets, cfg) for h, keep in zip(hs, keeps)]
        del layer
    return [M.rms_norm(h, rest.final_norm, cfg["layer_norm_epsilon"]) * keep[..., None]
            for h, keep in zip(hs, keeps)]
