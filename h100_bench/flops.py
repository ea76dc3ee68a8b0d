"""Model FLOPs and kernel bounds, counted from shapes.

A product of an (m, k) and a (k, n) matrix counts 2mkn. Only what the
algorithm needs is counted: each linear once per token that passes it,
attention's QK^T and PV once (4 S^2 D over the heads), no recompute.
Elementwise work (norms, activations, RoPE, softmax) is left out. Sizes come
from the configuration files' keys (the published configs' names).
"""

from __future__ import annotations


def dit_step(cfg: dict, n_txt: int, n_img: int) -> float:
    """One forward of the MM-DiT over n_txt text and n_img image tokens,
    its modulation vectors included."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    m = int(d * cfg["mlp_ratio"])
    s = n_txt + n_img
    flops = 2 * n_img * cfg["in_channels"] * d + 2 * n_txt * cfg["joint_attention_dim"] * d
    flops += 2 * (256 * d + d * d) * (2 if cfg["guidance_embeds"] else 1)   # time, guidance
    flops += 2 * (cfg["pooled_projection_dim"] * d + d * d)                # pooled vector
    double = 2 * s * (3 * d * d + d * d + 2 * d * m) + 4 * s * s * d + 2 * 2 * d * 6 * d
    single = 2 * s * (d * (3 * d + m) + (d + m) * d) + 4 * s * s * d + 2 * d * 3 * d
    flops += cfg["num_layers"] * double + cfg["num_single_layers"] * single
    return flops + 2 * d * 2 * d + 2 * n_img * d * cfg["out_channels"]


def t5_encode(cfg: dict, seq: int) -> float:
    inner = cfg["num_heads"] * cfg["d_kv"]
    d = cfg["d_model"]
    per_layer = 2 * seq * (4 * d * inner + 3 * d * cfg["d_ff"]) + 4 * seq * seq * inner
    return cfg["num_layers"] * per_layer


def clip_encode(cfg: dict, seq: int) -> float:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    per_layer = 2 * seq * (4 * d * d + 2 * d * ff) + 4 * seq * seq * d
    return cfg["num_hidden_layers"] * per_layer


def _conv(k, c_in, c_out, h, w):
    return 2 * k * k * c_in * c_out * h * w


def _resnet(c_in, c_out, h, w):
    return (_conv(3, c_in, c_out, h, w) + _conv(3, c_out, c_out, h, w)
            + (_conv(1, c_in, c_out, h, w) if c_in != c_out else 0))


def _mid(c, h, w):
    n = h * w
    return 2 * _resnet(c, c, h, w) + 2 * n * c * c * 4 + 4 * n * n * c


def vae_encode(cfg: dict, height: int, width: int) -> float:
    ch, n = cfg["block_out_channels"], cfg["layers_per_block"]
    h, w = height, width
    flops = _conv(3, cfg["in_channels"], ch[0], h, w)
    c_prev = ch[0]
    for i, c in enumerate(ch):
        for j in range(n):
            flops += _resnet(c_prev if j == 0 else c, c, h, w)
        c_prev = c
        if i < len(ch) - 1:
            h, w = h // 2, w // 2
            flops += _conv(3, c, c, h, w)
    return flops + _mid(ch[-1], h, w) + _conv(3, ch[-1], 2 * cfg["latent_channels"], h, w)


def vae_decode(cfg: dict, height: int, width: int) -> float:
    rev, n = list(reversed(cfg["block_out_channels"])), cfg["layers_per_block"] + 1
    f = 2 ** (len(rev) - 1)
    h, w = height // f, width // f
    flops = _conv(3, cfg["latent_channels"], rev[0], h, w) + _mid(rev[0], h, w)
    c_prev = rev[0]
    for i, c in enumerate(rev):
        for j in range(n):
            flops += _resnet(c_prev if j == 0 else c, c, h, w)
        c_prev = c
        if i < len(rev) - 1:
            h, w = h * 2, w * 2
            flops += _conv(3, c, c, h, w)
    return flops + _conv(3, rev[-1], cfg["out_channels"], h, w)


def edit_tokens(cfg: dict, height: int, width: int) -> tuple:
    """(text tokens, image tokens) of a canvas of height x width pixels."""
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1) * 2
    return cfg["max_sequence_length"], (height // f) * (width // f)


def edit_image(cfg: dict, height: int, width: int, steps: int) -> float:
    """All the model FLOPs of one edited image: the text encoders, the VAE
    encode of the masked canvas, `steps` DiT forwards and the decode."""
    n_txt, n_img = edit_tokens(cfg, height, width)
    return (t5_encode(cfg["t5"], n_txt) + clip_encode(cfg["clip"], cfg["clip"]["max_position_embeddings"])
            + vae_encode(cfg["vae"], height, width) + steps * dit_step(cfg["flux"], n_txt, n_img)
            + vae_decode(cfg["vae"], height, width))


def fused_attention(cfg: dict, seq: int, double: bool) -> tuple:
    """(FLOPs, bytes) of one fused norm + RoPE + attention call over a joint
    sequence of `seq` (batch 1, every key live): q, k, v read once and o
    written once in bf16, the cos / sin tables in float32, and the q / k
    norm scales: per row in float32 in a double block, one row each in a
    single block."""
    h, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    flops = 4 * h * seq * seq * hd
    nbytes = 4 * seq * h * hd * 2 + 2 * seq * hd * 4 + (2 * seq * hd * 4 if double else 2 * hd * 4)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time: the larger of the operations and the bytes at peak."""
    return max(flops / peak["flops_per_s"], nbytes / peak["bytes_per_s"])
