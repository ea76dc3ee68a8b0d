"""Model FLOPs and kernel bounds of the Qwen-Image cell, counted from shapes.

As ``flops``: a product of an (m, k) and a (k, n) matrix counts 2mkn; only
what the algorithm needs is counted: each linear once per token that passes
it, attention's QK^T and PV once over the heads (4 S^2 D bidirectional;
causal attention needs the S (S + 1) / 2 pairs at or below the diagonal),
no recompute; elementwise work is left out. Texts count at their own
lengths: the padding the program adds for its graphs is not work the
algorithm needs. Sizes come from the configuration's keys (the published
config.json names).
"""

from __future__ import annotations

from h100_bench.reference.qwen_text import TEMPLATE_DROP


def _dit_dims(cfg: dict) -> tuple:
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    return d, 4 * d, cfg["out_channels"] * cfg["patch_size"] ** 2


def modulation(cfg: dict) -> float:
    """The modulation vectors of one step: silu(temb) through each block's
    two (D, 6D) linears and the head's (D, 2D); with the timestep
    embedding's MLP. The program computes them once per step for both
    forwards."""
    d, _, _ = _dit_dims(cfg)
    return 2 * (256 * d + d * d) + cfg["num_layers"] * 2 * 2 * d * 6 * d + 2 * d * 2 * d


def dit_forward(cfg: dict, n_txt: int, n_img: int) -> float:
    """One forward of the DiT over n_txt text and n_img image tokens, its
    modulation vectors left out (``modulation``)."""
    d, m, out = _dit_dims(cfg)
    s = n_txt + n_img
    flops = 2 * n_img * cfg["in_channels"] * d + 2 * n_txt * cfg["joint_attention_dim"] * d
    block = 2 * s * (3 * d * d + d * d + 2 * d * m) + 4 * s * s * d
    return flops + cfg["num_layers"] * block + 2 * n_img * d * out


def qwen_encode(cfg: dict, seq: int) -> float:
    """The text encoder over `seq` tokens (causal)."""
    c = dict(cfg, **cfg.get("text_config", {}))
    d, ff = c["hidden_size"], c["intermediate_size"]
    nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // nh
    linears = 2 * seq * (d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * ff)
    attention = 2 * 2 * (seq * (seq + 1) // 2) * nh * hd
    return c["num_hidden_layers"] * (linears + attention)


def _conv(k, c_in, c_out, h, w):
    return 2 * k * k * c_in * c_out * h * w


def _res(c_in, c_out, h, w):
    return (_conv(3, c_in, c_out, h, w) + _conv(3, c_out, c_out, h, w)
            + (_conv(1, c_in, c_out, h, w) if c_in != c_out else 0))


def _mid(c, h, w):
    n = h * w
    return 2 * _res(c, c, h, w) + 2 * n * c * 4 * c + 4 * n * n * c


def wan_encode(cfg: dict, height: int, width: int) -> float:
    """The Wan VAE's encode of one frame, ``quant_conv`` included."""
    mult, nres = list(cfg["dim_mult"]), cfg["num_res_blocks"]
    dims = [cfg["base_dim"] * u for u in [1] + mult]
    h, w = height, width
    flops = _conv(3, 3, dims[0], h, w)
    for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
        for j in range(nres):
            flops += _res(c_in if j == 0 else c_out, c_out, h, w)
        if i != len(mult) - 1:
            h, w = h // 2, w // 2
            flops += _conv(3, c_out, c_out, h, w)
    z2 = 2 * cfg["z_dim"]
    return flops + _mid(dims[-1], h, w) + _conv(3, dims[-1], z2, h, w) + _conv(1, z2, z2, h, w)


def wan_decode(cfg: dict, height: int, width: int) -> float:
    """The Wan VAE's decode of one frame, ``post_quant_conv`` included."""
    mult, nres = list(cfg["dim_mult"]), cfg["num_res_blocks"]
    dims = [cfg["base_dim"] * u for u in [mult[-1]] + mult[::-1]]
    f = 2 ** (len(mult) - 1)
    h, w, z = height // f, width // f, cfg["z_dim"]
    flops = _conv(1, z, z, h, w) + _conv(3, z, dims[0], h, w) + _mid(dims[0], h, w)
    for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
        c_in = c_in // 2 if i > 0 else c_in
        for j in range(nres + 1):
            flops += _res(c_in if j == 0 else c_out, c_out, h, w)
        if i != len(mult) - 1:
            h, w = h * 2, w * 2
            flops += _conv(3, c_out, c_out // 2, h, w)
    return flops + _conv(3, dims[-1], 3, h, w)


def image_tokens(cfg: dict, height: int, width: int) -> int:
    """The DiT's image tokens of a canvas of height x width pixels."""
    f = 2 ** (len(cfg["wan_vae"]["dim_mult"]) - 1) * cfg["qwen_dit"]["patch_size"]
    return (height // f) * (width // f)


def edit_image(cfg: dict, height: int, width: int, steps: int, n_pos: int, n_neg: int) -> float:
    """All the model FLOPs of one edited image: the encoder over each
    templated prompt (its system prefix included: the encoder runs over
    it), the VAE encode of the canvas, `steps` steps of two DiT forwards
    (the prompt's n_pos and the negative's n_neg text tokens) and one set
    of modulation vectors, and the decode."""
    dit, n_img = cfg["qwen_dit"], image_tokens(cfg, height, width)
    enc = sum(qwen_encode(cfg["qwen_text"], TEMPLATE_DROP + n) for n in (n_pos, n_neg))
    step = dit_forward(dit, n_pos, n_img) + dit_forward(dit, n_neg, n_img) + modulation(dit)
    return (enc + wan_encode(cfg["wan_vae"], height, width) + steps * step
            + wan_decode(cfg["wan_vae"], height, width))


def fused_attention(cfg: dict, seq: int) -> tuple:
    """(FLOPs, bytes) of one fused norm + RoPE + attention call over a
    joint sequence of `seq` (batch 1, every key live): q, k, v read once
    and o written once in bf16, and the four folded float32 tables (per-row
    q and k norms of a double block): 4 * seq * D floats."""
    h, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    return 4 * h * seq * seq * hd, 4 * seq * h * hd * 2 + 4 * seq * hd * 4
