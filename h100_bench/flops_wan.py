"""Model FLOPs and kernel bounds of the Wan2.1-VACE cell, counted from shapes.

As ``flops``: a product of an (m, k) and a (k, n) matrix counts 2mkn; only
what the algorithm needs is counted: each linear once per token that
passes it, attention's QK^T and PV once over the heads (4 Sq Sk D), no
recompute; elementwise work is left out. The text counts at its 512 rows:
the published model embeds and attends to all of them. A causal 3-D
convolution counts its k_t x k x k taps at every output voxel (the zero
frames before frame 0 included, as the published chunks compute them).
Sizes come from the configuration's keys (the published config.json
names).
"""

from __future__ import annotations

from h100_bench.reference.umt5 import TEXT_LEN


def _dims(cfg: dict) -> tuple:
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    p = cfg["patch_size"]
    return d, cfg["ffn_dim"], p[0] * p[1] * p[2]


def video_tokens(cfg: dict, frames: int, height: int, width: int) -> int:
    """The DiT's video tokens of a clip of `frames` canvases of height x
    width pixels."""
    p = cfg["wan_dit"]["patch_size"]
    f = 2 ** (len(cfg["wan_vae"]["dim_mult"]) - 1)
    t_lat = 1 + (frames - 1) // 4
    return (t_lat // p[0]) * (height // f // p[1]) * (width // f // p[2])


def modulation(cfg: dict) -> float:
    """One step's timestep MLP and ``time_proj`` (the tables are added)."""
    d, _, _ = _dims(cfg)
    return 2 * (cfg["freq_dim"] * d + d * d) + 2 * d * 6 * d


def block(cfg: dict, s: int, l: int) -> float:
    """One block over s video tokens and l text rows: self-attention's
    q|k|v and o, the attention, the cross-attention's q, o and k|v of the
    text, its attention, the FFN."""
    d, ff, _ = _dims(cfg)
    return (2 * s * 4 * d * d + 4 * s * s * d + 2 * s * 2 * d * d + 2 * l * 2 * d * d
            + 4 * s * l * d + 2 * s * 2 * d * ff)


def dit_forward(cfg: dict, s: int, l: int = TEXT_LEN) -> float:
    """One forward of the DiT with its VACE branch, the modulation left out
    (``modulation``)."""
    d, _, patch = _dims(cfg)
    nv = len(cfg["vace_layers"])
    embed = (2 * s * cfg["in_channels"] * patch * d + 2 * s * cfg["vace_in_channels"] * patch * d
             + 2 * l * (cfg["text_dim"] * d + d * d))
    branch = 2 * s * d * d * (1 + nv)      # proj_in, and each block's proj_out
    head = 2 * s * d * cfg["out_channels"] * patch
    return embed + (cfg["num_layers"] + nv) * block(cfg, s, l) + branch + head


def umt5_encode(cfg: dict, seq: int = TEXT_LEN) -> float:
    """UMT5 over `seq` ids (the padded 512: the published encoder runs them)."""
    d, ff, inner = cfg["d_model"], cfg["d_ff"], cfg["num_heads"] * cfg["d_kv"]
    linears = 2 * seq * (4 * d * inner + 3 * d * ff)
    return cfg["num_layers"] * (linears + 4 * seq * seq * inner)


def _conv(kt, k, c_in, c_out, t, h, w):
    return 2 * kt * k * k * c_in * c_out * t * h * w


def _res(c_in, c_out, t, h, w):
    return (_conv(3, 3, c_in, c_out, t, h, w) + _conv(3, 3, c_out, c_out, t, h, w)
            + (_conv(1, 1, c_in, c_out, t, h, w) if c_in != c_out else 0))


def _mid(c, t, h, w):
    n = h * w
    return 2 * _res(c, c, t, h, w) + t * (2 * n * c * 4 * c + 4 * n * n * c)


def vae_encode(cfg: dict, frames: int, height: int, width: int) -> float:
    """The Wan VAE's encode of a clip, ``quant_conv`` included."""
    mult, nres = list(cfg["dim_mult"]), cfg["num_res_blocks"]
    tdown = list(cfg["temperal_downsample"])
    dims = [cfg["base_dim"] * u for u in [1] + mult]
    t, h, w = frames, height, width
    flops = _conv(3, 3, 3, dims[0], t, h, w)
    for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
        for j in range(nres):
            flops += _res(c_in if j == 0 else c_out, c_out, t, h, w)
        if i != len(mult) - 1:
            h, w = h // 2, w // 2
            flops += _conv(1, 3, c_out, c_out, t, h, w)
            if tdown[i]:
                t_next = 1 + (t - 1) // 2
                flops += _conv(3, 1, c_out, c_out, t_next - 1, h, w)
                t = t_next
    z2 = 2 * cfg["z_dim"]
    return (flops + _mid(dims[-1], t, h, w) + _conv(3, 3, dims[-1], z2, t, h, w)
            + _conv(1, 1, z2, z2, t, h, w))


def vae_decode(cfg: dict, frames: int, height: int, width: int) -> float:
    """The Wan VAE's decode of a clip's latents, ``post_quant_conv``
    included; `frames`, `height`, `width` of the decoded clip."""
    mult, nres = list(cfg["dim_mult"]), cfg["num_res_blocks"]
    tup = list(cfg["temperal_downsample"])[::-1]
    dims = [cfg["base_dim"] * u for u in [mult[-1]] + mult[::-1]]
    f = 2 ** (len(mult) - 1)
    t, h, w, z = 1 + (frames - 1) // 4, height // f, width // f, cfg["z_dim"]
    flops = (_conv(1, 1, z, z, t, h, w) + _conv(3, 3, z, dims[0], t, h, w)
             + _mid(dims[0], t, h, w))
    for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
        c_in = c_in // 2 if i > 0 else c_in
        for j in range(nres + 1):
            flops += _res(c_in if j == 0 else c_out, c_out, t, h, w)
        if i != len(mult) - 1:
            if tup[i]:
                flops += _conv(3, 1, c_out, 2 * c_out, t - 1, h, w)
                t = 1 + 2 * (t - 1)
            h, w = h * 2, w * 2
            flops += _conv(1, 3, c_out, c_out // 2, t, h, w)
    return flops + _conv(3, 3, dims[-1], 3, t, h, w)


def edit_clip(cfg: dict, frames: int, height: int, width: int, steps: int) -> float:
    """All the model FLOPs of one edited clip: UMT5 over the prompt and the
    negative prompt, two clip encodes (inactive, reactive), `steps` steps
    of two DiT forwards and one set of modulation vectors, the decode."""
    dit, vae = cfg["wan_dit"], cfg["wan_vae"]
    s = video_tokens(cfg, frames, height, width)
    step = 2 * dit_forward(dit, s) + modulation(dit)
    return (2 * umt5_encode(cfg["umt5"]) + 2 * vae_encode(vae, frames, height, width)
            + steps * step + vae_decode(vae, frames, height, width))


def self_attention(cfg: dict, s: int) -> tuple:
    """(FLOPs, bytes) of one self-attention call (the across-heads prep and
    the mainloop) over s tokens: q, k, v read once and o written once in
    bf16, the two (H*D,) float32 norm weights and the two (S, D) float32
    RoPE tables."""
    h, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    return 4 * h * s * s * hd, 4 * s * h * hd * 2 + 2 * h * hd * 4 + 2 * s * hd * 4


def cross_attention(cfg: dict, s: int, l: int = TEXT_LEN) -> tuple:
    """(FLOPs, bytes) of one cross-attention call: q (s rows) and o read
    and written once, k and v (l rows) read once, in bf16, and the two
    norm weights."""
    h, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    return 4 * h * s * l * hd, (2 * s + 2 * l) * h * hd * 2 + 2 * h * hd * 4


# profiler names of the two launches of each attention form: prep, mainloop
SELF_KERNELS = ("norm_across_heads_kernel<true>", "flash_fwd_sm90_kernel")
CROSS_KERNELS = ("norm_across_heads_kernel<false>", "flash_fwd_cross_sm90_kernel")
MIN_SEEN = 0.95     # the profiler may drop a few records (a profiled count is a floor)


def attention_share(data: dict, kernels, cost) -> float:
    """The share (%) of an attention form's roofline in the profiled clip:
    the bound of every call (``flops.bound_s`` of ``cost(cfg, seq)``, two
    forwards a step, one call a block of either stack) over the device
    time of its `kernels`, as the profiler timed them. Where the profiler
    dropped records, each kernel's time is its mean over the calls seen
    times the calls made; None where it saw under MIN_SEEN of them, or
    there is no profile."""
    from h100_bench import flops

    trace = data.get("trace") or {}
    if not trace.get("kernels") or not trace.get("clips"):
        return None
    dit = data["cfg"]["wan_dit"]
    blocks = dit["num_layers"] + len(dit["vace_layers"])
    bound, calls = 0.0, 0
    for clip in trace["clips"]:
        n = clip["steps"] * 2 * blocks
        bound += n * flops.bound_s(*cost(dit, clip["seq"]), data["cfg"]["peak"])
        calls += n
    seconds = 0.0
    for kernel in kernels:
        hits = [v for name, v in trace["kernels"].items() if kernel in name]
        seen = sum(c for c, _ in hits)
        if seen < MIN_SEEN * calls or seen > calls:
            return None
        seconds += sum(s for _, s in hits) * calls / seen
    return 100.0 * bound / seconds if seconds > 0 else None
