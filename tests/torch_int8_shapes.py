"""The (K, N) of every ``weight_only`` linear the int8 serving configuration
makes: ``quantize_tree`` over the FLUX.1-Fill DiT and T5-XXL of
``h100_bench/configs/flux1-fill-dev-w8.json``, built on the meta device.
Shared by the int8 kernel's CPU tests and its tests on the card; imports
neither JAX nor the JAX package."""

import json
import os

import torch

from textflux_torch.config import FluxConfig, T5Config
from textflux_torch.io.quantize import QuantLinear, quantize_tree
from textflux_torch.models.t5 import T5Encoder
from textflux_torch.models.transformer import FluxTransformer

W8_CONFIG = os.path.join(os.path.dirname(__file__), "..", "h100_bench", "configs",
                         "flux1-fill-dev-w8.json")

# sorted by K, then N: the DiT's embedders (time / guidance 256, pooled 768,
# image 384, text 4096), its blocks and head (3072, 12288, 15360), T5's
# attention and gated MLP (4096, 10240)
W8_SHAPES = (
    (256, 3072), (384, 3072), (768, 3072), (3072, 64), (3072, 3072), (3072, 6144),
    (3072, 9216), (3072, 12288), (3072, 18432), (3072, 21504), (4096, 3072),
    (4096, 4096), (4096, 10240), (10240, 4096), (12288, 3072), (15360, 3072),
)

# token counts the kernel meets: the conditioning vector (1), its 30 steps of
# modulation at once, a ragged count, the text (T5 and the DiT's text stream),
# the edit canvases' image streams (704, 1,152) and joint sequences (1,216,
# 1,664)
W8_ROWS = (1, 30, 333, 512, 704, 1152, 1216, 1664)


def w8_config_shapes() -> set:
    """{(in, out)} of the quantised linears of the w8 configuration's DiT and
    T5, as the benchmark's serving loop builds them."""
    with open(W8_CONFIG) as f:
        cfg = json.load(f)
    fc, tc = cfg["flux"], cfg["t5"]
    flux = FluxTransformer(FluxConfig(
        in_channels=fc["in_channels"], out_channels=fc["out_channels"],
        num_double_layers=fc["num_layers"], num_single_layers=fc["num_single_layers"],
        num_heads=fc["num_attention_heads"], head_dim=fc["attention_head_dim"],
        joint_dim=fc["joint_attention_dim"], pooled_dim=fc["pooled_projection_dim"],
        guidance_embeds=fc["guidance_embeds"], axes_dims_rope=tuple(fc["axes_dims_rope"])),
        device="meta", dtype=torch.bfloat16)
    t5 = T5Encoder(T5Config(d_model=tc["d_model"], d_kv=tc["d_kv"], d_ff=tc["d_ff"],
                            num_layers=tc["num_layers"], num_heads=tc["num_heads"]),
                   device="meta", dtype=torch.bfloat16)
    shapes = set()
    for kind, module in (("flux", flux), ("t5", t5)):
        assert cfg["quantize"][kind] == "weight_only"
        quantize_tree(module, mode="weight_only")
        shapes |= {(m.in_features, m.out_features) for m in module.modules()
                   if isinstance(m, QuantLinear) and m.mode == "weight_only"}
    return shapes
