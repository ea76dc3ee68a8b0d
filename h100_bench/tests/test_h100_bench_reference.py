"""The frozen reference against the program at a tiny width on the CPU, both
in float32 on the same seeded weights: they are two writings of one
architecture, so they agree to float32 rounding."""

import os

import numpy as np
import pytest
import torch

from h100_bench import weights
from h100_bench.reference import canvas, models as M
from h100_bench.reference.serve_check import build

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
CFG = __import__("json").load(open(os.path.join(TINY, "config.json")))
SEED = 2 ** 31 + 99


def program(kind):
    from textflux_torch.io import config_io
    from textflux_torch.models.clip import CLIPTextModel
    from textflux_torch.models.t5 import T5Encoder
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE

    cls, read, sub = {"flux": (FluxTransformer, config_io.flux_config_from, "transformer"),
                      "vae": (FluxVAE, config_io.vae_config_from, "vae"),
                      "clip": (CLIPTextModel, config_io.clip_config_from, "text_encoder"),
                      "t5": (T5Encoder, config_io.t5_config_from, "text_encoder_2")}[kind]
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, sub))
        json.dump(CFG[kind], open(os.path.join(d, sub, "config.json"), "w"))
        module = cls(read(os.path.join(d, sub)), device="meta", dtype=torch.float32)
    spec = weights.groups(M.MODELS[kind](CFG[kind]))
    module.load_state_dict(weights.state_dict(SEED, kind, spec, "cpu", torch.float32),
                           assign=True, strict=True)
    return module


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_same_names_same_weights():
    for kind in M.MODELS:
        ref = build(kind, CFG[kind], SEED, "cpu")
        prog = dict(program(kind).named_parameters())
        for name, p in ref.named_parameters():
            assert torch.equal(prog[name], p), name


@torch.inference_mode()
def test_text_encoders_agree():
    from textflux_torch.models.clip import clip_encode
    from textflux_torch.models.t5 import t5_encode

    clip_p, t5_p = canvas.prompts(["Hello world"])
    ids = torch.as_tensor(canvas.t5_ids(t5_p, 64))
    assert rel(t5_encode(program("t5"), ids), M.t5_encode(build("t5", CFG["t5"], SEED, "cpu"),
                                                          ids)) < 1e-5
    ids = torch.as_tensor(canvas.clip_ids(clip_p))
    _, pooled = clip_encode(program("clip"), ids)
    assert rel(pooled, M.clip_pooled(build("clip", CFG["clip"], SEED, "cpu"), ids)) < 1e-5


@torch.inference_mode()
def test_vae_agrees():
    from textflux_torch.models.vae import vae_decode, vae_encode_moments

    g = torch.Generator().manual_seed(0)
    img = torch.rand(1, 32, 48, 3, generator=g) * 2 - 1
    ref = build("vae", CFG["vae"], SEED, "cpu")
    prog = program("vae")
    for a, b in zip(vae_encode_moments(prog, img), M.vae_moments(ref, img)):
        assert rel(a, b) < 1e-5
    z = torch.randn(1, 16, 24, 4, generator=g)
    assert rel(vae_decode(prog, z), M.vae_decode(ref, z)) < 1e-5


@pytest.mark.parametrize("sigma", [1.0, 0.61, 0.05])
@torch.inference_mode()
def test_dit_velocity_agrees(sigma):
    from textflux_torch.models.transformer import flux_apply
    from textflux_torch.ops import packing
    from textflux_torch.ops.rope import rope_tables

    g = torch.Generator().manual_seed(1)
    lat_h, lat_w, n_txt = 8, 12, 10
    t_img = (lat_h // 2) * (lat_w // 2)
    tokens = torch.randn(1, t_img, 48, generator=g)
    txt = torch.randn(1, n_txt, 32, generator=g)
    pooled = torch.randn(1, 32, generator=g)
    ids = np.concatenate([packing.text_ids(n_txt), packing.latent_image_ids(lat_h, lat_w)])
    cos, sin = (torch.as_tensor(t) for t in rope_tables(ids, (4, 6, 6)))
    # the pipeline hands the timestep over in the model dtype (bf16), which
    # scales it there; the reference does the same
    t = torch.tensor([sigma]).to(torch.bfloat16)
    v = flux_apply(program("flux"), tokens, txt, pooled, t, torch.tensor([30.0]), cos, sin)
    ref = M.flux_velocity(build("flux", CFG["flux"], SEED, "cpu"), tokens, txt, pooled, sigma,
                          30.0, lat_h, lat_w)
    assert rel(v, ref) < 1e-5


def test_weight_only_int8_codes_agree():
    from textflux_torch.io.quantize import QuantLinear

    g = torch.Generator().manual_seed(2)
    lin = torch.nn.Linear(64, 32)
    lin.weight.data = torch.randn(32, 64, generator=g)
    q = QuantLinear.from_linear(lin, "weight_only")
    assert torch.allclose(q.dequantize(torch.float32), M.quantize_rows(lin.weight.data, 127),
                          rtol=0, atol=1e-7)


def test_schedule_agrees():
    from textflux_torch.ops.samplers import make_schedule

    for t_img in (704, 816, 896, 1152, 3712):
        assert np.array_equal(make_schedule(30, t_img), M.make_schedule(30, t_img))


def test_canvas_agrees(tmp_path):
    from PIL import Image

    from textflux_torch.cli.run_inference import render_conditioning
    from textflux_torch.pipeline.image_processor import (preprocess_image, preprocess_mask,
                                                         snap_to_multiple)

    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (288, 512, 3), dtype=np.uint8)).save(tmp_path / "s.png")
    m = np.zeros((288, 512, 3), np.uint8)
    m[100:200, 50:300] = 255
    Image.fromarray(m).save(tmp_path / "m.png")
    words = ["Hello there"]
    orig = Image.open(tmp_path / "s.png").convert("RGB")
    mask = Image.open(tmp_path / "m.png").convert("RGB")
    combined, cmask, _, _ = render_conditioning(orig, mask, words)
    w, h = snap_to_multiple(*combined.size)
    img, msk, (hh, ww) = canvas.conditioning(str(tmp_path / "s.png"), str(tmp_path / "m.png"),
                                             words)
    assert (hh, ww) == (h, w)
    assert np.array_equal(img, preprocess_image(combined.resize((w, h)), h, w))
    assert np.array_equal(msk, preprocess_mask(cmask.resize((w, h)), h, w))
