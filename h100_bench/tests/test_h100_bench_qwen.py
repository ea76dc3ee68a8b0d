"""The Qwen-Image cell's pieces on the CPU: its traffic by seed, the FLOP
counts of ``flops_qwen`` by hand and against PyTorch's own counter, and a
whole run of the tiny Qwen-Image cell under ``tiny_qwen/``: sound, it comes
out correct; with a fault planted in the timed path (guidance without its
norm rescale, the text's padding left unmasked, the blend skipped for one
step, a velocity altered, a block's update added twice, a serving call
that returns other than the eager forward) or the e4m3 control in the
program's place, it does not."""

import argparse
import filecmp
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import flops, flops_qwen, harness, requests

MIX = harness.load_json(harness.BENCH, "mixes", "edit-1024-cfg.json")
CFG = harness.load_json(harness.BENCH, "configs", "qwen-image.json")
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny_qwen")


def tiny_cell(**limits):
    workload = harness.load_json(TINY, "workload.json")
    workload["limits"] = dict(workload["limits"], **limits)
    e2e = harness.load_json(harness.ROOT, "BENCHMARK.json")["end_to_end"]
    return harness.assemble("tiny_qwen", workload, 1, harness.load_json(TINY, "config.json"),
                            harness.load_json(TINY, "mix.json"),
                            [dict(m, workloads=["tiny_qwen"]) for m in e2e], [])


def tiny_args(seed=2 ** 31 + 7, seconds=0.05):
    return argparse.Namespace(workload="tiny_qwen", seed=seed, seconds=seconds, trace=0)


def test_the_configuration_is_uncut():
    """Published widths at full depth: 60 double blocks of 24 x 128 heads,
    28 encoder layers at 3,584, the VAE at base 96 with dim_mult 1, 2, 4, 4;
    and the BENCHMARK.json entry that names the file."""
    entry = next(c for c in harness.load_json(harness.ROOT, "BENCHMARK.json")["configs"]
                 if c["name"] == "qwen-image")
    assert entry["file"] == "h100_bench/configs/qwen-image.json"
    assert CFG["reduced"] == entry["reduced"] == [] and CFG["source"] == entry["source"]
    dit, text, vae = CFG["qwen_dit"], CFG["qwen_text"], CFG["wan_vae"]
    assert (dit["num_layers"], dit["num_attention_heads"], dit["attention_head_dim"],
            dit["joint_attention_dim"], dit["in_channels"]) == (60, 24, 128, 3584, 64)
    assert (text["num_hidden_layers"], text["hidden_size"], text["intermediate_size"],
            text["num_key_value_heads"], text["vocab_size"]) == (28, 3584, 18944, 4, 152064)
    assert (vae["base_dim"], vae["dim_mult"], vae["num_res_blocks"], vae["z_dim"]) == \
        (96, [1, 2, 4, 4], 2, 16)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def test_the_cycle_of_canvas_shapes():
    from h100_bench.drivers.serve_qwen_closed_loop import canvas_hw

    sizes = [requests.scene_size(MIX, i) for i in range(8)]
    assert sizes[:4] == [(1024, 576), (768, 1024), (1024, 768), (1024, 1024)]
    assert sizes[4:] == sizes[:4]
    tokens = [flops_qwen.image_tokens(CFG, *canvas_hw(s)) for s in sizes[:4]]
    assert tokens == [2944, 3360, 3712, 4736]


def test_same_seed_same_requests_other_seed_other_content(tmp_path):
    mix = dict(MIX, pool=4)
    a = requests.make_pool(mix, 2 ** 33 + 5, str(tmp_path / "a"))
    b = requests.make_pool(mix, 2 ** 33 + 5, str(tmp_path / "b"))
    c = requests.make_pool(mix, 17, str(tmp_path / "c"))
    for x, y in zip(a, b):
        assert (x.words, x.noise_seed, x.size) == (y.words, y.noise_seed, y.size)
        assert filecmp.cmp(x.scene, y.scene, shallow=False)
    assert [x.size for x in a] == [x.size for x in c]
    assert [x.words for x in a] != [x.words for x in c]


def test_text_lengths_fill_one_bucket_each():
    """Every prompt of the mix (1-4 words of 3-9 letters) is 320-410 byte
    tokens, bucket 512; the negative is 34, bucket 64."""
    from h100_bench.drivers.serve_qwen_closed_loop import text_lengths

    short, long = text_lengths(("abc",)), text_lengths(("abcdefghi",) * 4)
    assert short == (320, 34) and long == (410, 34)


# ---------------------------------------------------------------------------
# FLOP counts
# ---------------------------------------------------------------------------

TINY_DIT = {"attention_head_dim": 16, "num_attention_heads": 2, "in_channels": 64,
            "joint_attention_dim": 32, "num_layers": 2, "out_channels": 16, "patch_size": 2}


def test_dit_forward_by_hand():
    # d 32, mlp 128, 7 tokens: embedders, two blocks, the head
    assert flops_qwen.dit_forward(TINY_DIT, 3, 4) == (
        2 * 4 * 64 * 32 + 2 * 3 * 32 * 32
        + 2 * (2 * 7 * (3 * 32 * 32 + 32 * 32 + 2 * 32 * 128) + 4 * 7 * 7 * 32)
        + 2 * 4 * 32 * 64)
    assert flops_qwen.modulation(TINY_DIT) == (2 * (256 * 32 + 32 * 32) + 2 * 2 * 2 * 32 * 192
                                               + 2 * 32 * 64)
    # full size: 13.6 GFLOP a token a forward in the blocks
    full = CFG["qwen_dit"]
    per_token = 60 * 2 * (4 * 3072 ** 2 + 2 * 3072 * 12288)
    assert per_token == pytest.approx(13.6e9, rel=0.01)
    assert flops_qwen.dit_forward(full, 0, 1) > per_token


def test_qwen_encode_by_hand():
    text = {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 2, "num_hidden_layers": 2}
    # q 32x32, k and v 32x16, o 32x32, three 32x64; causal: 15 of 25 pairs
    assert flops_qwen.qwen_encode(text, 5) == 2 * (
        2 * 5 * (32 * 32 + 2 * 32 * 16 + 32 * 32 + 3 * 32 * 64) + 2 * 2 * 15 * 4 * 8)


def test_fused_attention_by_hand():
    f, b = flops_qwen.fused_attention(TINY_DIT, 10)
    assert f == 4 * 2 * 10 * 10 * 16
    assert b == 4 * 10 * 2 * 16 * 2 + 4 * 10 * 16 * 4
    assert flops.bound_s(f, b, CFG["peak"]) == max(f / 989e12, b / 3.35e12)


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args, **kw)
    return counter.get_total_flops()


def test_counts_match_what_pytorch_counts():
    """The program's DiT forward (plain attention over every pair) and its
    Wan encode and decode, as ``FlopCounterMode`` counts their products."""
    from textflux_torch.config import QwenImageConfig, WanVAEConfig
    from textflux_torch.models import transformer as T
    from textflux_torch.models.qwen_image import (QwenImageTransformer, model_timesteps,
                                                  qwen_apply, qwen_vec, rope_ids)
    from textflux_torch.models.vae_wan import WanVAE, wan_decode, wan_encode
    from textflux_torch.ops.rope import rope_tables

    cfg = QwenImageConfig(num_double_layers=2, num_heads=2, head_dim=16, joint_dim=32,
                          axes_dims_rope=(4, 6, 6))
    dit = QwenImageTransformer(cfg, device="cpu")
    mods = T.flux_mods(dit, qwen_vec(dit, model_timesteps([0.5]), torch.float32))
    cos, sin = (torch.as_tensor(t) for t in rope_tables(rope_ids(2, 3, 5), (4, 6, 6)))
    got = _counted(qwen_apply, dit, torch.randn(1, 6, 64), torch.randn(1, 5, 32), cos, sin,
                   mods=mods)
    assert got == flops_qwen.dit_forward(TINY_DIT, 5, 6)
    vae_cfg = {"base_dim": 8, "dim_mult": [1, 2, 2, 2], "num_res_blocks": 1, "z_dim": 16}
    vae = WanVAE(WanVAEConfig(base_dim=8, dim_mult=(1, 2, 2, 2), num_res_blocks=1),
                 device="cpu")
    img = torch.rand(1, 48, 32, 3)
    assert _counted(wan_encode, vae, img) == flops_qwen.wan_encode(vae_cfg, 48, 32)
    assert _counted(wan_decode, vae, torch.randn(1, 6, 4, 16)) == \
        flops_qwen.wan_decode(vae_cfg, 48, 32)


def test_edit_image_adds_its_parts():
    h, w, steps, n_pos, n_neg = 1184, 1024, 30, 350, 34
    dit, n_img = CFG["qwen_dit"], flops_qwen.image_tokens(CFG, h, w)
    want = (flops_qwen.qwen_encode(CFG["qwen_text"], 180 + n_pos)
            + flops_qwen.qwen_encode(CFG["qwen_text"], 180 + n_neg)
            + flops_qwen.wan_encode(CFG["wan_vae"], h, w)
            + steps * (flops_qwen.dit_forward(dit, n_pos, n_img)
                       + flops_qwen.dit_forward(dit, n_neg, n_img) + flops_qwen.modulation(dit))
            + flops_qwen.wan_decode(CFG["wan_vae"], h, w))
    assert flops_qwen.edit_image(CFG, h, w, steps, n_pos, n_neg) == want
    # two forwards a step, over the cycle's mean canvas (3,688 image tokens):
    # 1.2-1.4e14 FLOPs; on the 1:1 canvas (4,736) 1.7e14
    mean = sum(flops_qwen.dit_forward(dit, n_pos, n) + flops_qwen.dit_forward(dit, n_neg, n)
               for n in (2944, 3360, 3712, 4736)) / 4
    assert 1.2e14 < mean < 1.4e14
    assert 1.6e14 < want / steps < 1.8e14


# ---------------------------------------------------------------------------
# a whole run of the tiny cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_module():
    return harness.load_module(os.path.join(harness.BENCH, "run.py"), "h100_bench_run")


def test_sound_run_is_correct(run_module):
    line, code, checks = run_module.run_cell(tiny_cell(), tiny_args(), "cpu")
    assert code == 0 and '"correct": true' in line, checks


def _no_rescale(monkeypatch):
    from textflux_torch.ops import samplers

    monkeypatch.setattr(samplers, "true_cfg", lambda c, u, s: (u.float() + s * (
        c.float() - u.float())).to(c.dtype))


def _pad_unmasked(monkeypatch):
    from textflux_torch.pipeline.qwen_image import QwenImagePipeline

    inner = QwenImagePipeline._texts

    def texts(self, *a):
        return [(t, c, s, torch.full_like(kv, c.shape[0])) for t, c, s, kv in inner(self, *a)]

    monkeypatch.setattr(QwenImagePipeline, "_texts", texts)


def _blend_skipped(monkeypatch):
    from textflux_torch.pipeline.qwen_image import QwenImagePipeline

    inner = QwenImagePipeline._denoise_step

    def step(self, lat, *a, step=0, **kw):
        if step != 1:
            return inner(self, lat, *a, step=step, **kw)
        self._blend = lambda x, *rest: x
        try:
            return inner(self, lat, *a, step=step, **kw)
        finally:
            del self._blend

    monkeypatch.setattr(QwenImagePipeline, "_denoise_step", step)


def _velocity_off(monkeypatch):
    import textflux_torch.pipeline.qwen_image as pipeline

    inner = pipeline.qwen_apply
    monkeypatch.setattr(pipeline, "qwen_apply", lambda *a, **k: inner(*a, **k) * 1.1)


def _residual_off(monkeypatch):
    from textflux_torch.models import transformer

    inner = transformer.double_block

    def block(blk, cfg, txt, img, *a, **kw):
        txt_out, img_out = inner(blk, cfg, txt, img, *a, **kw)
        return txt_out, img_out + (img_out - img)     # the image's update added twice

    monkeypatch.setattr(transformer, "double_block", block)


def _replay_off(monkeypatch):
    """The serving call returns other than the eager forward does (as a
    graph that replays stale work would)."""
    from textflux_torch.models.qwen_image import QwenImageTransformer

    inner = QwenImageTransformer.forward
    monkeypatch.setattr(QwenImageTransformer, "forward",
                        lambda self, *a, **kw: inner(self, *a, **kw) * 1.01)


@pytest.mark.parametrize("fault", [_no_rescale, _pad_unmasked, _blend_skipped, _velocity_off,
                                   _residual_off, _replay_off],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(run_module, monkeypatch, fault):
    fault(monkeypatch)
    line, code, checks = run_module.run_cell(tiny_cell(), tiny_args(), "cpu")
    assert code == 0 and '"correct": false' in line
    assert any(c["value"] > c["limit"] for c in checks)


def test_control_is_not_correct(run_module):
    cell = tiny_cell()
    out, code, _ = run_module.run_cell(cell, tiny_args(), "cpu", control=True)
    assert code == 0
    program, control = out["numbers"]["program"], out["numbers"]["control"]
    limits = cell["limits"]
    assert all(program[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits), control
