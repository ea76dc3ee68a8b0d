"""flops.py against counts made by hand from the published widths."""

import pytest

from h100_bench import flops, harness

CFG = harness.load_json(harness.BENCH, "configs", "flux1-fill-dev.json")
D, M = 3072, 12288


def hand_dit(n_txt, n_img):
    s = n_txt + n_img
    per_token = 19 * 2 * (3 * D * D + D * D + 2 * D * M) + 38 * 2 * (D * (3 * D + M) + (D + M) * D)
    attention = 57 * 4 * s * s * D
    mods = 19 * 2 * 2 * 6 * D * D + 38 * 2 * 3 * D * D + 2 * 2 * D * D
    embed = (2 * n_img * 384 * D + 2 * n_txt * 4096 * D + 2 * 2 * (256 * D + D * D)
             + 2 * (768 * D + D * D) + 2 * n_img * D * 64)
    return s * per_token + attention + mods + embed


@pytest.mark.parametrize("canvas,joint", [((352, 512), 1216), ((544, 384), 1328),
                                          ((448, 512), 1408), ((576, 512), 1664)])
def test_dit_step_at_the_four_canvases(canvas, joint):
    n_txt, n_img = flops.edit_tokens(CFG, *canvas)
    assert n_txt + n_img == joint
    assert flops.dit_step(CFG["flux"], n_txt, n_img) == hand_dit(n_txt, n_img)


def test_linears_take_about_12_9_gflop_a_token():
    one = flops.dit_step(CFG["flux"], 512, 1) - flops.dit_step(CFG["flux"], 512, 0)
    assert 12.9e9 < one - 57 * 4 * (2 * 512 + 1) * D < 12.92e9


def test_dit_step_at_the_training_length():
    assert flops.dit_step(CFG["flux"], 512, 3712) == hand_dit(512, 3712)


def test_text_encoders():
    t5 = 24 * (2 * 512 * (4 * 4096 * 4096 + 3 * 4096 * 10240) + 4 * 512 * 512 * 4096)
    assert flops.t5_encode(CFG["t5"], 512) == t5
    clip = 12 * (2 * 77 * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * 77 * 77 * 768)
    assert flops.clip_encode(CFG["clip"], 77) == clip


def test_vae_counts_every_convolution():
    # a 16 x 16 canvas: conv_in at 16x16; four levels of two resnets with
    # three downsamples; the mid block at 2x2; conv_out
    def conv(k, ci, co, h):
        return 2 * k * k * ci * co * h * h

    def res(ci, co, h):
        return conv(3, ci, co, h) + conv(3, co, co, h) + (conv(1, ci, co, h) if ci != co else 0)

    enc = conv(3, 3, 128, 16)
    enc += res(128, 128, 16) * 2 + conv(3, 128, 128, 8)
    enc += res(128, 256, 8) + res(256, 256, 8) + conv(3, 256, 256, 4)
    enc += res(256, 512, 4) + res(512, 512, 4) + conv(3, 512, 512, 2)
    enc += res(512, 512, 2) * 2
    enc += 2 * res(512, 512, 2) + 2 * 4 * 512 * 512 * 4 + 4 * 16 * 512
    enc += conv(3, 512, 32, 2)
    assert flops.vae_encode(CFG["vae"], 16, 16) == enc


def test_fused_attention_bound_is_operations_bound_at_serving_lengths():
    peak = CFG["peak"]
    for seq in (1216, 1664):
        f, b = flops.fused_attention(CFG["flux"], seq, True)
        assert f == 4 * 24 * seq * seq * 128
        assert b == 4 * seq * 3072 * 2 + 4 * seq * 128 * 4
        assert flops.bound_s(f, b, peak) == f / peak["flops_per_s"]


def test_edit_image_is_the_sum_of_its_stages():
    steps, (h, w) = 30, (448, 512)
    n_txt, n_img = flops.edit_tokens(CFG, h, w)
    total = (flops.t5_encode(CFG["t5"], 512) + flops.clip_encode(CFG["clip"], 77)
             + flops.vae_encode(CFG["vae"], h, w) + steps * flops.dit_step(CFG["flux"], n_txt, n_img)
             + flops.vae_decode(CFG["vae"], h, w))
    assert flops.edit_image(CFG, h, w, steps) == total
    # the DiT is nearly all of it: ~587 TFLOP an image at 1408 tokens
    assert 0.5e15 < total < 0.7e15
