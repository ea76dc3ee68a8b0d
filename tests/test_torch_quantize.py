"""The port's quantised serving and QLoRA training held against the JAX
package on the CPU, in float32: the quantisers' codes (bitwise) and the
mixed policy, ``dense`` over every quantised layout (with LoRA and grouped
LoRA), the half-permuted quantised DiT, the tiny quantised pipeline against
the JAX pipeline and the goldens, ``from_pretrained(quantize=...)`` and
``run_inference.main --quantize-mode`` on a tiny checkpoint written by the
JAX exporter, 8-bit AdamW against the JAX optimizer, and
``cli.train.main --quantize-base nf4 --optimizer adamw8bit``."""

import dataclasses
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from helpers import FLUX_TINY_WIDE, VAE_TINY, tiny_pipeline, tiny_pipeline_wide
from textflux_tpu.config import PipelineConfig
from textflux_tpu.io import quantize as JQ
from textflux_tpu.io.export import save_transformer_checkpoint
from textflux_tpu.models import transformer as JT
from textflux_tpu.models.layers import dense as jax_dense
from textflux_tpu.ops import packing as JP, rope as JR
from textflux_tpu.pipeline.fill import FillPipeline as JaxFillPipeline
from textflux_tpu.training import optim8bit as JO, train as JTR

import textflux_torch.config as TC
from textflux_torch.cli import train as CLI
from textflux_torch.io import quantize as TQ
from textflux_torch.io.from_jax import load_jax_dense
from textflux_torch.io.params import load_safetensors_dir
from textflux_torch.models import transformer as TT
from textflux_torch.models.layers import dense
from textflux_torch.pipeline.fill import FillPipeline
from textflux_torch.training import optim8bit as TO, train as TR

from torch_port_helpers import (FLUX_CFG, VAE_CFG, jax_pipeline_noise, n, port_module,
                                port_pipeline, t, write_tiny_checkpoint)

HERE = os.path.dirname(__file__)
GOLDEN_DIR = os.path.join(HERE, "golden")
EXAMPLE = os.path.join(HERE, "..", "resource", "example")
EXAMPLE_PATHS = [os.path.join(EXAMPLE, sub, name) for sub, name in
                 (("ori", "ori_0001.png"), ("mask", "mask_0001.png"),
                  ("txt", "words_0001.txt"))]
SERVE_MODES = ("weight_only", "w8a8", "nf4", "mixed")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's threads contend with the JAX CPU backend's in this process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_leaf(rng, d_in, d_out, mode, double_quant=False):
    p = {"w": jnp.asarray(rng.standard_normal((d_in, d_out)) * 0.05, jnp.float32),
         "b": jnp.asarray(rng.standard_normal(d_out), jnp.float32)}
    return p, JQ.quantize_dense(p, mode, double_quant=double_quant)


# ---------------------------------------------------------------------------
# the quantisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,double_quant,d_in", [
    ("weight_only", False, 256), ("w8a8", False, 256), ("nf4", False, 256),
    ("nf4", True, 384), ("nf4", False, 192)],
    ids=["weight_only", "w8a8", "nf4", "nf4_double_quant", "nf4_falls_back"])
def test_quantizer_codes_match_jax(mode, double_quant, d_in, rng):
    """The same int8 codes and packed NF4 bytes bitwise, scales and absmax
    to 1e-7; every port tensor is the transpose of the JAX one. An input
    width that is not a multiple of 128 falls back to weight_only."""
    p, want = _jax_leaf(rng, d_in, 96, mode, double_quant)
    lin = torch.nn.Linear(d_in, 96)
    with torch.no_grad():
        lin.weight.copy_(t(p["w"]).T)
        lin.bias.copy_(t(p["b"]))
    got = TQ.QuantLinear.from_linear(lin, mode, double_quant)
    assert not list(got.parameters())
    assert set(want) == {k for k, _ in got.named_buffers()} - {"bias"} | {"b"}
    assert got.mode == ("weight_only" if d_in % 128 else mode)
    for k, v in want.items():
        ref = np.asarray(v)
        ours = n(got.bias if k == "b" else getattr(got, k))
        ours = ours.T if ours.ndim == 2 else ours
        if ref.dtype in (np.int8, np.uint8):
            np.testing.assert_array_equal(ours, ref, err_msg=k)
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=0, err_msg=k)
    np.testing.assert_allclose(n(got.dequantize(torch.float32)).T,
                               np.asarray(JQ.dequantize_dense(want, jnp.float32)["w"]),
                               rtol=1e-6, atol=1e-7)


def _jax_modes(tree, path=()):
    """{path: mode} of every quantised leaf of a JAX tree."""
    if isinstance(tree, dict):
        for key, mode in (("w_q", "weight_only"), ("w_q8a8", "w8a8"), ("w_nf4", "nf4")):
            if key in tree:
                return {path: mode}
        return {k: v for key, sub in tree.items()
                for k, v in _jax_modes(sub, path + (key,)).items()}
    return {}


def _port_path(path, cfg):
    """A JAX leaf path -> the port's module paths (one per stacked layer)."""
    group = {"double": ("double_blocks", cfg.num_double_layers),
             "single": ("single_blocks", cfg.num_single_layers)}.get(path[0])
    if group is None:
        return [".".join(path)]
    return [".".join((group[0], str(i)) + path[1:]) for i in range(group[1])]


@pytest.mark.parametrize("mode", ["mixed", "nf4", "weight_only"])
@pytest.mark.parametrize("min_size", [0, None], ids=["min_size_0", "default_min_size"])
def test_quantize_tree_chooses_the_jax_modules(mode, min_size):
    """The same linears in the same modes, at min_size 0 and at the default
    (where a block linear counts its size over its stack, so the tiny wide
    config's 4x MLPs are quantised and its qkv projections are not)."""
    cfg = FLUX_TINY_WIDE
    params = JT.init_flux_params(jax.random.PRNGKey(2), cfg)
    kw = {} if min_size is None else {"min_size": min_size}
    want = {}   # the JAX tree's structure alone: traced, not computed
    quantized = jax.eval_shape(functools.partial(JQ.quantize_tree, mode=mode, **kw), params)
    for path, m in _jax_modes(quantized).items():
        want.update({p: m for p in _port_path(path, cfg)})
    model = TQ.quantize_tree(port_module(params, cfg), mode=mode, min_size=min_size)
    got = TQ.quantized_linears(model)
    assert got == want
    if mode == "mixed" and min_size == 0:
        assert set(got.values()) == {"nf4", "weight_only"}
    if min_size is None:
        assert "double_blocks.0.img_mlp.fc1" in got and "double_blocks.0.img_qkv" not in got
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TQ.quantize_tree(model, mode="int4")


# ---------------------------------------------------------------------------
# dense over each layout
# ---------------------------------------------------------------------------

DENSE_CASES = {
    "weight_only": ("weight_only", False, 10, None),
    "w8a8_6_rows": ("w8a8", False, 6, None),
    "w8a8_40_rows": ("w8a8", False, 40, None),
    "nf4": ("nf4", False, 10, None),
    "nf4_double_quant": ("nf4", True, 10, None),
    "weight_only_lora": ("weight_only", False, 10, "plain"),
    "nf4_lora": ("nf4", False, 10, "plain"),
    "weight_only_grouped_lora": ("weight_only", False, 10, "grouped"),
    "nf4_grouped_lora": ("nf4", True, 10, "grouped"),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_matches_jax(case, rng):
    """JAX dense and the port's on the same codes (carried across by
    load_jax_dense), with the parallel LoRA branches over the quantised
    base; to 1e-5."""
    mode, double_quant, rows, lora = DENSE_CASES[case]
    d_in, m, d, r, scale = 256, 3, 32, 4, 0.5
    d_out = m * d + 20      # grouped factors cover the leading m*d columns
    _, leaf = _jax_leaf(rng, d_in, d_out, mode, double_quant)
    lin = load_jax_dense(jax.tree.map(np.asarray, leaf), device="cpu")
    assert isinstance(lin, TQ.QuantLinear) and lin.mode == mode
    x = rng.standard_normal((rows // 2, 2, d_in)).astype(np.float32)
    if lora:
        shapes = ((d_in, r), (r, d_out)) if lora == "plain" else ((m, d_in, r), (m, r, d))
        a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
        keys = ("lora_a", "lora_b") if lora == "plain" else ("lora_ga", "lora_gb")
        leaf = dict(leaf, **{keys[0]: a * scale, keys[1]: b})
        TR.lora_insert(lin, {"": {"a": t(a), "b": t(b)}}, scale)
    want = np.asarray(jax_dense(leaf, jnp.asarray(x)))
    got = n(dense(lin, t(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int_mm_pads_up_to_17_rows(rng):
    """The padded branch on its own: 1 to 17 rows give the exact int32
    products."""
    w = torch.tensor(rng.integers(-127, 128, (24, 64)), dtype=torch.int8)
    for rows in (1, 6, 16, 17, 40):
        xq = torch.tensor(rng.integers(-127, 128, (rows, 64)), dtype=torch.int8)
        got = TQ.int_mm(xq, w)
        assert got.dtype == torch.int32 and got.shape == (rows, 24)
        assert torch.equal(got, (xq.long() @ w.long().T).int())


def test_lora_over_w8a8_raises_as_jax(rng):
    _, leaf = _jax_leaf(rng, 128, 64, "w8a8")
    factors = {"a": np.zeros((128, 2), np.float32), "b": np.zeros((2, 64), np.float32)}
    tree = {"double": {"img_qkv": dict(leaf)}, "single": {}}
    message = "LoRA over a w8a8 base is unsupported"
    with pytest.raises(ValueError, match=message):
        JTR.lora_insert(tree, {"double": {"img_qkv": factors}, "single": {}}, 1.0)
    lin = load_jax_dense(jax.tree.map(np.asarray, leaf), device="cpu")
    with pytest.raises(ValueError, match=message):
        TR.lora_insert(lin, {"": {k: t(v) for k, v in factors.items()}}, 1.0)


# ---------------------------------------------------------------------------
# the half-permuted quantised DiT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,double_quant", [
    ("weight_only", False), ("w8a8", False), ("nf4", False), ("mixed", True)],
    ids=["weight_only", "w8a8", "nf4", "mixed_double_quant"])
def test_half_permuted_quantized_dit_matches_jax(mode, double_quant, rng):
    """JAX's quantised tree carried across, half-permuted (every output-axis
    buffer of the fused projections gathered), through the fused path's
    plain version: JAX's flux_apply on the unpermuted tree, to 1e-5."""
    cfg = FLUX_TINY_WIDE
    params = jax.jit(functools.partial(JQ.quantize_tree, min_size=0, mode=mode,
                                       double_quant=double_quant))(
        JT.init_flux_params(jax.random.PRNGKey(5), cfg))
    model = TT.half_permute_flux_params(port_module(params, cfg))
    modes = set(TQ.quantized_linears(model).values())
    assert modes == ({"nf4", "weight_only"} if mode in ("nf4", "mixed") else {mode})
    ids = np.concatenate([JP.text_ids(6), JP.latent_image_ids(8, 10)], 0)
    img = rng.standard_normal((1, 20, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((1, 6, cfg.joint_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    ts, guidance = np.array([0.6], np.float32), np.array([30.0], np.float32)
    want = JT.flux_apply(params, cfg, img, txt, pooled, ts, guidance,
                         *JR.rope_tables(ids, cfg.axes_dims_rope), attn_impl="xla")
    with torch.no_grad():
        got = TT.flux_apply(model, *map(t, (img, txt, pooled, ts, guidance,
                                           *JR.rope_tables_half(ids, cfg.axes_dims_rope))),
                            attn_impl="fused")
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_half_permute_refuses_what_it_cannot_permute(rng):
    model = TQ.quantize_tree(port_module(JT.init_flux_params(jax.random.PRNGKey(6),
                                                             FLUX_TINY_WIDE),
                                         FLUX_TINY_WIDE), min_size=0, mode="nf4")
    model.double_blocks[0].img_qkv.register_buffer("zeros", torch.zeros(3))
    with pytest.raises(KeyError, match="unknown tensor 'zeros'"):
        TT.half_permute_flux_params(model)
    del model.double_blocks[0].img_qkv.zeros
    lin = model.single_blocks[0].linear1
    lin.lora_ga = torch.nn.Parameter(torch.zeros(3, lin.in_features, 2))
    with pytest.raises(ValueError, match="grouped per-module LoRA"):
        TT.half_permute_flux_params(model)


# ---------------------------------------------------------------------------
# the tiny quantised pipeline: JAX's and the goldens
# ---------------------------------------------------------------------------

PIPE_CASES = {   # mode -> (golden, JAX tiny pipeline, double_quant), as test_golden.py
    "weight_only": ("int8_weight_only", tiny_pipeline, False),
    "w8a8": ("int8_w8a8", tiny_pipeline, False),
    "nf4": ("nf4_w128", tiny_pipeline_wide, False),
    "mixed": ("mixed_dq_w128", tiny_pipeline_wide, True),
}
SEED, H, W = 7, 32, 48    # the goldens' seed and size (tests/test_golden.py)


def _fixture_inputs():
    return (Image.open(EXAMPLE_PATHS[0]), Image.open(EXAMPLE_PATHS[1]))


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_quantized_pipeline_matches_jax_and_golden(mode):
    """Both sides quantise the tiny pipeline's DiT with their own quantiser
    (min_size 0, as the goldens do); the port runs on JAX's noise."""
    golden, make, double_quant = PIPE_CASES[mode]
    jax_pipe = make()
    port_pipe = port_pipeline(jax_pipe)
    jax_pipe.flux_params = jax.jit(functools.partial(
        JQ.quantize_tree, min_size=0, mode=mode, double_quant=double_quant))(jax_pipe.flux_params)
    TQ.quantize_tree(port_pipe.flux, min_size=0, mode=mode, double_quant=double_quant)
    img, mask = _fixture_inputs()
    kw = dict(image=img, mask_image=mask, words=["OPEN"], height=H, width=W, seed=SEED,
              sampler="euler", output_type="np")
    want = jax_pipe(**kw, dtype=jnp.float32)
    noise = jax_pipeline_noise(SEED, height=H, width=W, vae_cfg=VAE_TINY, steps=2)
    with torch.no_grad():
        got = port_pipe(**kw, dtype=torch.float32, noise=noise)
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(got, np.load(os.path.join(GOLDEN_DIR, golden + ".npz"))["out"],
                               atol=2e-3)


# ---------------------------------------------------------------------------
# loading: from_pretrained and main() on a checkpoint written by the JAX exporter
# ---------------------------------------------------------------------------

# a DiT for the tiny checkpoint's 8x VAE, T5 and CLIP, wide enough (hidden
# 128) for the NF4 block interiors
WIDE_CFG = dataclasses.replace(FLUX_CFG, num_double_layers=1, num_single_layers=1,
                               head_dim=64, axes_dims_rope=(32, 16, 16))
MAX_T5, STEPS = 16, 2


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = write_tiny_checkpoint(str(tmp_path_factory.mktemp("tiny_ckpt")))
    save_transformer_checkpoint(JT.init_flux_params(jax.random.PRNGKey(12), WIDE_CFG),
                                WIDE_CFG, os.path.join(root, "wide_transformer"))
    return root


@pytest.fixture()
def min_size_0(monkeypatch):
    """Quantise every linear on both sides: at the tiny widths no linear
    reaches the default min_size. (The JAX quantiser runs jitted: its
    arithmetic is the same, one compile instead of one per operation.)"""
    quantize_tree = JQ.quantize_tree

    def jax_quantize_tree(tree, **kw):
        return jax.jit(functools.partial(quantize_tree, **dict(kw, min_size=0)))(tree)

    monkeypatch.setattr(JQ, "quantize_tree", jax_quantize_tree)
    monkeypatch.setattr(TQ, "MIN_SIZE", 0)


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_from_pretrained_quantized_matches_jax(mode, checkpoint, min_size_0):
    wide = os.path.join(checkpoint, "wide_transformer")
    jax_pipe = JaxFillPipeline.from_pretrained(
        checkpoint, transformer_path=wide, quantize=mode, dtype=jnp.float32,
        pipe_cfg=PipelineConfig(num_inference_steps=STEPS, max_sequence_length=MAX_T5),
        attn_impl="xla")
    pipe = FillPipeline.from_pretrained(
        checkpoint, transformer_path=wide, quantize=mode, dtype=torch.float32,
        pipe_cfg=TC.PipelineConfig(num_inference_steps=STEPS, max_sequence_length=MAX_T5),
        device="cpu")
    modes = TQ.quantized_linears(pipe.flux)
    assert modes == {p: m for path, m in _jax_modes(jax_pipe.flux_params).items()
                     for p in _port_path(path, WIDE_CFG)}
    assert len(modes) == 23 and ("nf4" in modes.values()) == (mode in ("nf4", "mixed"))
    assert set(TQ.quantized_linears(pipe.t5).values()) == {"weight_only"}
    stats = pipe.load_stats
    assert stats["transformer"]["device_bytes"] < 0.5 * stats["transformer"]["bytes"]
    img, mask = _fixture_inputs()
    kw = dict(image=img.resize((64, 48)), mask_image=mask.resize((64, 48)), words=["OPEN"],
              height=48, width=64, seed=1, output_type="np")
    want = jax_pipe(**kw, dtype=jnp.float32)
    noise = jax_pipeline_noise(1, height=48, width=64, vae_cfg=VAE_CFG, steps=STEPS)
    got = pipe(**kw, dtype=torch.float32, noise=noise)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("mode", ["w8a8", "nf4"])
def test_main_quantized_is_the_in_memory_image(mode, checkpoint, min_size_0, tmp_path):
    """run_inference.main with --quantize-mode (staged for nf4) against
    from_pretrained(quantize=mode) + run on the same inputs: bitwise."""
    from textflux_torch.cli.run_inference import main, run

    wide = os.path.join(checkpoint, "wide_transformer")
    argv = ["--model", checkpoint, "--transformer", wide, "--image", EXAMPLE_PATHS[0],
            "--mask", EXAMPLE_PATHS[1], "--words", EXAMPLE_PATHS[2], "--steps", str(STEPS),
            "--max-sequence-length", str(MAX_T5), "--device", "cpu", "--output-dir",
            str(tmp_path), "--quantize-mode", mode] + (["--staged-text"] if mode == "nf4" else [])
    main(argv)
    got = np.asarray(Image.open(tmp_path / "result_0001.png"))
    pipe = FillPipeline.from_pretrained(
        checkpoint, transformer_path=wide, quantize=mode,
        pipe_cfg=TC.PipelineConfig(max_sequence_length=MAX_T5), device="cpu")
    assert isinstance(pipe.t5.layers[0].q, TQ.QuantLinear)
    want = np.asarray(run(pipe, *EXAMPLE_PATHS, steps=STEPS, device="cpu")[0])
    assert got.shape == want.shape == (448, 512, 3) and got.std() > 0
    np.testing.assert_array_equal(got, want)


def test_unknown_quantize_mode_raises(checkpoint):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        FillPipeline.from_pretrained(checkpoint, quantize="int4", device="cpu",
                                     defer_transformer=True)


# ---------------------------------------------------------------------------
# 8-bit AdamW
# ---------------------------------------------------------------------------

def test_moment_codes_match_jax(rng):
    """quantize_dynamic and quantize_blockwise give JAX's codes and scales
    bitwise, over values spread across ten decades; the dequantised values
    agree to float32 rounding (exp's last bit differs between the two
    libraries) and the floor reads code 0 back as absmax * 1e-5."""
    x = (rng.standard_normal(20000) * np.exp(3 * rng.standard_normal(20000))).astype(np.float32)
    x[:100] = 0.0
    for quantize, dequantize in ((JO.quantize_dynamic, TO.quantize_dynamic),
                                 (JO.quantize_blockwise, TO.quantize_blockwise)):
        want, got = quantize(jnp.asarray(x)), dequantize(t(x))
        np.testing.assert_array_equal(n(got[0]), np.asarray(want.q))
        np.testing.assert_array_equal(n(got[1]), np.asarray(want.scale))
    q = TO.quantize_dynamic(t(x))
    for floor in (False, True):
        want = JO.dequantize_dynamic(JO.quantize_dynamic(jnp.asarray(x)), x.shape, floor=floor)
        np.testing.assert_allclose(n(TO.dequantize_dynamic(q, x.shape, floor=floor)),
                                   np.asarray(want), rtol=4e-7, atol=0)
    floored = n(TO.dequantize_dynamic(q, x.shape, floor=True))[:100]
    np.testing.assert_allclose(floored, np.abs(x[:256]).max() * 1e-5, rtol=1e-5)
    back = n(TO.dequantize_blockwise(TO.quantize_blockwise(t(x)), x.shape))
    np.testing.assert_allclose(back, x, atol=np.abs(x).max() / 127)


def test_adamw8bit_matches_jax_over_20_steps(rng):
    """20 clipped steps of the JAX trainer's adamw8bit chain and of
    ClippedAdamW8bit on the same gradients, each step from the same state:
    the parameters to 1e-6 and the moments' block scales to float32
    rounding after every step; their codes equal but for at most one in
    10^4, each then one level apart. (XLA's and torch's exp and log differ
    in the last bit, so a moment that lands within float32 rounding of a
    code boundary may round to the neighbouring code on one side; each step
    starts from JAX's state, as two free-running trajectories would part
    there by up to one code level's update.)"""
    p0 = [(0.5 * rng.standard_normal(s)).astype(np.float32)
          for s in ((300, 7), (5,), (2, 3, 130))]
    tc = TR.TrainConfig(optimizer="adamw8bit", learning_rate=1e-2, weight_decay=0.1)
    jtc = JTR.TrainConfig(**{f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)})
    tx = JTR.make_optimizer(jtc)
    params = [jnp.asarray(x) for x in p0]
    state = tx.init(params)
    ours = [torch.nn.Parameter(t(x)) for x in p0]
    opt = TR.make_optimizer(tc, {f"p{i}": p for i, p in enumerate(ours)})
    assert isinstance(opt, TR.ClippedAdamW8bit)
    differing = compared = 0
    for _ in range(20):
        grads = [(0.3 * rng.standard_normal(x.shape)).astype(np.float32) for x in p0]
        with torch.no_grad():   # each step starts from JAX's state
            for p, q in zip(ours, params):
                p.copy_(t(q))
            inner = state[1][0]
            for i in range(len(p0)):
                for m, qt in (("mu", inner.mu[i]), ("nu", inner.nu[i])):
                    opt.state[f"{m}_q"][i].copy_(t(qt.q, torch.int8))
                    opt.state[f"{m}_scale"][i].copy_(t(qt.scale))
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for p, g in zip(ours, grads):
            p.grad = t(g)
        opt.step()
        for p, q in zip(ours, params):
            np.testing.assert_allclose(n(p), np.asarray(q), rtol=0, atol=1e-6)
        inner = state[1][0]
        for i in range(len(p0)):
            for m, qt in (("mu", inner.mu[i]), ("nu", inner.nu[i])):
                step = n(opt.state[f"{m}_q"][i]).astype(np.int32) - np.asarray(qt.q)
                assert np.abs(step).max() <= 1
                differing += int(np.count_nonzero(step))
                compared += step.size
                np.testing.assert_allclose(n(opt.state[f"{m}_scale"][i]),
                                           np.asarray(qt.scale), rtol=1e-6, atol=0)
    assert differing <= compared * 1e-4, (differing, compared)
    assert opt.count == int(state[1][0].count) == 20
    moved = max(float(np.abs(np.asarray(p) - x).max()) for p, x in zip(params, p0))
    assert moved > 0.1


def test_adamw8bit_state_is_a_quarter_of_adamw(rng):
    params = [torch.nn.Parameter(torch.zeros(s)) for s in ((1000, 24), (300,))]
    n_params = sum(p.numel() for p in params)
    named = {f"p{i}": p for i, p in enumerate(params)}
    opt = TR.make_optimizer(TR.TrainConfig(optimizer="adamw8bit"), named)
    adamw = TR.make_optimizer(TR.TrainConfig(optimizer="adamw"), named)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    adamw.step()
    eight = TO.state_bytes(opt.state_dict())
    full = TO.state_bytes(adamw.state_dict())
    assert full >= 8 * n_params and eight <= 2.1 * n_params
    # blocks of 256 values: 256 int8 codes + one fp32 scale, per moment
    assert eight == 2 * sum(TO.n_blocks(p.numel()) * (256 + 4) for p in params)


# ---------------------------------------------------------------------------
# QLoRA through cli.train.main
# ---------------------------------------------------------------------------

def test_main_qlora_nf4_adamw8bit_trains_and_serves(checkpoint, min_size_0, tmp_path, rng,
                                                    monkeypatch):
    """--quantize-base nf4 --optimizer adamw8bit: the base is quantised as
    it loads (nf4 inside the blocks of the wide DiT), LoRA attaches over
    it, 2 steps give finite losses and every target's B moves, the base
    stays as loaded, and from_pretrained serves the export."""
    data = tmp_path / "data"
    (data / "mask").mkdir(parents=True)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(data / "s_0.png")
    m = np.zeros((64, 64), np.uint8)
    m[16:32, 16:48] = 255
    Image.fromarray(m).save(data / "mask" / "s_0_mask.png")
    (data / "s_0.txt").write_text("the text\n")
    seen = {}
    insert = TR.lora_insert

    def keep(model, lora, scale):
        seen.update(model=model, lora=lora, checksum=TR.base_checksum(model),
                    b0={p: f["b"].detach().clone() for p, f in lora.items()})
        return insert(model, lora, scale)

    monkeypatch.setattr(TR, "lora_insert", keep)
    out = tmp_path / "out"
    wide = os.path.join(checkpoint, "wide_transformer")
    CLI.main(["--model", checkpoint, "--transformer", wide, "--data-dir", str(data),
              "--resolution", "64",
              "--output-dir", str(out), "--mode", "lora", "--lora-rank", "2", "--lora-alpha", "2",
              "--quantize-base", "nf4", "--optimizer", "adamw8bit", "--learning-rate", "1e-2",
              "--train-batch-size", "1", "--grad-accum", "1", "--max-train-steps", "2",
              "--max-sequence-length", "16", "--log-every", "1", "--seed", "3",
              "--device", "cpu"])
    log = [json.loads(x) for x in (out / "train_log.jsonl").read_text().splitlines()]
    assert [e["step"] for e in log] == [1, 2]
    assert all(np.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in log)
    modes = TQ.quantized_linears(seen["model"])
    assert modes["double_blocks.0.img_qkv"] == "nf4" and modes["img_in"] == "weight_only"
    assert all(not torch.equal(f["b"], seen["b0"][p]) for p, f in seen["lora"].items())
    assert TR.base_checksum(seen["model"]) == seen["checksum"]

    sd = load_safetensors_dir(str(out / "pytorch_lora_weights.safetensors"))
    assert sd and all(torch.isfinite(v).all() for v in sd.values())
    cfg = TC.PipelineConfig(num_inference_steps=2, max_sequence_length=16)
    kw = dict(image=Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)),
              mask_image=Image.fromarray(np.pad(np.full((20, 32), 255, np.uint8),
                                                ((10, 18), (8, 24)))),
              words=["OPEN"], height=48, width=64, seed=4, output_type="np",
              dtype=torch.float32)
    base = FillPipeline.from_pretrained(checkpoint, transformer_path=wide, dtype=torch.float32,
                                        pipe_cfg=cfg, device="cpu")(**kw)
    tuned = FillPipeline.from_pretrained(checkpoint, transformer_path=wide, lora_path=str(out),
                                         dtype=torch.float32, pipe_cfg=cfg, device="cpu")(**kw)
    assert np.isfinite(tuned).all() and np.abs(tuned - base).max() > 1e-4
