"""textflux_torch's full-parameter training (``--mode attn|all``) held
against textflux_tpu's on the JAX package's own parameters and random draws:
the attention-unfreeze and all-trainable masks, two steps of
make_train_step for each mode and optimizer, gradient accumulation, the
8-bit moments' blocks, the per-parameter dtypes of loading and export, the
training state's checkpoints, and cli.train.main() end to end on a tiny
diffusers-layout checkpoint (resume, SIGTERM, the float32 export served by
FillPipeline.from_pretrained). CPU, float32 compute."""

import functools
import json
import os
import signal
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from helpers import FLUX_TINY, VAE_TINY
from textflux_tpu.config import FluxConfig
from textflux_tpu.io import params as JP
from textflux_tpu.io.export import export_flux_state_dict as jax_export_flux_state_dict
from textflux_tpu.models import vae as JV
from textflux_tpu.models.transformer import init_flux_params
from textflux_tpu.training import train as JTR

import textflux_torch.config as TC
from textflux_torch.cli import train as CLI
from textflux_torch.io.export import export_flux_state_dict, save_transformer_checkpoint
from textflux_torch.io.from_jax import load_jax_moments, load_jax_params
from textflux_torch.io.params import (checkpoint_dtypes, flux_key_map, load_flux_transformer,
                                      load_safetensors_dir)
from textflux_torch.io.safetensors import read_header
from textflux_torch.models.transformer import FluxTransformer
from textflux_torch.pipeline.fill import FillPipeline
from textflux_torch.training import optim8bit as TO
from textflux_torch.training import train as TR
from textflux_torch.training.checkpoint import CheckpointManager, copy_into

from torch_port_helpers import (FLUX_CFG, jax_loss_noise, n, port_cfg, port_module,
                                port_train_config, t, write_tiny_checkpoint)

H = W = 32   # pixels: a 16x16 VAE_TINY latent, 64 image tokens


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's threads contend with the JAX CPU backend's in this process
    (see test_torch_train_cli.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rng, accum=1):
    return {
        "pixel_values": (rng.standard_normal((accum, 1, H, W, 3)) * 0.5).astype(np.float32),
        "mask": (rng.random((accum, 1, H, W)) > 0.8).astype(np.float32),
        "txt": rng.standard_normal((accum, 1, 6, FLUX_TINY.joint_dim)).astype(np.float32),
        "pooled": rng.standard_normal((accum, 1, FLUX_TINY.pooled_dim)).astype(np.float32),
    }


def _numpy_tree(init, seed, rounded=True):
    """Parameters in the JAX tree that `init(key)` builds, made with numpy
    from `seed` (the JAX inits run eagerly take seconds to compile their
    many small draws): linears and convolutions uniform in
    +-1/sqrt(fan_in), norm scales 1 + N(0, 0.05^2), biases N(0, 0.05^2)
    (not zero, or a bias's largest |value| after two steps would be one
    step's size); rounded through bf16 unless `rounded` is False, so frozen
    bf16 storage on the port's side holds the JAX values exactly."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name.endswith("scale"):
            x = 1 + 0.05 * rng.standard_normal(leaf.shape)
        elif name == "w":
            # a convolution HWIO, or a dense (in, out) (stacked: (L, in, out))
            fan_in = np.prod(leaf.shape[:-1]) if leaf.ndim == 4 else leaf.shape[-2]
            bound = 1 / np.sqrt(fan_in)
            x = rng.uniform(-bound, bound, leaf.shape)
        else:
            x = 0.05 * rng.standard_normal(leaf.shape)
        x = torch.tensor(x, dtype=torch.float32)
        return jnp.asarray((x.bfloat16().float() if rounded else x).numpy())

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _init(cfg, seed, rounded=True):
    return _numpy_tree(lambda k: init_flux_params(k, cfg), seed, rounded)


@functools.lru_cache(maxsize=None)
def _jax_models():
    return _init(FLUX_TINY, 0), _numpy_tree(lambda k: JV.init_vae_params(k, VAE_TINY), 1,
                                            rounded=False)


def _jax_mask(params, cfg, jtc):
    return (JTR.attn_only_mask(params, cfg, jtc) if jtc.mode == "attn"
            else JTR.all_trainable_mask(params))


def _jax_value(tree, name):
    """The JAX tree's value (numpy) for a port parameter name, in the
    port's layout."""
    leaf, layer, transpose = TR.jax_leaf(name)
    x = tree
    for part in leaf.split("."):
        x = x[part]
    x = np.asarray(x)
    x = x if layer is None else x[layer]
    return x.T if transpose and x.ndim == 2 else x


def _full_model(params, tc, frozen=torch.bfloat16):
    """The port's DiT on the JAX params: float32 masters, frozen weights in
    `frozen` (load_jax_params with the per-parameter dtypes)."""
    cfg = port_cfg(FLUX_TINY)
    masks = TR.trainable_mask(FluxTransformer(cfg, device="meta"), tc)
    return load_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu",
                           dtype=TR.mask_dtypes(masks, lambda name: frozen))


# ---------------------------------------------------------------------------
# (a) the masks
# ---------------------------------------------------------------------------

# hidden 24: no per-layer slice of a projection is a multiple of 256 (img_qkv
# 24x72 = 1728, linear1 24x168 = 4032), so the JAX leaves' blocks straddle
# layers and the transposed (in, out) order decides which elements share one
FLUX_ODD = FluxConfig(in_channels=48, out_channels=16, num_double_layers=2,
                      num_single_layers=3, num_heads=2, head_dim=12, joint_dim=32,
                      pooled_dim=16, guidance_embeds=True, axes_dims_rope=(4, 4, 4),
                      time_embed_channels=256)


def _node(tree, leaf):
    for part in leaf.split("."):
        tree = tree[part]
    return tree



@pytest.mark.parametrize("mode", ["attn", "all"])
@pytest.mark.parametrize("cfg", ["tiny", "odd"])
def test_masks_match_jax(cfg, mode):
    """Every port parameter's mask, broadcast to the parameter, equals the
    JAX mask tree's at the same place (at FLUX_ODD's hidden 24 as well); a
    parameter is frozen exactly where the JAX leaf has no trainable entry
    (its optimizer gets no state)."""
    jcfg = {"tiny": FLUX_TINY, "odd": FLUX_ODD}[cfg]
    params = _jax_models()[0] if cfg == "tiny" else _init(FLUX_ODD, 2, rounded=False)
    jtc = JTR.TrainConfig(mode=mode)
    jmask = _jax_mask(params, jcfg, jtc)
    want = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m), p.shape), jmask, params)
    model = port_module(params, jcfg)
    masks = TR.trainable_mask(model, port_train_config(jtc))
    leaves = {}
    for name, p in model.named_parameters():
        expected = _jax_value(want, name)
        leaves.setdefault(TR.jax_leaf(name)[0], set()).add(name in masks)
        if name not in masks:
            assert not expected.any(), name
            continue
        m = masks[name]
        got = np.ones(p.shape, np.float32) if m is None else np.broadcast_to(n(m), p.shape)
        np.testing.assert_array_equal(got, expected, err_msg=name)
    # frozen parameters are exactly the leaves without a trainable entry
    for leaf, trains in leaves.items():
        assert trains == {JTR.np_any_trainable(_node(jmask, leaf))}, leaf
    if mode == "all":
        assert masks == {name: None for name, _ in model.named_parameters()}
    else:
        d = jcfg.num_heads * jcfg.head_dim
        for i in range(jcfg.num_single_layers):
            rows = masks[f"single_blocks.{i}.linear1.weight"][:, 0]
            assert rows[:3 * d].all() and not rows[3 * d:].any()
            assert masks[f"single_blocks.{i}.q_scale"] is None
            assert f"single_blocks.{i}.linear2.weight" not in masks


# ---------------------------------------------------------------------------
# (b) two steps for each mode and optimizer, (c) gradient accumulation
# ---------------------------------------------------------------------------

# Prodigy's lr multiplies its D estimate (both sides start D at 1e-4 here:
# at the default 1e-6 two steps move nothing the comparison could see)
LEARNING_RATES = {"adamw": 1e-4, "adamw8bit": 2e-5, "prodigy": 1.0}
# Adam divides each step by sqrt(v) + eps: at the default 1e-8 an element
# whose gradient is itself ~1e-8, a sum that cancels to the last bits where
# the two libraries order their float32 additions differently, steps by up
# to +-lr on either side (measured: 1 element in 768 of one projection,
# 4.8e-5 apart at lr 1e-3, 0.05 lr); at 1e-5 such an element takes no
# visible step. 8-bit AdamW runs at its full-parameter default, 2e-5: a
# gradient one ulp from a log-domain code boundary on one side lands one
# code level (4.6% of the moment) away on the other, a step ~5% of lr apart
# (measured: 3.2e-6 at 1e-4, past its tensor's 2.4e-6)
ADAM_EPS = 1e-5


@pytest.fixture()
def prodigy_d0(monkeypatch):
    monkeypatch.setattr(TR.ClippedProdigy, "estim_lr0", 1e-4)
    monkeypatch.setattr(optax.contrib, "prodigy",
                        functools.partial(optax.contrib.prodigy, estim_lr0=1e-4))


def _both_sides(mode, optimizer, accum=1):
    """The JAX step (jitted, its own mask, optimizer and trainable leaves)
    and the port's model, VAE, masks, optimizer and step on the same
    parameters (frozen weights stored bf16, masters float32)."""
    params, vae_params = _jax_models()
    jtc = JTR.TrainConfig(mode=mode, optimizer=optimizer, learning_rate=LEARNING_RATES[optimizer],
                          weight_decay=0.1, adam_eps=ADAM_EPS, compute_dtype="float32",
                          grad_accum=accum)
    mask = _jax_mask(params, FLUX_TINY, jtc)
    tx = JTR.make_optimizer(jtc, mask)
    jstep = jax.jit(JTR.make_train_step(
        FLUX_TINY, VAE_TINY, jtc, tx, attn_impl="xla",
        trainable_leaves=jax.tree.map(JTR.np_any_trainable, mask)))
    tc = port_train_config(jtc)
    model = _full_model(params, tc)
    masks = TR.trainable_mask(model, tc)
    opt = TR.make_optimizer(tc, TR.freeze_to_mask(model, masks), masks)
    jax_side = dict(params=params, state=tx.init(params), mask=mask, vae=vae_params, step=jstep)
    return jax_side, (model, port_module(vae_params, VAE_TINY), masks, opt,
                      TR.make_train_step(tc, attn_impl="plain"))


def _assert_params(model, masks, jparams, before):
    """Every parameter within 1e-5 of its largest |value| of JAX's; the
    frozen ones and the masked elements bitwise as they were; masters
    float32, frozen weights bf16. Returns the largest move of a trainable
    parameter relative to that tolerance."""
    moved = 0.0
    for name, p in model.named_parameters():
        want = _jax_value(jparams, name)
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(n(p.float()), want, rtol=0, atol=tol, err_msg=name)
        if name not in masks:
            assert p.dtype == torch.bfloat16 and torch.equal(p, before[name]), name
            continue
        assert p.dtype == torch.float32, name
        frozen = (torch.zeros(p.shape, dtype=torch.bool) if masks[name] is None
                  else torch.broadcast_to(masks[name] == 0, p.shape))
        assert torch.equal(p[frozen], before[name][frozen]), name
        moved = max(moved, float((p.detach() - before[name])[~frozen].abs().max()) / tol)
    return moved


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "prodigy"])
@pytest.mark.parametrize("mode", ["attn", "all"])
def test_two_steps_match_jax(mode, optimizer, rng, prodigy_d0):
    """Two steps of make_train_step against JAX's (weight decay 0.1, so a
    masked row that decayed would show): loss and grad_norm to 1e-5
    relative, every parameter to 1e-5 of its largest |value|, and the
    trainable ones moved well past that."""
    jx, (model, vae, masks, opt, step) = _both_sides(mode, optimizer)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    params, state = jx["params"], jx["state"]
    for i in range(2):
        batch = _batch(rng)
        key = jax.random.PRNGKey(10 + i)
        params, state, want = jx["step"](params, state, jx["mask"], jx["vae"],
                                          jax.tree.map(jnp.asarray, batch), key)
        got = step(model, vae, opt, {k: t(v) for k, v in batch.items()},
                   noise=[jax_loss_noise(key, b=1, height=H, width=W, vae_cfg=VAE_TINY)])
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    assert _assert_params(model, masks, params, before) > 10
    if optimizer == "adamw":   # JAX's moments carried into a fresh optimizer: the port's
        inner = state[1].inner_state[0]
        fresh = TR.make_optimizer(opt_tc(opt), dict(model.named_parameters()), masks)
        load_jax_moments(fresh, inner.mu, inner.nu, int(inner.count))
        assert fresh.count == opt.count == 2
        for p in opt.params:
            for k in ("exp_avg", "exp_avg_sq"):
                ours, theirs = opt.opt.state[p][k], fresh.opt.state[p][k]
                np.testing.assert_allclose(n(ours), n(theirs), rtol=1e-4,
                                           atol=1e-4 * float(theirs.abs().max()))


def opt_tc(opt):
    return TR.TrainConfig(mode="attn", learning_rate=opt.schedule(0), weight_decay=opt.weight_decay,
                          max_grad_norm=opt.max_grad_norm)


def test_grad_accum_matches_jax_scan(rng):
    """grad_accum 2 (the JAX step's scan over microbatches, each with its
    own split key): one step, loss, grad_norm and parameters as above."""
    jx, (model, vae, masks, opt, step) = _both_sides("attn", "adamw", accum=2)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    batch = _batch(rng, accum=2)
    key = jax.random.PRNGKey(21)
    params, _, want = jx["step"](jx["params"], jx["state"], jx["mask"], jx["vae"],
                                 jax.tree.map(jnp.asarray, batch), key)
    got = step(model, vae, opt, {k: t(v) for k, v in batch.items()},
               noise=jax_loss_noise(key, b=1, height=H, width=W, vae_cfg=VAE_TINY, accum=2))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    assert _assert_params(model, masks, params, before) > 10


# ---------------------------------------------------------------------------
# (d) the 8-bit moments block as the JAX leaves do
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["attn", "all"])
def test_8bit_moments_are_the_jax_blocks(mode, rng):
    """One masked 8-bit AdamW update on the same gradients: every leaf's
    int8 codes and block scales equal JAX's bitwise, and so do the
    parameters; load_jax_moments carries JAX's state into a fresh optimizer
    equal to the port's. The same moments blocked in the port's own
    (out, in), per-parameter layout give other codes."""
    params = _init(FLUX_ODD, 2, rounded=False)
    jtc = JTR.TrainConfig(mode=mode, optimizer="adamw8bit", learning_rate=1e-3,
                          weight_decay=0.1)
    mask = _jax_mask(params, FLUX_ODD, jtc)
    # a global norm under max_grad_norm: no clip, whose factor (the two
    # libraries sum the norm in other orders) would part the scales by an ulp
    grads = jax.tree.map(lambda p: (1e-3 * rng.standard_normal(p.shape)).astype(np.float32),
                         params)
    tx = JTR.make_optimizer(jtc, mask)

    @jax.jit
    def jax_step(grads, state, params):   # the masked update of JAX's make_train_step
        updates, state = tx.update(JTR.apply_mask(grads, mask), state, params)
        return optax.apply_updates(params, JTR.apply_mask(updates, mask)), state

    jparams, state = jax_step(jax.tree.map(jnp.asarray, grads), tx.init(params), params)

    tc = port_train_config(jtc)
    model = port_module(params, FLUX_ODD)
    masks = TR.trainable_mask(model, tc)
    named = TR.freeze_to_mask(model, masks)
    opt = TR.make_optimizer(tc, named, masks)
    for name, p in named.items():
        p.grad = t(_jax_value(grads, name))
    opt.step()
    inner = state[1].inner_state[0]
    assert any(not per_layer for _, _, per_layer in opt.leaves)
    for j, (idx, _, _) in enumerate(opt.leaves):
        leaf = TR.jax_leaf(opt.names[idx[0]])[0]
        for m in ("mu", "nu"):
            q, scale = _node(getattr(inner, m), leaf)
            np.testing.assert_array_equal(n(opt.state[f"{m}_q"][j]), np.asarray(q), leaf)
            np.testing.assert_array_equal(n(opt.state[f"{m}_scale"][j]), np.asarray(scale), leaf)
    for name, p in named.items():
        want = _jax_value(jparams, name)
        np.testing.assert_allclose(n(p), want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    fresh = TR.make_optimizer(tc, named, masks)
    load_jax_moments(fresh, inner.mu, inner.nu, int(inner.count))
    assert fresh.count == opt.count == 1
    for key in opt.state:
        for x, y in zip(opt.state[key], fresh.state[key], strict=True):
            assert torch.equal(x, y), key
    # img_qkv's first moment, (1 - b1) g after one step from zero: blocked
    # over the JAX leaf's (layer, in, out) order it gives the state's codes,
    # blocked per parameter in the port's (out, in) order other ones
    j = next(j for j, (idx, _, _) in enumerate(opt.leaves)
             if opt.names[idx[0]] == "double_blocks.0.img_qkv.weight")
    g = [t(_jax_value(grads, opt.names[i])) for i in opt.leaves[j][0]]
    jax_order = TO.quantize_dynamic((1.0 - tc.adam_b1) * torch.stack([x.T for x in g]))[0]
    port_order = torch.cat([TO.quantize_dynamic((1.0 - tc.adam_b1) * x)[0] for x in g])
    assert torch.equal(jax_order, opt.state["mu_q"][j])
    assert port_order.shape == jax_order.shape and not torch.equal(port_order, jax_order)


def test_8bit_state_of_another_layout_is_refused():
    """An 8-bit state blocked per parameter (one moment array for each of a
    leaf's two layers, where this optimizer keeps one for the JAX leaf)
    does not load: load_state_dict raises and leaves the state as it was."""
    named = {f"double_blocks.{i}.img_q_scale": torch.nn.Parameter(torch.zeros(12))
             for i in range(2)}
    opt = TR.make_optimizer(TR.TrainConfig(optimizer="adamw8bit"), named)
    assert [len(v) for v in opt.state.values()] == [1] * 4
    per_parameter = {k: [torch.ones_like(v[0][:1])] * 2 for k, v in opt.state.items()}
    with pytest.raises(ValueError, match="kept per parameter"):
        opt.load_state_dict({"count": 3, "adamw8bit": per_parameter})
    assert opt.count == 0 and not opt.state["mu_q"][0].any()


# ---------------------------------------------------------------------------
# per-parameter dtypes: loading, export, checkpoints
# ---------------------------------------------------------------------------

def test_mixed_dtype_export_matches_jax_and_loads_back(tmp_path):
    """A DiT with float32 masters beside bf16 frozen weights exports key
    for key what the JAX exporter writes of the same (bf16-rounded) params,
    in float32; the written file holds float32 only, and loading it with
    the per-parameter dtypes gives back each parameter in its dtype."""
    params, _ = _jax_models()
    tc = TR.TrainConfig(mode="attn")
    model = _full_model(params, tc)
    assert {p.dtype for p in model.parameters()} == {torch.float32, torch.bfloat16}
    want = jax_export_flux_state_dict(params, FLUX_TINY)
    got = export_flux_state_dict(model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(n(got[k].float()), np.asarray(v, np.float32), err_msg=k)
    out = str(tmp_path / "transformer")
    save_transformer_checkpoint(model, out, dtype=torch.float32)
    header, _ = read_header(os.path.join(out, "diffusion_pytorch_model.safetensors"))
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {"F32"}
    cfg = port_cfg(FLUX_TINY)
    masks = TR.trainable_mask(FluxTransformer(cfg, device="meta"), tc)
    back = load_flux_transformer(out, cfg, dtype=TR.mask_dtypes(masks, lambda name: torch.bfloat16),
                                 device="cpu")
    for (name, p), q in zip(model.named_parameters(), back.parameters()):
        assert q.dtype == p.dtype and torch.equal(q, p), name


def test_checkpoint_keeps_each_dtype(tmp_path):
    """A state mixing bf16, float32 and int8 tensors comes back in its
    dtypes (with and without a template); copy_into fills a live state in
    place and refuses another dtype or shape."""
    g = torch.Generator().manual_seed(0)
    state = {"params": {"frozen": torch.randn(4, 3, generator=g).bfloat16(),
                        "master": torch.randn(5, generator=g)},
             "opt_state": {"count": 2, "adamw8bit": {
                 "mu_q": [torch.randint(-127, 128, (2, 256), generator=g, dtype=torch.int8)],
                 "mu_scale": [torch.rand(2, generator=g)]}},
             "step": 2}
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    ckpt.save(2, state, wait=True)
    for back in (ckpt.restore(2), ckpt.restore(2, template=state)):
        for x, y in ((back["params"]["frozen"], state["params"]["frozen"]),
                     (back["params"]["master"], state["params"]["master"]),
                     (back["opt_state"]["adamw8bit"]["mu_q"][0],
                      state["opt_state"]["adamw8bit"]["mu_q"][0])):
            assert x.dtype == y.dtype and torch.equal(x, y)
    live = {k: torch.zeros_like(v) for k, v in state["params"].items()}
    copy_into(live, ckpt.restore(2)["params"])
    assert all(torch.equal(live[k], state["params"][k]) for k in live)
    live["frozen"] = live["frozen"].float()
    with pytest.raises(ValueError, match=r"params.frozen is \(4, 3\) torch.bfloat16"):
        copy_into(live, ckpt.restore(2)["params"], "params")
    with pytest.raises(ValueError, match="other keys"):
        copy_into({"master": live["master"]}, state["params"])


# ---------------------------------------------------------------------------
# (e), (f) cli.train.main() end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("tiny_ckpt")))


def _data(root, rng, copies=2):
    """A CombinedFolderDataset directory of `copies` identical 64x64
    samples: a grad-accum-2 batch is the same whatever the loader's
    order."""
    (root / "mask").mkdir(parents=True)
    img = rng.integers(0, 255, (64, 64, 3), np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:32, 16:48] = 255
    for i in range(copies):
        Image.fromarray(img).save(root / f"s_{i}.png")
        Image.fromarray(mask).save(root / "mask" / f"s_{i}_mask.png")
        (root / f"s_{i}.txt").write_text("the text\n")
    return str(root)


def _argv(checkpoint, data, out, *extra):
    return ["--model", checkpoint, "--data-dir", data, "--resolution", "64",
            "--output-dir", str(out), "--mode", "attn", "--optimizer", "adamw8bit",
            "--learning-rate", "1e-3", "--train-batch-size", "1", "--grad-accum", "2",
            "--max-sequence-length", "16", "--log-every", "1", "--seed", "3",
            "--device", "cpu", *extra]


def _log(out):
    return [json.loads(x) for x in (out / "train_log.jsonl").read_text().splitlines()]


@pytest.fixture()
def live_models(monkeypatch):
    """The DiT of each main() run, as load_models built it."""
    models = []
    load = CLI.load_models

    def keep(args, dev, tc):
        out = load(args, dev, tc)
        models.append(out[1])
        return out

    monkeypatch.setattr(CLI, "load_models", keep)
    return models


@pytest.mark.parametrize("precision", ["bf16", "no"])
@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_load_models_keeps_frozen_weights_exact(checkpoint, tmp_path, stored, precision):
    """load_models for --mode attn: the masters float32, and a frozen
    weight in the compute dtype only where the checkpoint stores it so
    (checkpoint_dtypes reads that from the headers), else float32: every
    parameter holds the checkpoint's value bitwise."""
    cfg = port_cfg(FLUX_CFG)
    src = os.path.join(checkpoint, "transformer")
    if stored == "bfloat16":
        base = load_flux_transformer(src, cfg, dtype=torch.float32, device="cpu")
        src = str(tmp_path / "transformer_bf16")
        save_transformer_checkpoint(base, src, dtype=torch.bfloat16)
    assert set(checkpoint_dtypes(src, cfg).values()) == {getattr(torch, stored)}
    args = CLI.parse_args(["--model", checkpoint, "--transformer", src, "--output-dir",
                           str(tmp_path / "out"), "--mixed-precision", precision,
                           "--device", "cpu"])
    tc = TR.TrainConfig(mode="attn", compute_dtype="bfloat16" if precision == "bf16"
                        else "float32")
    flux = CLI.load_models(args, torch.device("cpu"), tc)[1]
    masks = TR.trainable_mask(flux, tc)
    frozen = torch.bfloat16 if (stored, precision) == ("bfloat16", "bf16") else torch.float32
    assert any(name not in masks for name, _ in flux.named_parameters())
    base = load_flux_transformer(src, cfg, dtype=torch.float32, device="cpu")
    for (name, p), b in zip(flux.named_parameters(), base.parameters()):
        want = torch.float32 if name in masks or name.endswith("scale") else frozen
        assert p.dtype == want and torch.equal(p.float(), b), name


def test_main_attn_resumes_bitwise_and_serves_its_export(checkpoint, tmp_path, rng, capsys,
                                                         live_models):
    """--mode attn, 8-bit AdamW, grad-accum 2: 2 steps checkpointed every
    step, then a resume to step 3, against a straight 3-step run: the log
    reads [1, 2, 3] and every parameter equals the straight run's bitwise
    (float32 throughout, the checkpoint being float32). The float32 export
    holds the live model, is key for key what the JAX exporter writes of
    the checkpoint where nothing trained (the frozen weights come back
    unchanged), and FillPipeline.from_pretrained serves it."""
    data = _data(tmp_path / "data", rng)
    straight, split = tmp_path / "straight", tmp_path / "split"
    CLI.main(_argv(checkpoint, data, straight, "--max-train-steps", "3",
                   "--checkpointing-steps", "1"))
    CLI.main(_argv(checkpoint, data, split, "--max-train-steps", "2",
                   "--checkpointing-steps", "1"))
    assert CheckpointManager(str(split / "checkpoints")).all_steps() == [1, 2]
    CLI.main(_argv(checkpoint, data, split, "--max-train-steps", "3",
                   "--checkpointing-steps", "1", "--resume-from-checkpoint", "latest"))
    assert "resumed from step 2" in capsys.readouterr().out
    log = _log(split)
    assert [e["step"] for e in log] == [1, 2, 3] == [e["step"] for e in _log(straight)]
    assert all(np.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in log)
    ref, resumed = live_models[0], live_models[2]
    masks = TR.trainable_mask(ref, TR.TrainConfig(mode="attn"))
    for (name, p), q in zip(ref.named_parameters(), resumed.parameters()):
        assert p.dtype == q.dtype == torch.float32 and torch.equal(p, q), name
    base = load_flux_transformer(os.path.join(checkpoint, "transformer"), port_cfg(FLUX_CFG),
                                 dtype=torch.float32, device="cpu")
    # the trainable parameters moved, the frozen ones hold the checkpoint
    for (name, p), b in zip(ref.named_parameters(), base.parameters()):
        assert torch.equal(p, b) != (name in masks), name

    export = load_safetensors_dir(str(straight / "transformer"))
    assert {v.dtype for v in export.values()} == {torch.float32}
    want = jax_export_flux_state_dict(JP.load_flux_transformer(
        os.path.join(checkpoint, "transformer"), FLUX_CFG, dtype=jnp.float32), FLUX_CFG)
    assert set(export) == set(want)
    keys, name_of = flux_key_map(ref), {id(p): k for k, p in ref.named_parameters()}
    trained = 0
    for k, v in want.items():
        param, rows = keys[k]
        name = name_of[id(param)]
        m = masks[name] if name in masks else torch.zeros(1)
        if m is None or (m if rows is None else m[rows]).any():
            trained += 1
            assert not np.array_equal(n(export[k]), np.asarray(v)), k
        else:
            np.testing.assert_array_equal(n(export[k]), np.asarray(v), err_msg=k)
    assert 0 < trained < len(want)
    cfg = TC.PipelineConfig(num_inference_steps=2, max_sequence_length=16)
    pipe = FillPipeline.from_pretrained(checkpoint, transformer_path=str(straight / "transformer"),
                                        dtype=torch.float32, pipe_cfg=cfg, attn_impl="plain",
                                        device="cpu")
    for (name, p), q in zip(ref.named_parameters(), pipe.flux.parameters()):
        assert torch.equal(p.float(), q), name
    kw = dict(image=Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)),
              mask_image=Image.fromarray(np.pad(np.full((20, 32), 255, np.uint8),
                                                ((10, 18), (8, 24)))),
              words=["OPEN"], height=48, width=64, seed=4, output_type="np",
              dtype=torch.float32)
    tuned = pipe(**kw)
    untuned = FillPipeline.from_pretrained(checkpoint, dtype=torch.float32, pipe_cfg=cfg,
                                           attn_impl="plain", device="cpu")(**kw)
    assert np.isfinite(tuned).all() and np.abs(tuned - untuned).max() > 1e-4


def test_main_all_preemption_saves_and_resumes(checkpoint, tmp_path, rng):
    """--mode all under SIGTERM: the step finishes, the state is saved,
    the log ends with {"preempted": true} and nothing is exported; resuming
    'latest' continues from that step and exports."""
    data = _data(tmp_path / "data", rng)
    out = tmp_path / "out"
    argv = _argv(checkpoint, data, out, "--mode", "all", "--max-train-steps", "50",
                 "--checkpointing-steps", "100")
    log = out / "train_log.jsonl"

    def preempt_after_first_step():
        deadline = time.time() + 120
        while time.time() < deadline:
            if log.exists() and log.read_text().strip():
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.05)

    previous = signal.getsignal(signal.SIGTERM)
    thread = threading.Thread(target=preempt_after_first_step, daemon=True)
    thread.start()
    CLI.main(argv)
    thread.join(timeout=130)
    assert signal.getsignal(signal.SIGTERM) == previous
    lines = _log(out)
    assert lines[-1].get("preempted") is True
    stop = lines[-1]["step"]
    assert 1 <= stop < 50
    assert CheckpointManager(str(out / "checkpoints")).all_steps() == [stop]
    assert not (out / "transformer").exists()

    argv[argv.index("--max-train-steps") + 1] = str(stop + 1)
    CLI.main(argv + ["--resume-from-checkpoint", "latest"])
    assert [e["step"] for e in _log(out) if "loss" in e] == list(range(1, stop + 2))
    assert (out / "transformer" / "diffusion_pytorch_model.safetensors").exists()
