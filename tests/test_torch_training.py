"""textflux_torch's LoRA training held against textflux_tpu's on the JAX
package's own parameters (carried over by load_jax_params / load_jax_lora)
and the JAX package's random draws (handed to the port as ``noise=``): the
LoRA branches of dense, the factor set, insert against merge, the timestep
density / sigma / weighting functions, the learning-rate schedules, the
clipped AdamW, flow_matching_loss on the "plain" and "flash" attention
paths, and two optimizer steps of make_lora_train_step. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import FLUX_TINY, FLUX_TINY_WIDE, VAE_TINY
from textflux_tpu.models import layers as JL
from textflux_tpu.models import vae as JV
from textflux_tpu.models.transformer import init_flux_params
from textflux_tpu.ops import samplers as JS
from textflux_tpu.training import train as JTR

from textflux_torch.io.from_jax import load_jax_lora
from textflux_torch.models import layers as TL
from textflux_torch.ops import samplers as TS
from textflux_torch.training import train as TR

from torch_port_helpers import jax_loss_noise, n, port_module, port_train_config, t

H = W = 32   # pixels: a 16x16 VAE_TINY latent, 64 image tokens


def _batch(rng, accum=1, b=1, t_txt=6, cfg=FLUX_TINY):
    return {
        "pixel_values": (rng.standard_normal((accum, b, H, W, 3)) * 0.5).astype(np.float32),
        "mask": (rng.random((accum, b, H, W)) > 0.8).astype(np.float32),
        "txt": rng.standard_normal((accum, b, t_txt, cfg.joint_dim)).astype(np.float32),
        "pooled": rng.standard_normal((accum, b, cfg.pooled_dim)).astype(np.float32),
    }


def _tc(**kw):
    base = dict(mode="lora", grad_accum=1, lora_rank=4, lora_alpha=8.0, learning_rate=1e-3,
                compute_dtype="float32")
    base.update(kw)
    return JTR.TrainConfig(**base)


@pytest.fixture(scope="module")
def jax_models():
    params = init_flux_params(jax.random.PRNGKey(0), FLUX_TINY)
    vae_params = JV.init_vae_params(jax.random.PRNGKey(1), VAE_TINY)
    lora = JTR.lora_init(jax.random.PRNGKey(3), params, FLUX_TINY, 4)
    # non-zero B so every branch contributes to the loss
    lora = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(9), x.shape), lora)
    return params, vae_params, lora


def _port(jax_models, lora=None, scale=2.0):
    params, vae_params, jax_lora = jax_models
    model = port_module(params, FLUX_TINY)
    factors = load_jax_lora(jax.tree.map(np.asarray, jax_lora if lora is None else lora),
                            model)
    TR.lora_insert(model, factors, scale)
    return model, port_module(vae_params, VAE_TINY), factors


def _mb(batch, i=0):
    return {k: t(v[i]) for k, v in batch.items()}


@pytest.mark.parametrize("kind", ["plain", "grouped", "grouped_mlp_tail"])
def test_dense_lora_matches_jax(kind, rng):
    d_in, r, m, d = 24, 4, 3, 8
    d_out = {"plain": 40, "grouped": m * d, "grouped_mlp_tail": m * d + 20}[kind]
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    bias = rng.standard_normal(d_out).astype(np.float32)
    if kind == "plain":
        a = rng.standard_normal((d_in, r)).astype(np.float32)
        b = rng.standard_normal((r, d_out)).astype(np.float32)
    else:
        a = rng.standard_normal((m, d_in, r)).astype(np.float32)
        b = rng.standard_normal((m, r, d)).astype(np.float32)
    x = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    scale = 0.5
    keys = ("lora_a", "lora_b") if kind == "plain" else ("lora_ga", "lora_gb")
    want = JL.dense({"w": w, "b": bias, keys[0]: a * scale, keys[1]: b}, jnp.asarray(x))

    lin = torch.nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(t(w).T)
        lin.bias.copy_(t(bias))
    TR.lora_insert(lin, {"": {"a": t(a), "b": t(b)}}, scale)
    got = TL.dense(lin, t(x))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not lin.weight.requires_grad and getattr(lin, keys[0]).requires_grad


@pytest.mark.parametrize("cfg", [FLUX_TINY, FLUX_TINY_WIDE], ids=["tiny", "tiny_wide"])
def test_lora_init_targets_match_jax(cfg):
    params = init_flux_params(jax.random.PRNGKey(0), cfg)
    want = JTR.lora_init(jax.random.PRNGKey(3), params, cfg, 4)
    model = port_module(params, cfg)
    got = TR.lora_init(model, 4, generator=torch.Generator().manual_seed(0))
    expected = {}
    for group, blocks, n_layers in (("double", "double_blocks", cfg.num_double_layers),
                                    ("single", "single_blocks", cfg.num_single_layers)):
        for name, f in want[group].items():
            for i in range(n_layers):
                expected[f"{blocks}.{i}.{name}"] = (f["a"].shape[1:], f["b"].shape[1:])
    assert list(got) == list(TR.lora_targets(model))
    assert {p: (tuple(f["a"].shape), tuple(f["b"].shape)) for p, f in got.items()} == expected
    for f in got.values():
        assert f["a"].dtype == torch.float32 and not f["b"].any()
        assert 0.5 / 4 < float(f["a"].detach().std()) < 2.0 / 4     # N(0, 1) / rank


def test_load_jax_lora_round_trip(jax_models):
    params, _, jax_lora = jax_models
    model = port_module(params, FLUX_TINY)
    got = load_jax_lora(jax.tree.map(np.asarray, jax_lora), model)
    np.testing.assert_array_equal(n(got["double_blocks.1.img_mlp.fc2"]["b"]),
                                  np.asarray(jax_lora["double"]["img_mlp.fc2"]["b"][1]))
    np.testing.assert_array_equal(n(got["single_blocks.0.linear1"]["a"]),
                                  np.asarray(jax_lora["single"]["linear1"]["a"][0]))
    assert all(isinstance(x, torch.nn.Parameter) for f in got.values() for x in f.values())


def test_lora_merge_matches_jax(jax_models):
    params, _, jax_lora = jax_models
    want = JTR.lora_merge(params, jax_lora, 2.0)
    model = port_module(params, FLUX_TINY)
    TR.lora_merge(model, load_jax_lora(jax.tree.map(np.asarray, jax_lora), model), 2.0)
    for i in range(FLUX_TINY.num_double_layers):
        np.testing.assert_allclose(n(model.double_blocks[i].txt_qkv.weight).T,
                                   np.asarray(want["double"]["txt_qkv"]["w"][i]), atol=1e-6)
        np.testing.assert_allclose(n(model.double_blocks[i].img_mlp.fc1.weight).T,
                                   np.asarray(want["double"]["img_mlp"]["fc1"]["w"][i]),
                                   atol=1e-6)
    for i in range(FLUX_TINY.num_single_layers):
        np.testing.assert_allclose(n(model.single_blocks[i].linear1.weight).T,
                                   np.asarray(want["single"]["linear1"]["w"][i]), atol=1e-6)


def test_lora_insert_matches_merge(jax_models, rng):
    """Same loss, and the factors' gradients through the parallel branch
    equal those through the merged weight (chain rule: with W' = W +
    s*(A@B)^T, dA = s*G^T B^T and dB = s*A^T G^T)."""
    tc = port_train_config(_tc())
    batch = _mb(_batch(rng))
    noise = {k: t(v) for k, v in jax_loss_noise(jax.random.PRNGKey(4), b=1, height=H,
                                                width=W, vae_cfg=VAE_TINY).items()}
    model, vae, factors = _port(jax_models)
    loss_insert = TR.flow_matching_loss(model, vae, tc, batch, attn_impl="plain", noise=noise)
    loss_insert.backward()

    params, _, jax_lora = jax_models
    merged = port_module(params, FLUX_TINY)
    merged_factors = load_jax_lora(jax.tree.map(np.asarray, jax_lora), merged)
    TR.lora_merge(merged, merged_factors, 2.0)
    loss_merge = TR.flow_matching_loss(merged, vae, tc, batch, attn_impl="plain", noise=noise)
    loss_merge.backward()
    np.testing.assert_allclose(loss_insert.item(), loss_merge.item(), rtol=1e-5)

    for path in ("double_blocks.0.img_proj", "double_blocks.1.txt_qkv", "single_blocks.1.linear1"):
        g = merged.get_submodule(path).weight.grad      # (out, in)
        a, b = (merged_factors[path][k].detach() for k in ("a", "b"))
        if a.dim() == 3:    # grouped: module j owns output rows j*d:(j+1)*d
            m, _, d = b.shape
            gj = g[:m * d].reshape(m, d, -1)             # (M, d, in)
            da = 2.0 * torch.einsum("mdi,mrd->mir", gj, b)
            db = 2.0 * torch.einsum("mir,mdi->mrd", a, gj)
        else:
            da, db = 2.0 * g.T @ b.T, 2.0 * a.T @ g.T
        np.testing.assert_allclose(n(factors[path]["a"].grad), n(da), rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(n(factors[path]["b"].grad), n(db), rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("scheme", ["none", "logit_normal", "mode", "sigma_sqrt", "cosmap"])
def test_density_sigmas_and_weights_match_jax(scheme):
    key = jax.random.PRNGKey(5)
    raw = (jax.random.normal if scheme == "logit_normal" else jax.random.uniform)(key, (64,))
    want_u = JS.sample_timestep_density(key, 64, scheme, 0.3, 1.2, 1.29)
    got_u = TS.sample_timestep_density(64, scheme, 0.3, 1.2, 1.29, u=t(raw))
    np.testing.assert_allclose(n(got_u), np.asarray(want_u), rtol=1e-6, atol=1e-7)
    for shift in (1.0, 3.0):
        want_s = JS.train_sigmas(want_u, shift=shift)
        got_s = TS.train_sigmas(t(want_u), shift=shift)
        np.testing.assert_allclose(n(got_s), np.asarray(want_s), rtol=1e-6)
        np.testing.assert_allclose(n(TS.loss_weighting(scheme, got_s)),
                                   np.asarray(JS.loss_weighting(scheme, want_s)), rtol=1e-5)
    drawn = TS.sample_timestep_density(8, scheme, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (8,) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("scheduler,warmup", [
    ("constant", 0), ("constant", 10), ("cosine", 0), ("cosine", 10), ("linear", 0),
    ("linear", 10), ("cosine_with_restarts", 10), ("polynomial", 0)])
def test_lr_schedules_match_jax(scheduler, warmup):
    tc = JTR.TrainConfig(lr_scheduler=scheduler, lr_warmup_steps=warmup, learning_rate=2e-3,
                         max_train_steps=100, lr_num_cycles=2, lr_power=2.0)
    want = JTR.make_lr_schedule(tc)
    got = TR.make_lr_schedule(port_train_config(tc))
    for step in (0, 1, 5, 10, 11, 37, 50, 99, 100, 130):
        w = want(step) if callable(want) else want
        # the JAX schedules run in float32: near zero, absolute to its epsilon
        assert got(step) == pytest.approx(float(w), rel=1e-5, abs=1e-6 * tc.learning_rate), step


@pytest.mark.parametrize("max_norm", [1e-3, 10.0], ids=["clipped", "unclipped"])
def test_clipped_adamw_matches_optax(max_norm, rng):
    tc = JTR.TrainConfig(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=max_norm)
    shapes = [(5, 3), (4,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
             for _ in range(3)]
    tx = JTR.make_optimizer(tc)
    state = tx.init(params)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt = TR.make_optimizer(port_train_config(tc), {f"p{i}": p for i, p in enumerate(tp)})
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = t(x)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_flow_matching_loss_matches_jax(impl, jax_models, rng):
    params, vae_params, jax_lora = jax_models
    jtc = _tc(weighting_scheme="cosmap")
    batch = _batch(rng)
    key = jax.random.PRNGKey(7)
    want = JTR.flow_matching_loss(
        JTR.lora_insert(params, jax_lora, 2.0), FLUX_TINY, vae_params, VAE_TINY, jtc,
        {k: jnp.asarray(v[0]) for k, v in batch.items()}, key, attn_impl="xla")
    model, vae, _ = _port(jax_models)
    noise = jax_loss_noise(key, b=1, height=H, width=W, vae_cfg=VAE_TINY, scheme="cosmap")
    got = TR.flow_matching_loss(model, vae, port_train_config(jtc), _mb(batch),
                                attn_impl=impl, noise=noise)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_two_lora_steps_match_jax(impl, rng):
    """Two optimizer steps (lr 1e-3, so the factors move well past their
    rounding): loss, grad_norm and both factors after each step. Adam scales
    each update by g / (|g| + eps), so on the few elements whose gradient is
    near eps (1e-8) the two sides' float32 summation orders show through:
    atol is 1e-3 of one step's size there, rtol 1e-4 everywhere."""
    params = init_flux_params(jax.random.PRNGKey(0), FLUX_TINY)
    vae_params = JV.init_vae_params(jax.random.PRNGKey(1), VAE_TINY)
    jtc = _tc()
    jax_lora = JTR.lora_init(jax.random.PRNGKey(3), params, FLUX_TINY, jtc.lora_rank)
    tx = JTR.make_optimizer(jtc)
    opt_state = tx.init(jax_lora)
    step = jax.jit(JTR.make_lora_train_step(FLUX_TINY, VAE_TINY, jtc, tx, attn_impl="xla"))

    model, vae, factors = _port((params, vae_params, jax_lora))
    tc = port_train_config(jtc)
    opt = TR.make_optimizer(tc, TR.lora_named_parameters(factors))
    port_step = TR.make_train_step(tc, attn_impl=impl)
    for i in range(2):
        batch = _batch(rng)
        key = jax.random.PRNGKey(10 + i)
        jax_lora, opt_state, want = step(params, jax_lora, opt_state, vae_params,
                                         jax.tree.map(jnp.asarray, batch), key)
        noise = [jax_loss_noise(key, b=1, height=H, width=W, vae_cfg=VAE_TINY)]
        got = port_step(model, vae, opt, {k: t(v) for k, v in batch.items()}, noise=noise)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
        for group, blocks in (("double", "double_blocks"), ("single", "single_blocks")):
            for name, f in jax_lora[group].items():
                for layer in range(f["a"].shape[0]):
                    for k in ("a", "b"):
                        np.testing.assert_allclose(
                            n(factors[f"{blocks}.{layer}.{name}"][k]), np.asarray(f[k][layer]),
                            rtol=1e-4, atol=1e-3 * jtc.learning_rate)


def _grads(model, vae, tc, batch, noise, impl="flash"):
    factors = [p for p in model.parameters() if p.requires_grad]
    for p in factors:
        p.grad = None
    TR.flow_matching_loss(model, vae, tc, batch, attn_impl=impl, noise=noise).backward()
    return [p.grad.clone() for p in factors]


def test_remat_gives_equal_gradients(jax_models, rng):
    model, vae, _ = _port(jax_models)
    batch = _mb(_batch(rng))
    noise = jax_loss_noise(jax.random.PRNGKey(2), b=1, height=H, width=W, vae_cfg=VAE_TINY)
    on = _grads(model, vae, port_train_config(_tc(remat=True)), batch, noise)
    off = _grads(model, vae, port_train_config(_tc(remat=False)), batch, noise)
    for a, b in zip(on, off):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-9)


def test_grad_accum_is_the_mean_of_its_microbatches(jax_models, rng):
    """grad_accum 2 (learning rate 0, so the step leaves the factors as they
    were): the accumulated gradients and loss are the means of the two
    microbatches' own."""
    model, vae, factors = _port(jax_models)
    tc = port_train_config(_tc(grad_accum=2, learning_rate=0.0))
    batch = _batch(rng, accum=2)
    noise = jax_loss_noise(jax.random.PRNGKey(6), b=1, height=H, width=W, vae_cfg=VAE_TINY,
                           accum=2)
    params = TR.lora_parameters(factors)
    opt = TR.make_optimizer(tc, TR.lora_named_parameters(factors))
    metrics = TR.make_train_step(tc)(model, vae, opt, {k: t(v) for k, v in batch.items()},
                                     noise=noise)
    accumulated = [p.grad.clone() for p in params]
    losses, singles = [], []
    for i in range(2):
        for p in params:
            p.grad = None
        loss = TR.flow_matching_loss(model, vae, tc, _mb(batch, i), attn_impl="plain",
                                     noise=noise[i])
        loss.backward()
        losses.append(loss.item())
        singles.append([p.grad.clone() for p in params])
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)
    for acc, g0, g1 in zip(accumulated, *singles):
        np.testing.assert_allclose(n(acc), n((g0 + g1) / 2), rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(TR.global_norm(accumulated)), rtol=1e-6)


def test_step_draws_from_a_generator_and_freezes_the_base(jax_models, rng):
    model, vae, factors = _port(jax_models)
    tc = port_train_config(_tc(cond_dropout_prob=0.2, weighting_scheme="logit_normal"))
    before = TR.base_checksum(model)
    opt = TR.make_optimizer(tc, TR.lora_named_parameters(factors))
    step = TR.make_train_step(tc)
    batch = {k: t(v) for k, v in _batch(rng).items()}
    m1 = step(model, vae, opt, batch, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m1["loss"])) and float(m1["grad_norm"]) > 0
    assert TR.base_checksum(model) == before
    with pytest.raises(ValueError, match="noise keys"):
        TR.flow_matching_loss(model, vae, tc, _mb(_batch(rng)), noise={"eps": 0})
