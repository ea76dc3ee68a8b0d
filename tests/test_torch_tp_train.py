"""The JAX package's multi-chip dry run (__graft_entry__.py dryrun_multichip,
_dryrun_lora, _dryrun_serving; MULTICHIP_r05.json) on the port, at the same
mesh (2, 2, 2): data x fsdp x tensor, held against the JAX package's runs on
the same params and inputs, on the CPU.

One spawn of 8 gloo ranks (tests/torch_dist_helpers.py multichip_cases, one
thread each, every join under a timeout, every rank killed at the end); the
JAX side runs here meanwhile on its 8-device CPU mesh at the same shape, and
the results cross as numpy. Each rank holds its tensor shard of the DiT
(device-major), FSDP slices of that over fsdp, and the batch's row of its
(data, fsdp) coordinates; the ranks of a tensor group train on the same row.

The dry runs' configs, with two changes the comparisons need, as the other
step tests (tests/test_torch_fsdp.py) make them: float32 compute (the dry
run's default is bf16) and Adam's eps 1e-5 (at 1e-8 an element whose
gradient is ~1e-8 steps by up to +-lr on a last-bit difference in its sum).
The parameters are the dry run's draws rounded through bf16, the storage the
trainer gives frozen weights. Tolerances: the loss and grad norm within 1e-5
relative (1e-4 for LoRA), every trained tensor within 1e-5 of its largest
|value| or 1e-3 of a step, whichever is larger (LoRA: 1e-3 of a step), the
frozen ones and masked elements bitwise;
the served float images within 1e-4 of JAX's (tests/test_torch_parallel.py's
bound). Tensor parallelism in the other training modes and the checkpoints
across meshes are in tests/test_torch_fsdp.py, the tensor-parallel
gradients and serving over fsdp in tests/test_torch_parallel.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from PIL import Image

from textflux_tpu.config import (CLIPTextConfig, FluxConfig, PipelineConfig, T5Config,
                                 VAEConfig)
from textflux_tpu.io.quantize import quantize_tree
from textflux_tpu.models.clip import init_clip_params
from textflux_tpu.models.t5 import init_t5_params
from textflux_tpu.models.transformer import init_flux_params
from textflux_tpu.models.vae import init_vae_params
from textflux_tpu.parallel import partitioning as JPT
from textflux_tpu.pipeline import fill as JF
from textflux_tpu.training import train as JTR

import textflux_torch.config as TC
from textflux_torch.io.from_jax import load_jax_lora
from textflux_torch.models import transformer as TT
from textflux_torch.training import train as TR

import torch_dist_helpers as D
from torch_port_helpers import jax_loss_noise, jax_pipeline_noise, n, port_cfg, port_module, \
    port_train_config

SHAPE = (2, 2, 2)
# __graft_entry__.py dryrun_multichip / _dryrun_lora: heads 4 (tp 2: 2 a rank)
FLUX = FluxConfig(in_channels=48, out_channels=16, num_double_layers=2, num_single_layers=2,
                  num_heads=4, head_dim=8, joint_dim=32, pooled_dim=16, guidance_embeds=True,
                  axes_dims_rope=(4, 2, 2), time_embed_channels=256)
VAE = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
                norm_num_groups=4, scaling_factor=0.5, shift_factor=0.1)
B = 4          # max(data * fsdp, 2): a row a (data, fsdp) rank
STEPS = 2      # _dryrun_serving's denoise steps
H, W = 32, 48  # _dryrun_serving's image


def _bf16(tree):
    return jax.tree.map(lambda x: jnp.asarray(torch.tensor(np.asarray(x)).bfloat16().float()
                                              .numpy()), tree)


def _batch():
    rng = np.random.default_rng(0)
    return {
        "pixel_values": rng.standard_normal((2, B, 32, 32, 3)).astype(np.float32),
        "mask": (rng.random((2, B, 32, 32)) > 0.8).astype(np.float32),
        "txt": rng.standard_normal((2, B, 6, 32)).astype(np.float32),
        "pooled": rng.standard_normal((2, B, 16)).astype(np.float32),
    }


def _jax_train(jtc, params, vae, batch, key, mesh, lora=None):
    """One JAX step on the (2, 2, 2) mesh (the dry run's sharding)."""
    bspec = NamedSharding(mesh, P(None, ("data", "fsdp")))
    with mesh:
        sbatch = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), bspec), batch)
        svae = JPT.replicate_tree(vae, mesh)
        if lora is None:
            mask = JTR.attn_only_mask(params, FLUX, jtc)
            tx = JTR.make_optimizer(jtc, mask)
            step = JTR.make_train_step(FLUX, VAE, jtc, tx, attn_impl="xla",
                                       trainable_leaves=jax.tree.map(JTR.np_any_trainable, mask))
            sparams = JPT.shard_tree(params, JPT.flux_param_specs(FLUX), mesh)
            new, _, m = jax.jit(step)(sparams, tx.init(params), mask, svae, sbatch, key)
        else:
            tx = JTR.make_optimizer(jtc)
            step = JTR.make_lora_train_step(FLUX, VAE, jtc, tx, attn_impl="xla")
            sbase = JPT.shard_tree(params, JPT.adapt_specs_to_params(
                JPT.flux_param_specs(FLUX), params), mesh)
            slora = JPT.shard_tree(lora, JPT.lora_param_specs(lora), mesh)
            new, _, m = jax.jit(step)(sbase, slora, tx.init(slora), svae, sbatch, key)
        return dict(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                    params=jax.tree.map(np.asarray, new))


def _serving_spec():
    """_dryrun_serving's pipeline (heads 2 * tp), its unquantised DiT for the
    port (which quantises as it shards), and the call with the JAX draws."""
    flux_cfg = dataclasses.replace(FLUX, num_heads=2 * SHAPE[2])
    clip_cfg = CLIPTextConfig(vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2,
                              mlp_dim=32, max_positions=24, eos_token_id=63)
    t5_cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_heads=4)
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    trees = {"flux": (init_flux_params(ks[0], flux_cfg), flux_cfg),
             "vae": (init_vae_params(ks[1], VAE), VAE),
             "clip": (init_clip_params(ks[2], clip_cfg), clip_cfg),
             "t5": (init_t5_params(ks[3], t5_cfg), t5_cfg)}
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)) for _ in range(B)]
    m = np.zeros((H, W), np.uint8)
    m[10:20, 10:30] = 255
    seeds = list(range(B))
    call = dict(images=images, masks=[Image.fromarray(m)] * B, words_list=[["hi"]] * B,
                height=H, width=W, num_inference_steps=STEPS, seeds=seeds, sampler="euler")
    noise = [jax_pipeline_noise(s, height=H, width=W, vae_cfg=VAE, steps=STEPS) for s in seeds]
    spec = dict(shape=SHAPE, call=dict(call, noise=noise),
                pipe_cfg=TC.PipelineConfig(num_inference_steps=STEPS),
                modules={k: (jax.tree.map(np.asarray, t), port_cfg(c))
                         for k, (t, c) in trees.items()})
    return trees, call, spec


@pytest.fixture(scope="module")
def multichip():
    assert jax.device_count() >= 8
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = JPT.make_mesh(SHAPE, jax.devices()[:8])
    params = _bf16(init_flux_params(jax.random.PRNGKey(0), FLUX))
    vae = init_vae_params(jax.random.PRNGKey(1), VAE)
    batch = _batch()
    key = jax.random.PRNGKey(7)
    noise = [jax_loss_noise(key, b=B, height=32, width=32, vae_cfg=VAE, accum=2)]
    train_tc = JTR.TrainConfig(grad_accum=2, excluded_single_layers=(), adam_eps=1e-5,
                               compute_dtype="float32")
    lora_tc = JTR.TrainConfig(grad_accum=2, excluded_single_layers=(), mode="lora",
                              lora_rank=4, lora_alpha=4.0, adam_eps=1e-5,
                              compute_dtype="float32")
    qbase = quantize_tree(params, min_size=0, mode="weight_only")
    lora = JTR.lora_init(jax.random.PRNGKey(2), qbase, FLUX, lora_tc.lora_rank)
    common = dict(flux=jax.tree.map(np.asarray, params), flux_cfg=port_cfg(FLUX),
                  vae=jax.tree.map(np.asarray, vae), vae_cfg=port_cfg(VAE), shape=SHAPE,
                  batches=[batch], noise=noise)
    trees, call, serving = _serving_spec()
    spec = dict(train=dict(common, tc=dataclasses.asdict(port_train_config(train_tc))),
                lora=dict(common, tc=dataclasses.asdict(port_train_config(lora_tc)),
                          lora=jax.tree.map(np.asarray, lora), quantize="weight_only"),
                serving=serving)
    try:
        with D.Ranks(D.multichip_cases, 8, spec) as ranks:
            refs = {"train": _jax_train(train_tc, params, vae, batch, key, mesh),
                    "lora": _jax_train(lora_tc, qbase, vae, batch, key, mesh, lora=lora)}
            refs["lora"]["lora"] = refs["lora"].pop("params")
            flux_cfg = trees["flux"][1]
            pipe = JF.FillPipeline(
                flux_params=quantize_tree(trees["flux"][0], min_size=0, mode="weight_only"),
                flux_cfg=flux_cfg, vae_params=trees["vae"][0], vae_cfg=VAE,
                clip_params=trees["clip"][0], clip_cfg=trees["clip"][1],
                t5_params=trees["t5"][0], t5_cfg=trees["t5"][1],
                clip_tokenize=D.dryrun_clip_tokenize, t5_tokenize=D.dryrun_t5_tokenize,
                pipe_cfg=PipelineConfig(num_inference_steps=STEPS), attn_impl="xla")
            with mesh, pytest.MonkeyPatch.context() as mp:
                pipe.shard_for_serving(mesh)
                mp.setattr(JF.improc, "postprocess_image", lambda x: x)
                refs["serving"] = np.asarray(pipe.generate_batch(**call, dtype=jnp.float32))
            results = ranks.results(timeout=300)
    finally:
        torch.set_num_threads(torch_threads)
    for r, res in enumerate(results):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return dict(results=results, refs=refs, params=params, lora=lora, qbase=qbase)


def _ok(res):
    assert isinstance(res, dict) and "error" not in res, res.get("error")
    return res


def test_dryrun_multichip_train_step_matches_jax(multichip):
    """--mode attn, AdamW, grad_accum 2 at (2, 2, 2): every rank's loss (the
    ranks' mean) and grad norm within 1e-5 of JAX's, every tensor gathered
    whole within 1e-5 of its largest |value| or 1e-3 of a step (lr 2e-5),
    whichever is larger (the dry run's biases start at zero, so one step is
    their whole value; measured on double_blocks.0.img_qkv.bias: 2.6e-4 of
    a step), the frozen ones and the
    masked linear1 rows bitwise, the trained ones moved."""
    want = multichip["refs"]["train"]
    got = [_ok(r["train"]) for r in multichip["results"]]
    for g in got:
        np.testing.assert_allclose(g["losses"], [want["loss"]], rtol=1e-5)
        np.testing.assert_allclose(g["norms"], [want["norm"]], rtol=1e-5)
    masks = TR.trainable_mask(TT.FluxTransformer(port_cfg(FLUX), device="meta"),
                              TR.TrainConfig(mode="attn"))
    moved = 0.0
    for name, x in got[0]["params"].items():
        target = _value(want["params"], name)
        before = _value(multichip["params"], name)
        tol = max(1e-5 * float(np.abs(target).max()), 1e-3 * TR.TrainConfig().learning_rate)
        np.testing.assert_allclose(x, target, rtol=0, atol=tol, err_msg=name)
        if name not in masks:
            np.testing.assert_array_equal(x, before, err_msg=name)
            continue
        m = masks[name]
        frozen = np.zeros(x.shape, bool) if m is None else np.broadcast_to(n(m) == 0, x.shape)
        np.testing.assert_array_equal(x[frozen], before[frozen], err_msg=name)
        moved = max(moved, float(np.abs(x - before)[~frozen].max()) / tol)
    assert moved > 1
    # the forward's all-reduces (twice with remat's recompute) and the
    # backward's, on every rank
    for g in got:
        assert g["counts"]["all_reduce_sum"] > 0 and g["counts"]["all_reduce_grad"] > 0


def test_dryrun_lora_over_int8_base_matches_jax(multichip):
    """LoRA rank 4 over an int8 weight-only base at (2, 2, 2): the codes
    tensor-sharded and storage-sharded over fsdp (gathered block by block),
    the factors whole over tensor and FSDP-sharded over fsdp. Loss and
    grad norm within 1e-4 of JAX's, the factors within 1e-3 of a step, every
    B moved; a rank holds half the (tensor-shard) base's codes."""
    want = multichip["refs"]["lora"]
    got = [_ok(r["lora"]) for r in multichip["results"]]
    for g in got:
        np.testing.assert_allclose(g["losses"], [want["loss"]], rtol=1e-4)
        np.testing.assert_allclose(g["norms"], [want["norm"]], rtol=1e-4)
        assert g["counts"]["all_gather_storage"] > 0
    model = port_module(multichip["params"], FLUX)
    factors = load_jax_lora(want["lora"], model)
    before = load_jax_lora(multichip["lora"], model)
    lr = TR.TrainConfig().learning_rate
    for name, x in got[0]["params"].items():
        path, _, k = name.rpartition(".")
        if k not in ("lora_a", "lora_b", "lora_ga", "lora_gb"):
            continue
        np.testing.assert_allclose(x, n(factors[path][k[-1]]), rtol=1e-4, atol=1e-3 * lr,
                                   err_msg=name)
        if k.endswith("b"):
            assert np.abs(x - n(before[path]["b"])).max() > 0, name


def test_dryrun_serving_int8_batch4_matches_jax(multichip):
    """The int8 DiT (heads 2 * tp) served at (2, 2, 2), batch 4 (a sample a
    (data, fsdp) rank), 2 euler steps with JAX's draws: every rank returns
    the whole batch within 1e-4 of JAX's sharded generate_batch; the tensor
    ranks' all-reduces, one gather of the batch, and each rank holding half
    of its tensor shard's codes (storage over fsdp)."""
    ref = multichip["refs"]["serving"]
    assert ref.shape == (B, H, W, 3)
    outs = [_ok(r["serving"]) for r in multichip["results"]]
    for o in outs:
        np.testing.assert_allclose(o["images"], ref, atol=1e-4)
        # 2 steps x (4 x 2 double + 2 single) all-reduces
        assert o["counts"]["all_reduce_sum"] == STEPS * 10
        assert o["counts"]["all_gather_batch"] == 1
        assert o["counts"]["all_gather_storage"] > 0
    assert len({o["storage_bytes"] for o in outs}) <= 2


def _value(tree, name):
    """The JAX tree's value for a port parameter name, in the port's layout."""
    leaf, layer, transpose = TR.jax_leaf(name)
    x = tree
    for part in leaf.split("."):
        x = x[part]
    x = np.asarray(x)
    x = x if layer is None else x[layer]
    return x.T if transpose and x.ndim == 2 else x
