"""Shared helpers for the tests that hold textflux_torch against textflux_tpu.

Parameters come from the JAX package's own init and cross over as numpy
through ``textflux_torch.io.from_jax.load_jax_params``; both sides then run
in float32 on the CPU. Noise the JAX side draws with ``jax.random`` is drawn
here the same way and handed to the port.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from textflux_tpu.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig
from textflux_tpu.io.export import save_transformer_checkpoint
from textflux_tpu.models.transformer import init_flux_params

import textflux_torch.config as TC
from textflux_torch.io import params as TP
from textflux_torch.io.from_jax import load_jax_params
from textflux_torch.io.safetensors import save_file
from textflux_torch.models import vae as TV
from textflux_torch.models.clip import CLIPTextModel
from textflux_torch.models.t5 import T5Encoder
from textflux_torch.pipeline.fill import FillPipeline


def port_cfg(cfg):
    """The port's config dataclass with the same fields as a JAX one."""
    return getattr(TC, type(cfg).__name__)(**dataclasses.asdict(cfg))


def port_module(tree, cfg):
    """A port module (on the CPU, float32) holding a JAX parameter tree."""
    return load_jax_params(jax.tree.map(np.asarray, tree), port_cfg(cfg), device="cpu")


def port_pipeline(jax_pipe, attn_impl="plain"):
    """The port's FillPipeline on the parameters of a JAX FillPipeline built
    with attn_impl="xla" (whose DiT weights are still unpermuted)."""
    return FillPipeline(
        flux=port_module(jax_pipe.flux_params, jax_pipe.flux_cfg),
        vae=port_module(jax_pipe.vae_params, jax_pipe.vae_cfg),
        clip=port_module(jax_pipe.clip_params, jax_pipe.clip_cfg),
        t5=port_module(jax_pipe.t5_params, jax_pipe.t5_cfg),
        clip_tokenize=jax_pipe.clip_tokenize, t5_tokenize=jax_pipe.t5_tokenize,
        pipe_cfg=TC.PipelineConfig(**dataclasses.asdict(jax_pipe.pipe_cfg)),
        attn_impl=attn_impl, device="cpu")


def jax_pipeline_noise(seed, *, height, width, vae_cfg, steps, b=1):
    """The draws FillPipeline.__call__ of the JAX package makes for `seed`
    (single image): initial latents, VAE posterior eps, per-step overshoot
    noise — as writable numpy arrays for the port's ``noise=``."""
    f = vae_cfg.spatial_factor
    lat_h, lat_w = height // f, width // f
    t_img = (lat_h // 2) * (lat_w // 2)
    c = vae_cfg.latent_channels
    key_noise, key_vae, key_steps = jax.random.split(jax.random.PRNGKey(seed), 3)
    step_keys = jax.random.split(key_steps, steps)
    return {
        "latents": np.array(jax.random.normal(key_noise, (b, t_img, c * 4), jnp.float32)),
        "vae": np.array(jax.random.normal(key_vae, (b, lat_h, lat_w, c), jnp.float32)),
        "steps": np.stack([np.array(jax.random.normal(k, (t_img, c * 4), jnp.float32))[None]
                           for k in step_keys]),
    }


def jax_loss_noise(key, *, b, height, width, vae_cfg, scheme="none", accum=None):
    """The draws ``textflux_tpu.training.train.flow_matching_loss`` makes
    from `key` (split five ways as its train.py:412 does): both VAE posterior
    eps, the raw timestep-density draw "u" and the flow-matching "noise", as
    numpy arrays for the port's ``noise=``. With `accum`, one dict per
    microbatch from ``jax.random.split(key, accum)``, as the JAX step's
    accumulation scan splits it."""
    if accum is not None:
        return [jax_loss_noise(k, b=b, height=height, width=width, vae_cfg=vae_cfg,
                               scheme=scheme) for k in jax.random.split(key, accum)]
    f = vae_cfg.spatial_factor
    lat = (b, height // f, width // f, vae_cfg.latent_channels)
    k_vae, k_cond, k_t, k_noise, _ = jax.random.split(key, 5)
    raw = jax.random.normal if scheme == "logit_normal" else jax.random.uniform
    return {
        "vae": np.array(jax.random.normal(k_vae, lat, jnp.float32)),
        "cond_vae": np.array(jax.random.normal(k_cond, lat, jnp.float32)),
        "u": np.array(raw(k_t, (b,))),
        "noise": np.array(jax.random.normal(k_noise, lat, jnp.float32)),
    }


def port_train_config(tc):
    """The port's TrainConfig with the values of a JAX one (the port's
    fields are a subset)."""
    from textflux_torch.training.train import TrainConfig

    return TrainConfig(**{f.name: getattr(tc, f.name) for f in dataclasses.fields(TrainConfig)})


def t(x, dtype=torch.float32):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# a tiny checkpoint in the diffusers layout (the serving and training CLIs' tests)
# ---------------------------------------------------------------------------

# an 8x VAE (four blocks), so the example canvas packs to 896 image tokens
VAE_CFG = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=4,
                    norm_num_groups=4, scaling_factor=0.5, shift_factor=0.1)
FLUX_CFG = FluxConfig(in_channels=16 + 16 + 256, out_channels=16, num_double_layers=2,
                      num_single_layers=2, num_heads=2, head_dim=8, joint_dim=32, pooled_dim=16,
                      axes_dims_rope=(4, 2, 2))
CLIP_CFG = CLIPTextConfig(vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2, mlp_dim=32,
                          max_positions=77, eos_token_id=3)
T5_CFG = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_heads=4,
                  relative_attention_num_buckets=8, relative_attention_max_distance=16)

HF_CONFIGS = {
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [8, 8, 16, 16], "layers_per_block": 1, "norm_num_groups": 4,
            "scaling_factor": 0.5, "shift_factor": 0.1},
    "text_encoder": {"vocab_size": 64, "hidden_size": 16, "num_hidden_layers": 1,
                     "num_attention_heads": 2, "intermediate_size": 32,
                     "max_position_embeddings": 77, "eos_token_id": 3},
    "text_encoder_2": {"vocab_size": 64, "d_model": 32, "d_kv": 8, "d_ff": 64, "num_layers": 1,
                       "num_heads": 4, "relative_attention_num_buckets": 8,
                       "relative_attention_max_distance": 16},
}
VOCAB = ["the", "a", "image", "text", "words", "with", "of", "on", "and", "is", "pair",
         "images", "'OPEN'", "'SALE'"]


def write_tokenizers(root):
    """WordLevel tokenizer directories saved as transformers saves them."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "<unk>": 1, "<bos>": 2, "<eos>": 3}
    vocab.update({w: 4 + i for i, w in enumerate(VOCAB)})
    for name in ("tokenizer", "tokenizer_2"):
        tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
        PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", pad_token="<pad>",
                                bos_token="<bos>", eos_token="<eos>").save_pretrained(
            os.path.join(root, name))


def real_naming(model) -> dict:
    """A port module's state dict in the diffusers/transformers naming."""
    return {k: (p if rows is None else p[rows]).detach()
            for k, (p, rows) in TP.key_map(model).items()}


def write_component(root, sub, model):
    """A component in the diffusers/transformers naming, with its config.json."""
    save_file(real_naming(model), os.path.join(root, sub, "model.safetensors"))
    with open(os.path.join(root, sub, "config.json"), "w") as f:
        json.dump(HF_CONFIGS[sub], f)


def write_tiny_checkpoint(root: str) -> str:
    """A tiny FLUX.1-Fill checkpoint in the diffusers layout under `root`:
    the DiT (seed 11) from the JAX exporter, the VAE, CLIP and T5 from
    seeded port modules, WordLevel tokenizers, and a peft LoRA on a few
    modules under lora/. Returns `root`."""
    # the DiT from the JAX exporter; the rest from seeded port modules (both
    # packages then read every component from these files)
    flux = init_flux_params(jax.random.PRNGKey(11), FLUX_CFG)
    save_transformer_checkpoint(flux, FLUX_CFG, os.path.join(root, "transformer"))
    g = torch.Generator().manual_seed(11)
    write_component(root, "vae", TV.FluxVAE(port_cfg(VAE_CFG), device="cpu", generator=g))
    write_component(root, "text_encoder",
                    CLIPTextModel(port_cfg(CLIP_CFG), device="cpu", generator=g))
    write_component(root, "text_encoder_2",
                    T5Encoder(port_cfg(T5_CFG), device="cpu", generator=g))
    write_tokenizers(root)
    # a peft LoRA on a few modules, alpha given for some
    rng = np.random.default_rng(3)
    lora = {}
    for mod, (d_out, d_in) in {"transformer_blocks.0.attn.to_k": (16, 16),
                               "transformer_blocks.1.attn.add_v_proj": (16, 16),
                               "transformer_blocks.1.ff.net.0.proj": (64, 16),
                               "single_transformer_blocks.0.attn.to_q": (16, 16)}.items():
        lora[f"transformer.{mod}.lora_A.weight"] = torch.tensor(
            rng.standard_normal((2, d_in)) * 0.5, dtype=torch.float32)
        lora[f"transformer.{mod}.lora_B.weight"] = torch.tensor(
            rng.standard_normal((d_out, 2)) * 0.5, dtype=torch.float32)
        if "single" in mod:
            lora[f"transformer.{mod}.alpha"] = torch.tensor(3.0)
    save_file(lora, os.path.join(root, "lora", "pytorch_lora_weights.safetensors"))
    return root
