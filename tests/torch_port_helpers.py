"""Shared helpers for the tests that hold textflux_torch against textflux_tpu.

Parameters come from the JAX package's own init and cross over as numpy
through ``textflux_torch.io.from_jax.load_jax_params``; both sides then run
in float32 on the CPU. Noise the JAX side draws with ``jax.random`` is drawn
here the same way and handed to the port.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import textflux_torch.config as TC
from textflux_torch.io.from_jax import load_jax_params
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
