"""Flow-matching samplers (Euler, AMO stochastic overshoot) and the
training-time timestep density, sigma lookup and loss weighting.

Step functions over a precomputed sigma schedule. Scalars (sigma, c) are
taken as float32 0-d tensors so the step arithmetic runs in float32, as in
the JAX package. The overshoot steps consume Gaussian noise: pass it in as
``noise``, or give a ``torch.Generator`` to draw it from.

Behavioral parity references (diffusers):
  Euler update:  scheduling_flow_match_euler_discrete.py:327
  dynamic shift: pipeline_flux_fill.py:1248-1260
  AMO overshoot: scheduling_stochastic_rf_discrete_overshot.py:246-357
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Resolution-dependent schedule shift (mu) for the exponential time shift."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def make_schedule(
    num_steps: int,
    image_seq_len: Optional[int] = None,
    *,
    shift: float = 1.0,
    use_dynamic_shifting: bool = True,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> np.ndarray:
    """Sigma schedule of length num_steps+1 (terminal 0 appended), host-side.

    With dynamic shifting (the FLUX fill default), sigmas are warped by
    sigma' = e^mu / (e^mu + (1/sigma - 1)); otherwise by the static shift
    sigma' = shift*s / (1 + (shift-1)*s).
    """
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting:
        if image_seq_len is None:
            raise ValueError("image_seq_len is required for dynamic shifting")
        mu = calculate_shift(image_seq_len, base_seq_len, max_seq_len, base_shift, max_shift)
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0) ** 1.0)
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return np.append(sigmas, 0.0).astype(np.float32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _noise(x: torch.Tensor, noise: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(x.shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(x.shape)}")
        return noise.to(device=x.device, dtype=torch.float32)
    if generator is None:
        raise ValueError("the overshoot step needs noise or a generator")
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)


def euler_step(x: torch.Tensor, v: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    """Rectified-flow Euler: x <- x + (sigma_next - sigma) * v, fp32 internally."""
    sigma, sigma_next = _f32(sigma, x.device), _f32(sigma_next, x.device)
    out = x.float() + (sigma_next - sigma) * v.float()
    return out.to(x.dtype)


def _overshoot(x, v, sigma, sigma_next, noise, generator, c):
    xf, vf = x.float(), v.float()
    sigma, sigma_next = _f32(sigma, x.device), _f32(sigma_next, x.device)
    t = 1.0 - sigma
    step = sigma - sigma_next
    t_next = torch.clamp(t + step, max=1.0)
    t_over = torch.clamp(t_next + c * step, max=1.0)
    x_over = xf + (t_over - t) * (-vf)
    a = t_next / t_over
    b = torch.sqrt(torch.clamp((1.0 - t_next) ** 2 - (a - t_next) ** 2, min=0.0))
    return (a * x_over + b * _noise(x, noise, generator)).to(x.dtype)


def overshoot_step(
    x: torch.Tensor,
    v: torch.Tensor,
    sigma,
    sigma_next,
    noise: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    c: float = 2.0,
) -> torch.Tensor:
    """AMO stochastic overshoot step (overshoot function t, dt -> t + dt).

    Advance the ODE past the target time to t_over = min(t_next + c*dt, 1), then
    re-noise back so the marginal lands at t_next:
        x' = (t_next / t_over) * x_over + sqrt((1-t_next)^2 - (a - t_next)^2) * eps
    where a = t_next/t_over. Velocity convention: dx/dsigma = v, i.e. time t = 1 - sigma
    moves against sigma, hence x_over = x + (t_over - t) * (-v).
    """
    return _overshoot(x, v, sigma, sigma_next, noise, generator, _f32(c, x.device))


def overshoot_step_spatial(
    x: torch.Tensor,
    v: torch.Tensor,
    sigma,
    sigma_next,
    c_map: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Spatially-varying AMO overshoot: per-token overshoot strength.

    c_map (B, T) weights the overshoot per token of x (B, T, C) (e.g. stronger
    inside the text-edit region). c_map == c everywhere reduces to
    overshoot_step.
    """
    return _overshoot(x, v, sigma, sigma_next, noise, generator,
                      c_map.float()[..., None])


def scale_noise(x: torch.Tensor, sigma, noise: torch.Tensor) -> torch.Tensor:
    """Flow-matching forward process: x_sigma = (1 - sigma) * x + sigma * noise."""
    return (1.0 - sigma) * x + sigma * noise


# ---------------------------------------------------------------------------
# Training-time timestep sampling / loss weighting
# ---------------------------------------------------------------------------

DENSITY_SCHEMES = ("none", "logit_normal", "mode")


def sample_timestep_density(
    batch_size: int,
    scheme: str = "none",
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    mode_scale: float = 1.29,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample u in (0, 1) controlling the noise level (SD3 density schemes).

    The raw draw (standard normal for "logit_normal", uniform otherwise) is
    `u` when given (to hold the port against another implementation's
    random stream), else drawn from `generator`; the scheme's transform runs
    on it in float32."""
    if u is None:
        if generator is None:
            raise ValueError("sample_timestep_density needs u or a generator")
        draw = torch.randn if scheme == "logit_normal" else torch.rand
        u = draw((batch_size,), generator=generator, device=generator.device,
                 dtype=torch.float32)
    u = u.float()
    if scheme == "logit_normal":
        return torch.sigmoid(u * logit_std + logit_mean)
    if scheme == "mode":
        return 1.0 - u - mode_scale * (torch.cos(math.pi * u / 2.0) ** 2 - 1.0 + u)
    return u


def train_sigmas(u: torch.Tensor, num_train_timesteps: int = 1000,
                 shift: float = 3.0) -> torch.Tensor:
    """Map density samples u to schedule sigmas, as the JAX trainer indexes
    its shifted schedule: sigmas[i] = shifted((1000 - i) / 1000) with
    i = floor(u * 1000), float32."""
    indices = torch.clamp((u.float() * num_train_timesteps).to(torch.int32), 0,
                          num_train_timesteps - 1)
    base = (num_train_timesteps - indices).float() / num_train_timesteps
    return shift * base / (1.0 + (shift - 1.0) * base)


def loss_weighting(scheme: str, sigmas: torch.Tensor) -> torch.Tensor:
    """Per-sample loss weights for flow-matching training."""
    if scheme == "sigma_sqrt":
        return sigmas ** -2.0
    if scheme == "cosmap":
        return 2.0 / (math.pi * (1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2))
    return torch.ones_like(sigmas)
