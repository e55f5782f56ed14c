"""EDM preconditioning, Karras schedule, the EDM training loss and the
ADPM2 sampler (`styletts2_tpu/models/diffusion/sampler.py:25-129`). Both the
loss and the sampler carry gradients: stage 2 differentiates through them."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def karras_schedule(num_steps: int, sigma_min: float = 1e-4, sigma_max: float = 3.0,
                    rho: float = 9.0) -> np.ndarray:
    """sigma_i for i < num_steps plus a trailing 0, float32."""
    ramp = np.arange(num_steps, dtype=np.float64) / (num_steps - 1)
    s = (sigma_max ** (1.0 / rho)
         + ramp * (sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho))) ** rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


def edm_scale_weights(sigmas: torch.Tensor, sigma_data: float):
    """c_skip, c_out, c_in (each (B, 1, 1)) and c_noise (B,) for sigmas (B,)."""
    c_noise = torch.log(sigmas) * 0.25
    s = sigmas[:, None, None]
    s2 = s * s
    d2 = sigma_data ** 2
    c_skip = d2 / (s2 + d2)
    c_out = s * sigma_data * torch.rsqrt(d2 + s2)
    c_in = torch.rsqrt(s2 + d2)
    return c_skip, c_out, c_in, c_noise


def make_denoise_fn(net_apply: Callable, sigma_data: float) -> Callable:
    """EDM-preconditioned denoiser x0_hat(x_noisy, sigmas) around
    net_apply(x, c_noise)."""

    def denoise(x_noisy, sigmas):
        c_skip, c_out, c_in, c_noise = edm_scale_weights(sigmas, sigma_data)
        return c_skip * x_noisy + c_out * net_apply(c_in * x_noisy, c_noise)

    return denoise


def kdiffusion_loss(net_apply: Callable, x0: torch.Tensor, sigma_data: float,
                    dist_mean: float = -3.0, dist_std: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    sigmas: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The EDM training loss of net_apply(x, c_noise) at x0 (B, ...): sigma
    log-normal (exp(dist_mean + dist_std * N(0, 1))), x0 noised by
    sigma * N(0, 1), and the MSE of the preconditioned denoiser's estimate,
    weighted by (sigma^2 + sigma_data^2) / (sigma * sigma_data)^2, averaged.
    `sigmas` (B,) and `noise` (x0's shape) are drawn from `generator`
    unless given."""
    B = x0.shape[0]
    if sigmas is None:
        sigmas = torch.exp(dist_mean + dist_std * torch.randn(
            (B,), generator=generator, device=x0.device))
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    x_noisy = x0 + sigmas.reshape((B,) + (1,) * (x0.dim() - 1)) * noise
    x_denoised = make_denoise_fn(net_apply, sigma_data)(x_noisy, sigmas)
    losses = ((x_denoised - x0) ** 2).mean(dim=tuple(range(1, x0.dim())))
    weight = (sigmas ** 2 + sigma_data ** 2) * (sigmas * sigma_data) ** -2
    return (losses * weight).mean()


def sample_adpm2(denoise_fn: Callable, noise: torch.Tensor, num_steps: int,
                 generator: Optional[torch.Generator] = None,
                 churn: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """ADPM2 ancestral sampling over the default Karras schedule. The churn
    noise of step i is `churn[i]` when given (num_steps - 1 tensors shaped
    like `noise`), else a draw from `generator`. As in the reference, the
    num_steps - 1 steps never reach the schedule's trailing 0."""
    sigmas = karras_schedule(num_steps)
    if churn is not None and len(churn) != num_steps - 1:
        raise ValueError(f"churn needs {num_steps - 1} tensors, got {len(churn)}")
    B = noise.shape[0]
    x = noise * float(sigmas[0])
    for i in range(num_steps - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        sig2, sn2 = sigma * sigma, sigma_next * sigma_next
        sigma_up = np.sqrt(max(sn2 * (sig2 - sn2) / sig2, 0.0))
        sigma_down = np.sqrt(max(sn2 - sigma_up * sigma_up, 0.0))
        sigma_mid = (sigma + sigma_down) / 2.0  # the reference's rho = 1
        sb = torch.full((B,), float(sigma), device=noise.device)
        d = (x - denoise_fn(x, sb)) / float(sigma)
        x_mid = x + d * float(sigma_mid - sigma)
        mb = torch.full((B,), float(sigma_mid), device=noise.device)
        d_mid = (x_mid - denoise_fn(x_mid, mb)) / float(sigma_mid)
        x = x + d_mid * float(sigma_down - sigma)
        eps = churn[i] if churn is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = x + eps * float(sigma_up)
    return x
