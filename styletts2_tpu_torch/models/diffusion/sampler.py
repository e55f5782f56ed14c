"""EDM preconditioning, the Karras and linear schedules, the EDM and
v-diffusion training losses, the ADPM2, ancestral Euler, Karras and v
samplers, ADPM2 inpainting and span-by-span composition
(`styletts2_tpu/models/diffusion/sampler.py`). The losses and samplers
carry gradients: stage 2 differentiates through the EDM loss and ADPM2.

Every random draw is N(0, 1) from the sampler's `generator` unless the
draws are handed in (`churn`, `draws`): a test feeds the JAX package's own
draws that way."""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def karras_schedule(num_steps: int, sigma_min: float = 1e-4, sigma_max: float = 3.0,
                    rho: float = 9.0) -> np.ndarray:
    """sigma_i for i < num_steps plus a trailing 0, float32."""
    ramp = np.arange(num_steps, dtype=np.float64) / (num_steps - 1)
    s = (sigma_max ** (1.0 / rho)
         + ramp * (sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho))) ** rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


def linear_schedule(num_steps: int) -> np.ndarray:
    """num_steps sigmas from 1 down to 1 / num_steps, float32."""
    return np.linspace(1.0, 0.0, num_steps + 1)[:-1].astype(np.float32)


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


def _normal(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def _handed(draws: Optional[Sequence[torch.Tensor]], n: int, what: str) -> Optional[List]:
    if draws is not None and len(draws) != n:
        raise ValueError(f"{what} needs {n} tensors, got {len(draws)}")
    return None if draws is None else list(draws)


def _ancestral(sigma, sigma_next):
    """(sigma_up, sigma_down) of an ancestral step from sigma to sigma_next."""
    sig2, sn2 = sigma * sigma, sigma_next * sigma_next
    sigma_up = np.sqrt(max(sn2 * (sig2 - sn2) / sig2, 0.0))
    return sigma_up, np.sqrt(max(sn2 - sigma_up * sigma_up, 0.0))


def _adpm2_step(denoise_fn: Callable, x: torch.Tensor, sigma, sigma_next,
                eps: torch.Tensor) -> torch.Tensor:
    """One ADPM2 step from sigma to sigma_next: two denoiser calls (at sigma
    and at the midpoint, the reference's rho = 1), then churn `eps`."""
    sigma_up, sigma_down = _ancestral(sigma, sigma_next)
    sigma_mid = (sigma + sigma_down) / 2.0
    B = x.shape[0]
    d = (x - denoise_fn(x, torch.full((B,), float(sigma), device=x.device))) / float(sigma)
    x_mid = x + d * float(sigma_mid - sigma)
    mb = torch.full((B,), float(sigma_mid), device=x.device)
    d_mid = (x_mid - denoise_fn(x_mid, mb)) / float(sigma_mid)
    x = x + d_mid * float(sigma_down - sigma)
    return x + eps * float(sigma_up)


def sample_adpm2(denoise_fn: Callable, noise: torch.Tensor, num_steps: int,
                 generator: Optional[torch.Generator] = None,
                 churn: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """ADPM2 ancestral sampling over the default Karras schedule. The churn
    noise of step i is `churn[i]` when given (num_steps - 1 tensors shaped
    like `noise`), else a draw from `generator`. As in the reference, the
    num_steps - 1 steps never reach the schedule's trailing 0."""
    sigmas = karras_schedule(num_steps)
    churn = _handed(churn, num_steps - 1, "churn")
    x = noise * float(sigmas[0])
    for i in range(num_steps - 1):
        eps = churn[i] if churn is not None else _normal(x, generator)
        x = _adpm2_step(denoise_fn, x, sigmas[i], sigmas[i + 1], eps)
    return x


def sample_aeuler(denoise_fn: Callable, noise: torch.Tensor, num_steps: int,
                  generator: Optional[torch.Generator] = None,
                  churn: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Ancestral Euler sampling over the default Karras schedule: one
    denoiser call per step, then churn (`churn[i]` when given, as
    `sample_adpm2`)."""
    sigmas = karras_schedule(num_steps)
    churn = _handed(churn, num_steps - 1, "churn")
    B = noise.shape[0]
    x = noise * float(sigmas[0])
    for i in range(num_steps - 1):
        sigma = sigmas[i]
        sigma_up, sigma_down = _ancestral(sigma, sigmas[i + 1])
        d = (x - denoise_fn(x, torch.full((B,), float(sigma), device=x.device))) / float(sigma)
        x = x + d * float(sigma_down - sigma)
        eps = churn[i] if churn is not None else _normal(x, generator)
        x = x + eps * float(sigma_up)
    return x


def sample_karras(denoise_fn: Callable, noise: torch.Tensor, num_steps: int,
                  generator: Optional[torch.Generator] = None,
                  churn: Optional[Sequence[torch.Tensor]] = None, s_churn: float = 0.0,
                  s_noise: float = 1.0) -> torch.Tensor:
    """Karras et al.'s algorithm 2 over the default Karras schedule: sigma
    raised by gamma = min(s_churn / num_steps, sqrt 2 - 1) with s_noise *
    N(0, 1) noise (`churn[i]` when given), an Euler step and the
    second-order correction. With the default s_churn = 0 the noise is
    drawn and weighs nothing, as in the reference."""
    sigmas = karras_schedule(num_steps)
    churn = _handed(churn, num_steps - 1, "churn")
    gamma = min(s_churn / num_steps, math.sqrt(2.0) - 1.0)
    B = noise.shape[0]
    x = noise * float(sigmas[0])
    for i in range(num_steps - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        sigma_hat = sigma * np.float32(1.0 + gamma)
        eps = s_noise * (churn[i] if churn is not None else _normal(x, generator))
        x_hat = x + float(np.sqrt(max(sigma_hat ** 2 - sigma ** 2, 0.0))) * eps
        sh = torch.full((B,), float(sigma_hat), device=x.device)
        d = (x_hat - denoise_fn(x_hat, sh)) / float(sigma_hat)
        x = x_hat + float(sigma_next - sigma_hat) * d
        if sigma_next != 0.0:  # never 0 here: the steps stop short of the trailing 0
            sn = torch.full((B,), float(sigma_next), device=x.device)
            d2 = (x - denoise_fn(x, sn)) / float(sigma_next)
            x = x_hat + 0.5 * float(sigma - sigma_hat) * (d + d2)
    return x


SAMPLERS = {"adpm2": sample_adpm2, "aeuler": sample_aeuler, "karras": sample_karras}


def v_get_alpha_beta(sigmas):
    """(cos, sin) of sigmas * pi / 2: the v-diffusion signal and noise weights."""
    angle = torch.as_tensor(sigmas, dtype=torch.float32) * (math.pi / 2.0)
    return torch.cos(angle), torch.sin(angle)


def vdiffusion_loss(net_apply: Callable, x0: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    sigmas: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The v-diffusion training loss of net_apply(x_noisy, sigmas) at x0 (B,
    C, T): sigma ~ U(0, 1), x_noisy = alpha x0 + beta noise, the MSE against
    the velocity alpha noise - beta x0. `sigmas` (B,) and `noise` are drawn
    from `generator` unless given."""
    B = x0.shape[0]
    if sigmas is None:
        sigmas = torch.rand((B,), generator=generator, device=x0.device)
    if noise is None:
        noise = _normal(x0, generator)
    alpha, beta = v_get_alpha_beta(sigmas[:, None, None].to(x0.device))
    x_noisy = x0 * alpha + noise * beta
    x_target = noise * alpha - x0 * beta
    return ((net_apply(x_noisy, sigmas) - x_target) ** 2).mean()


def sample_v(denoise_fn: Callable, noise: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The deterministic v sampler over the linear schedule, as the
    reference's VSampler: num_steps - 1 steps, denoise_fn(x, sigmas)
    predicting the velocity; returns the last step's x0 estimate."""
    if num_steps < 2:
        raise ValueError(f"sample_v needs at least 2 steps, got {num_steps}")
    sigmas = linear_schedule(num_steps)
    B, dev = noise.shape[0], noise.device
    x = noise * float(sigmas[0])
    alpha, beta = (w.to(dev) for w in v_get_alpha_beta(sigmas[0]))
    for i in range(num_steps - 1):
        v = denoise_fn(x, torch.full((B,), float(sigmas[i]), device=dev))
        x_pred = x * alpha - v * beta
        x_eps = x * beta + v * alpha
        alpha, beta = (w.to(dev) for w in v_get_alpha_beta(sigmas[i + 1]))
        x = x_pred * alpha + x_eps * beta
    return x_pred


def inpaint_draws(num_steps: int, num_resamples: int = 1) -> int:
    """How many N(0, 1) tensors `inpaint_adpm2` draws."""
    return 1 + (num_steps - 1) * 2 * num_resamples


def inpaint_adpm2(denoise_fn: Callable, source: torch.Tensor, mask: torch.Tensor,
                  num_steps: int, num_resamples: int = 1,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """ADPM2 inpainting: where `mask` is 1 the result is `source`; elsewhere
    it is sampled, each step first pasting in the source noised to the
    step's sigma, then `num_resamples` ADPM2 steps, renoised back to sigma
    between two of them. The N(0, 1) draws, shaped like `source`, are
    `draws` in the order they are used when given (`inpaint_draws` of
    them: the start noise, then per step the source's noise and per
    resample its churn and, but for the last, its renoise)."""
    sigmas = karras_schedule(num_steps)
    draws = _handed(draws, inpaint_draws(num_steps, num_resamples), "draws")
    nxt = iter(draws).__next__ if draws is not None else lambda: _normal(source, generator)
    maskf = mask.to(source.dtype)
    x = nxt() * float(sigmas[0])
    for i in range(num_steps - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        source_noisy = source + float(sigma) * nxt()
        for r in range(num_resamples):
            x = source_noisy * maskf + x * (1.0 - maskf)
            x = _adpm2_step(denoise_fn, x, sigma, sigma_next, nxt())
            if r < num_resamples - 1:
                x = x + float(np.sqrt(max(sigma ** 2 - sigma_next ** 2, 0.0))) * nxt()
    return source * maskf + x * (1.0 - maskf)


def span_by_span_compose(denoise_fn: Callable, start: torch.Tensor, num_spans: int,
                         num_steps: int, num_resamples: int = 1, keep_start: bool = False,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
    """Autoregressive continuation of `start` (B, C, L) by half windows:
    each span inpaints a window whose first half is the previous span's
    second half, and keeps its new second half. Returns the num_spans new
    halves concatenated along L, after both halves of `start` when
    `keep_start`. `draws[i]` is span i's `inpaint_adpm2` draws when given."""
    draws = _handed(draws, num_spans, "draws")
    half = start.shape[-1] // 2
    mask = torch.zeros_like(start)
    mask[..., :half] = 1.0
    spans = [start[..., :half], start[..., half:]] if keep_start else []
    window = torch.zeros_like(start)
    window[..., :half] = start[..., half:]
    for i in range(num_spans):
        span = inpaint_adpm2(denoise_fn, window, mask, num_steps, num_resamples, generator,
                             draws[i] if draws is not None else None)
        window = torch.cat([span[..., half:], window[..., half:]], dim=-1)
        spans.append(span[..., half:])
    return torch.cat(spans, dim=-1)
