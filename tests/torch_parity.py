"""Shared harness for the port-vs-JAX parity tests (tests/test_torch_*.py).

Random JAX parameters at the tiny widths of `parallel/tiny.py` are made
host-side from a numpy seed (the init functions' shapes come from
`jax.eval_shape`, so no XLA init program runs), converted with
`styletts2_tpu_torch.convert.state_dict_from_jax` and loaded into the port.
Inputs are numpy arrays handed to both frameworks; activations cross the
boundary transposed (JAX NWC, the port NCW).
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch

from styletts2_tpu.parallel.tiny import tiny_config
from styletts2_tpu_torch.config import Config as PortConfig


def jax_cfg():
    """Tiny widths, three decoder resblock kernels so `resblocks.{i*3+j}`
    naming is exercised, and a one-layer PL-BERT."""
    cfg = tiny_config()
    cfg.plbert_params.intermediate_size = 256
    cfg.model_params.decoder.resblock_kernel_sizes = [3, 7, 11]
    cfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]] * 3
    return cfg


def port_cfg(jcfg) -> PortConfig:
    return PortConfig.from_dict(dataclasses.asdict(jcfg))


def _fill(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, k) for k, v in tree.items()}
    shape = tuple(tree.shape)
    if name == "g" or name.startswith("alpha"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name in ("scale", "gamma"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("bias", "beta", "b"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("fixed_embedding", "weights"):
        return rng.standard_normal(shape).astype(np.float32)
    if name in ("embedding", "position_embeddings", "token_type_embeddings"):
        return (rng.standard_normal(shape) / math.sqrt(shape[-1])).astype(np.float32)
    # kernels; a weight-norm v's scale cancels, so its fan-in needs no care
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)


def jax_models_and_params(jcfg, seed: int = 0):
    """(JAX Models, variables) with every leaf drawn from numpy `seed`."""
    from styletts2_tpu.models.build import build_models, init_params

    models = build_models(jcfg)
    shapes = jax.eval_shape(lambda k: init_params(models, k, jcfg), jax.random.PRNGKey(0))
    keys = ("text_encoder", "bert", "bert_encoder", "predictor", "decoder", "diffusion")
    rng = np.random.default_rng(seed)
    params = {k: _fill(shapes[k], rng) for k in keys}
    # the Generator's head is exp(log-magnitude); at random weights its gain
    # can push that past f32's range once the source noise is zeroed
    params["decoder"]["params"]["generator"]["conv_post"]["g"] *= 0.1
    return models, params


def port_models(jcfg, jparams):
    """The port's modules carrying the JAX weights."""
    from styletts2_tpu_torch.convert import state_dict_from_jax
    from styletts2_tpu_torch.models.build import build_models

    models = build_models(port_cfg(jcfg))
    models.load_state_dict(state_dict_from_jax(jparams))
    return models.requires_grad_(False).eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def nwc_to_ncw(x) -> torch.Tensor:
    return t(np.asarray(x).transpose(0, 2, 1))


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _zeros_like_draw(*size, generator=None, device=None, dtype=None, **_):
    if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
        size = tuple(size[0])
    return torch.zeros(size, device=device, dtype=dtype or torch.float32)


@contextmanager
def zero_noise():
    """Zero every random draw on both sides: jax.random.uniform / normal
    (SineGen phase and noise, ADPM2 churn) and the port's torch.rand /
    torch.randn (the same sources)."""
    j_uniform, j_normal = jax.random.uniform, jax.random.normal
    t_rand, t_randn = torch.rand, torch.randn

    def zuniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0, **kw):
        return jnp.zeros(shape, dtype)

    def znormal(key, shape=(), dtype=jnp.float32, **kw):
        return jnp.zeros(shape, dtype)

    jax.random.uniform, jax.random.normal = zuniform, znormal
    torch.rand = torch.randn = _zeros_like_draw
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal = j_uniform, j_normal
        torch.rand, torch.randn = t_rand, t_randn


@contextmanager
def stable_har_phase():
    """Zero the NSF source's STFT phase channel on both sides.

    The harmonic source is near-monochromatic, so most of its 11 STFT bins
    are ~0 in magnitude and their atan2 phase is chaotic: a 1e-6 relative
    difference in the source (float reassociation in the phase cumsum)
    flips them by up to 2 pi, and a random-init decoder amplifies that to
    O(1). The magnitude channels are stable and stay compared."""
    import styletts2_tpu.models.decoder_istft as jdi
    import styletts2_tpu_torch.models.decoder_istft as pdi

    orig_j, orig_p = jdi.stft_magphase, pdi.stft_magphase

    def magphase_j(*a):
        mag, phase = orig_j(*a)
        return mag, jnp.zeros_like(phase)

    def magphase_p(*a):
        mag, phase = orig_p(*a)
        return mag, torch.zeros_like(phase)

    jdi.stft_magphase, pdi.stft_magphase = magphase_j, magphase_p
    try:
        yield
    finally:
        jdi.stft_magphase, pdi.stft_magphase = orig_j, orig_p

