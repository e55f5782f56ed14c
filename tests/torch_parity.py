"""Shared harness for the port-vs-JAX parity tests (tests/test_torch_*.py).

Random JAX parameters at the tiny widths of `parallel/tiny.py` are made
host-side from a numpy seed (the init functions' shapes come from
`jax.eval_shape`, so no XLA init program runs), converted with
`styletts2_tpu_torch.convert.state_dict_from_jax` and loaded into the port.
`jax_cfg()` is the single-speaker iSTFTNet config, `jax_ms_cfg()` the
multispeaker HiFi-GAN one of configs/config_libritts.yml at the same widths.
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

# the suite runs in several worker processes on a few cores, beside XLA's own
# threads; torch's intra-op pool in every worker would oversubscribe them
torch.set_num_threads(1)


def jax_cfg():
    """Tiny widths, three decoder resblock kernels so `resblocks.{i*3+j}`
    naming is exercised, and a one-layer PL-BERT."""
    cfg = tiny_config()
    cfg.plbert_params.intermediate_size = 256
    cfg.model_params.decoder.resblock_kernel_sizes = [3, 7, 11]
    cfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]] * 3
    return cfg


def jax_ms_cfg():
    """`jax_cfg()` made multispeaker with the LibriTTS HiFi-GAN decoder
    (rates 10, 5, 3, 2: Generator widths 64 -> 32 -> 16 -> 8)."""
    cfg = jax_cfg()
    cfg.model_params.multispeaker = True
    cfg.model_params.decoder.type = "hifigan"
    cfg.model_params.decoder.upsample_rates = [10, 5, 3, 2]
    cfg.model_params.decoder.upsample_kernel_sizes = [20, 10, 6, 4]
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
    """(JAX Models, variables) with every leaf drawn from numpy `seed`,
    for the modules the port builds for `jcfg`. The style encoders'
    spectral-norm (u, v) are drawn too, then aligned to their kernels' top
    singular vectors as the JAX fast init does: independent random vectors
    would make each SN layer amplify ~50x."""
    from styletts2_tpu.models.build import _fi_spectral_align, build_models, init_params
    from styletts2_tpu_torch.models.build import module_keys

    models = build_models(jcfg)
    shapes = jax.eval_shape(lambda k: init_params(models, k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = {k: _fill(shapes[k], rng) for k in module_keys(port_cfg(jcfg))}
    for v in params.values():
        if "spectral" in v:
            _fi_spectral_align(v["spectral"], v["params"])
    # at random weights the Generator's head overflows or saturates: the
    # iSTFTNet head is exp(log-magnitude), which can pass f32's range once the
    # source noise is zeroed; HiFi-GAN's tanh input peaks ~40x above tanh's
    # linear range, so the unsaturated samples carry the input's absolute
    # error against an output peak of 1
    gain = 0.1 if jcfg.model_params.decoder.type == "istftnet" else 0.01
    params["decoder"]["params"]["generator"]["conv_post"]["g"] *= gain
    return models, params


def port_models(jcfg, jparams):
    """The port's modules carrying the JAX weights."""
    from styletts2_tpu_torch.convert import state_dict_from_jax
    from styletts2_tpu_torch.models.build import build_models

    pcfg = port_cfg(jcfg)
    models = build_models(pcfg)
    models.load_state_dict(state_dict_from_jax(jparams, pcfg))
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



@contextmanager
def zero_sines():
    """Zero the NSF source's harmonic sines on both sides; its voicing mask
    and noise stay (`zero_noise` zeroes the noise).

    The sine phase is a cumulative sum that reaches ~1e5 rad over a few
    seconds of audio, where one f32 ulp is ~1e-2 rad; the two frameworks sum
    it in another order, and HiFi-GAN feeds the raw source into every stage,
    so a random-init decoder turns that into O(1e-2) of its peak. The source
    itself is compared on its own (test_torch_decoder.py::test_nsf_source)."""
    from flax import linen as nn

    import styletts2_tpu.models.decoder_istft as jdi
    import styletts2_tpu_torch.models.decoder_istft as pdi

    orig_j, orig_p = jdi.SineGen, pdi.SineGen.forward

    class JaxNoSines(orig_j):
        @nn.compact
        def __call__(self, f0):
            f0 = f0.astype(jnp.float32)
            uv = (f0 > self.voiced_threshold).astype(f0.dtype)
            return jnp.zeros(f0.shape[:2] + (self.harmonic_num + 1,), f0.dtype), uv

    def port_no_sines(self, f0, generator=None):
        uv = (f0 > self.voiced_threshold).float()
        return torch.zeros(f0.shape[:2] + (self.dim,), device=f0.device), uv

    jdi.SineGen, pdi.SineGen.forward = JaxNoSines, port_no_sines
    try:
        yield
    finally:
        jdi.SineGen, pdi.SineGen.forward = orig_j, orig_p
