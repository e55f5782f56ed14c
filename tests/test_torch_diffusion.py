"""Port parity for the style diffusion: the Transformer1d denoiser (padded
keys masked, classifier-free guidance batched) and the ADPM2 sampler, whose
churn draws are made here with jax.random and handed to the port.

Tolerance: 1e-4 of the peak for one denoiser call (a one-block transformer
in f32); 1e-4 for the sampled style, whose 4 steps x 2 denoiser calls are
contractive (EDM preconditioning mixes the net's output in with weight
c_out < 1).
"""

import jax
import numpy as np
import pytest
import torch

from styletts2_tpu.models.diffusion import sampler as js
from styletts2_tpu_torch.models.diffusion import sampler as ps
from torch_parity import jax_cfg, jax_models_and_params, port_models, rel_err, t

TOL = 1e-4
B, T = 2, 12
LENGTHS = np.asarray([12, 7], np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    E = jcfg.plbert_params.hidden_size
    C = 2 * jcfg.model_params.style_dim
    emb = rng.standard_normal((B, T, E)).astype(np.float32)
    emb[1, 7:] = 100.0  # padded positions must not leak into the result
    noise = rng.standard_normal((B, 1, C)).astype(np.float32)
    return models, params, port_models(jcfg, params), emb, noise


@pytest.mark.parametrize("scale", [1.0, 1.5])
@torch.inference_mode()
def test_denoiser(setup, scale):
    models, params, port, emb, noise = setup
    sigma = np.asarray([0.7, 2.0], np.float32)
    want = np.asarray(jax.jit(lambda v, x, s, e: models.diffusion.apply(
        v, x, s, e, embedding_scale=scale, embedding_lengths=LENGTHS))(
        params["diffusion"], noise, sigma, emb))
    got = port["diffusion"](t(noise), t(sigma), t(emb), embedding_scale=scale,
                            embedding_lengths=torch.as_tensor(LENGTHS)).numpy()
    assert got.shape == (B, 1, noise.shape[-1])
    assert rel_err(got, want) < TOL


@torch.inference_mode()
def test_sample_adpm2_with_handed_churn(setup):
    models, params, port, emb, noise = setup
    steps, sigma_data = 5, 0.2
    key = jax.random.PRNGKey(7)

    def j_net(x, c_noise):
        return models.diffusion.apply(params["diffusion"], x, c_noise, emb,
                                      embedding_lengths=LENGTHS)

    want = np.asarray(jax.jit(lambda n, k: js.sample_adpm2(
        js.make_denoise_fn(j_net, sigma_data), n, k, num_steps=steps))(noise, key))
    # the draws sample_adpm2 makes from `key`, one per step
    churn = [t(jax.random.normal(k, noise.shape)) for k in jax.random.split(key, steps - 1)]

    def p_net(x, c_noise):
        return port["diffusion"](x, c_noise, t(emb), embedding_lengths=torch.as_tensor(LENGTHS))

    got = ps.sample_adpm2(ps.make_denoise_fn(p_net, sigma_data), t(noise), steps,
                          churn=churn).numpy()
    assert rel_err(got, want) < TOL
    np.testing.assert_array_equal(ps.karras_schedule(steps), js.karras_schedule(steps))
    with pytest.raises(ValueError):
        ps.sample_adpm2(ps.make_denoise_fn(p_net, sigma_data), t(noise), steps, churn=churn[:2])
