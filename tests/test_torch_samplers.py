"""Port parity for the rest of the diffusion sampler family: the ancestral
Euler and Karras samplers, the v-diffusion loss and sampler, ADPM2
inpainting and span-by-span composition. Every random draw is made here
with jax.random, as the JAX function makes it from its key, and handed to
the port. The denoiser is the tiny style denoiser of
tests/test_torch_diffusion.py; the inpainting samplers run it over its
feature axis (even length: the first half kept, the second sampled).

Tolerance: 1e-4 of the peak, as test_torch_diffusion.py holds ADPM2 (a few
steps of a one-block f32 transformer; EDM preconditioning is contractive);
1e-5 relative for the v-diffusion loss (one denoiser call and a mean).

The JAX package's `sample_v` raises for every step count (its scan pairs
num_steps - 1 sigmas with num_steps next sigmas), so the port's is held to
the reference's VSampler loop written here with the JAX package's own
`v_get_alpha_beta` and denoiser.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.models.diffusion import sampler as js
from styletts2_tpu_torch.models.diffusion import sampler as ps
from torch_parity import jax_cfg, jax_models_and_params, port_models, rel_err, t

TOL = 1e-4
B, T = 2, 12
LENGTHS = np.asarray([12, 7], np.int32)
SIGMA_DATA = 0.2


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=4)
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((B, T, jcfg.plbert_params.hidden_size)).astype(np.float32)
    noise = rng.standard_normal((B, 1, 2 * jcfg.model_params.style_dim)).astype(np.float32)

    def j_net(x, c_noise):
        return models.diffusion.apply(params["diffusion"], x, c_noise, emb,
                                      embedding_lengths=LENGTHS)

    port = port_models(jcfg, params)

    def p_net(x, c_noise):
        return port["diffusion"](x, c_noise, t(emb), embedding_lengths=torch.as_tensor(LENGTHS))

    return j_net, p_net, noise


def _normals(keys, shape):
    return [t(jax.random.normal(k, shape)) for k in keys]


@pytest.mark.parametrize("name,kw", [("adpm2", {}), ("aeuler", {}), ("karras", {}),
                                     ("karras", {"s_churn": 2.0, "s_noise": 1.003})])
@torch.inference_mode()
def test_sampler_matches_jax(setup, name, kw):
    j_net, p_net, noise = setup
    steps, key = 5, jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda n, k: js.SAMPLERS[name](
        js.make_denoise_fn(j_net, SIGMA_DATA), n, k, num_steps=steps, **kw))(noise, key))
    churn = _normals(jax.random.split(key, steps - 1), noise.shape)  # one draw per step
    got = ps.SAMPLERS[name](ps.make_denoise_fn(p_net, SIGMA_DATA), t(noise), steps,
                            churn=churn, **kw).numpy()
    assert got.shape == noise.shape and np.isfinite(got).all()
    assert rel_err(got, want) < TOL
    with pytest.raises(ValueError, match="churn needs 4"):
        ps.SAMPLERS[name](ps.make_denoise_fn(p_net, SIGMA_DATA), t(noise), steps, churn=churn[:3])


@torch.inference_mode()
def test_samplers_draw_from_the_generator(setup):
    """Without handed draws a sampler draws from its generator: the same
    seed gives the same bits, another seed another sample."""
    _, p_net, noise = setup
    denoise = ps.make_denoise_fn(p_net, SIGMA_DATA)
    for name in ("aeuler", "karras"):
        kw = {"s_churn": 2.0} if name == "karras" else {}
        a, b, c = (ps.SAMPLERS[name](denoise, t(noise), 4, torch.Generator().manual_seed(s), **kw)
                   for s in (1, 1, 2))
        assert torch.equal(a, b) and not torch.equal(a, c)


@torch.inference_mode()
def test_vdiffusion_loss_matches_jax(setup):
    j_net, p_net, noise = setup
    key = jax.random.PRNGKey(5)
    x0 = np.random.default_rng(7).standard_normal(noise.shape).astype(np.float32)
    want = float(jax.jit(lambda x, k: js.vdiffusion_loss(j_net, x, k))(x0, key))
    k_s, k_n = jax.random.split(key)
    sigmas = t(jax.random.uniform(k_s, (B,)))
    got = float(ps.vdiffusion_loss(p_net, t(x0), sigmas=sigmas,
                                   noise=t(jax.random.normal(k_n, x0.shape))))
    assert abs(got - want) / abs(want) < 1e-5


@torch.inference_mode()
def test_sample_v_follows_the_reference(setup):
    j_net, p_net, noise = setup
    steps = 4

    def reference(x):  # the reference's VSampler.forward over the linear schedule
        sigmas = jnp.asarray(js.linear_schedule(steps))
        x = sigmas[0] * x
        alpha, beta = js.v_get_alpha_beta(sigmas[0])
        for i in range(steps - 1):
            v = j_net(x, jnp.full((B,), sigmas[i]))
            x_pred = x * alpha - v * beta
            x_eps = x * beta + v * alpha
            alpha, beta = js.v_get_alpha_beta(sigmas[i + 1])
            x = x_pred * alpha + x_eps * beta
        return x_pred

    want = np.asarray(jax.jit(reference)(noise))
    got = ps.sample_v(p_net, t(noise), steps).numpy()
    np.testing.assert_array_equal(ps.linear_schedule(steps), js.linear_schedule(steps))
    assert rel_err(got, want) < TOL
    with pytest.raises(ValueError):
        ps.sample_v(p_net, t(noise), 1)


def _jax_inpaint_draws(key, shape, steps, resamples):
    """The N(0, 1) draws JAX's inpaint_adpm2 makes from `key` and uses, in
    the order the port takes them."""
    k0, key = jax.random.split(key)
    out = [jax.random.normal(k0, shape)]
    for k in jax.random.split(key, steps - 1):
        ks = jax.random.split(k, 2 * resamples + 1)
        out.append(jax.random.normal(ks[0], shape))
        for r in range(resamples):
            out.append(jax.random.normal(ks[1 + r], shape))
            if r < resamples - 1:
                out.append(jax.random.normal(ks[1 + resamples + r], shape))
    return [t(x) for x in out]


@pytest.mark.parametrize("resamples", [1, 2])
@torch.inference_mode()
def test_inpaint_adpm2_matches_jax(setup, resamples):
    j_net, p_net, noise = setup
    steps, key = 4, jax.random.PRNGKey(9)
    mask = np.zeros(noise.shape, np.float32)
    mask[..., : noise.shape[-1] // 2] = 1.0
    want = np.asarray(jax.jit(lambda s, m, k: js.inpaint_adpm2(
        js.make_denoise_fn(j_net, SIGMA_DATA), s, m, k, steps, resamples))(noise, mask, key))
    draws = _jax_inpaint_draws(key, noise.shape, steps, resamples)
    assert len(draws) == ps.inpaint_draws(steps, resamples)
    got = ps.inpaint_adpm2(ps.make_denoise_fn(p_net, SIGMA_DATA), t(noise), t(mask), steps,
                           resamples, draws=draws).numpy()
    half = noise.shape[-1] // 2
    np.testing.assert_array_equal(got[..., :half], noise[..., :half])
    assert rel_err(got, want) < TOL


@torch.inference_mode()
def test_span_by_span_compose_matches_jax(setup):
    j_net, p_net, noise = setup
    steps, spans, key = 3, 2, jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(lambda s, k: js.span_by_span_compose(
        js.make_denoise_fn(j_net, SIGMA_DATA), s, k, spans, steps, keep_start=True))(noise, key))
    draws = []
    for _ in range(spans):  # one key per span, split as the JAX loop does
        key, k = jax.random.split(key)
        draws.append(_jax_inpaint_draws(k, noise.shape, steps, 1))
    got = ps.span_by_span_compose(ps.make_denoise_fn(p_net, SIGMA_DATA), t(noise), spans, steps,
                                  keep_start=True, draws=draws).numpy()
    L = noise.shape[-1]
    assert got.shape == noise.shape[:-1] + (L + spans * L // 2,)
    np.testing.assert_array_equal(got[..., :L], noise)
    assert rel_err(got, want) < TOL
