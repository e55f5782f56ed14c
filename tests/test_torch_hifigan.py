"""Port parity for the multispeaker modules of configs/config_libritts.yml at
tiny widths: the StyleTransformer1d denoiser (reference-style features,
padded keys masked, classifier-free guidance batched) and the HiFi-GAN
Decoder, whose 16 AdaINResBlock1 run the fused AdaIN+snake op 96 times.

Random draws are zeroed on both sides (`zero_noise`). Tolerances: 1e-4 of
the peak for one denoiser call (a one-block transformer in f32, as
test_torch_diffusion.py); 1e-3 of the peak for the waveform, the bound the
iSTFTNet decoder is held to (~40 layers of f32 convolutions in another
summation order through a random-init network). The voiced case keeps the
harmonic source, whose phase the two frameworks accumulate in another order
(its own error, 1e-4, is test_torch_decoder.py::test_nsf_source's bound).
"""

import jax
import numpy as np
import pytest
import torch

import styletts2_tpu_torch.models.decoder_istft as pdi
from torch_parity import jax_models_and_params, jax_ms_cfg, port_models, rel_err, t, zero_noise

B, F, T = 2, 6, 12
LENGTHS = np.asarray([12, 7], np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_ms_cfg()
    models, params = jax_models_and_params(jcfg, seed=11)
    return jcfg, models, params, port_models(jcfg, params)


@pytest.mark.parametrize("scale", [1.0, 1.5])
@torch.inference_mode()
def test_style_denoiser(setup, scale):
    jcfg, models, params, port = setup
    rng = np.random.default_rng(12)
    C = 2 * jcfg.model_params.style_dim
    emb = rng.standard_normal((B, T, jcfg.plbert_params.hidden_size)).astype(np.float32)
    emb[1, 7:] = 100.0  # padded positions must not leak into the result
    noise = rng.standard_normal((B, 1, C)).astype(np.float32)
    feats = rng.standard_normal((B, C)).astype(np.float32)
    sigma = np.asarray([0.7, 2.0], np.float32)
    want = np.asarray(jax.jit(lambda v, x, s, e, f: models.diffusion.apply(
        v, x, s, e, features=f, embedding_scale=scale, embedding_lengths=LENGTHS))(
        params["diffusion"], noise, sigma, emb, feats))
    got = port["diffusion"](t(noise), t(sigma), t(emb), embedding_scale=scale,
                            embedding_lengths=torch.as_tensor(LENGTHS), features=t(feats)).numpy()
    assert got.shape == (B, 1, C)
    assert rel_err(got, want) < 1e-4
    with pytest.raises(ValueError, match="features"):
        port["diffusion"](t(noise), t(sigma), t(emb))


@pytest.mark.parametrize("voiced", [False, True])
@torch.inference_mode()
def test_hifigan_decoder(setup, monkeypatch, voiced):
    jcfg, models, params, port = setup
    rng = np.random.default_rng(13)
    H, S = jcfg.model_params.hidden_dim, jcfg.model_params.style_dim
    asr = rng.standard_normal((B, F, H)).astype(np.float32)
    f0 = rng.uniform(80.0, 260.0, (B, 2 * F)).astype(np.float32) * voiced
    f0[:, :3] = 0.0  # unvoiced frames take the noise branch
    n = rng.standard_normal((B, 2 * F)).astype(np.float32)
    s = rng.standard_normal((B, S)).astype(np.float32)
    calls = []
    fused = pdi.adain_snake

    def counting(x, *a):
        calls.append(tuple(x.shape))
        return fused(x, *a)

    monkeypatch.setattr(pdi, "adain_snake", counting)
    with zero_noise():
        want = np.asarray(jax.jit(lambda v, *a: models.decoder.apply(
            v, *a, rngs={"noise": jax.random.PRNGKey(0)}))(params["decoder"], asr, f0, n, s))
        got = port["decoder"](t(asr.transpose(0, 2, 1)), t(f0), t(n), t(s)).numpy()
    assert got.shape == want.shape == (B, 600 * F)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0
    assert rel_err(got, want) < 1e-3
    # 4 stages x (noise_res + 3 resblocks) x 3 dilations x 2, at the stages' shapes
    assert len(calls) == 96
    C0 = jcfg.model_params.decoder.upsample_initial_channel
    assert sorted(set(calls)) == sorted({(B, C0 // 2, 20 * F), (B, C0 // 4, 100 * F),
                                         (B, C0 // 8, 300 * F), (B, C0 // 16, 600 * F)})
