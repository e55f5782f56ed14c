"""Port parity for the iSTFTNet decoder (the path of the fused AdaIN+snake
kernel): the NSF source and the whole Decoder, with JAX weights converted
by state_dict_from_jax.

Random draws are zeroed on both sides (`zero_noise`) and the chaotic STFT
phase of the harmonic source is zeroed on both sides (`stable_har_phase`),
as tests/test_ref_parity.py did against the reference.

Tolerances: 1e-4 of the peak for the sine source (f32 phase cumsum over
frames, summed in another order); 1e-3 of the peak for the waveform, the
bound the reference-parity harness held every stage to: ~40 layers of f32
convolutions in another summation order, through a random-init network
that amplifies them.
"""

import jax
import numpy as np
import pytest
import torch

import styletts2_tpu_torch.models.decoder_istft as pdi
from styletts2_tpu.models.decoder_istft import SourceModuleHnNSF
from torch_parity import (jax_cfg, jax_models_and_params, port_models, rel_err,
                          stable_har_phase, t, zero_noise)

B, F = 2, 6


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=6)
    rng = np.random.default_rng(7)
    H, S = jcfg.model_params.hidden_dim, jcfg.model_params.style_dim
    asr = rng.standard_normal((B, F, H)).astype(np.float32)
    f0 = rng.uniform(80.0, 260.0, (B, 2 * F)).astype(np.float32)
    f0[:, :3] = 0.0  # unvoiced frames take the noise branch
    n = rng.standard_normal((B, 2 * F)).astype(np.float32)
    s = rng.standard_normal((B, S)).astype(np.float32)
    return models, params, port_models(jcfg, params), (asr, f0, n, s)


@torch.inference_mode()
def test_nsf_source(setup):
    _, params, port, (_, f0, _, _) = setup
    f0_up = np.repeat(f0, 300, axis=1)[..., None]
    jp = params["decoder"]["params"]["generator"]["m_source"]
    with zero_noise():
        want = np.asarray(SourceModuleHnNSF(upsample_scale=300).apply(
            {"params": jp}, f0_up, rngs={"noise": jax.random.PRNGKey(0)})[0])
        got = port["decoder"].generator.m_source(t(f0_up))[0].numpy()
    assert got.shape == want.shape == (B, 600 * F, 1)
    assert rel_err(got, want) < 1e-4


@torch.inference_mode()
def test_decoder(setup, monkeypatch):
    models, params, port, (asr, f0, n, s) = setup
    calls = []
    fused = pdi.adain_snake

    def counting(x, *a):
        calls.append(tuple(x.shape))
        return fused(x, *a)

    monkeypatch.setattr(pdi, "adain_snake", counting)
    with zero_noise(), stable_har_phase():
        want = np.asarray(jax.jit(lambda v, *a: models.decoder.apply(
            v, *a, rngs={"noise": jax.random.PRNGKey(0)}))(params["decoder"], asr, f0, n, s))
        got = port["decoder"](t(asr.transpose(0, 2, 1)), t(f0), t(n), t(s)).numpy()
    assert got.shape == want.shape == (B, 600 * F)
    assert np.isfinite(got).all()
    assert rel_err(got, want) < 1e-3
    # 8 AdaINResBlock1 x 3 dilations x 2: every one through the fused op
    assert len(calls) == 48
    C0 = port["decoder"].generator.ups[0].weight_v.shape[1]
    assert {c[1:] for c in calls} == {(C0, 20 * F), (C0 // 2, 120 * F + 1)}
