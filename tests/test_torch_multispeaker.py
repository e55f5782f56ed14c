"""The port's multispeaker (LibriTTS, HiFi-GAN) synthesis against the JAX
Synthesizer at tiny widths: the weight round trip, `compute_style`,
`inference` with a reference style and classifier-free guidance, and
`LFinference` carrying the style over.

Random draws are zeroed on both sides (`zero_noise`) and so are the NSF
source's harmonic sines (`zero_sines`: their phase reaches ~1e5 rad, where
f32 rounding in another summation order is O(1e-2) rad). Tolerances: the
integer durations equal; the style within 1e-4 of its peak (text encoders
and 5 diffusion steps in f32); the waveform within 1e-3 of its peak, the
decoder's bound (test_torch_hifigan.py); compute_style within 1e-4 (the
mel front end and ten SN convolutions, test_torch_style.py).
"""

import jax
import numpy as np
import pytest

from styletts2_tpu.convert import convert_styletts2_checkpoint
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.models.build import build_models, module_keys
from torch_parity import jax_models_and_params, jax_ms_cfg, port_cfg, rel_err, zero_noise, zero_sines

TEXT = "ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt."
NEXT = "sˈɛkənd sˈɛntəns."


@pytest.fixture(scope="module")
def setup():
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg = jax_ms_cfg()
    _, params = jax_models_and_params(jcfg, seed=21)
    jsyn = JaxSynthesizer(jcfg, params=params)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    n = np.arange(48000)  # 2 s reference voice: harmonics plus noise
    wave = (0.3 * np.sin(2 * np.pi * 150.0 * n / 24000) + 0.1 * np.sin(2 * np.pi * 450.0 * n / 24000)
            + 0.02 * np.random.default_rng(22).standard_normal(n.size)).astype(np.float32)
    return jcfg, params, jsyn, psyn, wave


def test_weight_round_trip_is_exact(setup):
    """For the LibriTTS config, state_dict_from_jax is the exact inverse of
    convert_styletts2_checkpoint on every leaf of every module, the style
    encoders' spectral (u, v) included, and loads strictly into the port."""
    jcfg, params, *_ = setup
    pcfg = port_cfg(jcfg)
    sd = state_dict_from_jax(params, pcfg)
    port_sd = build_models(pcfg).state_dict()
    assert sd.keys() == port_sd.keys()
    assert all(sd[k].shape == port_sd[k].shape for k in sd)
    keys = module_keys(pcfg)
    assert {"style_encoder", "predictor_encoder"} <= set(keys)
    net = {key: {} for key in keys}
    for name, v in sd.items():
        key, rest = name.split(".", 1)
        net[key][rest] = v.numpy()
    back = convert_styletts2_checkpoint({"net": net}, jcfg)
    for key in keys:
        want = jax.tree_util.tree_flatten_with_path(params[key])[0]
        got = jax.tree_util.tree_flatten_with_path(back[key])[0]
        assert [p for p, _ in got] == [p for p, _ in want], key
        for (path, g), (_, w) in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w), (key, path)


def test_compute_style_matches_jax(setup):
    _, _, jsyn, psyn, wave = setup
    want = jsyn.compute_style(wave)
    got = psyn.compute_style(wave)
    assert got.shape == want.shape == (1, 2 * psyn.style_dim)
    assert rel_err(got, want) < 1e-4


def test_inference_and_lfinference_match_jax(setup):
    jcfg, _, jsyn, psyn, _ = setup
    rng = np.random.default_rng(23)
    ref_s = rng.standard_normal((1, 2 * psyn.style_dim)).astype(np.float32)
    noise = rng.standard_normal((1, 1, 2 * psyn.style_dim)).astype(np.float32)
    seen = []
    get_phase_b = jsyn._get_phase_b

    def spy(n_frames):  # records the durations the JAX decoder stage gets
        pb = get_phase_b(n_frames)

        def run(params_, t_en, d, s, ref, pred_dur, key, pcm16=False):
            seen.append(np.asarray(pred_dur))
            return pb(params_, t_en, d, s, ref, pred_dur, key, pcm16=pcm16)

        return run

    jsyn._get_phase_b = spy
    with zero_noise(), zero_sines():
        want_wav, want_s = jsyn.inference(TEXT, ref_s=ref_s, noise=noise, embedding_scale=1.5,
                                          speed=4.0)
        got = psyn.synthesize(TEXT, ref_s=ref_s, noise=noise, embedding_scale=1.5, speed=4.0)
        want_lf, want_s2 = jsyn.LFinference(NEXT, want_s, ref_s=ref_s, speed=4.0)
        got_lf, got_s2 = psyn.LFinference(NEXT, got.s_pred, ref_s=ref_s, speed=4.0)
    L = len(got.pred_dur)
    np.testing.assert_array_equal(got.pred_dur, seen[0][0, :L])
    assert rel_err(got.s_pred, want_s) < 1e-4
    # multispeaker: no +5 on the last token, 50 samples trimmed
    assert got.wav.shape == want_wav.shape == (int(got.pred_dur.sum()) * 600 - 50,)
    assert np.isfinite(got.wav).all()
    assert rel_err(got.wav, want_wav) < 1e-3
    # LFinference: the carried style weighs 0.7, 100 samples trimmed
    assert rel_err(got_s2, want_s2) < 1e-4
    assert got_lf.shape == want_lf.shape == (int(seen[1][0].sum()) * 600 - 100,)
    assert rel_err(got_lf, want_lf) < 1e-3


def test_style_mix_and_long_form(setup):
    """alpha = beta = 0 returns the reference style itself; long_form is the
    LFinference chain over its sentences; STinference is inference."""
    _, _, _, psyn, wave = setup
    ref_s = psyn.compute_style(wave)
    kw = dict(ref_s=ref_s, diffusion_steps=3, speed=8.0)
    _, s = psyn.inference(NEXT, alpha=0.0, beta=0.0, **kw)
    np.testing.assert_allclose(s, ref_s, rtol=1e-6, atol=1e-6)
    wav = psyn.long_form(f"hˈɛloʊ! {NEXT}", seed=3, **kw)
    w1, s1 = psyn.LFinference("hˈɛloʊ!", None, seed=3, **kw)
    w2, _ = psyn.LFinference(NEXT, s1, seed=4, **kw)
    np.testing.assert_array_equal(wav, np.concatenate([w1, w2]))
    st = psyn.STinference("hˈɛloʊ.", ref_s, NEXT, diffusion_steps=3, seed=5)
    np.testing.assert_array_equal(
        st, psyn.inference("hˈɛloʊ.", ref_s=ref_s, diffusion_steps=3, seed=5)[0])
