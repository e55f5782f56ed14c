"""The bf16 decoder of the port on the CPU, and its oracle, the fidelity
metrics (`styletts2_tpu_torch/eval.py`).

- `eval.py` against `styletts2_tpu/eval.py` on the same waves: the
  mel-cepstra within 1e-4 of their peak (the same front end in f32), MCD
  with and without DTW within 1e-4 dB relative, the DTW path equal to the
  JAX package's, the F0 metrics equal.
- `Synthesizer(decoder_dtype="bfloat16")` against the JAX Synthesizer's bf16
  decoder at `jax_cfg()` (iSTFTNet) and `jax_ms_cfg()` (HiFi-GAN) widths,
  the decoder's weights held at their bf16-rounded values, every random
  draw zeroed and the source's chaotic part zeroed (its STFT phase, or the
  HiFi-GAN sines) as tests/torch_parity.py does: equal durations, MCD <= 2.5
  dB (the JAX package's `tests/test_bf16.py` bound) and the waveform within
  REL_TOL of its peak (measured here: iSTFTNet 1.03 dB and 7.5e-2,
  HiFi-GAN 1.12 dB and 4.3e-2). That bound does not tell bf16 from f32:
  port f32 against JAX bf16 reads 0.85 / 1.08 dB.
- The decoder alone against the JAX decoder compiled to round every bf16
  op (XLA's default keeps a fusion's intermediates in f32): the port's
  bf16 effect, bf16 vs f32 on the same weights, is JAX's at the AdaIN
  head's first and last blocks and at the waveform (see
  `test_bf16_decoder_rounds_as_jax`).
- The port's bf16 against its f32 compute (the same bf16-rounded weights,
  the same draws, nothing zeroed): equal durations, MCD <= 2.5 dB for both
  decoders (measured here: iSTFTNet 0.25 dB, HiFi-GAN 1.28 dB), and on the
  JAX package's own test case at full width (`test_bf16_jax_test_case`).
  Marked slow, as that JAX test is: the same case on JAX's own weights
  (JAX 1.23 dB, the port 1.01 dB), and the full-width LibriTTS HiFi-GAN
  decoder, where the port (5.23 dB) reads what JAX's decoder reads when
  every bf16 op is rounded (5.12 dB; 0.98 dB with XLA's fusions).
- The f32 islands stay f32 under bf16: the sine source and its phase, the
  normalisation statistics, the weight norm, the spectral-norm iteration
  and its vectors, and each decoder's head.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import styletts2_tpu.eval as jeval
import styletts2_tpu_torch.models.decoder_hifigan as pdh
import styletts2_tpu_torch.models.decoder_istft as pdi
from styletts2_tpu.config import Config as JaxConfig
from styletts2_tpu.models.build import build_models as jax_build_models
from styletts2_tpu_torch import eval as peval
from styletts2_tpu_torch.config import Config as PortConfig
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.inference import Synthesizer
from styletts2_tpu_torch.models.layers import SNConv2d, instance_norm, weight_norm
from torch_parity import (jax_cfg, jax_models_and_params, jax_ms_cfg, port_cfg, port_models,
                          rel_err, stable_har_phase, zero_noise, zero_sines)

TEXT = "ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt."
MCD_BOUND = 2.5
REL_TOL = 0.15
STRICT = {"xla_allow_excess_precision": False}
BF16_SEEN = 5
EFFECT_RATIO = 2
JAX_CASE = dict(text="ðɪs ɪz ɐ tˈɛst.", diffusion_steps=3, seed=4)  # tests/test_bf16.py's


def _wave(rng, seconds, f0=150.0):
    t = np.arange(int(seconds * 24000)) / 24000
    wav = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 5))
    return (wav + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def test_eval_matches_jax(rng):
    a, b = _wave(rng, 1.0), _wave(rng, 1.3, f0=170.0)
    want = np.asarray(jeval.mfcc_from_wav(a))
    got = peval.mfcc_from_wav(a)
    assert got.shape == want.shape == (81, 13) and rel_err(got, want) < 1e-4
    for use_dtw in (True, False):
        w, g = jeval.mcd(a, b, use_dtw=use_dtw), peval.mcd(a, b, use_dtw=use_dtw)
        assert g > 1.0 and abs(g - w) <= 1e-4 * w, (use_dtw, g, w)
    assert peval.mcd(a, a) == 0.0
    ca, cb = peval.mfcc_from_wav(a), peval.mfcc_from_wav(b)
    for p, o in zip(peval.dtw_path(ca, cb), jeval._dtw_path(ca, cb)):
        np.testing.assert_array_equal(p, o)
    f0a = np.where(rng.random(200) < 0.7, rng.uniform(80, 300, 200), 0.0)
    f0b = np.where(rng.random(190) < 0.7, rng.uniform(80, 300, 190), 0.0)
    assert peval.f0_metrics(f0a, f0b) == jeval.f0_metrics(f0a, f0b)


def _rounded(params):
    """The decoder's weights at their bf16-rounded values, the rest as they are."""
    out = dict(params)
    out["decoder"] = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
                                  params["decoder"])
    return out


@pytest.fixture(scope="module", params=["istftnet", "hifigan"])
def case(request):
    jcfg = jax_cfg() if request.param == "istftnet" else jax_ms_cfg()
    jmodels, params = jax_models_and_params(jcfg, seed=8)
    params = _rounded(params)
    sd = state_dict_from_jax(params, port_cfg(jcfg))
    noise = np.random.default_rng(9).standard_normal(
        (1, 1, 2 * jcfg.model_params.style_dim)).astype(np.float32)
    return types.SimpleNamespace(jcfg=jcfg, jmodels=jmodels, params=params, sd=sd, noise=noise,
                                 hifigan=request.param == "hifigan")


def _chaos_off(case):
    return zero_sines() if case.hifigan else stable_har_phase()


def test_bf16_decode_matches_jax(case):
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer

    jsyn = JaxSynthesizer(case.jcfg, params=case.params, decoder_dtype="bfloat16")
    psyn = Synthesizer(port_cfg(case.jcfg), state_dict=case.sd, device="cpu",
                       decoder_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in psyn.models["decoder"].parameters())
    kw = dict(noise=case.noise, speed=4.0)
    with zero_noise(), _chaos_off(case):
        want, _ = jsyn.inference(TEXT, **kw)
        got = psyn.synthesize(TEXT, **kw)
    assert got.wav.dtype == np.float32 and got.wav.shape == want.shape
    assert np.isfinite(got.wav).all()
    score, err = peval.mcd(got.wav, want, use_dtw=False), rel_err(got.wav, want)
    print(f"\nbf16 port vs JAX ({'hifigan' if case.hifigan else 'istftnet'}): MCD {score:.4f} dB, "
          f"waveform rel err {err:.3e}")
    assert score <= MCD_BOUND and err < REL_TOL


POINTS = ("encode", "decode_3", "wav")


def _decoder_inputs(jcfg, n_frames=60):
    mp, rng = jcfg.model_params, np.random.default_rng(3)
    return (rng.standard_normal((1, n_frames, mp.hidden_dim)).astype(np.float32),
            rng.uniform(100, 250, (1, 2 * n_frames)).astype(np.float32),
            rng.standard_normal((1, 2 * n_frames)).astype(np.float32),
            rng.standard_normal((1, mp.style_dim)).astype(np.float32))


def _jax_points(case, inputs, bf16, points=POINTS):
    """The JAX decoder's outputs at `points` (submodule paths, then "wav"),
    compiled with XLA's excess precision off (every bf16 op rounded, as
    eager PyTorch rounds it)."""
    dt = jnp.bfloat16 if bf16 else jnp.float32
    asr, f0, n, s = inputs
    args = (jax.tree.map(lambda x: x.astype(dt), case.params["decoder"]),
            jnp.asarray(asr, dt), jnp.asarray(f0), jnp.asarray(n), jnp.asarray(s, dt))
    fn = jax.jit(lambda p, *a: case.jmodels.decoder.apply(
        p, *a, rngs={"noise": jax.random.PRNGKey(0)}, capture_intermediates=True))
    wav, state = fn.lower(*args).compile(compiler_options=STRICT)(*args)
    out = {"wav": np.asarray(wav, np.float32)}
    for k in points[:-1]:
        node = state["intermediates"]
        for part in k.split("/"):
            node = node[part]
        out[k] = np.asarray(node["__call__"][0], np.float32).transpose(0, 2, 1)
    return out


def _submodule(dec, path):
    """The port's module at a JAX path ("decode_3", "generator/noise_res_3")."""
    for part in path.split("/"):
        if hasattr(dec, part):
            dec = getattr(dec, part)
        else:
            name, i = part.rsplit("_", 1)
            dec = getattr(dec, name)[int(i)]
    return dec


def _port_points(case, inputs, bf16, points=POINTS):
    dt = torch.bfloat16 if bf16 else torch.float32
    asr, f0, n, s = (torch.from_numpy(x) for x in inputs)
    dec = port_models(case.jcfg, case.params)["decoder"].to(dt)
    got = {}
    hooks = [_submodule(dec, k).register_forward_hook(
        lambda m, a, o, k=k: got.__setitem__(k, o.float().numpy())) for k in points[:-1]]
    with torch.no_grad():
        wav = dec(asr.transpose(1, 2).to(dt), f0, n, s.to(dt), generator=torch.Generator())
    for h in hooks:
        h.remove()
    return dict(got, wav=wav.numpy())


def test_bf16_decoder_rounds_as_jax(case):
    """The decoder alone, on the same inputs, against the JAX decoder
    compiled to round every bf16 op: the port's bf16 effect (bf16 vs f32
    on the same weights) at the AdaIN head's first block, its last one and
    the waveform is the JAX decoder's within a factor EFFECT_RATIO, and at
    least BF16_SEEN times the f32 parity between the two, which an f32 run
    (no effect) does not reach. Measured here, port / JAX: 8.9e-3 / 8.4e-3,
    1.05e-2 / 9.2e-3, and at the waveform 1.6e-2 / 1.9e-2 (iSTFTNet, f32
    parity 2.3e-3) and 4.3e-2 / 5.1e-2 (HiFi-GAN). Port bf16 against JAX
    bf16 is not below port f32 against JAX bf16 (7.9e-3 against 8.4e-3 at
    the first block): JAX adds a conv's bias, and a dense layer's, after
    rounding its output, the port inside it, so the two round in other
    places."""
    inputs = _decoder_inputs(case.jcfg)
    with zero_noise(), _chaos_off(case):
        j32, j16 = (_jax_points(case, inputs, b) for b in (False, True))
        p32, p16 = (_port_points(case, inputs, b) for b in (False, True))
    for k in POINTS:
        effect, jax_effect, floor = rel_err(p16[k], p32[k]), rel_err(j16[k], j32[k]), rel_err(
            p32[k], j32[k])
        print(f"\n{'hifigan' if case.hifigan else 'istftnet'} {k}: bf16 effect port {effect:.3e}, "
              f"JAX {jax_effect:.3e}; f32 parity {floor:.3e}; port bf16 vs JAX bf16 "
              f"{rel_err(p16[k], j16[k]):.3e}, port f32 vs JAX bf16 {rel_err(p32[k], j16[k]):.3e}")
        assert effect >= BF16_SEEN * floor, (k, effect, floor)
        assert jax_effect / EFFECT_RATIO <= effect <= EFFECT_RATIO * jax_effect, (
            k, effect, jax_effect)


def test_bf16_vs_f32_compute(case):
    cfg = port_cfg(case.jcfg)
    syn32 = Synthesizer(cfg, state_dict=case.sd, device="cpu")
    syn16 = Synthesizer(cfg, state_dict=case.sd, device="cpu", decoder_dtype="bfloat16")
    kw = dict(noise=case.noise, speed=4.0, seed=4)
    a, b = syn32.synthesize(TEXT, **kw), syn16.synthesize(TEXT, **kw)
    np.testing.assert_array_equal(a.pred_dur, b.pred_dur)  # the f32 stages
    assert a.wav.shape == b.wav.shape and np.isfinite(b.wav).all()
    score = peval.mcd(b.wav, a.wav, use_dtw=False)
    print(f"\nbf16 vs f32 compute ({'hifigan' if case.hifigan else 'istftnet'}): MCD {score:.4f} dB")
    assert score <= MCD_BOUND


def _jax_case_cfg(make):
    """tests/test_bf16.py's `tiny_cfg`: full width, one PL-BERT layer and
    one denoiser layer."""
    cfg = make()
    cfg.plbert_params.num_hidden_layers = 1
    cfg.model_params.diffusion.transformer.num_layers = 1
    return cfg


def _port_bf16_vs_f32(cfg, state_dict=None, **kw):
    """JAX_CASE through the port's bf16 and f32 decoders holding the same
    bf16-rounded weights: (MCD in dB, the f32 synthesis)."""
    syn16 = Synthesizer(cfg, state_dict=state_dict, seed=0, device="cpu",
                        decoder_dtype="bfloat16")
    syn32 = Synthesizer(cfg, state_dict=state_dict, seed=0, device="cpu")
    with torch.no_grad():
        for p32, p16 in zip(syn32.models["decoder"].parameters(),
                            syn16.models["decoder"].parameters()):
            p32.copy_(p16.float())
    noise = np.random.default_rng(1).standard_normal((1, 1, 256)).astype(np.float32)
    a, b = (syn.synthesize(noise=noise, **JAX_CASE, **kw) for syn in (syn32, syn16))
    np.testing.assert_array_equal(a.pred_dur, b.pred_dur)
    assert np.isfinite(b.wav).all()
    return peval.mcd(b.wav, a.wav, use_dtw=False), a


def test_bf16_jax_test_case():
    """The JAX package's own bf16 bound (tests/test_bf16.py: its config,
    text, noise, steps and seed; the decoder's weights bf16-rounded on both
    paths) on the port's full-width iSTFTNet with its seed-0 weights: MCD
    <= 2.5 dB (measured here 1.11 dB; the JAX package's test reads ~1.1)."""
    score, _ = _port_bf16_vs_f32(_jax_case_cfg(PortConfig))
    print(f"\nbf16 vs f32 compute, JAX's test case, the port's weights: MCD {score:.4f} dB")
    assert score <= MCD_BOUND


@pytest.mark.slow
def test_bf16_jax_test_case_on_jax_weights():
    """tests/test_bf16.py on JAX's own weights (`Synthesizer(tiny_cfg(),
    seed=0)`), the decoder's rounded: the JAX package reads 1.23 dB here,
    the port on the same weights 1.01 dB (<= 2.5)."""
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer

    jcfg = _jax_case_cfg(JaxConfig)
    params = _rounded(JaxSynthesizer(jcfg, seed=0, frame_bucket=1).params)
    noise = np.random.default_rng(1).standard_normal((1, 1, 256)).astype(np.float32)
    want = [JaxSynthesizer(jcfg, params=params, decoder_dtype=dt, frame_bucket=1).inference(
        JAX_CASE["text"], noise=noise, diffusion_steps=3, seed=4)[0]
        for dt in ("float32", "bfloat16")]
    pcfg = port_cfg(jcfg)
    score, _ = _port_bf16_vs_f32(pcfg, state_dict_from_jax(params, pcfg))
    print(f"\nJAX's test case on JAX's weights: JAX {peval.mcd(want[1], want[0], use_dtw=False):.4f} "
          f"dB, the port {score:.4f} dB")
    assert score <= MCD_BOUND


@pytest.mark.slow
def test_bf16_hifigan_full_width_rounds_as_jax():
    """The full-width LibriTTS HiFi-GAN decoder (`configs/config_libritts.yml`)
    on JAX's weights (`Synthesizer(cfg, seed=0)`, rounded), alone on seeded
    inputs, draws zeroed: the port's bf16-vs-f32 MCD is the JAX decoder's
    compiled to round every bf16 op (measured 5.23 against 5.12 dB) within
    EFFECT_RATIO; JAX's default program, whose fusions keep their
    intermediates in f32 (XLA's excess precision), reads 0.98 dB. Neither
    is held to 2.5 dB: the bf16 error grows through the source branch
    (`noise_res`, stage by stage, on both sides; printed)."""
    from styletts2_tpu.config import load_config
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer

    jcfg = load_config("configs/config_libritts.yml")
    case = types.SimpleNamespace(jcfg=jcfg, jmodels=None, hifigan=True, params=_rounded(
        JaxSynthesizer(jcfg, seed=0, frame_bucket=1).params))
    case.jmodels = jax_build_models(jcfg)
    rng = np.random.default_rng(3)
    mp = jcfg.model_params
    inputs = ((0.5 * rng.standard_normal((1, 100, mp.hidden_dim))).astype(np.float32),
              rng.uniform(100, 250, (1, 200)).astype(np.float32),
              rng.standard_normal((1, 200)).astype(np.float32),
              (0.3 * rng.standard_normal((1, mp.style_dim))).astype(np.float32))
    points = tuple(f"generator/noise_res_{i}" for i in range(4)) + ("wav",)
    with zero_noise():
        j32, j16 = (_jax_points(case, inputs, b, points) for b in (False, True))
        p32, p16 = (_port_points(case, inputs, b, points) for b in (False, True))
        for k in points[:-1]:
            print(f"\n{k}: bf16 error, the port {rel_err(p16[k], p32[k]):.3e}, JAX rounding every "
                  f"op {rel_err(j16[k], j32[k]):.3e}")
        (j32, j16), (p32, p16) = ((a["wav"][0], b["wav"][0]) for a, b in ((j32, j16), (p32, p16)))
        fused = np.asarray(jax.jit(lambda p, *a: case.jmodels.decoder.apply(
            p, *a, rngs={"noise": jax.random.PRNGKey(0)}))(
            jax.tree.map(lambda x: x.astype(jnp.bfloat16), case.params["decoder"]),
            jnp.asarray(inputs[0], jnp.bfloat16), *map(jnp.asarray, inputs[1:3]),
            jnp.asarray(inputs[3], jnp.bfloat16)), np.float32)[0]
    port, jax_strict = peval.mcd(p16, p32, use_dtw=False), peval.mcd(j16, j32, use_dtw=False)
    print(f"\nHiFi-GAN full width, bf16 vs f32: the port {port:.4f} dB, JAX rounding every op "
          f"{jax_strict:.4f} dB, JAX's default program {peval.mcd(fused, j32, use_dtw=False):.4f} dB")
    assert jax_strict / EFFECT_RATIO <= port <= EFFECT_RATIO * jax_strict


def test_f32_islands(rng, monkeypatch):
    """Under bf16: the sine source (the phase cumsum) computes in f32 from
    the pitch as given; instance norm's statistics are f32 and its output
    the input's dtype; weight norm normalises in f32 from the rounded v and
    g; the spectral-norm iteration and its stored vectors are f32; the
    iSTFT head and the HiFi-GAN head take f32 and each decoder returns f32."""
    f0 = torch.from_numpy(rng.uniform(90, 250, (1, 4800, 1)).astype(np.float32)).bfloat16()
    gen = pdi.SineGen(upsample_scale=300)
    g = torch.Generator().manual_seed(0)
    sines, uv = gen(f0, torch.Generator().manual_seed(0))
    want, _ = gen(f0.float(), g)
    assert sines.dtype == uv.dtype == torch.float32 and torch.equal(sines, want)

    x = torch.from_numpy(rng.standard_normal((2, 8, 300)).astype(np.float32) * 3 + 40).bfloat16()
    xs = x.double()
    ref = (xs - xs.mean(-1, keepdim=True)) / torch.sqrt(xs.var(-1, unbiased=False, keepdim=True)
                                                        + 1e-5)
    got = instance_norm(x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.double(), ref, atol=2e-2, rtol=1e-2)  # one bf16 rounding

    v = torch.from_numpy(rng.standard_normal((64, 512, 7)).astype(np.float32)).bfloat16()
    gain = torch.ones(64, 1, 1).bfloat16()
    w = weight_norm(v, gain)
    vd = v.double()
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, (vd / vd.pow(2).sum((1, 2), keepdim=True).add(1e-12).sqrt()).bfloat16())

    sn = SNConv2d(4, 8, 3, padding=1)
    torch.nn.init.normal_(sn.weight_orig)
    sn.weight_u.normal_()
    params = {n: p.bfloat16() for n, p in sn.named_parameters()}
    y = functional_call(sn, params, (torch.randn(1, 4, 6, 6).bfloat16(),), {"update_stats": True})
    assert y.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in sn.pending + (sn.weight_u, sn.weight_v))

    seen = {}
    istft = pdi.istft
    monkeypatch.setattr(pdi, "istft", lambda m, p, *a: seen.setdefault("istft", (m.dtype, p.dtype))
                        and istft(m, p, *a))
    conv1d = torch.nn.functional.conv1d
    monkeypatch.setattr(pdh, "F", types.SimpleNamespace(
        conv1d=lambda x, w, *a, **k: seen.setdefault("head", (x.dtype, w.dtype)) and conv1d(
            x, w, *a, **k)))
    for cfg in (jax_cfg(), jax_ms_cfg()):
        syn = Synthesizer(port_cfg(cfg), device="cpu", decoder_dtype="bfloat16")
        wav = syn.synthesize("hˈɛloʊ.", diffusion_steps=3, speed=8.0).wav
        assert wav.dtype == np.float32 and np.isfinite(wav).all()
    assert seen == {"istft": (torch.float32,) * 2, "head": (torch.float32,) * 2}
