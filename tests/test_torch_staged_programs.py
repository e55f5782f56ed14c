"""The JAX Synthesizer's staged and batched programs in the port, on the CPU,
against the JAX package at the tiny widths of tests/torch_parity.py, for the
single-speaker iSTFTNet config and the multispeaker HiFi-GAN one:

- each program run alone (`Synthesizer._text`, `_style`, `_duration`,
  `_phase_a_program`, `_prosody`, `_decode` and its PCM16 form) against the
  JAX stage of the same name (`stage_text`, `stage_style`, `stage_duration`,
  `phase_a`, `stage_prosody`, `stage_decode`, `stage_decode_pcm16`) on the
  same inputs, a batch of 3 texts of mixed lengths;
- `inference` with `phase_a="staged"` (the chain text -> style -> duration
  -> prosody -> decode) against the JAX staged `inference`, in f32 and as
  16-bit PCM (`pcm16=True`);
- `inference_batch` of 3 mixed-length texts (phase A as one program)
  against the JAX `inference_batch`.

Random draws are zeroed on both sides, and so are the chaotic source phase
(iSTFTNet) and the harmonic sines (HiFi-GAN), as in test_torch_synth.py and
test_torch_multispeaker.py. Tolerances, those of test_torch_synth.py: the
integer durations and the lengths equal, the style within 1e-4 of its peak,
a waveform within 1e-3 of its peak; a program's floating outputs within
1e-4 of their peak (the decoder's 1e-3). 16-bit PCM: the lengths equal, the
port's samples its own f32 waveform scaled by 32767, clamped and truncated
as JAX's `stage_decode_pcm16` makes them, and within 1 LSB of JAX's samples
wherever the two f32 waveforms differ by less than one LSB, at least 99% of
the samples (elsewhere the f32 bound holds them: random-init decoders reach
peaks of ~4e4, iSTFTNet, or sit in tanh's saturation, HiFi-GAN).
"""

from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

import styletts2_tpu.inference as jinf
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.inference import Synthesizer, _mix
from styletts2_tpu_torch.text import encode_text
from torch_parity import (jax_cfg, jax_models_and_params, jax_ms_cfg, nwc_to_ncw, port_cfg,
                          rel_err, stable_har_phase, zero_noise, zero_sines)

TEXTS = ["ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt.", "hˈɛloʊ.", "ɐ ʃˈɔːɹt wˈʌn."]
STEPS = 5  # the main path's ADPM2 steps
SPEED = 4.0
N_FRAMES = 100  # the frame bucket of the programs' batch


@contextmanager
def _draws_zeroed(ms):
    with zero_noise(), (zero_sines() if ms else stable_har_phase()):
        yield


@pytest.fixture(scope="module", params=["ljspeech", "libritts"])
def pair(request):
    """(JAX Synthesizer, its params, the port's on the CPU, reference
    styles (3, 2*style_dim) or None, the CFG scale, whether multispeaker)."""
    ms = request.param == "libritts"
    jcfg = jax_ms_cfg() if ms else jax_cfg()
    # the weights test_torch_synth.py and test_torch_batch.py hold the paths with
    _, params = jax_models_and_params(jcfg, seed=31 if ms else 8)
    if not ms:
        params = _head_gain(params, 0.1)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    refs = None
    if ms:
        refs = np.random.default_rng(32).standard_normal((3, 2 * psyn.style_dim)).astype(
            np.float32)
    return jinf.Synthesizer(jcfg, params=params), params, psyn, refs, 1.5 if ms else 1.0, ms


def _head_gain(params, gain):
    """The iSTFTNet head's weight-norm gain (conv_post g, whose output is
    exponentiated into the spectrum's magnitude) times `gain`, on both sides.
    At random init its log-magnitudes put a batch's waveform peaks at ~1e3
    (this file's batch at seed 8: 920, 306, 1849), where the two frameworks'
    ~1e-6 differences upstream read 1.6e-3 of the peak against the bound of
    1e-3; at 0.1 the peaks are ~0.2, an audio level, as phase 8 of
    chip_smoke.py keeps HiFi-GAN's head out of tanh's saturation."""
    dec = params["decoder"]["params"]
    post = dict(dec["generator"]["conv_post"], g=dec["generator"]["conv_post"]["g"] * gain)
    generator = dict(dec["generator"], conv_post=post)
    return dict(params, decoder=dict(params["decoder"], params=dict(dec, generator=generator)))


def _close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and rel_err(got, want) < tol


def _batch(psyn, refs):
    """The 3 texts' inputs, host tensors of `Synthesizer._host_inputs` with
    a carry-over of weight 0.6, and a seeded starting noise."""
    sd = psyn.style_dim
    s_prev = np.random.default_rng(44).standard_normal((3, 2 * sd)).astype(np.float32)
    inputs = psyn._host_inputs([encode_text(t) for t in TEXTS], refs, _mix(0.3, 0.7, 0.6), s_prev)
    inputs["noise"] = torch.from_numpy(
        np.random.default_rng(45).standard_normal((3, 1, 2 * sd)).astype(np.float32))
    return inputs


@pytest.fixture(scope="module")
def jax_chain(pair):
    """(`_batch`'s inputs as numpy, {stage name: the JAX stage's outputs as
    numpy}): each stage run on the previous ones' outputs."""
    jsyn, params, psyn, refs, scale, ms = pair
    x = {k: v.numpy() for k, v in _batch(psyn, refs).items()}
    tokens, lengths = x["tokens"].astype(np.int32), x["lengths"].astype(np.int32)
    key = jax.random.PRNGKey(0)
    stage_text, stage_duration = jsyn._stages()
    stage_style = jsyn._get_stage_style(STEPS, scale)
    phase_b = jsyn._get_phase_b(N_FRAMES)
    cells = dict(zip(phase_b.__code__.co_freevars, (c.cell_contents for c in phase_b.__closure__)))
    out = {}
    with _draws_zeroed(ms):
        out["text"] = stage_text(params, tokens, lengths)
        style_args = (x["noise"], key, x["feats"], 0.3, 0.7, x["s_prev"], 0.6)
        out["style"] = stage_style(params, out["text"][1], lengths, *style_args)
        out["duration"] = stage_duration(params, out["text"][2], out["style"][0], lengths)
        out["phase_a"] = jsyn._get_phase_a(STEPS, scale)(params, tokens, lengths, *style_args)
        out["prosody"] = cells["stage_prosody"](params, out["text"][0], out["duration"][0],
                                                out["style"][0], out["duration"][1])
        asr, F0, N = out["prosody"]
        out["decode"] = cells["stage_decode"](params, asr, F0, N, out["style"][1], key)
        out["decode_pcm16"] = cells["stage_decode_pcm16"](params, asr, F0, N, out["style"][1], key)
    return x, {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["text", "style", "duration", "phase_a", "prosody", "decode",
                                  "decode_pcm16"])
@torch.inference_mode()
def test_program_matches_the_jax_stage(pair, jax_chain, name):
    """Each program on the inputs of the JAX stage of the same name: the
    text features, the style (carry-over and reference mix), the integer
    durations (equal), phase A as one program, the aligned features with F0
    and energy, the waveform and its 16-bit PCM."""
    _, _, psyn, _, scale, ms = pair
    x, want = jax_chain
    tokens, lengths = torch.from_numpy(x["tokens"]), torch.from_numpy(x["lengths"])
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    gen = torch.Generator().manual_seed(0)
    style_in = dict(lengths=lengths, noise=t["noise"], feats=t["feats"], scalars=t["scalars"],
                    s_prev=t["s_prev"])
    with _draws_zeroed(ms):
        if name == "text":
            t_en, bert_dur, d_en = psyn._text(gen, tokens, lengths)
            _close(t_en, nwc_to_ncw(want["text"][0]))
            _close(bert_dur, want["text"][1])
            _close(d_en, want["text"][2])
        elif name == "style":
            got = psyn._style(gen, torch.from_numpy(want["text"][1]), **style_in, steps=STEPS,
                              scale=scale)
            for g, w in zip(got, want["style"]):
                _close(g, w)
        elif name == "duration":
            d, pred_dur = psyn._duration(gen, torch.from_numpy(want["text"][2]),
                                         torch.from_numpy(want["style"][0]), lengths)
            _close(d, want["duration"][0])
            np.testing.assert_array_equal(pred_dur.numpy(), want["duration"][1])
            assert (pred_dur.numpy()[:, 1:] == 0).any()  # mixed lengths: 0 past each length
        elif name == "phase_a":
            got = psyn._phase_a_program(gen, tokens, **style_in, steps=STEPS, scale=scale)
            t_en, d, s, ref, s_out, pred_dur = want["phase_a"]
            for g, w in zip(got[1:5], (d, s, ref, s_out)):
                _close(g, w)
            _close(got[0], nwc_to_ncw(t_en))
            np.testing.assert_array_equal(got[5].numpy(), pred_dur)
        elif name == "prosody":
            asr, F0, N = psyn._prosody(gen, nwc_to_ncw(want["text"][0]),
                                       torch.from_numpy(want["duration"][0]),
                                       torch.from_numpy(want["style"][0]),
                                       torch.from_numpy(want["duration"][1].astype(np.int64)),
                                       n_frames=N_FRAMES)
            _close(asr, nwc_to_ncw(want["prosody"][0]))
            _close(F0, want["prosody"][1])
            _close(N, want["prosody"][2])
        else:
            jasr, F0, N = want["prosody"]
            args = (gen, nwc_to_ncw(jasr), torch.from_numpy(F0), torch.from_numpy(N),
                    torch.from_numpy(want["style"][1]))
            (wav,) = psyn._decode(*args)
            _close(wav, want["decode"], 1e-3)
            if name == "decode_pcm16":
                (pcm,) = psyn._decode(*args, pcm16=True)
                assert pcm.dtype == torch.int16 and pcm.shape == want[name].shape
                _pcm_within_an_lsb(pcm.numpy(), wav.numpy(), want[name], want["decode"])


def _pcm_within_an_lsb(pcm, wav, want_pcm, want_wav):
    """16-bit PCM as JAX's `stage_decode_pcm16` makes it: the port's samples
    are its own f32 waveform scaled by 32767, clamped and truncated, and
    within 1 LSB of JAX's wherever the two f32 waveforms differ by less
    than one LSB (99% of the samples or more; elsewhere the f32 bound of
    1e-3 of the peak holds them: a random-init iSTFTNet's peak is ~4e4)."""
    np.testing.assert_array_equal(pcm, np.trunc(np.clip(
        wav * np.float32(32767.0), -32768, 32767)).astype(np.int16))  # in f32, as both compute
    agree = np.abs(wav.astype(np.float64) - want_wav) * 32767.0 < 1.0
    lsb = np.abs(pcm.astype(np.int64) - want_pcm.astype(np.int64))
    assert agree.mean() >= 0.99 and lsb[agree].max() <= 1


@pytest.fixture(scope="module")
def phase_b_durations(pair):
    """The durations each JAX phase B is run with, newest last."""
    jsyn = pair[0]
    seen, get = [], jsyn._get_phase_b

    def spy(n_frames):
        pb = get(n_frames)

        def run(params_, t_en, d, s, ref, pred_dur, key, pcm16=False):
            seen.append(np.asarray(pred_dur))
            return pb(params_, t_en, d, s, ref, pred_dur, key, pcm16=pcm16)

        return run

    jsyn._get_phase_b = spy
    yield seen
    jsyn._get_phase_b = get


@pytest.mark.parametrize("pcm16", [False, True])
def test_staged_inference_matches_jax(pair, phase_b_durations, pcm16):
    """`inference` through the staged programs (two host syncs) against the
    JAX staged `inference`: durations, style, waveform; with pcm16 the
    16-bit samples within 1 LSB of JAX's where its f32 waveform agrees, and
    equal to the port's own f32 waveform scaled, clamped and truncated."""
    jsyn, _, psyn, refs, scale, ms = pair
    ref_s = None if refs is None else refs[:1]
    noise = np.random.default_rng(9).standard_normal((1, 1, 2 * psyn.style_dim)).astype(np.float32)
    kw = dict(ref_s=ref_s, noise=noise, diffusion_steps=STEPS, embedding_scale=scale, speed=SPEED)
    with _draws_zeroed(ms):
        want_wav, want_s = jsyn.inference(TEXTS[0], pcm16=pcm16, **kw)
        got = psyn.synthesize(TEXTS[0], pcm16=pcm16, **kw)
        if pcm16:  # the f32 waveforms beside the 16-bit ones
            jax_f32, _ = jsyn.inference(TEXTS[0], **kw)
            f32 = psyn.synthesize(TEXTS[0], **kw).wav
    L = len(got.pred_dur)
    np.testing.assert_array_equal(got.pred_dur, phase_b_durations[-1][0, :L])
    assert rel_err(got.s_pred, want_s) < 1e-4
    assert got.wav.shape == want_wav.shape and np.isfinite(got.wav).all()
    if not pcm16:
        assert rel_err(got.wav, want_wav) < 1e-3
    else:
        _pcm_within_an_lsb(np.round(got.wav * 32767.0).astype(np.int16), f32,
                           np.round(want_wav * 32767.0).astype(np.int16), jax_f32)


def test_inference_batch_matches_jax(pair, phase_b_durations):
    """`inference_batch` of 3 mixed-length texts, phase A as one program,
    against the JAX `inference_batch`: durations equal, each waveform's
    length equal and within 1e-3 of its peak."""
    jsyn, _, psyn, refs, scale, ms = pair
    got_dur, run = [], psyn._run

    def spy(toks, *a):
        out = run(toks, *a)
        got_dur.append(out.pred_dur)
        return out

    psyn._run = spy
    try:
        with _draws_zeroed(ms):
            want = jsyn.inference_batch(TEXTS, ref_s=refs, diffusion_steps=STEPS,
                                        embedding_scale=scale, speed=SPEED)
            got = psyn.inference_batch(TEXTS, ref_s=refs, diffusion_steps=STEPS,
                                       embedding_scale=scale, speed=SPEED)
    finally:
        psyn._run = run
    np.testing.assert_array_equal(got_dur[-1], phase_b_durations[-1])
    assert len({len(w) for w in got}) == 3  # mixed lengths
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert rel_err(g, w) < 1e-3
