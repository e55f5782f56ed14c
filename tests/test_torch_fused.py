"""The port's single-dispatch synthesis on the CPU against the JAX
Synthesizer's, at the tiny widths of tests/torch_parity.py: the whole-pipeline
program (`Synthesizer._fused`, the JAX `_make_fused`) for the single-speaker
iSTFTNet and the multispeaker HiFi-GAN configs, within its frame budget and
past it; `inference_fused` as that program's output cut on the host;
`phase_a="fused"` against the JAX `Synthesizer(phase_a="fused")` and the
port's staged path; and `BiLSTM.masked`, the LSTM branch those programs run,
against `pack_padded_sequence`.

Tolerances, those of test_torch_synth.py: the integer durations and the
frame totals equal; the style within 1e-4 of its peak; the waveform within
1e-3 of its peak. Random draws are zeroed on both sides, and so are the
chaotic source phase (iSTFTNet) and the harmonic sines (HiFi-GAN) as in
test_torch_synth.py and test_torch_multispeaker.py. The fused and the staged
phase A run the same modules on the same inputs, the LSTMs by another branch:
their waveforms agree within 1e-6 of the peak. `masked` equals packing
within 1e-6 (the same f32 recurrence, batched otherwise).
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

import styletts2_tpu.inference as jinf
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.inference import Synthesizer, _mix
from styletts2_tpu_torch.models.layers import BiLSTM
from styletts2_tpu_torch.text import encode_text
from torch_parity import (jax_cfg, jax_models_and_params, jax_ms_cfg, port_cfg, rel_err,
                          stable_har_phase, zero_noise, zero_sines)

TEXT = "ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt."
BUDGET = 200  # frames; these weights give 174 at speed 4, 290 at 2.5, ~700 at 1
STEPS = 3


SEEN = []  # the durations of the JAX alignments, newest last


@contextmanager
def jax_durations():
    """Record in SEEN the durations each JAX alignment is built from: a
    debug callback in the programs traced under it, which every later run
    of those programs calls."""
    orig = jinf.duration_to_alignment

    def spy(pred_dur, n_frames):
        jax.debug.callback(lambda d: SEEN.append(np.asarray(d)), pred_dur)
        return orig(pred_dur, n_frames)

    jinf.duration_to_alignment = spy
    try:
        yield
    finally:
        jinf.duration_to_alignment = orig


@contextmanager
def draws_zeroed(ms):
    with zero_noise(), (zero_sines() if ms else stable_har_phase()):
        yield


@pytest.fixture(scope="module", params=["ljspeech", "libritts"])
def pair(request):
    """(JAX Synthesizer, its params, the port's, the reference style or
    None, the CFG scale, whether multispeaker)."""
    ms = request.param == "libritts"
    jcfg = jax_ms_cfg() if ms else jax_cfg()
    _, params = jax_models_and_params(jcfg, seed=21 if ms else 8)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    ref_s = None
    if ms:
        ref_s = (0.5 * np.random.default_rng(10).standard_normal((1, 2 * psyn.style_dim))
                 ).astype(np.float32)
    return jinf.Synthesizer(jcfg, params=params), params, psyn, ref_s, 1.5 if ms else 1.0, ms


@pytest.fixture(scope="module")
def jax_fused(pair):
    """The JAX whole-pipeline program of `pair`, compiled once (params as
    an argument, as the JAX `inference_fused` calls it)."""
    jsyn, *_, scale, _ = pair
    return jsyn._make_fused(STEPS, scale, BUDGET)


@pytest.mark.parametrize("speed", [4.0, 1.0, 2.5])
def test_fused_program_matches_jax(pair, jax_fused, speed):
    """Durations max(round(duration / speed), 1), the total min(sum,
    budget) and the waveform equal JAX's, within the budget (speed 4) and
    past it (the alignment cut at the budget)."""
    _, params, psyn, ref_s, scale, ms = pair
    sd = psyn.style_dim
    noise = np.random.default_rng(9).standard_normal((1, 1, 2 * sd)).astype(np.float32)
    toks = encode_text(TEXT)
    L = len(toks)
    inputs = psyn._inputs(toks, ref_s, noise, _mix(0.3, 0.7, speed=speed), seed=0)
    T = inputs["tokens"].shape[1]
    tokens = np.zeros((1, T), np.int32)
    tokens[0, :L] = toks
    ref = np.zeros((1, 2 * sd), np.float32) if ref_s is None else ref_s
    SEEN.clear()
    with draws_zeroed(ms), jax_durations():
        want_wav, want_total = jax_fused(params, tokens, np.asarray([L], np.int32), noise,
                                         jax.random.PRNGKey(0), ref, 0.3, 0.7,
                                         jnp.asarray(speed, jnp.float32))
        with torch.inference_mode():
            wav, total, pred_dur = psyn._fused(**inputs, frame_budget=BUDGET, steps=STEPS,
                                               scale=scale, generator=torch.Generator())
    want_wav, want_total = np.asarray(want_wav), np.asarray(want_total)
    np.testing.assert_array_equal(pred_dur.numpy(), SEEN[-1])
    assert (int(pred_dur.sum()) > BUDGET) == (speed < 4.0)
    assert int(total[0]) == int(want_total[0]) == min(int(pred_dur.sum()), BUDGET)
    assert wav.shape == want_wav.shape == (1, BUDGET * 600)
    n = int(total[0]) * 600
    assert np.isfinite(wav.numpy()).all()
    assert rel_err(wav.numpy()[0, :n], want_wav[0, :n]) < 1e-3


def test_inference_fused_cuts_the_program(pair):
    """`inference_fused` is the program on its inputs (the starting noise
    from seed + 1, the other draws from seed), cut to total * 600 samples."""
    *_, psyn, ref_s, scale, ms = pair
    wav = psyn.inference_fused(TEXT, frame_budget=BUDGET, ref_s=ref_s, diffusion_steps=STEPS,
                               embedding_scale=scale, seed=3, speed=4.0)
    inputs = psyn._inputs(encode_text(TEXT), ref_s, None, _mix(0.3, 0.7, speed=4.0), seed=3)
    with torch.inference_mode():
        full, total, _ = psyn._fused(**inputs, frame_budget=BUDGET, steps=STEPS, scale=scale,
                                     generator=torch.Generator().manual_seed(3))
    assert len(wav) == int(total[0]) * 600 > 0
    np.testing.assert_array_equal(wav, full[0, : len(wav)].numpy())


def test_phase_a_fused_matches_jax_and_staged():
    """Synthesizer(phase_a="fused").synthesize against the JAX
    Synthesizer(phase_a="fused").inference (durations, style, waveform) and
    against the port's staged path; long-form carry-over included."""
    jcfg = jax_cfg()
    _, params = jax_models_and_params(jcfg, seed=8)
    sd_port = state_dict_from_jax(params, port_cfg(jcfg))
    fused = Synthesizer(port_cfg(jcfg), state_dict=sd_port, device="cpu", phase_a="fused")
    staged = Synthesizer(port_cfg(jcfg), state_dict=sd_port, device="cpu")
    jsyn = jinf.Synthesizer(jcfg, params=params, phase_a="fused")
    noise = np.random.default_rng(9).standard_normal(
        (1, 1, 2 * fused.style_dim)).astype(np.float32)
    SEEN.clear()
    with draws_zeroed(False), jax_durations():
        want_wav, want_s = jsyn.inference(TEXT, noise=noise, diffusion_steps=STEPS, speed=4.0)
        got = fused.synthesize(TEXT, noise=noise, diffusion_steps=STEPS, speed=4.0)
        base = staged.synthesize(TEXT, noise=noise, diffusion_steps=STEPS, speed=4.0)
        carried = [s.LFinference("hˈɛloʊ.", base.s_pred, diffusion_steps=STEPS, speed=4.0)
                   for s in (fused, staged)]
    L = len(got.pred_dur)
    np.testing.assert_array_equal(got.pred_dur, SEEN[-1][0, :L])
    assert rel_err(got.s_pred, want_s) < 1e-4
    assert got.wav.shape == want_wav.shape
    assert rel_err(got.wav, want_wav) < 1e-3
    np.testing.assert_array_equal(got.pred_dur, base.pred_dur)
    assert got.wav.shape == base.wav.shape and rel_err(got.wav, base.wav) < 1e-6
    assert rel_err(got.s_pred, base.s_pred) < 1e-6
    (w_f, s_f), (w_s, s_s) = carried
    assert w_f.shape == w_s.shape and rel_err(w_f, w_s) < 1e-6 and rel_err(s_f, s_s) < 1e-6
    with pytest.raises(ValueError, match="phase_a"):
        Synthesizer(port_cfg(jcfg), state_dict=sd_port, device="cpu", phase_a="one")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_bilstm_matches_packing(seed):
    """BiLSTM.masked (lengths on the device, no host sync) equals
    pack_padded_sequence on every step, padded steps 0, over random lengths
    1..T with T among them."""
    g = torch.Generator().manual_seed(seed)
    B, T, C, H = 6, 11, 9, 5
    lstm = BiLSTM(C, H).eval()
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    x = torch.randn(B, T, C, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[seed % B] = T
    lengths[(seed + 1) % B] = 1
    with torch.no_grad():
        got = lstm.masked(x, lengths)
        packed = pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
        want = pad_packed_sequence(torch.nn.LSTM.forward(lstm, packed)[0], batch_first=True,
                                   total_length=T)[0]
    assert got.shape == want.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
