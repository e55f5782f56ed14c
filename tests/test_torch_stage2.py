"""Stage-2 training of the port against the JAX trainer at tiny widths
(`styletts2_tpu/parallel/tiny.py`, a 2-layer WavLM), the same numpy-seeded
weights in both.

The JAX side is composed here from the JAX modules and losses as
`styletts2_tpu/train/stage2.py` composes them: the generator forward
(`gen_forward`, :204-385), whose loss terms give the generator loss before
diffusion, with it and in the joint phase (one jitted program per config:
the three phases' gradients are one batched backward pass); the
SLM-adversarial generator loss (:388-481) with the gradient post-processing
(:623-645); the WavLM discriminator's loss (:484-520). This file holds the
single-speaker (iSTFTNet) config's generator and the real steps;
tests/test_torch_stage2_ms.py the multispeaker config's generator
(HiFi-GAN, the reference styles feeding the denoiser) and
tests/test_torch_stage2_slm.py the SLM pass and `wd` of both. Most of each
file's time is tracing and compiling the JAX programs. Every weight and
input is an argument of the jitted program: weights closed over as
constants let XLA fold whole sub-networks at compile time, which doubled
it. Run eagerly, op by op, the generator's reference takes several times
longer than traced and compiled.
Each JAX loss and gradient is held against the port's loss and per-module
gradients, with the modules in eval mode (dropout off, no
box smoothing), every random draw zeroed (the EDM noise and sigma
exp(mean), the sampler's noise and churn, the clip starts), every embedding
masked on both sides, and the NSF source's chaotic parts zeroed
(tests/torch_parity.py). Then one real `train_step` of the port per phase:
the discriminators step before the adversarial term, which is taken
against the updated ones, then the generator, then the SLM pass and `wd`;
only the phase's modules move; the spectral-norm vectors advance by one
power iteration; sigma_data becomes the batch estimate from diff_epoch on.

Tolerances: losses 1e-4 relative; gradients 3e-2 in L2 per module, for the
reason given in tests/test_torch_stage1.py (a random-init network's
gradient is ill-conditioned in its deepest inputs).
"""

import copy
import dataclasses
import types
from contextlib import ExitStack, contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import styletts2_tpu_torch.convert as pc
from styletts2_tpu import losses as JL
from styletts2_tpu.models.build import _fi_spectral_align, build_training_models, init_training_params
from styletts2_tpu.models.diffusion.sampler import kdiffusion_loss, make_denoise_fn, sample_adpm2
from styletts2_tpu.models.wavlm import WavLM as JaxWavLM
from styletts2_tpu.models.wavlm import resample_24k_to_16k as jax_resample
from styletts2_tpu.ops.stft import log_norm, preprocess_mel
from styletts2_tpu.train.stage1 import aligner_pass, clip_slice
from styletts2_tpu.train.stage2 import soft_alignment
from styletts2_tpu_torch import losses as PL
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.data.meldataset import Batch
from styletts2_tpu_torch.models import build as pbuild
from styletts2_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                       MultiResSpecDiscriminator)
from styletts2_tpu_torch.models.wavlm import WavLM
from styletts2_tpu_torch.train import stage2 as pstage2
from styletts2_tpu_torch.train import state as pstate
from styletts2_tpu_torch.train.state import TrainState, build_optimizers
from styletts2_tpu.parallel.tiny import tiny_config
from torch_parity import _fill, port_cfg, stable_har_phase, zero_noise, zero_sines

WAVLM = dict(hidden=32, heads=2, intermediate=48, num_layers=2)
KEYS = pbuild.TRAIN_MODULES + pbuild.STAGE2_MODULES + ("wavlm",)
B, WAV_LEN, CLIP, NUM_STEPS, SIGMA_DATA = 2, 48000, 40, 3, 0.2
GRAD_TOL = 3e-2
PHASES = {"pre": (False, False), "diff": (True, False), "joint": (True, True)}


def _stats(tree, rng):
    if "mean" in tree:
        return {"mean": (0.1 * rng.standard_normal(tree["mean"].shape)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)}
    return {k: _stats(v, rng) for k, v in tree.items()}


def _config(ms):
    """`tiny_config()` (one resblock kernel of two dilations: XLA's compile
    time grows with the decoder's blocks) with the 2-layer WavLM's states;
    multispeaker with the LibriTTS HiFi-GAN rates when `ms`. SLM clips of 40
    frames from alignments of 120."""
    jcfg = tiny_config()
    jcfg.model_params.slm.hidden, jcfg.model_params.slm.nlayers = WAVLM["hidden"], 3
    if ms:
        dec = jcfg.model_params.decoder
        jcfg.model_params.multispeaker = True
        dec.type, dec.upsample_rates, dec.upsample_kernel_sizes = "hifigan", [10, 5, 3, 2], [
            20, 10, 6, 4]
    return jcfg


def _make_setup(ms):
    """The same numpy-seeded weights in both packages, WavLM of 2 layers in
    both (the port built with it: the full one's init takes seconds)."""
    jcfg = _config(ms)
    models = dataclasses.replace(build_training_models(jcfg), wavlm=JaxWavLM(**WAVLM))
    shapes = jax.eval_shape(lambda k: init_training_params(models, k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(31 + ms)
    variables = {}
    for k in KEYS:
        v = {"params": _fill(shapes[k]["params"], rng)}
        if "batch_stats" in shapes[k]:
            v["batch_stats"] = _stats(shapes[k]["batch_stats"], rng)
        if "spectral" in shapes[k]:
            v["spectral"] = _fill(shapes[k]["spectral"], rng)
            _fi_spectral_align(v["spectral"], v["params"])
        variables[k] = v
    # the Generator's head in f32's range / out of tanh's saturation (torch_parity)
    variables["decoder"]["params"]["generator"]["conv_post"]["g"] *= 0.01 if ms else 0.1
    pcfg = port_cfg(jcfg)
    with mock.patch.object(pbuild, "WavLM", lambda: WavLM(**WAVLM)):
        port = pbuild.build_training_models(pcfg, stage="second")
    port.load_state_dict(state_dict_from_jax(variables, pcfg, keys=KEYS))

    waves = (0.2 * rng.standard_normal((B, WAV_LEN))).astype(np.float32)
    tokens = rng.integers(1, 178, (B, 12)).astype(np.int32)
    batch = Batch(waves=waves, wave_lengths=np.full(B, WAV_LEN), tokens=tokens,
                  input_lengths=np.asarray([12, 9], np.int32),
                  ref_tokens=rng.integers(1, 178, (B, 10)).astype(np.int32),
                  ref_lengths=np.asarray([10, 7], np.int32),
                  mel_lengths=np.asarray([160, 140], np.int32), ref_waves=waves[::-1].copy(),
                  ref_wave_lengths=np.asarray([WAV_LEN, 40000]), speakers=np.zeros(B, np.int32))
    return types.SimpleNamespace(jcfg=jcfg, models=models, variables=variables, pcfg=pcfg,
                                 port=port, batch=batch, starts=np.asarray([3, 5]),
                                 st_starts=np.asarray([7, 1]), ms=ms)


_SETUPS = {}


def _setup(ms):
    if ms not in _SETUPS:
        _SETUPS[ms] = _make_setup(ms)
    return _SETUPS[ms]


@contextmanager
def _draws(ms):
    """Every draw zeroed on both sides, the NSF source's chaotic parts
    zeroed, and every denoiser embedding masked: the port's zeroed
    uniform falls below embedding_mask_proba, so the JAX Bernoulli is
    forced to match."""
    bern = jax.random.bernoulli
    jax.random.bernoulli = lambda key, p, shape: jnp.ones(shape, bool)
    try:
        with ExitStack() as stack:
            stack.enter_context(zero_noise())
            stack.enter_context(zero_sines() if ms else stable_har_phase())
            yield
    finally:
        jax.random.bernoulli = bern


def _jax_inputs(s):
    b = s.batch
    bd = {"waves": jnp.asarray(b.waves), "tokens": jnp.asarray(b.tokens),
          "input_lengths": jnp.asarray(b.input_lengths), "mel_lengths": jnp.asarray(b.mel_lengths),
          "ref_tokens": jnp.asarray(b.ref_tokens), "ref_lengths": jnp.asarray(b.ref_lengths),
          "ref_waves": jnp.asarray(b.ref_waves),
          "ref_mel_lengths": jnp.asarray(np.minimum(b.ref_wave_lengths // 300 + 1,
                                                    b.ref_waves.shape[1] // 300))}
    variables = jax.tree.map(jnp.asarray, s.variables)
    params = {k: v["params"] for k, v in variables.items()}
    extras = {k: {c: x for c, x in v.items() if c != "params"} for k, v in variables.items()}
    return bd, params, extras


def _jax_gen_terms(s, gp, params, extras, bd):
    """`gen_forward` (stage2.py:204-385) in eval mode, as its loss terms: the
    mel and WavLM-feature losses against both targets (`gp`, the
    reconstruction from the ground-truth prosody, before joint_epoch;
    `clip`, the recorded clip, from it), F0, energy, duration CE and L1,
    and the diffusion and sampled-style losses; and the spectral-norm
    vectors of the full-utterance passes."""
    models, cfg, ms = s.models, s.jcfg, s.ms
    dist = cfg.model_params.diffusion.dist
    p = dict(params, **gp)
    sg = jax.lax.stop_gradient
    key = jax.random.PRNGKey(0)

    def mv(k):
        return {"params": p[k], **extras.get(k, {})}

    mels = preprocess_mel(bd["waves"])
    mels = mels[:, :, : (mels.shape[-1] // 2) * 2]
    _, _, _, mono = aligner_pass(models, {"text_aligner": {"params": sg(p["text_aligner"])}}, mels,
                                 bd["mel_lengths"], bd["tokens"], bd["input_lengths"], key,
                                 train=False)
    t_en = sg(models.text_encoder.apply({"params": sg(p["text_encoder"])}, bd["tokens"],
                                        bd["input_lengths"]))
    asr = jnp.einsum("btc,btl->blc", t_en, mono)
    d_gt = mono.sum(axis=-1)
    s_dur_full, pe_mut = models.predictor_encoder.apply(
        mv("predictor_encoder"), mels, lengths=bd["mel_lengths"], update_stats=True,
        mutable=["spectral"])
    gs_full, se_mut = models.style_encoder.apply(
        mv("style_encoder"), mels, lengths=bd["mel_lengths"], update_stats=True,
        mutable=["spectral"])
    s_trg = sg(jnp.concatenate([gs_full, s_dur_full], axis=-1))
    valid = (jnp.arange(bd["tokens"].shape[1])[None, :] < bd["input_lengths"][:, None])
    bert_dur = models.bert.apply({"params": p["bert"]}, bd["tokens"], valid.astype(jnp.int32))
    d_en = models.bert_encoder.apply({"params": p["bert_encoder"]}, bert_dur)
    feats = None
    if ms:
        ref_mels = preprocess_mel(bd["ref_waves"])
        feats = sg(jnp.concatenate([
            models.style_encoder.apply(mv("style_encoder"), ref_mels,
                                       lengths=bd["ref_mel_lengths"]),
            models.predictor_encoder.apply(mv("predictor_encoder"), ref_mels,
                                           lengths=bd["ref_mel_lengths"])], axis=-1))

    def net_apply(x, c_noise, train=False, **kw):
        return models.diffusion.apply({"params": p["diffusion"]}, x, c_noise, bert_dur,
                                      features=feats, embedding_mask_proba=0.1, train=train,
                                      rngs={"noise": key})

    terms = {"diff": kdiffusion_loss(lambda x, c, **kw: net_apply(x, c, train=True),
                                     s_trg[:, None, :], key, SIGMA_DATA, dist_mean=dist.mean,
                                     dist_std=dist.std)}
    noise = jax.random.normal(key, s_trg[:, None, :].shape)
    s_preds = sample_adpm2(make_denoise_fn(net_apply, SIGMA_DATA), noise, key,
                           num_steps=NUM_STEPS)[:, 0]
    terms["sty"] = jnp.mean(jnp.abs(s_preds - sg(s_trg)))
    dur_logits, p_seq = models.predictor.apply({"params": p["predictor"]}, d_en, s_dur_full,
                                               bd["input_lengths"], mono)
    starts, st_starts = jnp.asarray(s.starts), jnp.asarray(s.st_starts)
    en = clip_slice(asr, starts, CLIP)
    p_en = clip_slice(p_seq, starts, CLIP)
    gt = clip_slice(mels, starts * 2, 2 * CLIP, axis=2)
    st = clip_slice(mels, st_starts * 2, 2 * CLIP, axis=2)
    wav_clip = clip_slice(bd["waves"], starts * 600, CLIP * 600)
    style_in = st if ms else gt
    s_dur_clip = models.predictor_encoder.apply(mv("predictor_encoder"), style_in)
    s_clip = models.style_encoder.apply(mv("style_encoder"), style_in)
    F0_real = sg(models.pitch_extractor.apply(mv("pitch_extractor"), gt)[0])
    N_real = sg(log_norm(gt))
    y_rec_gt_pred = sg(models.decoder.apply({"params": sg(p["decoder"])}, en, F0_real, N_real,
                                            sg(s_clip), False, rngs={"noise": key}))
    F0_fake, N_fake = models.predictor.apply({"params": p["predictor"]}, p_en, s_dur_clip,
                                             method="F0Ntrain")
    y_rec = models.decoder.apply({"params": p["decoder"]}, en, F0_fake, N_fake, s_clip, False,
                                 rngs={"noise": key})
    wl = {"params": sg(params["wavlm"])}
    rec_states = models.wavlm.apply(wl, jax_resample(y_rec))
    for name, wav_tgt in (("gp", y_rec_gt_pred), ("clip", wav_clip)):
        terms[f"mel_{name}"] = JL.multires_stft_loss(y_rec, wav_tgt)
        real_states = [sg(h) for h in models.wavlm.apply(wl, jax_resample(sg(wav_tgt)))]
        terms[f"slm_{name}"] = JL.wavlm_feature_loss(real_states, rec_states)
    terms.update(F0=JL.smooth_l1(F0_real, F0_fake) / 10.0, norm=JL.smooth_l1(N_real, N_fake),
                 ce=JL.duration_ce_loss(dur_logits, d_gt, bd["input_lengths"]),
                 dur=JL.duration_l1_loss(jax.nn.sigmoid(dur_logits).sum(-1), d_gt,
                                         bd["input_lengths"]))
    return terms, {"predictor_encoder": pe_mut, "style_encoder": se_mut}


def _phase_metrics(lp, terms, diff_on, joint_on):
    """A phase's metrics as `gen_forward` reports them, g_loss included."""
    tgt = "clip" if joint_on else "gp"
    m = {"mel": terms[f"mel_{tgt}"], "slm": terms[f"slm_{tgt}"],
         **{k: terms[k] for k in ("F0", "norm", "ce", "dur")}}
    if diff_on:
        m.update(diff=terms["diff"], sty=terms["sty"])
    m["g_loss"] = (lp.lambda_mel * m["mel"] + lp.lambda_F0 * m["F0"] + lp.lambda_ce * m["ce"]
                   + lp.lambda_norm * m["norm"] + lp.lambda_dur * m["dur"]
                   + lp.lambda_slm * m["slm"]
                   + (lp.lambda_sty * m["sty"] + lp.lambda_diff * m["diff"] if diff_on else 0.0))
    return m


_REFERENCE = {}


def _jax_reference(s):
    """The JAX generator loss of every phase and its gradient over the joint
    phase's modules (a superset of the others'), from one jitted program:
    (params, extras, {phase: metrics}, {phase: grads}, spectral vectors)."""
    if s.ms in _REFERENCE:
        return _REFERENCE[s.ms]
    bd, params, extras = _jax_inputs(s)
    lp = s.jcfg.loss_params
    keys = _trainer(s).gen_keys(True, True)

    def losses(gp, params, extras, bd):  # all arguments: XLA folds no weights as constants
        terms, sn = _jax_gen_terms(s, gp, params, extras, bd)
        return jnp.stack([_phase_metrics(lp, terms, *PHASES[ph])["g_loss"] for ph in PHASES]), (
            terms, sn)

    with _draws(s.ms):
        jac, (terms, sn) = jax.jit(jax.jacrev(losses, has_aux=True))(
            {k: params[k] for k in keys}, params, extras, bd)
    # on the host: each eager op on a JAX array compiles a program per shape
    jac, terms, sn = jax.tree.map(np.asarray, (jac, terms, sn))
    metrics = {ph: _phase_metrics(lp, terms, *PHASES[ph]) for ph in PHASES}
    grads = {ph: jax.tree.map(lambda g, i=i: g[i], jac) for i, ph in enumerate(PHASES)}
    _REFERENCE[s.ms] = (params, extras, metrics, grads, sn)
    return _REFERENCE[s.ms]


def _port_grads(port, key):
    """The module's gradients, zeros where none arrived; LSTMs' bias_hh left
    out (the JAX LSTMs have one bias: bias_ih's gradient)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in port[key].named_parameters() if "bias_hh" not in n}


def _assert_grads(port, grads, extras, keys):
    for key in keys:
        want = {}
        pc._MODULES[key](dict(extras[key], params=grads[key]), want)
        have = _port_grads(port, key)
        assert set(have) <= set(want), key
        got = np.concatenate([have[n].numpy().ravel() for n in sorted(have)])
        ref = np.concatenate([np.asarray(want[n]).ravel() for n in sorted(have)])
        norm = np.linalg.norm(ref)
        assert norm > 0, key
        assert np.linalg.norm(got - ref) < GRAD_TOL * norm, (key, np.linalg.norm(got - ref) / norm)


def _assert_losses(got, want):
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert abs(float(got[name]) - float(v)) <= 1e-4 * abs(float(v)), (name, got[name], v)


def _trainer(s, finetune=False):
    state = TrainState(s.port, {}, sigma_data=SIGMA_DATA)
    return pstage2.Stage2Trainer(s.pcfg, state, "cpu", finetune=finetune)


def _check_generator(ms, phase):
    """The port's generator forward and backward in `phase` against the JAX
    reference."""
    s = _setup(ms)
    diff_on, joint_on = PHASES[phase]
    params, extras, metrics, grads, sn = _jax_reference(s)
    trainer = _trainer(s)
    keys = trainer.gen_keys(diff_on, joint_on)
    with _draws(ms):
        trainer._modes(False, keys)
        for mod in s.port.values():
            mod.zero_grad(set_to_none=True)
        t = trainer._tensors(s.batch)
        g_loss, _, got, aux = trainer.generator_forward(
            t, s.starts, s.st_starts, CLIP, diff_on, joint_on, NUM_STEPS, SIGMA_DATA, train=False)
        g_loss.backward()
    _assert_losses({k: v.detach() for k, v in got.items()}, metrics[phase])
    _assert_grads(s.port, grads[phase], extras, keys)
    for key in set(s.port) - set(keys):  # nothing else gets a gradient
        assert all(p.grad is None for p in s.port[key].parameters()), key
    # the full-utterance passes' power iterations wait for the commit
    for key in pstage2.STYLE_KEYS:
        stem = s.port[key].shared[0]
        np.testing.assert_array_equal(stem.weight_u.numpy(),
                                      np.asarray(s.variables[key]["spectral"]["stem"]["u"]))
        np.testing.assert_allclose(stem.pending[0].numpy(),
                                   np.asarray(sn[key]["spectral"]["stem"]["u"]), rtol=1e-5,
                                   atol=1e-6)
        for mod in s.port[key].modules():
            mod.pending = None
    assert aux["y_rec_gt_pred"].shape == (B, CLIP * 600)


@pytest.mark.parametrize("phase", list(PHASES))
def test_generator_loss_and_grads_match_jax(phase):
    _check_generator(False, phase)


def _jax_slm(s, slm_params, params, bd, aux, use_ind):
    """`slm_gen_loss_fn` (stage2.py:388-481), eval mode."""
    models, cfg = s.models, s.jcfg
    sa = cfg.slmadv_params
    p = dict(params, **slm_params)
    sg = jax.lax.stop_gradient
    key = jax.random.PRNGKey(0)
    slm_clip, slm_frames = sa.min_len // 2, max(sa.max_len, 2 * (sa.min_len // 2) + 40)
    K = max(2, int(B * sa.batch_percentage))
    ref_tokens, ref_lengths = bd["ref_tokens"][:K], bd["ref_lengths"][:K]
    valid = (jnp.arange(ref_tokens.shape[1])[None, :] < ref_lengths[:, None]).astype(jnp.int32)
    bert_dur = models.bert.apply({"params": p["bert"]}, ref_tokens, valid)
    d_en = models.bert_encoder.apply({"params": p["bert_encoder"]}, bert_dur)
    s_trg = aux["s_trg"][:K]

    def net_apply(x, c_noise, **kw):
        return models.diffusion.apply({"params": p["diffusion"]}, x, c_noise, bert_dur,
                                      features=aux.get("ref_feats"), embedding_mask_proba=0.1,
                                      train=True, rngs={"noise": key})

    noise = jax.random.normal(key, s_trg[:, None, :].shape)
    s_sampled = sample_adpm2(make_denoise_fn(net_apply, SIGMA_DATA), noise, key,
                             num_steps=NUM_STEPS)[:, 0]
    s_preds = jnp.where(use_ind > 0, s_trg, s_sampled)
    sdim = cfg.model_params.style_dim
    s_dur, s_ac = s_preds[:, sdim:], s_preds[:, :sdim]
    d_only = models.predictor.apply({"params": p["predictor"]}, d_en, s_dur, ref_lengths,
                                    method="encode_texts")
    dur_logits = models.predictor.apply({"params": p["predictor"]}, d_only, ref_lengths,
                                        method="duration")
    attn, total = soft_alignment(dur_logits, ref_lengths, slm_frames, sig=sa.sig)
    t_en = sg(models.text_encoder.apply({"params": sg(params["text_encoder"])}, ref_tokens,
                                        ref_lengths))
    asr_pred = jnp.einsum("btc,btf->bfc", t_en, attn)
    _, p_pred = models.predictor.apply({"params": p["predictor"]}, d_en, s_dur, ref_lengths, attn)
    gt_half = bd["mel_lengths"][:K] // 2
    valid_b = (total > slm_clip) & (gt_half > slm_clip)
    max_start = jnp.maximum(jnp.minimum(total, slm_frames) - slm_clip, 1)
    starts = (jax.random.uniform(key, (K,)) * max_start).astype(jnp.int32)
    en = clip_slice(asr_pred, starts, slm_clip)
    p_en = clip_slice(p_pred, starts, slm_clip)
    F0_fake, N_fake = models.predictor.apply({"params": p["predictor"]}, p_en, s_dur,
                                             method="F0Ntrain")
    y_pred = models.decoder.apply({"params": sg(params["decoder"])}, en, F0_fake, N_fake, s_ac,
                                  False, rngs={"noise": key})
    states = models.wavlm.apply({"params": sg(params["wavlm"])}, jax_resample(y_pred))
    d_g = models.wd.apply({"params": sg(params["wd"])}, JL.stack_wavlm_states(states))
    w = valid_b.astype(jnp.float32)[:, None]
    gen_loss = jnp.sum(((1.0 - d_g) ** 2) * w) / jnp.maximum(jnp.sum(w) * d_g.shape[1], 1.0)
    return gen_loss, valid_b


def _jax_post_process(grads, sa):
    """The SLM gradients' post-processing, stage2.py:623-642."""
    pred_norm = optax.global_norm(grads["predictor"])
    scale_all = jnp.where(pred_norm > sa.thresh, 1.0 / jnp.maximum(pred_norm, 1e-8), 1.0)
    grads = jax.tree.map(lambda g: g * scale_all, grads)
    grads["predictor"] = dict(grads["predictor"])
    for k in ("duration_proj", "lstm"):
        grads["predictor"][k] = jax.tree.map(lambda g: g * sa.scale, grads["predictor"][k])
    grads["diffusion"] = jax.tree.map(lambda g: g * sa.scale, grads["diffusion"])
    return grads, pred_norm


def _jax_wd_loss(s, wd_p, params, jaux, y_pred, valid_b):
    """`slm_d_loss_fn` (stage2.py:484-520) with use_rec = 1: the real clips
    are the reconstructions from the ground-truth prosody, and the
    regulariser is on."""
    sa = s.jcfg.slmadv_params
    sg = jax.lax.stop_gradient
    wl = {"params": sg(params["wavlm"])}
    K = y_pred.shape[0]

    def wd_of(x):
        st = s.models.wavlm.apply(wl, jax_resample(sg(x)))
        return s.models.wd.apply({"params": wd_p}, JL.stack_wavlm_states([sg(h) for h in st]))

    need = (sa.min_len // 2) * 600
    rec = jaux["y_rec_gt_pred"][:K]
    real = jnp.pad(rec, ((0, 0), (0, max(need - rec.shape[1], 0))))[:, :need]
    d_r, d_g = wd_of(real), wd_of(y_pred)
    w = valid_b.astype(jnp.float32)[:, None]
    loss = (jnp.sum(((1.0 - d_r) ** 2) * w) + jnp.sum((d_g ** 2) * w)) / jnp.maximum(
        jnp.sum(w) * d_r.shape[1], 1.0)
    return loss + jnp.mean(jnp.abs(wd_of(jaux["y_rec_gt"]) - wd_of(jaux["y_rec_gt_pred"])))


def _check_slm(ms):
    """The SLM generator loss and its post-processed gradients, then the
    WavLM discriminator's loss with the reconstruction regulariser and its
    gradient, from the same aux and y_pred (the port's, handed to JAX; both
    JAX losses in one jitted program)."""
    s = _setup(ms)
    sa = s.jcfg.slmadv_params
    trainer = _trainer(s)
    bd, params, extras = _jax_inputs(s)
    with _draws(ms):
        with torch.no_grad():
            trainer._modes(False)
            t = trainer._tensors(s.batch)
            _, _, _, aux = trainer.generator_forward(t, s.starts, s.st_starts, CLIP, True, True,
                                                     NUM_STEPS, SIGMA_DATA, train=False)
        for key in pstage2.STYLE_KEYS:
            for mod in s.port[key].modules():
                mod.pending = None
        trainer._modes(False, pstage2.SLM_KEYS)
        for mod in s.port.values():
            mod.zero_grad(set_to_none=True)
        got, y_pred, valid = trainer.slm_generator_loss(t, aux, NUM_STEPS, False, SIGMA_DATA)
        got.backward()
        trainer.scale_slm_grads()
        y = y_pred.detach()
        trainer._modes(False, ("wd",))
        got_d = trainer.slm_discriminator_loss(t, y, aux, valid, True)
        got_d.backward()
    jaux = {"s_trg": aux["s_trg"].numpy(), "y_rec_gt": aux["y_rec_gt"].numpy(),
            "y_rec_gt_pred": aux["y_rec_gt_pred"].numpy()}
    if ms:
        jaux["ref_feats"] = aux["feats"].numpy()

    def both(slm_params, wd_params, jaux, y_pred, params, bd):  # no weights as constants
        (loss, valid_b), grads = jax.value_and_grad(
            lambda sp: _jax_slm(s, sp, params, bd, jaux, jnp.asarray(0)), has_aux=True)(slm_params)
        grads, pred_norm = _jax_post_process(grads, sa)
        d_loss, wd_grads = jax.value_and_grad(
            lambda wp: _jax_wd_loss(s, wp, params, jaux, y_pred, valid_b))(wd_params)
        return loss, valid_b, grads, pred_norm, d_loss, wd_grads

    with _draws(ms):
        want, valid_b, grads, pred_norm, want_d, wd_grads = jax.tree.map(np.asarray, jax.jit(both)(
            {k: params[k] for k in pstage2.SLM_KEYS}, params["wd"], jaux, y.numpy(), params, bd))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_b))
    assert bool(valid.all())
    assert abs(float(got.detach()) - float(want)) <= 1e-4 * abs(float(want))
    assert float(pred_norm) > 0
    _assert_grads(s.port, grads, extras, pstage2.SLM_KEYS)
    assert abs(float(got_d.detach()) - float(want_d)) <= 1e-4 * abs(float(want_d))
    _assert_grads(s.port, {"wd": wd_grads}, extras, ("wd",))


def _small_discriminators(port):
    """One period and one resolution: the step's order does not depend on
    the discriminators' size, and the full ones take most of a CPU step."""
    port["mpd"] = MultiPeriodDiscriminator(periods=(3,))
    port["msd"] = MultiResSpecDiscriminator(fft_sizes=(512,), hop_sizes=(50,), win_lengths=(240,))
    for k in ("mpd", "msd"):
        pbuild.init_discriminator_(port[k], torch.Generator().manual_seed(1))


@pytest.mark.parametrize("phase", list(PHASES))
def test_train_step_order_and_updates(phase):
    s = _setup(False)
    diff_on, joint_on = PHASES[phase]
    port = copy.deepcopy(s.port)
    _small_discriminators(port)
    cfg = copy.deepcopy(s.pcfg)
    cfg.loss_params.diff_epoch, cfg.loss_params.joint_epoch = 1, 2
    cfg.slmadv_params.iter = 1  # wd steps every step
    epoch = {"pre": 0, "diff": 1, "joint": 2}[phase]
    state = TrainState(port, build_optimizers(cfg, port, stage2=True), sigma_data=SIGMA_DATA)
    trainer = pstage2.Stage2Trainer(cfg, state, "cpu")
    log, seen = [], {}
    step_modules, forward, slm = pstate.step_modules, trainer.generator_forward, \
        trainer.slm_generator_loss

    def spy_step(models, opts, keys):
        log.append(tuple(keys))
        step_modules(models, opts, keys)

    def spy_forward(*a, **k):
        out = forward(*a, **k)
        seen.update(y=out[1].detach(), aux=out[3])
        return out

    def spy_slm(*a, **k):
        log.append("slm")
        seen["slm_params"] = {n: p.detach().clone() for n, p in port["predictor"].named_parameters()}
        return slm(*a, **k)

    trainer.generator_forward, trainer.slm_generator_loss = spy_forward, spy_slm
    before = {k: {n: p.detach().clone() for n, p in m.state_dict().items()} for k, m in port.items()}
    pstage2.step_modules = spy_step
    try:
        torch.manual_seed(0)
        metrics = trainer.train_step(s.batch, epoch, 0, np.random.default_rng(2))
    finally:
        pstage2.step_modules = step_modules
    assert state.step == 1 and all(np.isfinite(v) for v in metrics.values()), metrics
    g_keys = trainer.gen_keys(diff_on, joint_on)
    want_log = ([pstage2.D_KEYS] if diff_on else []) + [g_keys]
    if joint_on:
        want_log += ["slm", pstage2.SLM_KEYS, ("wd",)]
    assert log == want_log
    assert ("d_loss" in metrics) == diff_on and ("slm_gen" in metrics) == joint_on
    if joint_on:
        assert metrics["slm_valid_frac"] > 0 and metrics["slm_d"] > 0
        # the SLM pass saw the generator step's weights
        after_g = {n: p for n, p in seen["slm_params"].items()}
        assert any(not torch.equal(p, before["predictor"][n]) for n, p in after_g.items())
    if diff_on:  # the adversarial term against the updated discriminators
        y, w = seen["y"], seen["aux"]["wav_tgt"]
        with torch.no_grad():
            now = float(PL.generator_adv_loss(port["mpd"](w, y), port["msd"](w, y)))
            old = {k: copy.deepcopy(port[k]) for k in ("mpd", "msd")}
            for k in old:
                old[k].load_state_dict(before[k])
            stale = float(PL.generator_adv_loss(old["mpd"](w, y), old["msd"](w, y)))
        assert metrics["gen"] == pytest.approx(now, rel=1e-5)
        assert abs(stale - now) > 1e-4 * abs(now)
    stepped = set(g_keys) | (set(pstage2.D_KEYS) if diff_on else set()) | (
        set(pstage2.SLM_KEYS) | {"wd"} if joint_on else set())
    for k, m in port.items():
        moved = [n for n, p in m.named_parameters() if not torch.equal(p, before[k][n])]
        assert bool(moved) == (k in stepped), (k, moved[:3])
    # the spectral-norm vectors: one power iteration from the step's start
    for key in pstage2.STYLE_KEYS:
        mod = port[key].shared[0]
        w_mat = before[key]["shared.0.weight_orig"].reshape(mod.weight_orig.shape[0], -1)
        v = w_mat.T @ before[key]["shared.0.weight_u"]
        v = v / (v.norm() + 1e-12)
        u = w_mat @ v
        torch.testing.assert_close(mod.weight_u, u / (u.norm() + 1e-12), rtol=1e-5, atol=1e-6)
        assert mod.pending is None
    want_sigma = float(seen["aux"]["s_trg"].std(dim=-1, unbiased=False).mean()) if diff_on \
        else SIGMA_DATA
    assert state.sigma_data == pytest.approx(want_sigma, rel=1e-6)
