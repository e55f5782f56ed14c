"""Port parity for the text side and the prosody predictor: TextEncoder,
PL-BERT, BertEncoder, ProsodyPredictor.encode_texts / duration / F0Ntrain
and AdainResBlk1d, with JAX weights converted by state_dict_from_jax.

Tolerance: 1e-4 of the output's peak in f32. Each module stacks a few
layers (convs, LSTMs over up to 16 steps, a one-layer transformer), each
reassociating sums differently in the two frameworks (~1e-6 per layer).
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_cfg, jax_models_and_params, nwc_to_ncw, port_models, rel_err, t

TOL = 1e-4
B, T = 2, 16
LENGTHS = np.asarray([16, 11], np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=1)
    return jcfg, models, params, port_models(jcfg, params)


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(2)
    tok = rng.integers(1, 178, (B, T)).astype(np.int32)
    tok[np.arange(T)[None, :] >= LENGTHS[:, None]] = 0
    return tok


def _apply(module, variables, *args, **kw):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args))


@torch.inference_mode()
def test_text_encoder_plbert_bert_encoder(setup, tokens):
    jcfg, models, params, port = setup
    tok_t, len_t = torch.as_tensor(tokens, dtype=torch.int64), torch.as_tensor(LENGTHS)

    want = _apply(models.text_encoder, params["text_encoder"], tokens, LENGTHS)
    got = port["text_encoder"](tok_t, len_t).numpy().transpose(0, 2, 1)
    assert rel_err(got, want) < TOL
    assert np.all(got[1, 11:] == 0)

    valid = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.int32)
    want_bert = _apply(models.bert, params["bert"], tokens, valid)
    got_bert = port["bert"](tok_t, torch.as_tensor(valid)).numpy()
    assert rel_err(got_bert, want_bert) < TOL

    want_d = _apply(models.bert_encoder, params["bert_encoder"], want_bert)
    got_d = port["bert_encoder"](t(want_bert)).numpy()
    assert rel_err(got_d, want_d) < TOL


@torch.inference_mode()
def test_predictor_methods(setup):
    jcfg, models, params, port = setup
    rng = np.random.default_rng(3)
    H, S = jcfg.model_params.hidden_dim, jcfg.model_params.style_dim
    d_en = rng.standard_normal((B, T, H)).astype(np.float32)
    s = rng.standard_normal((B, S)).astype(np.float32)
    pred, jp = port["predictor"], params["predictor"]
    len_t = torch.as_tensor(LENGTHS)

    want_d = _apply(models.predictor, jp, d_en, s, LENGTHS, method="encode_texts")
    got_d = pred.encode_texts(t(d_en), t(s), len_t).numpy()
    assert rel_err(got_d, want_d) < TOL

    want_dur = _apply(models.predictor, jp, want_d, LENGTHS, method="duration")
    got_dur = pred.duration(t(want_d), len_t).numpy()
    assert rel_err(got_dur, want_dur) < TOL

    n_frames = 10
    en = rng.standard_normal((B, n_frames, H + S)).astype(np.float32)
    want_f0, want_n = (np.asarray(a) for a in jax.jit(
        lambda v, x, st: models.predictor.apply(v, x, st, method="F0Ntrain"))(jp, en, s))
    got_f0, got_n = pred.F0Ntrain(nwc_to_ncw(en), t(s))
    assert got_f0.shape == (B, 2 * n_frames)
    assert rel_err(got_f0.numpy(), want_f0) < TOL
    assert rel_err(got_n.numpy(), want_n) < TOL
