"""Port parity for the modules that stage-2 training adds or changes, at tiny
widths, with the same numpy-seeded inputs and weights on both sides:
the duration, smooth-L1 and WavLM-stacking losses; the WavLM discriminator
and its weight conversion; the EDM training loss with the JAX draws handed
over; the differentiable soft alignment (values and gradient, and against
the reference's per-sample conv1d form); the prosody predictor's three
train-mode dropouts; the denoiser's embedding mask; the spectral-norm
per-call switch; the stage-2 optimizers; the LSTM's single bias.

Tolerances: 1e-5 relative for the losses, the WavLM discriminator (four
convs) and the EDM loss; the soft alignment 1e-5 of its peak and its
gradient 1e-4 (50 accumulated exp terms, a softmax); 1e-4 of the peak for
the denoiser and the predictor (as tests/test_torch_diffusion.py and
tests/test_torch_text_prosody.py). Dropout's rate within 3 sigma of the
binomial spread.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import styletts2_tpu_torch.convert as pc
from styletts2_tpu import convert as jconvert
from styletts2_tpu import losses as JL
from styletts2_tpu.models import layers as jl
from styletts2_tpu.models.diffusion import sampler as js
from styletts2_tpu.models.discriminators import WavLMDiscriminator as JaxWD
from styletts2_tpu.train.stage2 import soft_alignment as jax_soft_alignment
from styletts2_tpu_torch import losses as PL
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models import layers as pl
from styletts2_tpu_torch.models.diffusion import sampler as ps
from styletts2_tpu_torch.models.diffusion.denoiser import draw_embedding_mask
from styletts2_tpu_torch.models.discriminators import WavLMDiscriminator
from styletts2_tpu_torch.models.layers import BiLSTM
from styletts2_tpu_torch.train.stage2 import soft_alignment
from styletts2_tpu_torch.train.state import build_optimizers, step_modules
from torch_parity import _fill, jax_cfg, jax_models_and_params, port_models, rel_err, t

WD = dict(slm_hidden=32, slm_layers=3, initial_channel=8)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(21)


@pytest.fixture(scope="module")
def diffusion_setup():
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=22)
    return jcfg, models, params, port_models(jcfg, params)


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def test_stage2_losses(rng):
    B, T, D = 3, 9, 50
    logits = (2.0 * rng.standard_normal((B, T, D))).astype(np.float32)
    lengths = np.asarray([9, 6, 4], np.int32)
    dur = rng.integers(0, 12, (B, T)).astype(np.float32)
    pred_sum = rng.uniform(0, 12, (B, T)).astype(np.float32)
    for got, want in [
        (PL.duration_ce_loss(t(logits), t(dur), torch.as_tensor(lengths)),
         JL.duration_ce_loss(jnp.asarray(logits), jnp.asarray(dur), jnp.asarray(lengths))),
        (PL.duration_l1_loss(t(pred_sum), t(dur), torch.as_tensor(lengths)),
         JL.duration_l1_loss(jnp.asarray(pred_sum), jnp.asarray(dur), jnp.asarray(lengths))),
    ]:
        assert _rel(got, want) < 1e-5
    x, y = rng.standard_normal((2, 2, 40)).astype(np.float32) * 2
    assert _rel(PL.smooth_l1(t(x), t(y)), JL.smooth_l1(jnp.asarray(x), jnp.asarray(y))) < 1e-5
    states = [rng.standard_normal((2, 7, 5)).astype(np.float32) for _ in range(3)]
    got = PL.stack_wavlm_states([t(s) for s in states]).numpy()
    np.testing.assert_array_equal(got, np.asarray(JL.stack_wavlm_states(
        [jnp.asarray(s) for s in states])))
    # only the interior tokens 1 .. len - 2 count
    moved = pred_sum.copy()
    moved[:, 0] += 5.0
    moved[0, 8] += 5.0
    assert float(PL.duration_l1_loss(t(moved), t(dur), torch.as_tensor(lengths))) == pytest.approx(
        float(PL.duration_l1_loss(t(pred_sum), t(dur), torch.as_tensor(lengths))), rel=1e-6)


@pytest.fixture(scope="module")
def wd_setup(rng):
    x = rng.standard_normal((2, 11, WD["slm_hidden"] * WD["slm_layers"])).astype(np.float32)
    mod = JaxWD(**WD)
    shapes = jax.eval_shape(lambda k: mod.init(k, x), jax.random.PRNGKey(0))
    params = _fill(shapes["params"], rng)
    return mod, params, x


def test_wavlm_discriminator(wd_setup):
    mod, params, x = wd_setup
    want = np.asarray(mod.apply({"params": params}, x))
    sd = {}
    pc._MODULES["wd"]({"params": params}, sd)
    port = WavLMDiscriminator(**WD)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = port(t(x)).numpy()
    assert got.shape == want.shape == (2, 11)
    assert rel_err(got, want) < 1e-5


def test_wavlm_discriminator_convert_round_trip(wd_setup):
    """JAX params -> the port's `wd.*` state_dict (the reference names) ->
    the JAX package's own `convert_wd`: the same bits."""
    _, params, _ = wd_setup
    sd = {}
    pc._MODULES["wd"]({"params": params}, sd)
    assert set(sd) == {f"{n}.{p}" for n in ("pre", "convs.0", "convs.1", "convs.2", "conv_post")
                       for p in ("weight_v", "weight_g", "bias")}
    assert set(WavLMDiscriminator(**WD).state_dict()) == set(sd)
    back = jconvert.convert_wd({k: np.asarray(v) for k, v in sd.items()})["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_kdiffusion_loss_with_the_jax_draws(diffusion_setup, rng):
    jcfg, models, params, port = diffusion_setup
    B, T = 3, 10
    E, C = jcfg.plbert_params.hidden_size, 2 * jcfg.model_params.style_dim
    emb = rng.standard_normal((B, T, E)).astype(np.float32)
    x0 = (0.3 * rng.standard_normal((B, 1, C))).astype(np.float32)
    key, sigma_data = jax.random.PRNGKey(3), 0.27

    def j_net(x, c, **kw):
        return models.diffusion.apply(params["diffusion"], x, c, emb)

    want = js.kdiffusion_loss(j_net, jnp.asarray(x0), key, sigma_data, dist_mean=-3.0, dist_std=1.0)
    k_sigma, k_noise = jax.random.split(key)  # the draws kdiffusion_loss makes from `key`
    sigmas = np.exp(-3.0 + np.asarray(jax.random.normal(k_sigma, (B,))))
    noise = np.asarray(jax.random.normal(k_noise, x0.shape))
    x0_t = t(x0).requires_grad_(True)
    got = ps.kdiffusion_loss(lambda x, c: port["diffusion"](x, c, t(emb)), x0_t, sigma_data,
                             sigmas=t(sigmas), noise=t(noise))
    assert _rel(got.detach(), want) < 1e-5
    got.backward()  # the loss carries gradients
    assert x0_t.grad is not None and torch.isfinite(x0_t.grad).all()
    # without handed draws it draws from the generator: the same seed, the same loss
    gen_loss = [float(ps.kdiffusion_loss(lambda x, c: port["diffusion"](x, c, t(emb)), t(x0),
                                         sigma_data, generator=torch.Generator().manual_seed(5)))
                for _ in range(2)]
    assert gen_loss[0] == gen_loss[1] and np.isfinite(gen_loss[0])


def _reference_conv1d(logits, lengths, sig):
    """The reference's per-sample grouped conv1d (slmadv.py:57-85), as
    tests/test_stage2.py spells it out: (softmax outputs, totals)."""
    refs, ls = [], []
    for b in range(len(lengths)):
        org = torch.from_numpy(logits[b, : lengths[b], :])
        pred = torch.sigmoid(org)
        dur = pred.sum(axis=-1)
        l = int(torch.round(pred.sum()).item())
        tt = torch.arange(0, l).unsqueeze(0).expand((len(pred), l))
        loc = torch.cumsum(dur, dim=0) - dur / 2
        h = torch.exp(-0.5 * torch.square(tt - (l - loc.unsqueeze(-1))) / sig ** 2)
        out = F.conv1d(org.unsqueeze(0), h.unsqueeze(1), padding=h.shape[-1] - 1,
                       groups=int(lengths[b]))[..., :l]
        refs.append(F.softmax(out.squeeze(0), dim=0).numpy())
        ls.append(l)
    return refs, ls


def test_soft_alignment_against_jax_and_the_reference(rng):
    B, T, D, sig = 3, 7, 50, 1.5
    logits = (1.5 * rng.standard_normal((B, T, D)) - 1.0).astype(np.float32)
    lengths = np.asarray([7, 5, 2], np.int64)
    n_frames = 120
    cot = rng.standard_normal((B, T, n_frames)).astype(np.float32)

    def jax_obj(lg):
        attn, _ = jax_soft_alignment(lg, jnp.asarray(lengths), n_frames, sig)
        return jnp.sum(attn * cot)

    want_attn, want_total = jax_soft_alignment(jnp.asarray(logits), jnp.asarray(lengths),
                                               n_frames, sig)
    want_grad = np.asarray(jax.grad(jax_obj)(jnp.asarray(logits)))
    lg = t(logits).requires_grad_(True)
    attn, total = soft_alignment(lg, torch.as_tensor(lengths), n_frames, sig)
    (attn * t(cot)).sum().backward()
    np.testing.assert_array_equal(total.numpy(), np.asarray(want_total))
    assert rel_err(attn.detach(), want_attn) < 1e-5
    assert rel_err(lg.grad, want_grad) < 1e-4
    refs, ls = _reference_conv1d(logits, lengths, sig)
    attn = attn.detach()
    for b in range(B):
        assert int(total[b]) == ls[b] < n_frames
        np.testing.assert_allclose(attn[b, : lengths[b], : ls[b]].numpy(), refs[b], atol=2e-5)
        assert float(attn[b, :, ls[b]:].abs().max()) == 0.0  # frames past the total
        assert float(attn[b, lengths[b]:].abs().sum()) == 0.0  # invalid tokens


@pytest.fixture(scope="module")
def predictor_setup():
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=23)
    return jcfg, models, params, port_models(jcfg, params)["predictor"]


def test_predictor_dropout(predictor_setup, monkeypatch):
    """Eval mode equals the JAX predictor's deterministic forward; train mode
    runs the JAX package's three dropouts, each at its rate: 0.2 after each
    duration-encoder LSTM, 0.5 before the duration projection and 0.2
    before each conv of the F0 / N blocks."""
    jcfg, models, params, pred = predictor_setup
    rng = np.random.default_rng(24)
    B, T, L = 2, 16, 24
    H, S = jcfg.model_params.hidden_dim, jcfg.model_params.style_dim
    lengths = np.asarray([16, 11], np.int32)
    d_en = rng.standard_normal((B, T, H)).astype(np.float32)
    s = rng.standard_normal((B, S)).astype(np.float32)
    aln = np.zeros((B, T, L), np.float32)
    aln[:, np.minimum(np.arange(L) * T // L, 10), np.arange(L)] = 1.0
    want_dur, want_en = models.predictor.apply(params["predictor"], d_en, s, lengths, aln)
    want_f0, want_n = models.predictor.apply(params["predictor"], want_en, s, method="F0Ntrain")
    len_t = torch.as_tensor(lengths)
    with torch.no_grad():
        pred.eval()
        dur, en = pred(t(d_en), t(s), len_t, t(aln))
        f0, n = pred.F0Ntrain(en, t(s))
    assert rel_err(dur, want_dur) < 1e-4
    assert rel_err(en.numpy().transpose(0, 2, 1), want_en) < 1e-4
    assert rel_err(f0, want_f0) < 1e-4 and rel_err(n, want_n) < 1e-4

    calls = []
    dropout = F.dropout

    def spy(x, p=0.5, training=True, inplace=False):
        y = dropout(x, p, training, inplace)
        calls.append((p, training, x.detach(), y.detach()))
        return y

    monkeypatch.setattr(F, "dropout", spy)
    torch.manual_seed(0)
    with torch.no_grad():
        pred.train()
        d = pred.encode_texts(t(d_en), t(s), len_t)
        pred.duration(d, len_t)
        pred.F0Ntrain(en, t(s))
        pred.eval()
    n_layers = jcfg.model_params.n_layer
    assert [(c[0], c[1]) for c in calls] == (
        [(0.2, True)] * n_layers + [(0.5, True)] + [(0.2, True)] * 12)
    for p, _, x, y in calls:
        live = x != 0
        dropped = float(((y == 0) & live).sum()) / float(live.sum())
        sigma = math.sqrt(p * (1 - p) / float(live.sum()))
        assert abs(dropped - p) < 3 * sigma, (p, dropped)
        kept = (y != 0) & live
        torch.testing.assert_close(y[kept], x[kept] / (1 - p))
    calls.clear()
    with torch.no_grad():
        pred(t(d_en), t(s), len_t, t(aln))
        pred.F0Ntrain(en, t(s))
    assert all(not training for _, training, _, _ in calls)  # eval: no dropout


def test_denoiser_embedding_mask(diffusion_setup, rng, monkeypatch):
    """A forced mask swaps the marked items' PL-BERT embedding for the fixed
    one, as the JAX denoiser's train-mode Bernoulli draw does."""
    jcfg, models, params, port = diffusion_setup
    B, T = 3, 9
    E, C = jcfg.plbert_params.hidden_size, 2 * jcfg.model_params.style_dim
    emb = rng.standard_normal((B, T, E)).astype(np.float32)
    x = rng.standard_normal((B, 1, C)).astype(np.float32)
    sigma = np.asarray([0.5, 1.0, 2.0], np.float32)
    mask = np.asarray([True, False, True])
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask).reshape(shape))
    want = np.asarray(models.diffusion.apply(params["diffusion"], x, sigma, emb,
                                             embedding_mask_proba=0.1, train=True,
                                             rngs={"noise": jax.random.PRNGKey(0)}))
    with torch.no_grad():
        got = port["diffusion"](t(x), t(sigma), t(emb), embedding_mask=torch.as_tensor(mask))
        plain = port["diffusion"](t(x), t(sigma), t(emb))
    assert rel_err(got, want) < 1e-4
    assert float((got - plain)[1].abs().max()) == 0.0  # an unmasked item is untouched
    assert float((got - plain)[0].abs().max()) > 0.0
    draws = draw_embedding_mask(20000, 0.1, torch.Generator().manual_seed(0))
    assert draws.dtype == torch.bool and abs(float(draws.float().mean()) - 0.1) < 3 * math.sqrt(
        0.1 * 0.9 / 20000)


@pytest.mark.parametrize("cin,cout,k,stride,pad,groups,bias", [
    (1, 8, 3, 1, 1, 1, True),
    (6, 6, 3, 2, 1, 6, True),
])
def test_snconv2d_per_call_switch(rng, cin, cout, k, stride, pad, groups, bias):
    """update_stats=True: one power iteration, used at once (the JAX
    update_stats=True output and vectors) but stored only by
    commit_spectral_updates; False, the default: the stored vectors in
    either mode. (Stage 1 passes True in train mode and commits after its
    optimizer step: tests/test_torch_stage1.py.)"""
    x = rng.standard_normal((2, 11, 13, cin)).astype(np.float32)
    mod = jl.SNConv2d(cout, (k, k), stride=(stride, stride), padding=(pad, pad), groups=groups,
                      use_bias=bias)
    shapes = jax.eval_shape(lambda key: mod.init(key, x), jax.random.PRNGKey(0))
    variables = {c: _fill(v, rng) for c, v in shapes.items()}
    upd, mut = mod.apply(variables, x, update_stats=True, mutable=["spectral"])
    stale = mod.apply(variables, x, update_stats=False)
    sd = {}
    pc._snconv2d(variables["params"], variables["spectral"], sd, "m")
    after = {}
    pc._snconv2d(variables["params"], mut["spectral"], after, "m")
    port = pl.SNConv2d(cin, cout, k, stride, pad, groups, bias).train()
    port.load_state_dict({n[2:]: t(v) for n, v in sd.items()})
    u0, v0 = port.weight_u.clone(), port.weight_v.clone()
    xt = t(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = port(xt, update_stats=True)
        assert torch.equal(port.weight_u, u0) and torch.equal(port.weight_v, v0)  # pending
        got_stale = port(xt, update_stats=False)  # train mode, the stored vectors
        pl.commit_spectral_updates(port)
    assert rel_err(got.numpy().transpose(0, 2, 3, 1), upd) < 1e-5
    assert rel_err(got_stale.numpy().transpose(0, 2, 3, 1), stale) < 1e-5
    for name in ("weight_u", "weight_v"):
        assert rel_err(getattr(port, name), after[f"m.{name}"]) < 1e-5, name
    assert port.pending is None
    pl.commit_spectral_updates(port)  # nothing pending: a no-op
    assert rel_err(port.weight_u, after["m.weight_u"]) < 1e-5
    # the default, in train mode: the stored vectors, nothing pending
    port.load_state_dict({n[2:]: t(v) for n, v in sd.items()})
    with torch.no_grad():
        got_default = port(xt)
    assert torch.equal(got_default, got_stale) and port.pending is None
    assert torch.equal(port.weight_u, u0)


def test_stage2_optimizers():
    """Stage 2: bert at bert_lr, betas (0.9, 0.99), weight decay 0.01; the
    decoder and the style encoder at ft_lr; every other module as stage 1
    (lr, betas (0, 0.99), weight decay 1e-4), eps 1e-9 throughout; the
    frozen WavLM has none."""
    cfg = Config()
    op = cfg.optimizer_params
    keys = ("bert", "decoder", "style_encoder", "predictor", "diffusion", "wd", "wavlm")
    models = torch.nn.ModuleDict({k: torch.nn.Linear(2, 2) for k in keys})
    for stage2 in (False, True):
        opts = build_optimizers(cfg, models, stage2=stage2)
        assert set(opts) == set(keys) - {"wavlm"}
        for k, o in opts.items():
            (g,) = o.param_groups
            if stage2 and k == "bert":
                want = (op.bert_lr, (0.9, 0.99), 0.01)
            elif stage2 and k in ("decoder", "style_encoder"):
                want = (op.ft_lr, (0.0, 0.99), 1e-4)
            else:
                want = (op.lr, (0.0, 0.99), 1e-4)
            assert (g["lr"], tuple(g["betas"]), g["weight_decay"], g["eps"]) == want + (1e-9,), k


def test_lstm_single_bias_steps_like_the_jax_lstm():
    """The JAX LSTM has one bias; the port's bias_ih and bias_hh both get its
    gradient. A step moves bias_ih as the JAX bias and leaves bias_hh."""
    lstm = BiLSTM(4, 3)
    models = torch.nn.ModuleDict({"predictor": lstm})
    with torch.no_grad():
        lstm.bias_hh_l0.zero_()
        lstm.bias_hh_l0_reverse.zero_()
    opts = build_optimizers(Config(), models)
    lstm(torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(0))).sum().backward()
    assert torch.equal(lstm.bias_ih_l0.grad, lstm.bias_hh_l0.grad)
    before = {n: p.detach().clone() for n, p in lstm.named_parameters()}
    step_modules(models, opts, ("predictor",))
    for n, p in lstm.named_parameters():
        if n.startswith("bias_hh"):
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n
