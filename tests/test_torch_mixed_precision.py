"""bf16 mixed-precision training of the port (`train/mp.py`,
`mixed_precision: bf16`) on the CPU, on tests/test_torch_stage1.py's tiny
modules and batch.

- The cast helpers do nothing when disabled, and the bf16 module set is the
  JAX package's.
- The bf16 generator losses of a TMA step (the style encoder, decoder,
  WavLM and discriminators in bf16) match the JAX trainer's with mp=True.
  JAX casts only under train=True (`stage1.py:132`), so its train-mode
  draws are turned off instead: the aligner and text encoder in eval mode,
  the style encoder's stored spectral-norm vectors, the decoder without its
  box smoothing, every random draw and the source's STFT phase zeroed; the
  port runs in eval mode with the bf16 casts on. The JAX program is
  compiled with XLA's excess precision off, so that it rounds every bf16
  op as eager PyTorch does. Four readings per loss, relative (measured
  here: mel / slm / gen): port bf16 vs JAX bf16 1.4e-4 / 1.8e-3 / 8.8e-3,
  held to JAX_TOL; port f32 vs JAX bf16 (the control) 2.2e-4 / 8.8e-4 /
  6.6e-3. The two bf16 programs round in other places (JAX adds a conv's
  bias after rounding its output, the port inside it; the port normalises
  the discriminators' weight norm in f32 where JAX does it in bf16), so
  the first is not below the control. What tells bf16 from f32 is each
  side's bf16 effect, bf16 vs f32 on the same weights: the port's 3.6e-4
  / 9.0e-4 / 2.2e-3 against JAX's 2.2e-4 / 8.8e-4 / 6.6e-3, held within a
  factor EFFECT_RATIO of JAX's and to at least BF16_SEEN times the f32
  parity (5.5e-7 / 5.8e-6 / 2.3e-6); an f32 run has no effect and fails.
  The aligner's losses (s2s, mono) have none on either side.
- A bf16 TMA `train_step` tracks the port's f32 step from the same weights
  and draws within 0.15 relative on every logged loss (the JAX package's
  `tests/test_mixed_precision.py` bound; measured here: <= 1.2e-3), and
  the masters and the Adam moments stay f32.
- Validation runs f32 under bf16, as the JAX trainer's does: equal to the
  f32 trainer's.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu import losses as JL
from styletts2_tpu.models.wavlm import WavLM as JaxWavLM
from styletts2_tpu.models.wavlm import resample_24k_to_16k as jax_resample
from styletts2_tpu.train import mp as jax_mp
from styletts2_tpu.train.stage1 import Stage1Trainer as JaxStage1
from styletts2_tpu.train.stage1 import s2s_ce_loss as jax_s2s_ce_loss
from styletts2_tpu_torch import losses as PL
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                       MultiResSpecDiscriminator, init_discriminator_)
from styletts2_tpu_torch.models.wavlm import WavLM
from styletts2_tpu_torch.train import mp
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train.state import TrainState, build_optimizers
from test_torch_stage1 import CLIP, _batch
from test_torch_stage1 import setup as stage1_setup  # noqa: F401 (a fixture)
from torch_parity import _fill, stable_har_phase, zero_noise

# 3 channels per positional-conv group: PyTorch's CPU bf16 grouped
# convolution returns wrong sums at 2, 4 or 8 channels per group with that
# conv's kernel of 128 (test_torch_stage1.py's hidden 32 has 2)
WAVLM = dict(hidden=48, heads=2, intermediate=48, num_layers=2)
JAX_TOL = 2e-2
BF16_SEEN = 20  # a bf16 loss moves from f32 by this many times f32 parity at least
EFFECT_RATIO = 4  # the port's bf16 effect on a loss against the JAX trainer's
STEP_TOL = 0.15
LOGGED = ("g_loss", "mel", "s2s", "mono", "gen", "slm", "d_loss")


@pytest.fixture(scope="module")
def setup(stage1_setup):  # noqa: F811
    """tests/test_torch_stage1.py's modules and batch, with a WavLM of WAVLM."""
    jcfg, models, variables, pcfg, port, batch, starts = stage1_setup
    models = dataclasses.replace(models, wavlm=JaxWavLM(**WAVLM))
    shapes = jax.eval_shape(lambda k: models.wavlm.init(k, jnp.zeros((1, 3200))),
                            jax.random.PRNGKey(0))
    variables = dict(variables, wavlm={"params": _fill(shapes["params"],
                                                       np.random.default_rng(12))})
    port = copy.deepcopy(port)
    port["wavlm"] = WavLM(**WAVLM)
    port["wavlm"].load_state_dict({k.split(".", 1)[1]: v for k, v in state_dict_from_jax(
        {"wavlm": variables["wavlm"]}, pcfg, keys=("wavlm",)).items()})
    return jcfg, models, variables, pcfg, port, batch, starts


def _bf16(pcfg):
    return dataclasses.replace(pcfg, mixed_precision="bf16")


def test_cast_helpers_do_nothing_when_disabled():
    x = torch.randn(2, 3)
    assert mp.cast_in(x, False) is x
    tokens = torch.arange(3)
    assert mp.cast_in(tokens, True) is tokens and mp.cast_in(x, True).dtype == torch.bfloat16
    models = torch.nn.ModuleDict({"decoder": torch.nn.Linear(3, 4), "bert": torch.nn.Linear(3, 4)})
    assert torch.equal(mp.run(models, "decoder", False, x), models["decoder"](x))
    assert mp.run(models, "bert", True, x).dtype == torch.float32  # not a bf16 module
    y = mp.run(models, "decoder", True, x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, torch.nn.functional.linear(
        x.bfloat16(), models["decoder"].weight.bfloat16(), models["decoder"].bias.bfloat16()))
    y.float().sum().backward()  # the cast is differentiable: f32 gradients on the f32 masters
    assert models["decoder"].weight.dtype == models["decoder"].weight.grad.dtype == torch.float32
    with pytest.raises(ValueError, match="mixed_precision"):
        mp.enabled(types.SimpleNamespace(mixed_precision="fp16"))


def test_a_step_casts_a_parameter_once_per_version():
    models = torch.nn.ModuleDict({"decoder": torch.nn.Linear(3, 4)})
    w = models["decoder"].weight
    x = torch.randn(2, 3)
    assert mp.cast_param(w) is not mp.cast_param(w)  # outside a step: a cast per call
    opt = torch.optim.AdamW(models.parameters(), lr=0.1)
    seen = []

    @mp.casts_once
    def step():
        first, again = mp.cast_param(w), mp.cast_param(w)
        seen.append(first)
        loss = sum(mp.run(models, "decoder", True, x).float().sum() for _ in range(3))
        loss.backward()  # three uses of one copy: three times one use's gradient
        assert first is again and w.grad.dtype == torch.float32
        grad = w.grad.clone()
        opt.step()  # a new version of the master
        assert mp.cast_param(w) is not first
        with torch.no_grad():  # another autograd mode: another copy, reused in it
            plain = mp.cast_param(w)
            assert plain is mp.cast_param(w) and plain.grad_fn is None
        assert mp.cast_param(w).grad_fn is not None
        return grad

    grad = step()
    want = 3 * x.bfloat16().float().sum(0).expand(4, 3)
    torch.testing.assert_close(grad, want, rtol=1e-2, atol=0)  # bf16 products
    assert mp._step_casts is None  # the copies go with the step
    assert step() is not None and seen[0] is not seen[1]


def test_bf16_modules_are_the_jax_packages():
    assert mp.BF16_MODULES == jax_mp.BF16_MODULES


class _Deterministic:
    """A JAX module with its train-mode draws off: the keyword arguments
    given forced, and a decoder call's positional `train` made False."""

    def __init__(self, module, **forced):
        self.module, self.forced = module, forced

    def apply(self, variables, *args, **kw):
        if len(args) == 5:  # the decoder's (asr, F0, N, s, train)
            args = args[:4] + (False,)
        return self.module.apply(variables, *args, **dict(kw, **self.forced))


STRICT = {"xla_allow_excess_precision": False}  # XLA rounds every bf16 op, as eager PyTorch


def _jax_losses(jcfg, models, variables, batch, starts, bf16):
    """The JAX trainer's generator losses of a TMA step on the mono path
    (its `_forward_recon` at train=True, then the WavLM and adversarial
    terms cast as its step casts them), with mp = `bf16`, compiled with
    STRICT rounding."""
    cast_in, cast_params = jax_mp.cast_in, jax_mp.cast_module_params
    models = dataclasses.replace(
        models, text_aligner=_Deterministic(models.text_aligner, train=False, rngs=None),
        text_encoder=_Deterministic(models.text_encoder, train=False, rngs=None),
        style_encoder=_Deterministic(models.style_encoder, update_stats=False),
        decoder=_Deterministic(models.decoder))
    ns = types.SimpleNamespace(models=models, mp=bf16, multispeaker=False)
    variables = jax.tree.map(jnp.asarray, variables)
    params = {k: v["params"] for k, v in variables.items()}
    extras = {k: {c: x for c, x in v.items() if c != "params"} for k, v in variables.items()}
    bd = {k: jnp.asarray(v) for k, v in batch.items()}

    def losses(params, extras):
        y, w, aux = JaxStage1._forward_recon(ns, params, extras, bd, jnp.asarray(starts),
                                             jnp.asarray(starts), jax.random.PRNGKey(0), CLIP,
                                             jnp.asarray(1), train=True)
        s2s = jax_s2s_ce_loss(aux["s2s_pred"], bd["tokens"], bd["input_lengths"])
        mono = jnp.mean(jnp.abs(aux["s2s_attn"] - aux["mono"])) * 10.0
        p = cast_params(params, bf16)
        wl = {"params": p["wavlm"]}
        slm = JL.wavlm_feature_loss(models.wavlm.apply(wl, cast_in(jax_resample(w), bf16)),
                                    models.wavlm.apply(wl, cast_in(jax_resample(y), bf16)))
        wc, yc = cast_in(w, bf16), cast_in(y, bf16)
        gen = JL.generator_adv_loss(models.mpd.apply({"params": p["mpd"]}, wc, yc),
                                    models.msd.apply({"params": p["msd"]}, wc, yc))
        return {"mel": JL.multires_stft_loss(y, w), "s2s": s2s, "mono": mono, "slm": slm,
                "gen": gen, "y_dtype": jnp.zeros((), y.dtype)}

    out = jax.jit(losses).lower(params, extras).compile(compiler_options=STRICT)(params, extras)
    assert out.pop("y_dtype").dtype == jnp.float32  # the decoder's f32 head
    return {k: float(v) for k, v in out.items()}


def _port_losses(pcfg, port, batch, starts, bf16):
    """The port's generator losses of the same step, in eval mode, with the
    bf16 casts on when `bf16`."""
    for m in port.values():
        m.eval().requires_grad_(False)
    trainer = pstage1.Stage1Trainer(_bf16(pcfg) if bf16 else pcfg, TrainState(port, {}), "cpu")
    tensors = trainer._tensors(types.SimpleNamespace(**batch))
    with torch.no_grad():
        y, w, aux = trainer.forward_recon(*tensors, starts, starts, CLIP, True, mp=bf16)
        _, got = trainer.generator_losses(y, w, aux, tensors[1], tensors[2], True)
        got["gen"] = PL.generator_adv_loss(mp.run(port, "mpd", bf16, w, y),
                                           mp.run(port, "msd", bf16, w, y))
    assert y.dtype == torch.float32
    return {k: float(v) for k, v in got.items()}


def test_bf16_generator_losses_match_jax(setup):
    jcfg, models, variables, pcfg, port, batch, starts = setup
    with zero_noise(), stable_har_phase():
        j16, j32 = (_jax_losses(jcfg, models, variables, batch, starts, b) for b in (True, False))
        p16, p32 = (_port_losses(pcfg, port, batch, starts, b) for b in (True, False))
    assert sorted(p16) == sorted(j16)
    for k in j16:
        assert abs(p16[k] - j16[k]) <= JAX_TOL * abs(j16[k]), (k, p16[k], j16[k])
        effect, jax_effect = _rel(p16[k], p32[k]), _rel(j16[k], j32[k])
        if k in ("s2s", "mono"):  # the aligner's losses: f32 in both
            assert effect == jax_effect == 0.0, (k, effect, jax_effect)
            continue
        floor = _rel(p32[k], j32[k])  # f32 parity
        assert effect >= BF16_SEEN * floor, (k, effect, floor)
        assert jax_effect / EFFECT_RATIO <= effect <= EFFECT_RATIO * jax_effect, (
            k, effect, jax_effect)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _step(pcfg, port, batch, epoch):
    """One train_step from `port`'s weights; the discriminators are built
    small (one period, one resolution), as tests/test_torch_stage2_run.py
    builds them: the step's order does not depend on their size, and the
    full ones take most of its CPU time."""
    port = copy.deepcopy(port)
    g = torch.Generator().manual_seed(0)
    port["mpd"] = MultiPeriodDiscriminator(periods=(3,))
    port["msd"] = MultiResSpecDiscriminator(fft_sizes=(512,), hop_sizes=(50,), win_lengths=(240,))
    for k in ("mpd", "msd"):
        init_discriminator_(port[k], g)
    state = TrainState(port, build_optimizers(pcfg, port))
    torch.manual_seed(0)
    metrics = pstage1.Stage1Trainer(pcfg, state, "cpu").train_step(
        _batch(batch), epoch=epoch, iters=0, rng=np.random.default_rng(3))
    return metrics, state


def test_bf16_step_tracks_f32_and_keeps_f32_masters(setup):
    _, _, _, pcfg, port, batch, _ = setup
    tma = pcfg.loss_params.TMA_epoch
    m32, _ = _step(pcfg, port, batch, tma)
    m16, state = _step(_bf16(pcfg), port, batch, tma)
    for k in LOGGED:
        assert np.isfinite(m16[k]), k
        assert abs(m16[k] - m32[k]) <= STEP_TOL * max(abs(m32[k]), 1e-3), (k, m16[k], m32[k])
    for k in set(mp.BF16_MODULES) & set(state.models):
        assert all(p.dtype == torch.float32 for p in state.models[k].parameters()), k
    for k in ("decoder", "style_encoder", "mpd", "msd"):  # the stepped bf16 modules
        moments = [state.opts[k].state[p] for p in state.models[k].parameters()]
        assert all(v.dtype == torch.float32 for m in moments for v in m.values()), k
        assert all("exp_avg_sq" in m for m in moments), k


def test_bf16_validation_is_f32(setup):
    _, _, _, pcfg, port, batch, _ = setup
    got = [pstage1.Stage1Trainer(cfg, TrainState(copy.deepcopy(port), {}), "cpu").validate(
        _batch(batch), np.random.default_rng(5)) for cfg in (pcfg, _bf16(pcfg))]
    assert got[0] == got[1]
