"""Trained-weights fidelity of the port (`styletts2_tpu_torch/fidelity.py`)
against the JAX package's tool (`tools/train_tiny_fidelity.py`) and trainer.

- `speechlike_batch` draws the JAX tool's arrays bit for bit from the same
  seed, and the port's `tiny_config()` is the JAX package's field by field.
- A short port run lowers the mel loss and keeps the bf16-vs-f32 decoder
  MCD finite and under 10 dB (the mirror of the JAX package's
  `test_short_training_reduces_mel_loss_and_bounds_bf16_mcd`).
- The port's tiny model trained for STEPS pre-TMA steps, written as a
  reference-layout checkpoint (`train/state.py:save_checkpoint`) and read by
  the JAX package's own `convert_styletts2_checkpoint`: the JAX trainer's
  eval forward (`_forward_recon(..., train=False, return_io=True)`) and the
  port's reconstruct the held-out batch alike, the NSF source's draws handed
  to both alike (`injected_draws`) and its chaotic STFT phase zeroed on both
  sides (tests/torch_parity.py). The decoder's bf16 effect (bf16 against f32
  on the same trained weights and inputs, JAX compiled to round every bf16
  op as eager PyTorch does, tests/test_torch_bf16.py) is seen on both sides
  and reads JAX's bf16-vs-f32 MCD. The slow case trains 200 steps, where the
  JAX test's < 10 dB bound engages.

Tolerances, measured first (at STEPS = 10; the margin beside each): the
decoder inputs within IO_TOL of their peak (<= 1.1e-6, 9x); the
reconstruction within WAV_TOL of its peak (7.9e-6, 12x) and its MCD
against JAX's under PARITY_MCD (0.0002 dB, 50x); the bf16 effect, L2 over
the waveform, at least BF16_SEEN times the f32 parity on both sides (port
0.104, JAX 0.050, parity 4.1e-6: 1.2e4x) and its MCD within MCD_GAP dB of
JAX's (port 2.68, JAX 2.72 dB: 0.03). The two effects' sizes differ by up
to 2x (JAX adds a conv's bias after rounding its output, the port inside
it: tests/test_torch_bf16.py), so the MCD, the metric the fidelity tool
reports, is what is held.
"""

import contextlib
import copy
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.convert import convert_styletts2_checkpoint
from styletts2_tpu.models.build import build_training_models as jax_build_training_models
from styletts2_tpu.parallel.tiny import tiny_config as jax_tiny_config
from styletts2_tpu.train.stage1 import Stage1Trainer as JaxStage1
from styletts2_tpu_torch import fidelity
from styletts2_tpu_torch.eval import mcd
from styletts2_tpu_torch.inference import decode
from styletts2_tpu_torch.parallel.tiny import tiny_config
from styletts2_tpu_torch.train.state import save_checkpoint
from torch_parity import port_cfg, rel_err, stable_har_phase
from torch_tiny_train import small_aux_builders

SHORT_STEPS = 12  # the JAX test's
STEPS = 10
SLOW_STEPS = 200
KEYS = ("text_encoder", "style_encoder", "decoder", "text_aligner", "pitch_extractor")
STRICT = {"xla_allow_excess_precision": False}
WAV_TOL, IO_TOL, PARITY_MCD = 1e-4, 1e-5, 0.01
BF16_SEEN, MCD_GAP = 100.0, 0.5


def test_speechlike_batch_is_the_jax_tools():
    from tools.train_tiny_fidelity import speechlike_batch

    for args in ((2,), (3, 130000, 120600)):
        want = speechlike_batch(np.random.default_rng(999), *args)
        got = fidelity.speechlike_batch(np.random.default_rng(999), *args)
        for f in ("waves", "wave_lengths", "tokens", "input_lengths", "ref_tokens", "ref_lengths",
                  "mel_lengths", "ref_waves", "ref_wave_lengths", "speakers"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_tiny_config_is_the_jax_packages():
    import dataclasses

    assert dataclasses.asdict(tiny_config()) == dataclasses.asdict(port_cfg(jax_tiny_config()))


def _parity_cfg():
    """The fidelity tool's tiny config with three resblock kernels per
    upsample, the iSTFTNet layout the JAX converter reads
    (`styletts2_tpu/convert.py:397-418`, as tests/torch_parity.py's
    `jax_cfg`)."""
    cfg = fidelity.fidelity_config("tiny")
    cfg.model_params.decoder.resblock_kernel_sizes = [3, 7, 11]
    cfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]] * 3
    return cfg


def _train(steps, cfg=None):
    """The port's tiny fidelity model (the stage-1 modules at seed 0; `cfg`,
    else the tool's tiny config) after `steps` pre-TMA steps at batch 2 of
    the JAX tool's batches: (trainer, mel losses, the bf16-vs-f32 MCD at
    random init)."""
    cfg = cfg or fidelity.fidelity_config("tiny")
    with small_aux_builders():  # WavLM and the discriminators do not run before TMA
        trainer = fidelity.build_trainer(cfg, "cpu")
    held_out = fidelity.speechlike_batch(np.random.default_rng(fidelity.HELD_OUT_SEED), 2)
    mcd0, _, _ = fidelity.decoder_mcd_f32_vs_bf16(trainer, held_out)
    rng = np.random.default_rng(fidelity.TRAIN_SEED)
    losses = []
    for it in range(steps):
        m = trainer.train_step(fidelity.speechlike_batch(rng, 2), 0, it, rng)
        assert m is not None
        losses.append(m["mel"])
    return trainer, losses, mcd0


@pytest.fixture(scope="module")
def trained():
    return _train(STEPS, _parity_cfg())


@pytest.mark.parametrize("decoder", ["istftnet", "hifigan"])
def test_only_hifigans_generator_starts_at_the_references_init(decoder):
    """HiFi-GAN's Generator builds its weight-norm convs with g = ||v||, so
    w = v, the reference's init (the JAX init's g = 1 saturates its tanh
    head and it does not train: PERF.md §6); every other weight-norm
    conv, iSTFTNet's Generator's too, keeps the JAX init's g = 1."""
    from styletts2_tpu_torch.models import build as pbuild
    from styletts2_tpu_torch.models.layers import WNConv1d, WNConvTranspose1d, weight_norm

    cfg = tiny_config()
    if decoder == "hifigan":
        cfg.model_params.decoder.type = "hifigan"
        cfg.model_params.decoder.upsample_rates = [10, 5, 3, 2]
        cfg.model_params.decoder.upsample_kernel_sizes = [20, 10, 6, 4]
    dec = pbuild._decoder(cfg)
    pbuild._init_weights(dec, torch.Generator().manual_seed(0))
    gen = {id(m) for m in dec.generator.modules()}
    convs = [m for m in dec.modules() if isinstance(m, (WNConv1d, WNConvTranspose1d))]
    assert sum(id(m) in gen for m in convs) > 4 and sum(id(m) not in gen for m in convs) > 4
    for m in convs:
        if decoder == "hifigan" and id(m) in gen:
            torch.testing.assert_close(weight_norm(m.weight_v, m.weight_g), m.weight_v,
                                       rtol=1e-5, atol=1e-7)
        else:
            assert torch.equal(m.weight_g, torch.ones_like(m.weight_g))


def test_short_port_run_lowers_mel_loss_and_bounds_bf16_mcd():
    trainer, losses, mcd0 = _train(SHORT_STEPS)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    held_out = fidelity.speechlike_batch(np.random.default_rng(fidelity.HELD_OUT_SEED), 2)
    score, items, _ = fidelity.decoder_mcd_f32_vs_bf16(trainer, held_out)
    print(f"\nport tiny, {len(losses)} steps: mel {np.mean(losses[:3]):.4f} -> "
          f"{np.mean(losses[-3:]):.4f}; bf16-vs-f32 MCD {mcd0:.4f} dB at random init, "
          f"{score:.4f} dB trained ({', '.join(f'{x:.4f}' for x in items)})")
    assert np.isfinite(items).all() and score < 10.0, items


def _jax_side(trainer, tmp_path):
    """The trained port weights through `save_checkpoint` and the JAX
    converter: (the JAX config, its models, a namespace standing for the
    JAX trainer, its variables)."""
    path = tmp_path / "trained.pth"
    save_checkpoint(str(path), trainer.state)
    net = torch.load(path, weights_only=True)["net"]
    path.unlink()
    jcfg = jax_tiny_config()
    jcfg.loss_params.TMA_epoch = fidelity.PRE_TMA
    jcfg.model_params.decoder.resblock_kernel_sizes = [3, 7, 11]
    jcfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]] * 3
    variables = convert_styletts2_checkpoint(
        {"net": {k: {n: v.numpy() for n, v in net[k].items()} for k in KEYS}}, jcfg)
    jv = jax.tree.map(jnp.asarray, variables)
    models = jax_build_training_models(jcfg)
    ns = types.SimpleNamespace(models=models, mp=False, multispeaker=False, cfg=jcfg)
    ns.state = types.SimpleNamespace(params={k: v["params"] for k, v in jv.items()},
                                     extras={k: {c: x for c, x in v.items() if c != "params"}
                                             for k, v in jv.items()})
    return jcfg, models, ns, jv


@contextlib.contextmanager
def injected_draws():
    """The NSF source's draws (its initial phases, uniform, and its noise,
    normal) handed to both frameworks alike: each draw of a shape comes
    from numpy seeded by that shape, on the JAX side (jax.random.uniform /
    normal) and the port's (torch.rand / randn). With every draw zeroed a
    briefly trained decoder's exp head can swing its output to ~1e17, where
    the mel front end's power overflows f32."""
    j_uniform, j_normal, t_rand, t_randn = (jax.random.uniform, jax.random.normal, torch.rand,
                                            torch.randn)

    def draw(shape, normal):
        shape = tuple(int(n) for n in shape)
        rng = np.random.default_rng([int(normal), *shape])
        return (rng.standard_normal(shape) if normal else rng.random(shape)).astype(np.float32)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(minval + (maxval - minval) * draw(shape, False), dtype)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(draw(shape, True), dtype)

    def torch_draw(normal_):
        def fn(*size, generator=None, device=None, dtype=None, **_):
            if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
                size = tuple(size[0])
            return torch.from_numpy(draw(size, normal_)).to(device=device, dtype=dtype)
        return fn

    jax.random.uniform, jax.random.normal = uniform, normal
    torch.rand, torch.randn = torch_draw(False), torch_draw(True)
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal, torch.rand, torch.randn = (j_uniform, j_normal,
                                                                          t_rand, t_randn)


def _parity(trainer, tmp_path):
    jcfg, jmodels, ns, jv = _jax_side(trainer, tmp_path)
    held_out = fidelity.speechlike_batch(np.random.default_rng(fidelity.HELD_OUT_SEED), 2)
    clip_len = 40
    starts = np.zeros(2, np.int64)
    bdict = {k: jnp.asarray(getattr(held_out, k))
             for k in ("waves", "tokens", "input_lengths", "mel_lengths")}
    with injected_draws(), stable_har_phase():
        y_j, _, aux = jax.jit(lambda p, e, b, s: JaxStage1._forward_recon(
            ns, p, e, b, s, s, jax.random.PRNGKey(0), clip_len, use_mono=jnp.asarray(1),
            train=False, return_io=True))(ns.state.params, ns.state.extras, bdict,
                                          jnp.asarray(starts, jnp.int32))
        trainer._modes(False, ())
        with torch.no_grad():
            y_p, _, paux = trainer.forward_recon(*trainer._tensors(held_out), starts, starts,
                                                 clip_len, True, torch.Generator())
        y_j, y_p = np.asarray(y_j), y_p.numpy()
        io_j = [np.asarray(x) for x in aux["decoder_io"]]
        io_p = [x.numpy() for x in paux["decoder_io"]]
        io_p[0] = io_p[0].transpose(0, 2, 1)  # en: NCW -> the JAX side's NWC
        # the decoder's bf16 effect on both sides, from the port's inputs
        en, f0, norm, s = paux["decoder_io"]
        dec = trainer.models["decoder"]
        p32 = decode(dec, en, f0, norm, s, torch.Generator()).numpy()
        p16 = decode(copy.deepcopy(dec).to(torch.bfloat16), en, f0, norm, s,
                     torch.Generator()).numpy()

        def jax_decode(dt):
            args = (jax.tree.map(lambda x: x.astype(dt), jv["decoder"]["params"]),
                    jnp.asarray(io_p[0], dt), jnp.asarray(io_p[1]), jnp.asarray(io_p[2]),
                    jnp.asarray(io_p[3], dt))
            fn = jax.jit(lambda p, *a: jmodels.decoder.apply({"params": p}, *a,
                                                             rngs={"noise": jax.random.PRNGKey(0)}))
            return np.asarray(fn.lower(*args).compile(compiler_options=STRICT)(*args), np.float32)

        j32, j16 = jax_decode(jnp.float32), jax_decode(jnp.bfloat16)
    return y_j, y_p, io_j, io_p, (p32, p16, j32, j16)


def _l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(trainer, losses, tmp_path):
    y_j, y_p, io_j, io_p, (p32, p16, j32, j16) = _parity(trainer, tmp_path)
    assert y_p.shape == y_j.shape and np.isfinite(y_p).all()
    io_err = [rel_err(p, j) for p, j in zip(io_p, io_j)]
    wav_err = rel_err(y_p, y_j)
    scores = [mcd(y_p[b], y_j[b], use_dtw=False) for b in range(len(y_j))]
    effect, jax_effect, floor = _l2(p16, p32), _l2(j16, j32), _l2(p32, j32)
    mcd_p = float(np.mean([mcd(p16[b], p32[b], use_dtw=False) for b in range(len(p32))]))
    mcd_j = float(np.mean([mcd(j16[b], j32[b], use_dtw=False) for b in range(len(j32))]))
    print(f"\nport trained {len(losses)} steps (mel {np.mean(losses[:3]):.4f} -> "
          f"{np.mean(losses[-3:]):.4f}) vs JAX on its checkpoint: decoder inputs "
          f"{', '.join(f'{e:.2e}' for e in io_err)}; waveform {wav_err:.3e} of its peak, MCD "
          f"{', '.join(f'{x:.4f}' for x in scores)} dB; bf16 effect (L2) port {effect:.3e} JAX "
          f"{jax_effect:.3e}, f32 parity {floor:.3e}; bf16-vs-f32 MCD port {mcd_p:.4f} JAX "
          f"{mcd_j:.4f} dB")
    assert max(io_err) <= IO_TOL, io_err
    assert wav_err <= WAV_TOL and max(scores) <= PARITY_MCD, (wav_err, scores)
    assert min(effect, jax_effect) >= BF16_SEEN * floor, (effect, jax_effect, floor)
    assert abs(mcd_p - mcd_j) <= MCD_GAP, (mcd_p, mcd_j)
    return mcd_p


def test_trained_port_reconstructs_as_jax(trained, tmp_path):
    trainer, losses, _ = trained
    _check(trainer, losses, tmp_path)


@pytest.mark.slow
def test_trained_port_reconstructs_as_jax_after_200_steps(tmp_path):
    trainer, losses, _ = _train(SLOW_STEPS, _parity_cfg())
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert _check(trainer, losses, tmp_path) < 10.0


BANNED = ("jax", "jaxlib", "flax", "yaml", "transformers", "styletts2_tpu")


def test_port_and_smoke_import_no_jax_yaml_or_transformers():
    """No line of the port's package or of chip_smoke.py imports JAX, flax,
    PyYAML, transformers or the JAX package (PyYAML alone, inside
    `config.load_config`, for a YAML file the caller names); importing the
    fidelity tool, the mesh, the tiny config and chip_smoke.py loads none
    of them."""
    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^(\s*)(?:import|from)\s+(" + "|".join(BANNED) + r")\b")
    for path in sorted((root / "styletts2_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = pattern.match(line)
            assert m is None or (path.name == "config.py" and m.group(2) == "yaml"
                                 and m.group(1)), f"{path.relative_to(root)}:{i}: {line}"
    code = ("import sys, chip_smoke, styletts2_tpu_torch.fidelity, styletts2_tpu_torch.parallel.mesh, "
            "styletts2_tpu_torch.parallel.tiny\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "[]", (res.stdout, res.stderr[-2000:])


def test_fidelity_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default runs")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "styletts2_tpu_torch.fidelity", "--steps", "1"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fidelity.run("tiny", 1)
