"""The port's synthesis path as a whole: its config defaults, the weight
conversion round trip, `Synthesizer.inference` against the JAX Synthesizer,
the port's import boundary, the card as `Synthesizer`'s default device and
chip_smoke.py's refusal without a card.

Tolerances of the end-to-end comparison: the integer durations must be
equal; the style s_pred within 1e-4 of its peak (text encoders and 5
diffusion steps in f32); the waveform within 1e-3 of its peak, the bound the
reference-parity harness held every stage to (see test_torch_decoder.py).
Random draws and the chaotic source phase are zeroed on both sides.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from styletts2_tpu.convert import convert_styletts2_checkpoint
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.models.build import module_keys
from torch_parity import (jax_cfg, jax_models_and_params, port_cfg, rel_err,
                          stable_har_phase, zero_noise)

REPO = Path(__file__).resolve().parent.parent
TEXT = "ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt."


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_cfg()
    _, params = jax_models_and_params(jcfg, seed=8)
    return jcfg, params


def test_config_defaults_are_config_yml():
    """Config() is configs/config.yml and libritts_config() is
    configs/config_libritts.yml, and both agree with the JAX package's
    loaded configs on every field the port reads."""
    import dataclasses

    from styletts2_tpu.config import Config as JaxConfig
    from styletts2_tpu.config import load_config as jax_load_config
    from styletts2_tpu_torch.config import Config, libritts_config, load_config

    assert load_config(str(REPO / "configs" / "config.yml")) == Config()
    assert port_cfg(JaxConfig()) == Config()
    libritts = load_config(str(REPO / "configs" / "config_libritts.yml"))
    assert libritts == libritts_config()
    assert port_cfg(jax_load_config(str(REPO / "configs" / "config_libritts.yml"))) == libritts
    assert libritts.model_params.multispeaker and dataclasses.asdict(libritts) != dataclasses.asdict(Config())


def test_weight_round_trip_is_exact(setup):
    """state_dict_from_jax is the exact inverse of convert_styletts2_checkpoint
    on every leaf of the slice's modules, and loads strictly into the port."""
    from styletts2_tpu_torch.models.build import build_models

    jcfg, params = setup
    sd = state_dict_from_jax(params, port_cfg(jcfg))
    port_sd = build_models(port_cfg(jcfg)).state_dict()
    assert sd.keys() == port_sd.keys()
    assert all(sd[k].shape == port_sd[k].shape for k in sd)

    keys = module_keys(port_cfg(jcfg))
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


def test_synthesizer_matches_jax(setup):
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg, params = setup
    noise = np.random.default_rng(9).standard_normal(
        (1, 1, 2 * jcfg.model_params.style_dim)).astype(np.float32)
    jsyn = JaxSynthesizer(jcfg, params=params)
    seen = {}
    get_phase_b = jsyn._get_phase_b

    def spy(n_frames):  # records the durations the JAX decoder stage gets
        pb = get_phase_b(n_frames)

        def run(params_, t_en, d, s, ref, pred_dur, key, pcm16=False):
            seen["pred_dur"] = np.asarray(pred_dur)
            return pb(params_, t_en, d, s, ref, pred_dur, key, pcm16=pcm16)

        return run

    jsyn._get_phase_b = spy
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    with zero_noise(), stable_har_phase():
        want_wav, want_s = jsyn.inference(TEXT, noise=noise, speed=4.0)
        got = psyn.synthesize(TEXT, noise=noise, speed=4.0)
    L = len(got.pred_dur)
    np.testing.assert_array_equal(got.pred_dur, seen["pred_dur"][0, :L])
    assert rel_err(got.s_pred, want_s) < 1e-4
    assert got.wav.shape == want_wav.shape == (int(got.pred_dur.sum()) * 600,)
    assert np.isfinite(got.wav).all()
    assert rel_err(got.wav, want_wav) < 1e-3


def test_last_token_pad_follows_the_option(setup):
    """The +5 frames on the last token come only with pad_last_token, which
    defaults on for single-speaker; LFinference turns it off, as the JAX
    Synthesizer does."""
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg, params = setup
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    kw = dict(diffusion_steps=3, speed=4.0, seed=1)
    padded = psyn.synthesize(TEXT, **kw)
    plain = psyn.synthesize(TEXT, pad_last_token=False, **kw)
    np.testing.assert_array_equal(padded.pred_dur[:-1], plain.pred_dur[:-1])
    assert padded.pred_dur[-1] == plain.pred_dur[-1] + 5
    assert len(plain.wav) == int(plain.pred_dur.sum()) * 600
    lf, _ = psyn.LFinference(TEXT, None, **kw)
    assert len(lf) == len(plain.wav)
    trimmed = psyn.synthesize(TEXT, trim_samples=7, **kw)
    np.testing.assert_array_equal(trimmed.wav, padded.wav[:-7])


def test_bucketed_inference_matches_exact_length(setup, monkeypatch):
    """Padding the text to its 64-token bucket changes nothing (the LSTMs and
    the denoiser mask the padded tokens): a bucketed run equals an
    exact-length one, as the JAX package's tests/test_inference.py holds its
    Synthesizer. The frame bucket is 1 in both."""
    from styletts2_tpu_torch import inference

    jcfg, params = setup
    psyn = inference.Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                                 device="cpu")
    noise = np.random.default_rng(3).standard_normal(
        (1, 1, 2 * jcfg.model_params.style_dim)).astype(np.float32)
    kw = dict(noise=noise, diffusion_steps=3, seed=5, speed=4.0)
    monkeypatch.setattr(inference, "FRAME_BUCKET", 1)
    wav_b, s_b = psyn.inference(TEXT, **kw)
    monkeypatch.setattr(inference, "TEXT_BUCKET", 1)
    wav_e, s_e = psyn.inference(TEXT, **kw)
    np.testing.assert_allclose(s_b, s_e, atol=2e-5)
    assert wav_e.shape == wav_b.shape
    denom = np.abs(wav_e).max() + 1e-6
    np.testing.assert_allclose(wav_b / denom, wav_e / denom, atol=1e-3)


def _run(code, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # beside the suite's other workers
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    """Importing the port, its benches, its server, its demo, its trainers (with
    `train/mp.py`), `eval.py`, the data-parallel module and the Hugging Face
    WavLM reader, and running a tiny single-speaker and a tiny multispeaker CPU
    synthesis, each with the f32 and the bf16 decoder, loads neither JAX,
    flax, PyYAML, transformers nor the JAX package."""
    code = """
import sys
import numpy as np
import styletts2_tpu_torch.bench
import styletts2_tpu_torch.bench_train
import styletts2_tpu_torch.demo
import styletts2_tpu_torch.eval
import styletts2_tpu_torch.serve
import styletts2_tpu_torch.train.run
import styletts2_tpu_torch.parallel.ddp
from styletts2_tpu_torch.convert import hf_model_dir, read_safetensors, wavlm_from_hf
from styletts2_tpu_torch.config import Config, libritts_config
from styletts2_tpu_torch.inference import Synthesizer
for cfg in (Config(), libritts_config()):
    cfg.plbert_params.num_hidden_layers = 1
    cfg.plbert_params.hidden_size = 64
    cfg.plbert_params.intermediate_size = 128
    cfg.plbert_params.num_attention_heads = 2
    cfg.model_params.hidden_dim = 64
    cfg.model_params.style_dim = 32
    cfg.model_params.dim_in = 16
    cfg.model_params.diffusion.transformer.num_layers = 1
    cfg.model_params.decoder.upsample_initial_channel = 64
    for dtype in ("float32", "bfloat16"):
        syn = Synthesizer(cfg, seed=0, device="cpu", decoder_dtype=dtype)
        ref = syn.compute_style(np.sin(np.arange(30000) / 20.0)) if syn.multispeaker else None
        wav, s = syn.inference("hˈɛloʊ.", ref_s=ref, diffusion_steps=3, speed=8.0)
        assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all() and s.shape == (1, 64)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "transformers", "styletts2_tpu"))
print("BAD", bad)
"""
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_synthesizer_defaults_to_the_card(monkeypatch):
    """A Synthesizer built without a device runs on the card: where there is
    none it raises rather than running on the CPU."""
    import torch

    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(Config(), seed=0)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no card, and where it stands alone without the repo."""
    res = _run(f"import runpy; runpy.run_path({str(REPO / 'chip_smoke.py')!r}, run_name='__main__')",
               REPO)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    res = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')", tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
