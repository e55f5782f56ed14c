"""The port's entry points against what its trainers write and what the JAX
package does: a stage-2 training checkpoint (13 modules, sigma_data) serves
requests through the server the CLI builds, the style sampler denoises with
the trained sigma_data as the JAX `Synthesizer(sigma_data=...)` does, and
the server and the training CLI run convolutions and matmuls in f32 (TF32
off), with no switch to turn it on.

Tolerances of the JAX comparison are those of test_torch_synth.py: equal
durations, the style within 1e-4 of its peak.
"""

import io
import json
import sys
import types
import urllib.request
import wave

import numpy as np
import pytest
import torch
import yaml

from styletts2_tpu_torch.config import config_from_path
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.models.build import build_training_models, module_keys
from styletts2_tpu_torch.serve import make_server, parse_args
from styletts2_tpu_torch.train import run
from styletts2_tpu_torch.train.state import TrainState, build_optimizers, save_checkpoint
from test_torch_stage2_run import small_aux_models  # noqa: F401 (a fixture)
from test_torch_train_run import TINY
from torch_parity import (jax_cfg, jax_models_and_params, port_cfg, rel_err, stable_har_phase,
                          zero_noise)

TEXT = "ðɪs ɪz ɐ tˈɛst."


def _config(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump({"model_params": TINY}))
    return path


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def test_stage2_checkpoint_serves_a_request(tmp_path, small_aux_models):  # noqa: F811
    """A checkpoint of the stage-2 trainer's state (every training module,
    the optimizers, sigma_data) loads into the server the CLI builds: the
    synthesis modules strictly, the training-only ones skipped; it answers a
    request and samples with the file's sigma_data. A file without
    sigma_data samples with the config's; one without a synthesis module is
    an error."""
    cfg_path = _config(tmp_path)
    cfg = config_from_path(str(cfg_path))
    models = build_training_models(cfg, torch.Generator().manual_seed(3), stage="second")
    state = TrainState(models, build_optimizers(cfg, models, stage2=True), step=7, epoch=2,
                       sigma_data=0.35)
    ckpt = tmp_path / "epoch_2nd_00002.pth"
    save_checkpoint(str(ckpt), state)
    net = torch.load(ckpt, map_location="cpu", weights_only=True)["net"]
    assert set(net) - set(module_keys(cfg)) >= {"text_aligner", "pitch_extractor", "mpd", "msd",
                                                 "wd", "style_encoder", "predictor_encoder"}

    server = make_server(parse_args(["--config", str(cfg_path), "--ckpt", str(ckpt),
                                     "--device", "cpu", "--window-ms", "1"]))
    port = server.start_background()
    try:
        code, body = _post(port, {"text": TEXT, "diffusion_steps": 3, "speed": 4.0})
        assert code == 200
        with wave.open(io.BytesIO(body)) as f:
            assert f.getframerate() == 24000 and f.getnframes() > 0
            assert f.getnframes() % 600 == 0
    finally:
        server.close()
    assert server.syn.sigma_data == 0.35
    for k in module_keys(cfg):
        got = server.syn.models[k].state_dict()
        assert got.keys() == net[k].keys(), k
        for name, v in net[k].items():
            assert torch.equal(got[name], v), (k, name)

    state.sigma_data = None  # a stage-1 style file: the config's sigma_data
    save_checkpoint(str(tmp_path / "no_sigma.pth"), state)
    args = parse_args(["--config", str(cfg_path), "--ckpt", str(tmp_path / "no_sigma.pth"),
                       "--device", "cpu"])
    other = make_server(args)
    other.close()
    assert other.syn.sigma_data == cfg.model_params.diffusion.dist.sigma_data
    del net["decoder"]
    torch.save({"net": net}, tmp_path / "no_decoder.pth")
    with pytest.raises(RuntimeError, match="decoder"):
        make_server(parse_args(["--config", str(cfg_path), "--ckpt",
                                str(tmp_path / "no_decoder.pth"), "--device", "cpu"]))


def test_sampler_sigma_data_matches_jax():
    """At sigma_data 0.35 the port's style and durations are the JAX
    Synthesizer's, and differ from those at the default 0.2."""
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg = jax_cfg()
    _, params = jax_models_and_params(jcfg, seed=8)
    noise = np.random.default_rng(9).standard_normal(
        (1, 1, 2 * jcfg.model_params.style_dim)).astype(np.float32)
    sd = state_dict_from_jax(params, port_cfg(jcfg))
    jsyn = JaxSynthesizer(jcfg, params=params, sigma_data=0.35)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=sd, device="cpu", sigma_data=0.35)
    default = Synthesizer(port_cfg(jcfg), state_dict=sd, device="cpu")
    kw = dict(noise=noise, diffusion_steps=3, speed=4.0)
    with zero_noise():
        _, want_s = jsyn.inference(TEXT, **kw)
        got = psyn.synthesize(TEXT, **kw)
        at_default = default.synthesize(TEXT, **kw)
    assert rel_err(got.s_pred, want_s) < 1e-4
    assert rel_err(at_default.s_pred, want_s) > 1e-2


def test_entry_points_leave_tf32_off(tmp_path, monkeypatch):
    """The server the CLI builds and the training CLI turn TF32 off in
    cuDNN and cuBLAS whatever it was before; neither CLI has a switch for
    it."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)

    def tf32_on():
        for f in flags:
            monkeypatch.setattr(f, "allow_tf32", True)

    tf32_on()
    server = make_server(parse_args(["--config", str(_config(tmp_path)), "--device", "cpu"]))
    server.close()
    assert not any(f.allow_tf32 for f in flags)

    tf32_on()
    calls = []
    monkeypatch.setattr(run, "run_stage", lambda *a: calls.append(
        types.SimpleNamespace(args=a, tf32=[f.allow_tf32 for f in flags])))
    run.main(["first", "--config_path", "configs/config.yml", "--device", "cpu"])
    assert len(calls) == 1 and calls[0].tf32 == [False, False]
    for argv in (["--tf32"], ["--config", "configs/config.yml", "--tf32"]):
        with pytest.raises(SystemExit):
            parse_args(argv)
    with pytest.raises(SystemExit):
        run.main(["first", "--config_path", "configs/config.yml", "--tf32"])


RAW = ' "This is a test." '


class StubEspeak:
    """phonemizer's espeak-ng backend, stubbed (neither machine has
    espeak-ng): the IPA of the one sentence the tests send. Records the
    texts and options it was given."""

    calls = []

    def __init__(self, language, preserve_punctuation, with_stress):
        self.options = (language, preserve_punctuation, with_stress)

    def phonemize(self, texts):
        StubEspeak.calls.append((self.options, list(texts)))
        return ["ðɪs ɪz ɐ tˈɛst ."]


def stub_phonemizer(monkeypatch):
    StubEspeak.calls = []
    backend = types.ModuleType("phonemizer.backend")
    backend.EspeakBackend = StubEspeak
    package = types.ModuleType("phonemizer")
    package.backend = backend
    monkeypatch.setitem(sys.modules, "phonemizer", package)
    monkeypatch.setitem(sys.modules, "phonemizer.backend", backend)


def test_raw_text_is_phonemized_as_jax(monkeypatch):
    """`raw_text=True` runs the text through `text.phonemize` before
    encoding it, as the JAX Synthesizer's `inference(raw_text=True)` does:
    under the same stub backend the tokens, the durations and the waveform
    are JAX's, and equal the port's own run on the IPA it phonemized."""
    from styletts2_tpu import text as jtext
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer
    from styletts2_tpu_torch import text as ptext
    from styletts2_tpu_torch.inference import Synthesizer

    stub_phonemizer(monkeypatch)
    ipa = ptext.phonemize(RAW)
    assert ipa == jtext.phonemize(RAW)
    assert StubEspeak.calls[0] == (("en-us", True, True), ["This is a test."])
    np.testing.assert_array_equal(ptext.encode_text(ipa), jtext.encode_text(ipa))
    jcfg = jax_cfg()
    _, params = jax_models_and_params(jcfg, seed=8)
    jsyn = JaxSynthesizer(jcfg, params=params)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    noise = np.random.default_rng(9).standard_normal(
        (1, 1, 2 * jcfg.model_params.style_dim)).astype(np.float32)
    kw = dict(noise=noise, diffusion_steps=3, speed=4.0)
    with zero_noise(), stable_har_phase():
        want_wav, want_s = jsyn.inference(RAW, raw_text=True, **kw)
        got = psyn.synthesize(RAW, raw_text=True, **kw)
        from_ipa = psyn.synthesize(ipa, **kw)
    assert len(got.pred_dur) == len(ptext.encode_text(ipa))
    np.testing.assert_array_equal(got.pred_dur, from_ipa.pred_dur)
    np.testing.assert_array_equal(got.wav, from_ipa.wav)
    assert got.wav.shape == want_wav.shape
    assert rel_err(got.s_pred, want_s) < 1e-4
    assert rel_err(got.wav, want_wav) < 1e-3
    wav, _ = psyn.inference(RAW, raw_text=True, **kw)
    assert wav.shape == got.wav.shape


def test_server_phonemizes_raw_text(tmp_path, monkeypatch):
    """The server answers `"raw_text": true` by phonemizing the text (the
    JAX server's `handle_tts`), and with 501 where the phonemizer is not
    installed."""
    server = make_server(parse_args(["--config", str(_config(tmp_path)), "--device", "cpu",
                                     "--window-ms", "1"]))
    port = server.start_background()
    body = {"text": RAW, "raw_text": True, "diffusion_steps": 3, "speed": 8.0}
    try:
        monkeypatch.setitem(sys.modules, "phonemizer", None)  # not installed
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, body)
        assert err.value.code == 501
        stub_phonemizer(monkeypatch)
        code, wav = _post(port, body)
        assert code == 200 and StubEspeak.calls
        code, ipa_wav = _post(port, {**body, "text": "ðɪs ɪz ɐ tˈɛst .", "raw_text": False})
        assert code == 200 and wav == ipa_wav
    finally:
        server.close()


@pytest.mark.parametrize("kind", ["json", "yaml"])
def test_sigma_data_written_where_the_copy_has_no_line(tmp_path, kind):
    """A config copy without a sigma_data line gets
    model_params.diffusion.dist.sigma_data, the missing keys created (the
    JAX trainer's write-back): the finetune notebook's JSON config through
    json, a YAML one through PyYAML; the rest of the config as it was."""
    cfg = {"log_dir": "logs", "epochs_2nd": 1, "batch_size": 2,
           "data_params": {"train_data": "train_list.txt"},
           "loss_params": {"diff_epoch": 0, "joint_epoch": 100}}
    if kind == "json":  # the config examples/torch/finetune_demo.ipynb writes
        nb = json.loads(open("examples/torch/finetune_demo.ipynb").read())
        ns = {"root": "ft", "LITE": False}
        cell = next("".join(c["source"]) for c in nb["cells"]
                    if c["cell_type"] == "code" and "cfg = {" in "".join(c["source"]))
        exec(cell.split("if LITE:")[0], ns)
        cfg = ns["cfg"]
        path = tmp_path / "config_ft.json"
        path.write_text(json.dumps(cfg, indent=1))
    else:
        path = tmp_path / "config.yml"
        path.write_text(yaml.safe_dump(cfg))
    assert "sigma_data" not in path.read_text()
    line = run.write_sigma_data(str(path), 0.4321)
    assert line == "model_params.diffusion.dist.sigma_data: 0.4321"
    got = json.loads(path.read_text()) if kind == "json" else yaml.safe_load(path.read_text())
    assert got.pop("model_params") == {"diffusion": {"dist": {"sigma_data": 0.4321}}}
    assert got == cfg
    assert config_from_path(str(path)).model_params.diffusion.dist.sigma_data == 0.4321
    assert run.write_sigma_data(str(path), 0.5) == (
        '"sigma_data": 0.5' if kind == "json" else "sigma_data: 0.5")


def test_sigma_data_without_pyyaml_warns(tmp_path, monkeypatch, caplog):
    """Where PyYAML cannot be imported (the card), a YAML copy without the
    line is left as it is and the run's logger warns, naming the file; a
    JSON copy is written all the same."""
    path = tmp_path / "config.yml"
    path.write_text("log_dir: logs\nbatch_size: 2\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with caplog.at_level("WARNING", logger="styletts2_tpu_torch"):
        assert run.write_sigma_data(str(path), 0.25) is None
    assert path.read_text() == "log_dir: logs\nbatch_size: 2\n"
    assert any(str(path) in r.getMessage() and "PyYAML" in r.getMessage()
               for r in caplog.records if r.levelname == "WARNING")
    js = tmp_path / "config.json"
    js.write_text(json.dumps({"log_dir": "logs"}))
    assert run.write_sigma_data(str(js), 0.25) is not None
    assert json.loads(js.read_text())["model_params"]["diffusion"]["dist"]["sigma_data"] == 0.25
