"""The port's serving layer (styletts2_tpu_torch.serve), mirroring
tests/test_serve.py: the micro-batcher with a fake synthesizer (fusion,
splitting of incompatible settings, per-request errors), the HTTP
endpoints, and end-to-end requests through a tiny multispeaker port model
on the CPU, with a voice table read from a WAV file and a checkpoint loaded
strictly. It imports neither JAX nor the JAX package.
"""

import io
import json
import threading
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from styletts2_tpu_torch.config import libritts_config
from styletts2_tpu_torch.serve import (Batcher, TTSServer, _Request, load_synthesizer, main,
                                       make_server, parse_args, wav_bytes)

torch.set_num_threads(1)  # the suite runs in several worker processes on a few cores


def _params(**kw):
    return (float(kw.get("alpha", 0.3)), float(kw.get("beta", 0.7)), int(kw.get("steps", 5)),
            float(kw.get("scale", 1.0)), float(kw.get("speed", 1.0)), int(kw.get("seed", 0)))


class FakeSynthesizer:
    """Records its calls; a deterministic waveform per text."""

    style_dim = 128
    multispeaker = True

    def __init__(self):
        self.calls = []

    def _wav(self, text):
        return np.full(1200 + 10 * len(text), 0.25, np.float32)

    def inference_batch(self, texts, ref_s=None, **kw):
        assert ref_s is None or ref_s.shape == (len(texts), 256)
        self.calls.append(("batch", list(texts)))
        return [self._wav(t) for t in texts]


def _submit_all(batcher, reqs):
    threads = [threading.Thread(target=batcher.submit, args=(r,)) for r in reqs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)


def test_wav_bytes_roundtrip():
    data = np.sin(np.linspace(0, 20, 2400)).astype(np.float32) * 0.5
    with wave.open(io.BytesIO(wav_bytes(data, 24000))) as f:
        assert (f.getframerate(), f.getnchannels(), f.getnframes()) == (24000, 1, 2400)
        pcm = np.frombuffer(f.readframes(2400), np.int16)
    np.testing.assert_allclose(pcm / 32767.0, data, atol=1 / 32000)


def test_batcher_fuses_concurrent_requests():
    syn = FakeSynthesizer()
    b = Batcher(syn, max_batch=8, window_ms=200)
    try:
        reqs = [_Request(text=f"t{i}", ref_s=None, params=_params()) for i in range(4)]
        _submit_all(b, reqs)
        assert all(r.wav is not None and r.error is None for r in reqs)
        assert [k for k, _ in syn.calls] == ["batch"]  # one batched call (window >> skew)
        assert sorted(syn.calls[0][1]) == ["t0", "t1", "t2", "t3"]
        assert b.stats == {"requests": 4, "batches": 1, "batched_requests": 4}
    finally:
        b.close()


def test_batcher_splits_incompatible_params():
    syn = FakeSynthesizer()
    b = Batcher(syn, max_batch=8, window_ms=150)
    try:
        r1 = _Request(text="a", ref_s=None, params=_params(steps=5))
        r2 = _Request(text="b", ref_s=None, params=_params(steps=10))
        _submit_all(b, [r1, r2])
        assert r1.error is None and r2.error is None
        assert syn.calls == [("batch", ["a"]), ("batch", ["b"])]  # a lone request is a batch of 1
    finally:
        b.close()


def test_batcher_surfaces_errors_per_request():
    class Boom(FakeSynthesizer):
        def inference_batch(self, *a, **kw):
            raise RuntimeError("decoder exploded")

    b = Batcher(Boom(), max_batch=1, window_ms=1)
    try:
        r = b.submit(_Request(text="x", ref_s=None, params=_params()))
        assert r.wav is None and "decoder exploded" in r.error
        ok = b.submit(_Request(text="y", ref_s=None, params=_params(steps=3)))
        assert "decoder exploded" in ok.error  # the worker keeps serving after a failure
    finally:
        b.close()


def _post(port, obj, path="/tts"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())


def test_http_endpoints_with_fake_synth():
    server = TTSServer(FakeSynthesizer(), voices={"v": np.zeros((1, 256), np.float32)})
    port = server.start_background()
    try:
        health = _get(port, "/healthz")
        assert health["status"] == "ok" and health["voices"] == ["v"] and health["multispeaker"]
        assert _get(port, "/voices") == {"voices": ["v"]}
        code, ctype, body = _post(port, {"text": "həlˈoʊ", "voice": "v"})
        assert code == 200 and ctype == "audio/wav"
        with wave.open(io.BytesIO(body)) as f:
            assert f.getframerate() == 24000 and f.getnframes() > 0
        assert _post(port, {"voice": "v"})[0] == 400  # no text
        assert _post(port, {"text": "x", "voice": "nope"})[0] == 400
        assert _post(port, {"text": "hello", "raw_text": True})[0] == 501  # no phonemizer
        assert _post(port, {"text": "x"}, path="/nope")[0] == 404
    finally:
        server.close()


def _tiny_libritts():
    cfg = libritts_config()
    cfg.plbert_params.num_hidden_layers = 1
    cfg.plbert_params.hidden_size = 64
    cfg.plbert_params.intermediate_size = 128
    cfg.plbert_params.num_attention_heads = 2
    cfg.model_params.hidden_dim = 64
    cfg.model_params.style_dim = 32
    cfg.model_params.dim_in = 16
    cfg.model_params.diffusion.transformer.num_layers = 1
    cfg.model_params.decoder.upsample_initial_channel = 64
    return cfg


def test_http_end_to_end_tiny_model(tmp_path):
    """Two concurrent requests with a voice from a 22.05 kHz WAV through a
    tiny multispeaker port model on the CPU come back as valid 24 kHz WAVs of
    sum(durations) * 600 - 50 samples and share one batch."""
    from styletts2_tpu_torch.inference import Synthesizer

    syn = Synthesizer(_tiny_libritts(), seed=0, device="cpu")
    n = np.arange(33075)  # 1.5 s at 22.05 kHz, resampled to 24 kHz
    pcm = (0.3 * np.sin(2 * np.pi * 150.0 * n / 22050) * 32767).astype(np.int16)
    with wave.open(str(tmp_path / "anna.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(22050)
        f.writeframes(pcm.tobytes())
    voices = TTSServer.load_voices(syn, str(tmp_path))
    assert list(voices) == ["anna"] and voices["anna"].shape == (1, 64)
    server = TTSServer(syn, voices, max_batch=4, window_ms=3000)
    port = server.start_background()
    try:
        results = {}

        def go(name, text):
            results[name] = _post(port, {"text": text, "voice": "anna", "diffusion_steps": 3,
                                         "speed": 4.0})

        threads = [threading.Thread(target=go, args=("a", "ðɪs ɪz ɐ tˈɛst.")),
                   threading.Thread(target=go, args=("b", "sˈɛkənd lˈaɪn."))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        for name in ("a", "b"):
            code, ctype, body = results[name]
            assert code == 200 and ctype == "audio/wav", body[:200]
            with wave.open(io.BytesIO(body)) as f:
                assert f.getframerate() == 24000
                frames = f.getnframes()
            assert frames > 600 and (frames + 50) % 600 == 0
        assert _get(port, "/healthz")["stats"]["batched_requests"] == 2
    finally:
        server.close()


def test_load_synthesizer_checkpoint_and_device(tmp_path):
    """--ckpt loads a {"net": {module: state_dict}} file strictly, and
    --device cuda without a card is an error, not a fall-back to the CPU."""
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.inference import Synthesizer

    cfg_path = tmp_path / "tiny.yml"
    cfg = _tiny_libritts()
    cfg_path.write_text(
        "log_dir: Models/LibriTTS\nepochs_1st: 50\nepochs_2nd: 30\nmax_len: 300\n"
        "loss_params:\n  TMA_epoch: 5\n  diff_epoch: 10\n  joint_epoch: 30\n"
        "model_params:\n  multispeaker: true\n  dim_in: 16\n  hidden_dim: 64\n  style_dim: 32\n"
        "  decoder:\n    type: hifigan\n    upsample_rates: [10, 5, 3, 2]\n"
        "    upsample_kernel_sizes: [20, 10, 6, 4]\n    upsample_initial_channel: 64\n"
        "  diffusion:\n    transformer:\n      num_layers: 1\n"
        "plbert_params:\n  num_hidden_layers: 1\n  hidden_size: 64\n  intermediate_size: 128\n"
        "  num_attention_heads: 2\n")
    assert load_config(str(cfg_path)) == cfg
    src = Synthesizer(cfg, seed=5, device="cpu")
    net = {}
    for name, v in src.models.state_dict().items():
        mod, rest = name.split(".", 1)
        net.setdefault(mod, {})[rest] = v
    torch.save({"net": net}, tmp_path / "net.pt")
    syn = load_synthesizer(str(cfg_path), str(tmp_path / "net.pt"), device="cpu")
    assert (syn.multispeaker, syn.hifigan, syn.style_dim) == (True, True, 32)
    for k, v in syn.models.state_dict().items():
        assert torch.equal(v, src.models.state_dict()[k]), k
    del net["style_encoder"]["unshared.bias"]
    torch.save({"net": net}, tmp_path / "short.pt")
    with pytest.raises(RuntimeError, match="unshared.bias"):
        load_synthesizer(str(cfg_path), str(tmp_path / "short.pt"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", str(cfg_path), "--device", "cuda"])


def test_main_builds_the_repo_configs_without_pyyaml(monkeypatch):
    """The card has no PyYAML: the CLI's config path builds configs/config.yml
    and configs/config_libritts.yml without importing it, and with yaml
    blocked `main` gets as far as the missing card."""
    import sys

    from styletts2_tpu_torch.config import Config, config_from_path, libritts_config

    monkeypatch.chdir(Path(__file__).resolve().parents[1])  # the CLI's paths are the repo's
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises ImportError
    assert config_from_path("configs/config.yml") == Config()
    assert config_from_path("configs/config_libritts.yml") == libritts_config()
    with pytest.raises(ImportError):
        config_from_path(__file__)  # any other file goes through load_config
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", "configs/config_libritts.yml"])
    args = parse_args(["--config", "configs/config_libritts.yml", "--device", "cpu"])
    assert (args.max_batch, args.window_ms, args.port) == (8, 15.0, 8760)


def test_make_server_runs_the_cli_path(tmp_path):
    """`make_server` of parsed CLI arguments (a tiny YAML config, a voice
    directory, the CPU) answers a request; a lone request goes through
    inference_batch and equals `inference` of the same text."""
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(
        "model_params:\n  multispeaker: true\n  dim_in: 16\n  hidden_dim: 64\n  style_dim: 32\n"
        "  decoder:\n    type: hifigan\n    upsample_rates: [10, 5, 3, 2]\n"
        "    upsample_kernel_sizes: [20, 10, 6, 4]\n    upsample_initial_channel: 64\n"
        "  diffusion:\n    transformer:\n      num_layers: 1\n"
        "plbert_params:\n  num_hidden_layers: 1\n  hidden_size: 64\n  intermediate_size: 128\n"
        "  num_attention_heads: 2\n")
    vdir = tmp_path / "voices"
    vdir.mkdir()
    n = np.arange(36000)  # 1.5 s at 24 kHz
    with wave.open(str(vdir / "v.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(24000)
        f.writeframes((0.3 * np.sin(2 * np.pi * 180.0 * n / 24000) * 32767).astype(np.int16).tobytes())
    server = make_server(parse_args(["--config", str(cfg_path), "--voices", str(vdir),
                                     "--device", "cpu", "--window-ms", "1"]))
    port = server.start_background()
    try:
        text, kw = "ðɪs ɪz ɐ tˈɛst.", {"diffusion_steps": 3, "speed": 4.0, "seed": 2}
        code, ctype, body = _post(port, dict(kw, text=text, voice="v"))
        assert code == 200 and ctype == "audio/wav", body[:200]
        want, _ = server.syn.inference(text, ref_s=server.voices["v"], **kw)
        assert body == wav_bytes(want)
    finally:
        server.close()
