"""The reference's own checkpoints on the port: `convert.state_dict_from_reference`
against the JAX package's `convert_styletts2_checkpoint`, `serve --ckpt`
and the demo CLI on a reference-layout file, PL-BERT's `step_N.t7`, and
the demo's WAV writing and resampling against the JAX package's.

The reference-layout files are made as chip_smoke.py makes them
(`reference_net`: `module.` prefixes, the diffusion UNet under `unet.` and
again under `diffusion.net.`, ALBERT's pooler and position ids, each LSTM
bias split into two nonzero halves) from seeded weights; no public
checkpoint is read.

Tolerances of the JAX comparison are those of test_torch_synth.py and
test_torch_multispeaker.py: equal durations, the style within 1e-4 of its
peak, the waveform within 1e-3 of its peak, random draws zeroed on both
sides and the NSF source's chaotic parts zeroed (the STFT phase for
iSTFTNet, the harmonic sines for HiFi-GAN). The LSTM bias split changes
only rounding: b - r + r against b.
"""

import logging
import wave

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import reference_net
from styletts2_tpu.convert import convert_styletts2_checkpoint
from styletts2_tpu_torch.config import Config, config_from_path
from styletts2_tpu_torch.convert import state_dict_from_jax, state_dict_from_reference
from styletts2_tpu_torch.inference import Synthesizer
from styletts2_tpu_torch.models.build import build_models, module_keys
from styletts2_tpu_torch.models.plbert import PLBERT
from test_torch_train_run import TINY
from torch_parity import (jax_cfg, jax_models_and_params, jax_ms_cfg, port_cfg, rel_err,
                          stable_har_phase, zero_noise, zero_sines)

TEXT = "ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt."


def _numpy_net(net):
    return {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in net.items()}


@pytest.mark.parametrize("multispeaker", [False, True], ids=["istftnet", "hifigan_ms"])
def test_reference_file_synthesises_as_jax(multispeaker):
    """One reference-layout `net`, read by the JAX package's converter into
    its Synthesizer and by the port's reader into the port's, synthesises
    the same durations, style and waveform."""
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer

    jcfg = jax_ms_cfg() if multispeaker else jax_cfg()
    _, params = jax_models_and_params(jcfg, seed=31)
    pcfg = port_cfg(jcfg)
    net = reference_net(state_dict_from_jax(params, pcfg), seed=1)
    assert set(net["diffusion"]) >= {"module.unet.to_out.1.weight",
                                     "module.diffusion.net.to_out.1.weight"}
    assert float(net["text_encoder"]["module.lstm.bias_hh_l0"].abs().min()) > 0
    jsyn = JaxSynthesizer(jcfg, params=convert_styletts2_checkpoint({"net": _numpy_net(net)}, jcfg))
    psyn = Synthesizer(pcfg, state_dict=state_dict_from_reference(net, pcfg), device="cpu")
    rng = np.random.default_rng(32)
    noise = rng.standard_normal((1, 1, 2 * psyn.style_dim)).astype(np.float32)
    kw = dict(noise=noise, speed=4.0)
    if multispeaker:
        kw["ref_s"] = rng.standard_normal((1, 2 * psyn.style_dim)).astype(np.float32)
    seen = {}
    get_phase_b = jsyn._get_phase_b

    def spy(n_frames):  # records the durations the JAX decoder stage gets
        pb = get_phase_b(n_frames)

        def run(params_, t_en, d, s, ref, pred_dur, key, pcm16=False):
            seen["pred_dur"] = np.asarray(pred_dur)
            return pb(params_, t_en, d, s, ref, pred_dur, key, pcm16=pcm16)

        return run

    jsyn._get_phase_b = spy
    with zero_noise(), (zero_sines() if multispeaker else stable_har_phase()):
        want_wav, want_s = jsyn.inference(TEXT, **kw)
        got = psyn.synthesize(TEXT, **kw)
    np.testing.assert_array_equal(got.pred_dur, seen["pred_dur"][0, : len(got.pred_dur)])
    assert rel_err(got.s_pred, want_s) < 1e-4
    assert got.wav.shape == want_wav.shape and np.isfinite(got.wav).all()
    assert rel_err(got.wav, want_wav) < 1e-3


def _tiny(multispeaker=False):
    cfg = Config.from_dict({"model_params": dict(TINY, multispeaker=multispeaker)})
    cfg.plbert_params.num_hidden_layers = 1
    cfg.plbert_params.hidden_size = 64
    cfg.plbert_params.intermediate_size = 128
    cfg.plbert_params.num_attention_heads = 2
    cfg.model_params.diffusion.transformer.num_layers = 1
    return cfg


def _config_file(tmp_path, cfg):
    import dataclasses

    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    assert config_from_path(str(path)) == cfg
    return path


def test_reader_strips_the_reference_layout_and_logs_what_it_leaves(caplog):
    """The reader returns the port's own state_dict from a reference-layout
    `net` (the LSTM halves summing to the port's bias), from the port's own
    layout unchanged, and logs in one line the names nothing reads."""
    cfg = _tiny()
    sd = build_models(cfg, torch.Generator().manual_seed(2)).state_dict()
    net = reference_net(sd, seed=3)
    net["decoder"]["module.unused_extra"] = torch.zeros(3)
    with caplog.at_level(logging.INFO, logger="styletts2_tpu_torch.convert"):
        got = state_dict_from_reference(net, cfg)
    assert got.keys() == sd.keys()
    for name, v in sd.items():
        if "bias_ih" in name or "bias_hh" in name:
            continue
        assert torch.equal(got[name], v), name
    lstm = "text_encoder.lstm.bias_{}_l0"
    assert not torch.equal(got[lstm.format("hh")], sd[lstm.format("hh")])
    torch.testing.assert_close(got[lstm.format("ih")] + got[lstm.format("hh")],
                               sd[lstm.format("ih")] + sd[lstm.format("hh")], rtol=0, atol=1e-6)
    lines = [r.getMessage() for r in caplog.records if "nothing reads" in r.getMessage()]
    assert len(lines) == 1
    for unread in ("decoder.unused_extra", "bert.pooler.weight", "bert.embeddings.position_ids",
                   "diffusion.diffusion.net."):
        assert unread in lines[0], unread

    own = {k: {n[len(k) + 1:]: v for n, v in sd.items() if n.startswith(k + ".")}
           for k in module_keys(cfg)}
    back = state_dict_from_reference(own, cfg)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_reader_names_what_the_file_lacks():
    cfg = _tiny()
    net = reference_net(build_models(cfg, torch.Generator().manual_seed(2)).state_dict())
    del net["predictor"]["module.F0_proj.weight"]
    with pytest.raises(RuntimeError, match=r"module 'predictor'.*'F0_proj.weight'"):
        state_dict_from_reference(net, cfg)
    del net["decoder"]
    with pytest.raises(RuntimeError, match="decoder"):
        state_dict_from_reference(net, cfg)


def test_reader_reads_only_synthesis_modules():
    """A training-only module (the WavLM discriminator) is refused by name."""
    cfg = _tiny()
    net = reference_net(build_models(cfg, torch.Generator().manual_seed(2)).state_dict())
    net["wd"] = {"module.out.weight": torch.zeros(1)}
    with pytest.raises(ValueError, match=r"not a synthesis module.*'wd'"):
        state_dict_from_reference(net, cfg, keys=("bert", "wd"))


def test_serve_and_demo_read_a_reference_file(tmp_path, capsys):
    """`serve --ckpt` loads a multispeaker reference-layout file into the
    Synthesizer the CLI builds, with the same weights as the port's layout
    (the LSTM bias sums) and the config's sigma_data; the demo CLI on the
    CPU writes a 24 kHz WAV that read_wav reads back, with `--ref_wav` at
    22.05 kHz and with `--longform`."""
    from styletts2_tpu_torch import demo
    from styletts2_tpu_torch.serve import make_server, parse_args
    from styletts2_tpu_torch.utils import read_wav, write_wav

    cfg = _tiny(multispeaker=True)
    cfg_path = _config_file(tmp_path, cfg)
    sd = build_models(cfg, torch.Generator().manual_seed(4)).state_dict()
    ckpt = tmp_path / "epochs_2nd_00020.pth"
    torch.save({"net": reference_net(sd, seed=5), "epoch": 20, "iters": 100}, ckpt)
    server = make_server(parse_args(["--config", str(cfg_path), "--ckpt", str(ckpt),
                                     "--device", "cpu"]))
    server.close()
    assert server.syn.sigma_data == cfg.model_params.diffusion.dist.sigma_data
    got = server.syn.models.state_dict()
    assert got.keys() == sd.keys()
    for name, v in sd.items():
        if "bias_hh" in name:
            continue
        if "bias_ih" in name:
            hh = name.replace("bias_ih", "bias_hh")
            torch.testing.assert_close(got[name] + got[hh], v + sd[hh], rtol=0, atol=1e-6)
        else:
            assert torch.equal(got[name], v), name

    voice = tmp_path / "voice.wav"
    n = np.arange(int(2.5 * 22050))
    write_wav(str(voice), 0.3 * np.sin(2 * np.pi * 150.0 * n / 22050), 22050)
    for extra in ([], ["--longform"]):
        out = tmp_path / f"out{len(extra)}.wav"
        demo.main(["--text", "hˈɛloʊ. ðɪs ɪz ɐ tˈɛst.", "--out", str(out), "--config",
                   str(cfg_path), "--ckpt", str(ckpt), "--ref_wav", str(voice), "--steps", "3",
                   "--device", "cpu", *extra])
        wav, sr = read_wav(str(out))
        assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
        assert f"wrote {out}:" in capsys.readouterr().out


def test_demo_defaults_to_the_card(monkeypatch):
    from styletts2_tpu_torch import demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert demo.parse_args(["--text", "a"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--text", "hˈɛloʊ."])


def test_write_wav_and_resample_linear_match_jax(tmp_path):
    from styletts2_tpu import utils as ju
    from styletts2_tpu_torch import utils as pu

    rng = np.random.default_rng(40)
    x = (0.6 * rng.standard_normal(22050)).astype(np.float32)  # clipped where |x| > 1
    for sr_in, sr_out in ((22050, 24000), (24000, 16000), (24000, 24000)):
        np.testing.assert_array_equal(pu.resample_linear(x, sr_in, sr_out),
                                      ju.resample_linear(x, sr_in, sr_out))
    ju.write_wav(str(tmp_path / "jax.wav"), x, 24000)
    pu.write_wav(str(tmp_path / "port.wav"), x, 24000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    with wave.open(str(tmp_path / "port.wav")) as f:
        assert (f.getframerate(), f.getnchannels(), f.getsampwidth()) == (24000, 1, 2)


def _plbert_file(path, cfg, seed):
    """A PL-BERT pretraining checkpoint as the reference's Utils/PLBERT holds
    it: {"net": ...} of a DataParallel MultiTaskModel whose `encoder` is the
    ALBERT (its pooler included) beside the pretraining heads."""
    bert = PLBERT(cfg.plbert_params)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in bert.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    H = cfg.plbert_params.hidden_size
    net = {f"module.encoder.{k}": v for k, v in bert.state_dict().items()}
    net["module.encoder.pooler.weight"] = torch.randn((H, H), generator=g)
    net["module.encoder.pooler.bias"] = torch.zeros(H)
    net["module.mask_predictor.weight"] = torch.randn((7, H), generator=g)
    torch.save({"net": net, "step": seed}, path)
    return bert


def test_plbert_loads_from_the_newest_step(tmp_path, caplog):
    from styletts2_tpu_torch.train import run

    cfg = _tiny()
    cfg.PLBERT_dir = str(tmp_path)
    logger = logging.getLogger("test_plbert")
    models = torch.nn.ModuleDict({"bert": PLBERT(cfg.plbert_params)})
    with caplog.at_level(logging.INFO, logger="test_plbert"):
        run._load_plbert(models, cfg, logger)
    assert "PL-BERT at random init" in caplog.text

    want = _plbert_file(tmp_path / "step_1.t7", cfg, seed=1)
    run._load_plbert(models, cfg, logger)
    for name, v in want.state_dict().items():
        assert torch.equal(models["bert"].state_dict()[name], v), name

    _plbert_file(tmp_path / "step_99.t7", cfg, seed=99)
    want = _plbert_file(tmp_path / "step_100.t7", cfg, seed=100)  # "step_99" sorts after it
    with caplog.at_level(logging.INFO, logger="test_plbert"):
        run._load_plbert(models, cfg, logger)
    assert "loaded PL-BERT from" in caplog.text and "step_100.t7" in caplog.text
    for name, v in want.state_dict().items():
        assert torch.equal(models["bert"].state_dict()[name], v), name
