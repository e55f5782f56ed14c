"""WavLM from a local Hugging Face directory without `transformers`
(`convert.wavlm_from_hf`, `convert.hf_model_dir`, `train/run.py:_load_wavlm`).

A tiny `transformers.WavLMModel` (hidden 48, 2 layers; the positional conv
at the port's kernel 128 and 16 groups) is written by `save_pretrained` as
`model.safetensors` and as `pytorch_model.bin`. The port's reader, through
the documented safetensors layout or `torch.load(weights_only=True)`, gives
the hidden states transformers gives (tolerance 1e-5 of each state's peak;
measured here: <= 1e-6) and those of the JAX package's `convert_wavlm` into
its own WavLM (1e-4: f32 in another framework). A hub name resolves through
the snapshot `refs/main` names in a cache under HF_HOME, and nothing else;
a changed conv kernel raises; a missing weight raises naming it; the
trainer's setup loads a directory (logging "loaded WavLM"), keeps the
random init without one, and warns naming the file when it is unreadable.
"""

import json
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.convert import convert_wavlm
from styletts2_tpu.models.wavlm import WavLM as JaxWavLM
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.convert import hf_model_dir, read_safetensors, wavlm_from_hf
from styletts2_tpu_torch.train import run

torch.set_num_threads(1)

WIDTHS = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64)


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """(the transformers model, its directory in each format)."""
    from transformers import WavLMConfig, WavLMModel

    torch.manual_seed(0)
    model = WavLMModel(WavLMConfig(**WIDTHS)).eval()
    with torch.no_grad():  # a trained-looking positional conv and gates, not the init's
        for name, p in model.named_parameters():
            if "pos_conv" in name or "gru_rel_pos" in name:
                p.add_(0.1 * torch.randn(p.shape))
    root = tmp_path_factory.mktemp("wavlm")
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        dirs[fmt] = str(root / fmt)
        model.save_pretrained(dirs[fmt], safe_serialization=safe)
    return model, dirs


def _wav():
    return np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_reader_matches_transformers_and_jax(hf, fmt):
    model, dirs = hf
    files = os.listdir(dirs[fmt])
    assert ("model.safetensors" in files) == (fmt == "safetensors")
    port = wavlm_from_hf(dirs[fmt]).eval()
    wav = _wav()
    with torch.no_grad():
        want = [h.numpy() for h in model(torch.from_numpy(wav), output_hidden_states=True).hidden_states]
        got = [h.numpy() for h in port(torch.from_numpy(wav))]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jax_states = JaxWavLM(hidden=48, heads=4, intermediate=64, num_layers=2).apply(
        convert_wavlm(sd, num_layers=2), jnp.asarray(wav))
    assert len(got) == len(want) == len(jax_states) == 3
    for g, w, j in zip(got, want, jax_states):
        peak = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-5 * peak
        assert np.abs(g - np.asarray(j)).max() <= 1e-4 * peak


def test_safetensors_reader_reads_every_tensor(hf):
    model, dirs = hf
    got = read_safetensors(os.path.join(dirs["safetensors"], "model.safetensors"))
    want = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_hub_name_resolves_from_the_local_cache_only(hf, tmp_path, monkeypatch):
    _, dirs = hf
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert hf_model_dir("acme/wavlm-tiny") is None
    repo = tmp_path / "hf" / "hub" / "models--acme--wavlm-tiny"
    shutil.copytree(dirs["bin"], repo / "snapshots" / "abc123")
    (repo / "snapshots" / "old").mkdir()
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123\n")
    path = hf_model_dir("acme/wavlm-tiny")
    assert path == str(repo / "snapshots" / "abc123")
    assert hf_model_dir(dirs["bin"]) == dirs["bin"]  # a directory is itself
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "elsewhere"))
    assert hf_model_dir("acme/wavlm-tiny") is None  # HF_HUB_CACHE comes first


def test_a_changed_conv_kernel_or_a_missing_weight_raises(hf, tmp_path):
    _, dirs = hf
    bad = tmp_path / "bad"
    shutil.copytree(dirs["bin"], bad)
    cfg = json.loads((bad / "config.json").read_text())
    cfg["conv_kernel"] = [10, 3, 3, 3, 3, 2, 3]
    (bad / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="conv_kernel"):
        wavlm_from_hf(str(bad))
    missing = tmp_path / "missing"
    shutil.copytree(dirs["bin"], missing)
    sd = torch.load(missing / "pytorch_model.bin", weights_only=True)
    del sd["encoder.layer_norm.weight"]
    torch.save(sd, missing / "pytorch_model.bin")
    with pytest.raises(KeyError, match="encoder.layer_norm.weight"):
        wavlm_from_hf(str(missing))


def test_setup_loads_the_directory_or_keeps_the_random_init(hf, tmp_path, caplog):
    model, dirs = hf
    cfg = Config()
    cfg.model_params.slm.hidden, cfg.model_params.slm.nlayers = 48, 3
    logger = logging.getLogger("test_torch_wavlm_hf")
    models = {"wavlm": None}
    cfg.model_params.slm.model = dirs["safetensors"]
    with caplog.at_level(logging.INFO, logger="test_torch_wavlm_hf"):
        run._load_wavlm(models, cfg, logger)
    assert f"loaded WavLM from {dirs['safetensors']}" in caplog.text
    got = models["wavlm"].state_dict()["encoder.layers.1.feed_forward.output_dense.weight"]
    assert torch.equal(got, model.state_dict()["encoder.layers.1.feed_forward.output_dense.weight"])

    models, absent = {"wavlm": "init"}, str(tmp_path / "absent")
    cfg.model_params.slm.model = absent
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="test_torch_wavlm_hf"):
        run._load_wavlm(models, cfg, logger)
    assert models["wavlm"] == "init" and "WavLM at random init" in caplog.text

    broken = tmp_path / "broken"
    shutil.copytree(dirs["bin"], broken)
    (broken / "pytorch_model.bin").write_bytes(b"not a checkpoint")
    cfg.model_params.slm.model = str(broken)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="test_torch_wavlm_hf"):
        run._load_wavlm(models, cfg, logger)
    assert models["wavlm"] == "init"
    assert any(r.levelno == logging.WARNING and "pytorch_model.bin" in r.getMessage()
               for r in caplog.records), caplog.text
