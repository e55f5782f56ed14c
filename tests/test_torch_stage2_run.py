"""The port's `second` and `finetune` entry points on the CPU at tiny widths,
on tests/test_torch_train_run.py's fixture: stage 1 writes
`first_stage.pth`; stage 2 takes the first stage's handoff (the stage-2
modules at their init, predictor_encoder a copy of style_encoder), trains,
writes `epoch_2nd_00001.pth`, `second_final.pth` and sigma_data into its
config copy, and a second call resumes without being asked; finetuning
starts from `second_final.pth`'s weights alone (`load_only_params`).
`run.start` picks each stage's start point: its epoch file, a
`pretrained_model` (stage 2 only under `second_stage_load_pretrained`), the
first stage's handoff.
Also: `configs/config_ft.yml` builds without PyYAML and equals the JAX
package's loaded file, and the sigma_data write-back keeps every other
field of a YAML file. The entry points build a 2-layer WavLM and
discriminators of one period and one resolution here: the plumbing does
not depend on their size, and the full ones take most of the CPU time.
"""

import dataclasses
import json
import logging
import shutil
import types

import pytest
import torch
import yaml

from styletts2_tpu_torch.config import (REPO_CONFIGS, Config, config_from_path, finetune_config,
                                        load_config)
from styletts2_tpu_torch.models import build as pbuild
from styletts2_tpu_torch.models.build import STAGE2_MODULES, TRAIN_MODULES
from styletts2_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                       MultiResSpecDiscriminator)
from styletts2_tpu_torch.models.wavlm import WavLM
from styletts2_tpu_torch.train import run
from test_torch_train_run import TINY, _fixture
from torch_parity import port_cfg

WAVLM = dict(hidden=32, heads=2, intermediate=48, num_layers=2)


@pytest.fixture
def small_aux_models(monkeypatch):
    monkeypatch.setattr(pbuild, "WavLM", lambda: WavLM(**WAVLM))
    monkeypatch.setattr(pbuild, "MultiPeriodDiscriminator",
                        lambda: MultiPeriodDiscriminator(periods=(3,)))
    monkeypatch.setattr(pbuild, "MultiResSpecDiscriminator", lambda: MultiResSpecDiscriminator(
        fft_sizes=(512,), hop_sizes=(50,), win_lengths=(240,)))


def _yaml(path, log_dir, data, **fields):
    params = {"log_dir": str(log_dir), "epochs_1st": 1, "epochs_2nd": 1, "batch_size": 2,
              "max_len": 80, "save_freq": 1, "log_interval": 1,
              "data_params": {"train_data": str(data / "train.txt"),
                              "val_data": str(data / "val.txt"), "root_path": str(data),
                              "OOD_data": str(data / "ood.txt"), "min_length": 10},
              "model_params": dict(TINY, diffusion={"dist": {"sigma_data": 0.2}},
                                   slm={"hidden": WAVLM["hidden"], "nlayers": 3}),
              "slmadv_params": {"min_len": 80, "max_len": 120}}
    for k, v in fields.items():
        params[k] = dict(params.get(k, {}), **v) if isinstance(v, dict) else v
    path.write_text(yaml.safe_dump(params))
    return path


def test_finetune_config_is_config_ft_yml():
    from styletts2_tpu.config import load_config as jax_load_config

    path = f"{REPO_CONFIGS}/config_ft.yml"
    assert config_from_path(path) == finetune_config() == load_config(path)
    assert port_cfg(jax_load_config(path)) == finetune_config()
    assert finetune_config() != Config()


def test_sigma_data_write_back_keeps_the_rest(tmp_path):
    path = tmp_path / "config.yml"
    shutil.copy(f"{REPO_CONFIGS}/config.yml", path)
    before = yaml.safe_load(path.read_text())
    line = run.write_sigma_data(str(path), 0.1234)
    after = yaml.safe_load(path.read_text())
    assert line == "sigma_data: 0.1234"
    assert after["model_params"]["diffusion"]["dist"].pop("sigma_data") == 0.1234
    before["model_params"]["diffusion"]["dist"].pop("sigma_data")
    assert after == before
    # a Config written as JSON, as run_stage writes one
    js = tmp_path / "config.json"
    js.write_text(json.dumps(dataclasses.asdict(Config()), indent=2))
    assert run.write_sigma_data(str(js), 0.5) == '"sigma_data": 0.5,'
    assert yaml.safe_load(js.read_text())["model_params"]["diffusion"]["dist"]["sigma_data"] == 0.5
    # a copy without the line gets the keys (test_torch_repairs.py has the cases)
    (tmp_path / "none.yml").write_text("log_dir: x\n")
    assert run.write_sigma_data(str(tmp_path / "none.yml"), 0.5) is not None
    assert yaml.safe_load((tmp_path / "none.yml").read_text()) == {
        "log_dir": "x", "model_params": {"diffusion": {"dist": {"sigma_data": 0.5}}}}


@pytest.mark.parametrize("stage,flag,epoch_file,pretrained,first,want", [
    ("second", True, True, True, True, "resume"),  # its own epoch file first
    ("second", True, False, True, True, "pretrained"),  # a stage-2 checkpoint: no handoff
    ("second", False, False, True, True, "first"),  # the first stage's handoff
    ("second", True, False, False, True, "first"),  # no such file: the handoff
    ("second", True, False, False, False, None),  # nothing: the seeded init
    ("finetune", False, False, True, True, "pretrained"),  # whatever the flag
    ("finetune", True, False, False, True, None),  # never the first stage
])
def test_start_point(tmp_path, monkeypatch, stage, flag, epoch_file, pretrained, first, want):
    cfg = Config(log_dir=str(tmp_path), pretrained_model=str(tmp_path / "pre.pth"),
                 second_stage_load_pretrained=flag, load_only_params=True)
    for name, there in ((f"{run.CKPT_PREFIX[stage]}00001.pth", epoch_file), ("pre.pth", pretrained),
                        (cfg.first_stage_path, first)):
        if there:
            (tmp_path / name).write_bytes(b"")
    calls = []
    monkeypatch.setattr(run, "load_checkpoint", lambda path, state, load_only_params=False: calls.append(
        "pretrained" if path == cfg.pretrained_model and load_only_params else "resume"))
    monkeypatch.setattr(run, "_load_first_stage", lambda state, path, logger: calls.append("first"))
    run.start(stage, cfg, types.SimpleNamespace(epoch=1), logging.getLogger("t"))
    assert calls == ([want] if want else [])


def test_second_and_finetune_clis(tmp_path, capsys, small_aux_models):
    data, log_dir, ft_dir = tmp_path / "data", tmp_path / "logs", tmp_path / "ft"
    data.mkdir()
    _fixture(data)
    stage2 = {"loss_params": {"TMA_epoch": 1, "diff_epoch": 5, "joint_epoch": 5}}
    cfg_path = _yaml(tmp_path / "cfg.yml", log_dir, data, save_freq=5, **stage2)
    try:
        run.main(["first", "--config_path", str(cfg_path), "--max_steps", "1", "--device", "cpu"])
        first = torch.load(log_dir / "first_stage.pth", map_location="cpu", weights_only=True)

        # the handoff alone: stage-1 weights, predictor_encoder = style_encoder
        cfg = load_config(str(cfg_path))
        state, _, _ = run.setup(cfg, torch.device("cpu"), logging.getLogger("t"), "second")
        init = {k: {n: p.clone() for n, p in state.models[k].state_dict().items()}
                for k in ("bert", "predictor", "diffusion", "wd", "mpd")}
        run._load_first_stage(state, str(log_dir / "first_stage.pth"), logging.getLogger("t"))
        se, pe = state.models["style_encoder"].state_dict(), state.models["predictor_encoder"].state_dict()
        assert se.keys() == pe.keys() and all(torch.equal(se[n], pe[n]) for n in se)
        assert any(n.endswith("weight_u") for n in pe)  # the spectral-norm vectors came too
        for n, p in state.models["text_encoder"].state_dict().items():
            assert torch.equal(p, first["net"]["text_encoder"][n])
        for k, sd in init.items():  # not taken from the first stage
            assert all(torch.equal(p, sd[n]) for n, p in state.models[k].state_dict().items()), k
        assert (state.step, state.epoch, state.sigma_data) == (0, 0, 0.2)
        del state

        _yaml(cfg_path, log_dir, data, **stage2)  # an epoch file every epoch
        capsys.readouterr()
        run.main(["second", "--config_path", str(cfg_path), "--max_steps", "1", "--device", "cpu"])
        err = capsys.readouterr().err
        assert f"loaded first stage from {log_dir / 'first_stage.pth'}" in err
        assert "epoch 0 it 1: mel=" in err and "validation mel" in err
        ckpt = torch.load(log_dir / "second_final.pth", map_location="cpu", weights_only=True)
        assert set(ckpt) == {"net", "optimizer", "iters", "epoch", "sigma_data"}
        assert set(ckpt["net"]) == set(TRAIN_MODULES + STAGE2_MODULES)  # no WavLM
        assert (ckpt["iters"], ckpt["epoch"]) == (1, 1)
        assert (log_dir / "epoch_2nd_00001.pth").exists()
        written = yaml.safe_load((log_dir / "cfg.yml").read_text())
        assert written["model_params"]["diffusion"]["dist"]["sigma_data"] == ckpt["sigma_data"]
        assert f"sigma_data {ckpt['sigma_data']!r} written into {log_dir / 'cfg.yml'}" in err

        _yaml(cfg_path, log_dir, data, epochs_2nd=2, save_freq=5, **stage2)  # one more epoch
        run.main(["second", "--config_path", str(cfg_path), "--max_steps", "1", "--device", "cpu"])
        err = capsys.readouterr().err
        assert f"auto-resuming from {log_dir / 'epoch_2nd_00001.pth'} (epoch 1)" in err
        assert "loaded first stage" not in err and "epoch 1 it 2: mel=" in err
        ckpt = torch.load(log_dir / "second_final.pth", map_location="cpu", weights_only=True)
        assert (ckpt["iters"], ckpt["epoch"]) == (2, 2)
        pretrained = log_dir / "second_final.pth"

        # finetuning from the stage-2 weights alone: its own step and epoch counts
        ft_path = _yaml(tmp_path / "ft.yml", ft_dir, data, pretrained_model=str(pretrained),
                        load_only_params=True,
                        loss_params={"TMA_epoch": 0, "diff_epoch": 0, "joint_epoch": 10})
        run.main(["finetune", "--config_path", str(ft_path), "--max_steps", "1", "--device", "cpu"])
        err = capsys.readouterr().err
        assert f"loaded {pretrained} (weights only)" in err
        assert " s2s=" in err and " mono=" in err and " d_loss=" in err and " diff=" in err
        ft = torch.load(ft_dir / "finetune_final.pth", map_location="cpu", weights_only=True)
        assert (ft["iters"], ft["epoch"]) == (1, 1) and (ft_dir / "epoch_ft_00001.pth").exists()
        assert ft["sigma_data"] != 0.2  # estimated from the batch from diff_epoch 0 on
        assert yaml.safe_load((ft_dir / "ft.yml").read_text())["model_params"]["diffusion"][
            "dist"]["sigma_data"] == ft["sigma_data"]
        run.main(["finetune", "--config_path", str(ft_path), "--device", "cpu"])  # nothing left
        assert f"auto-resuming from {ft_dir / 'epoch_ft_00001.pth'} (epoch 1)" in \
            capsys.readouterr().err
    finally:  # the checkpoints are ~1 GB each at these widths
        for p in list(log_dir.glob("*.pth")) + list(ft_dir.glob("*.pth")):
            p.unlink()
