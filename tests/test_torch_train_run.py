"""The port's stage-1 entry point on the CPU at tiny widths: `run_stage("first")`
on a seeded fixture dataset takes one step, validates and writes
`epoch_1st_00001.pth`, `first_stage.pth`, `metrics.jsonl` and `train.log`
in the reference checkpoint layout (no WavLM); the CLI, run again on the
same log directory, resumes from that checkpoint without being asked and
trains the TMA epoch (the discriminator step included).
"""

import json
import os
import wave

import numpy as np
import torch

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models.build import TRAIN_MODULES
from styletts2_tpu_torch.train import run

# one intra-op thread per test worker, as tests/torch_parity.py sets it
torch.set_num_threads(1)

TEXTS = ["ðɪs ɪz ɐ ʃˈɔːɹt ɹᵻkwˈɛst.", "hˈɪɹ ɪz ɐ lˈɔŋɡɚ wˈʌn, wɪð tˈuː klˈɔːzᵻz ænd ɐ kˈɑːmə."]
TINY = {"hidden_dim": 64, "style_dim": 32, "dim_in": 16,
        "decoder": {"upsample_initial_channel": 64, "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1, 3]]}}


def _fixture(root, n=4):
    """n seeded 24 kHz WAVs of 1.2-1.6 s (harmonics plus noise) and the
    train / val / OOD lists."""
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        k = np.arange(int(24000 * rng.uniform(1.2, 1.6)))
        phase = 2 * np.pi * np.cumsum(140 + 30 * np.sin(2 * np.pi * 0.7 * k / 24000)) / 24000
        w = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6)) + 0.02 * rng.standard_normal(k.size)
        with wave.open(str(root / f"u{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes((np.clip(w, -1, 1) * 32767).astype(np.int16).tobytes())
        lines.append(f"u{i}.wav|{TEXTS[i % 2]}|0")
    (root / "train.txt").write_text("\n".join(lines))
    (root / "val.txt").write_text("\n".join(lines[:2]))
    (root / "ood.txt").write_text("\n".join(TEXTS * 3))


def test_run_stage_writes_checkpoints_and_resumes(tmp_path, capsys):
    data, log_dir = tmp_path / "data", tmp_path / "logs"
    data.mkdir()
    _fixture(data)
    params = {"log_dir": str(log_dir), "epochs_1st": 2, "batch_size": 2, "max_len": 80,
              "save_freq": 1, "log_interval": 1,
              "data_params": {"train_data": str(data / "train.txt"), "val_data": str(data / "val.txt"),
                              "root_path": str(data), "OOD_data": str(data / "ood.txt"),
                              "min_length": 10},
              "model_params": TINY, "loss_params": {"TMA_epoch": 1}}
    try:
        state = run.run_stage("first", Config.from_dict(params), max_steps=1, device="cpu")
        assert (state.step, state.epoch) == (1, 1)
        assert {"epoch_1st_00001.pth", "first_stage.pth", "metrics.jsonl", "train.log"} <= set(
            os.listdir(log_dir))
        ckpt = torch.load(log_dir / "first_stage.pth", map_location="cpu", weights_only=True)
        assert set(ckpt) == {"net", "optimizer", "iters", "epoch"}
        assert set(ckpt["net"]) == set(ckpt["optimizer"]) == set(TRAIN_MODULES)  # no WavLM
        assert (ckpt["iters"], ckpt["epoch"]) == (1, 1)
        records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
        assert "train/mel" in records[0] and "d_loss" not in str(records[0])  # pre-TMA
        assert any("eval/mel" in r for r in records)

        # the CLI on the same log directory: the YAML goes through load_config
        yml = tmp_path / "cfg.yml"
        yml.write_text(json.dumps(params))  # JSON is YAML
        capsys.readouterr()
        run.main(["first", "--config_path", str(yml), "--max_steps", "1", "--device", "cpu"])
        err = capsys.readouterr().err
        assert f"auto-resuming from {log_dir / 'epoch_1st_00001.pth'} (epoch 1)" in err
        assert "d_loss=" in err  # epoch 1 is the TMA epoch
        assert (log_dir / "epoch_1st_00002.pth").exists() and (log_dir / "cfg.yml").exists()
        ckpt = torch.load(log_dir / "first_stage.pth", map_location="cpu", weights_only=True)
        assert (ckpt["iters"], ckpt["epoch"]) == (2, 2)
    finally:  # the checkpoints are ~1 GB each at these widths
        for p in log_dir.glob("*.pth"):
            p.unlink()
