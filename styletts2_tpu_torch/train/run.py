"""The stage-1 training entry point (`styletts2_tpu/train/run.py`, stage `first`).

    python -m styletts2_tpu_torch.train.run first --config_path configs/config.yml \\
        [--max_steps N] [--device cuda]

`run_stage("first", config)` builds the stage-1 modules with seeded random
weights (the JAX package's init distributions), loads the reference ASR
and JDC checkpoints where `ASR_path` / `F0_path` exist (the port's module
names are the reference's), resumes from the newest `epoch_1st_NNNNN.pth`
in `log_dir` without being asked, then runs the epoch loop: train steps
(a metrics line every `log_interval`), the validation mel loss, an
asynchronous checkpoint every `save_freq` epochs and `first_stage.pth` at
the end. With STYLETTS2_DEBUG_NAN=1 it stops at the first non-finite
metric and names the non-finite parameters. WavLM stays at random init:
its pretrained weights come from the Hugging Face hub, which the port does
not read, as the JAX `run.py` falls back when they are missing; PL-BERT is
not part of stage 1.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Optional, Union

import numpy as np
import torch

from styletts2_tpu_torch.config import Config, config_from_path
from styletts2_tpu_torch.data.meldataset import build_dataloader
from styletts2_tpu_torch.models.build import build_training_models
from styletts2_tpu_torch.observability import MetricsWriter, get_logger
from styletts2_tpu_torch.train.stage1 import Stage1Trainer
from styletts2_tpu_torch.train.state import (AsyncSaver, TrainState, build_optimizers,
                                             find_latest_checkpoint, load_checkpoint,
                                             save_checkpoint)

CKPT_PREFIX = "epoch_1st_"


def _load_pretrained(models, cfg: Config, logger) -> None:
    """The reference's pretrained aligner and pitch extractor, where present."""
    for path, key in ((cfg.ASR_path, "text_aligner"), (cfg.F0_path, "pitch_extractor")):
        if not (path and os.path.exists(path)):
            continue
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = sd.get("model", sd.get("net", sd))
            sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
            missing, _ = models[key].load_state_dict(sd, strict=False)
            if missing:
                raise KeyError(f"missing {missing[:5]}")
            logger.info(f"loaded pretrained {key} from {path}")
        except (OSError, RuntimeError, KeyError, AttributeError) as e:
            logger.warning(f"could not load {key} from {path}: {type(e).__name__}: {e}")


def setup(cfg: Config, device, logger):
    torch.manual_seed(0)  # dropout's draws
    models = build_training_models(cfg, torch.Generator().manual_seed(0))
    _load_pretrained(models, cfg, logger)
    logger.info("WavLM at random init: the port reads no Hugging Face weights")
    models.to(device)
    state = TrainState(models, build_optimizers(cfg, models))
    dp = cfg.data_params
    train_loader = build_dataloader(dp.train_data, dp.root_path, ood_path=dp.OOD_data,
                                    min_length=dp.min_length, batch_size=cfg.batch_size)
    val_loader = build_dataloader(dp.val_data, dp.root_path, ood_path=dp.OOD_data,
                                  min_length=dp.min_length, batch_size=cfg.batch_size,
                                  validation=True)
    return state, train_loader, val_loader


def run_stage(stage: str, config: Union[Config, str], max_steps: Optional[int] = None,
              device="cuda") -> TrainState:
    """Train stage `first` with `config` (a Config, or a config file's path,
    which is copied into log_dir); at most `max_steps` steps when given."""
    if stage != "first":
        raise ValueError(f"the port trains stage 'first' only, not {stage!r}")
    cfg = config_from_path(config) if isinstance(config, str) else config
    log_dir = cfg.log_dir
    logger = get_logger(log_dir)
    if isinstance(config, str):
        shutil.copy(config, os.path.join(log_dir, os.path.basename(config)))
    device = torch.device(device)
    state, train_loader, val_loader = setup(cfg, device, logger)
    latest = find_latest_checkpoint(log_dir, CKPT_PREFIX)
    if latest is not None:
        load_checkpoint(latest, state)
        logger.info(f"auto-resuming from {latest} (epoch {state.epoch})")
    trainer = Stage1Trainer(cfg, state, device)
    writer, saver = MetricsWriter(log_dir), AsyncSaver()
    debug_nan = os.environ.get("STYLETTS2_DEBUG_NAN") == "1"
    rng = np.random.default_rng(1)
    iters = 0
    try:
        for epoch in range(state.epoch, cfg.epochs_1st):
            for batch in train_loader:
                t0 = time.perf_counter()
                metrics = trainer.train_step(batch, epoch, rng)  # ends in a host sync
                dt = time.perf_counter() - t0
                if metrics is None:
                    continue
                if debug_nan and not all(np.isfinite(v) for v in metrics.values()):
                    bad = [n for n, p in state.models.named_parameters()
                           if not bool(torch.isfinite(p).all())]
                    logger.error(f"non-finite metrics at epoch {epoch} step {state.step}: "
                                 f"{metrics}; non-finite parameters: {bad[:20]}")
                    raise FloatingPointError(f"NaN/Inf at step {state.step} (STYLETTS2_DEBUG_NAN)")
                iters += 1
                if iters % cfg.log_interval == 0:
                    metrics["step_sec"] = dt
                    writer.scalars({f"train/{k}": v for k, v in metrics.items()}, state.step)
                    logger.info(f"epoch {epoch} it {state.step}: "
                                + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                if max_steps and iters >= max_steps:
                    break
            vals = [v for v in (trainer.validate(b, rng) for b in val_loader) if v is not None]
            if vals:
                writer.scalars({"eval/mel": float(np.mean(vals))}, state.step)
                logger.info(f"epoch {epoch}: validation mel {np.mean(vals):.4f}")
            state.epoch = epoch + 1
            if state.epoch % cfg.save_freq == 0:
                saver.save(os.path.join(log_dir, f"{CKPT_PREFIX}{state.epoch:05d}.pth"), state)
            if max_steps and iters >= max_steps:
                break
        save_checkpoint(os.path.join(log_dir, cfg.first_stage_path), state)
    finally:
        saver.close()
        writer.close()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description="styletts2_tpu_torch stage-1 training")
    ap.add_argument("stage", choices=["first"])
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run_stage(args.stage, args.config_path, args.max_steps, args.device)


if __name__ == "__main__":
    main()
