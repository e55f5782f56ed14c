"""The training entry points (`styletts2_tpu/train/run.py`).

    python -m styletts2_tpu_torch.train.run first --config_path configs/config.yml \\
        [--max_steps N] [--device cuda]
    python -m styletts2_tpu_torch.train.run second --config_path configs/config.yml ...
    python -m styletts2_tpu_torch.train.run finetune --config_path configs/config_ft.yml ...
    python -m torch.distributed.run --nproc_per_node N -m styletts2_tpu_torch.train.run ...

`run_stage(stage, config)` builds the stage's modules with seeded random
weights (the JAX package's init distributions), loads the reference ASR
and JDC checkpoints where `ASR_path` / `F0_path` exist (the port's module
names are the reference's), resumes from the stage's newest epoch file in
`log_dir` (`epoch_1st_`, `epoch_2nd_`, `epoch_ft_NNNNN.pth`) without being
asked, then runs the epoch loop: train steps (a metrics line every
`log_interval`), the validation losses, an asynchronous checkpoint every
`save_freq` epochs and, at the end, `first_stage.pth` or `{stage}_final.pth`.
`mixed_precision: bf16` in the config runs every stage's steps in bf16
(`train/mp.py`); checkpoints stay f32 either way. The command line runs
convolutions and matmuls in f32 (`utils.set_f32_compute`).
Without an epoch file to resume from, `finetune` takes the weights of
`pretrained_model` (only those when `load_only_params`), and so does
`second` when `second_stage_load_pretrained` is set and that file exists;
otherwise `second` takes the first stage's handoff from
`log_dir/first_stage_path` (the stage-2 modules left at their init,
`predictor_encoder` a copy of `style_encoder`). After
stage 2 or finetuning the estimated sigma_data is written into the config
copy in `log_dir`: a config file given by path is copied there, a Config
object written there as JSON (a YAML subset) to `config.yml`. With
STYLETTS2_DEBUG_NAN=1 the loop stops at the first non-finite metric
(`observability.nan_check`) and names the non-finite parameters (up to
20); STYLETTS2_TRACE_STEP=N writes a torch.profiler trace of the run's
N-th step into `log_dir/traces/` (`observability.trace`); each step is
timed by a `StepTimer` (`step_sec`, its EMA `step_sec_avg`). Stages 2 and
finetuning take PL-BERT from the newest `step_N.t7` in `PLBERT_dir` (the
largest N) where there is one. WavLM (`model_params.slm.model`) is read
from a local Hugging Face directory, or a hub name's snapshot in the local
cache (`convert.hf_model_dir`, `convert.wavlm_from_hf`); with neither it
stays at random init, as the JAX `run.py` falls back. Launched by
`torch.distributed.run`, each process is one rank of a data-parallel group
(`parallel/ddp.py`): `batch_size` is the global batch, each rank takes its
share of it from its own slice of the training list, and rank 0 alone
writes the log file, metrics, checkpoints, eval artifacts and the config
copy. STYLETTS2_TPU_MODEL_PARALLEL=k (the JAX package's variable, default 1)
lays the launched ranks out as a (world // k, k) mesh (`parallel/mesh.py`):
each model group of k ranks holds one copy of the model with PL-BERT's,
the denoiser's and WavLM's wide layers sharded over it, and takes one
data rank's share of the batch; a world that k does not divide raises.
Checkpoints hold the full tensors either way. After each epoch's
validation the trainer's `eval_artifacts` of the first validation batch
are written (`MetricsWriter.audio`, `.attention`): reconstructions and their
ground truth, the first sample's attention in stage 1, and from
`joint_epoch` a fully sampled utterance; a failure there is logged and
training carries on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import shutil
from typing import Optional, Union

import numpy as np
import torch

from styletts2_tpu_torch.config import Config, config_from_path, parse_config
from styletts2_tpu_torch.convert import hf_model_dir, state_dict_from_reference, wavlm_from_hf
from styletts2_tpu_torch.data.meldataset import build_dataloader
from styletts2_tpu_torch.models.build import build_training_models
from styletts2_tpu_torch.observability import MetricsWriter, StepTimer, get_logger, nan_check, trace
from styletts2_tpu_torch.parallel import ddp, mesh
from styletts2_tpu_torch.train.finetune import FinetuneTrainer
from styletts2_tpu_torch.train.stage1 import Stage1Trainer
from styletts2_tpu_torch.train.stage2 import Stage2Trainer
from styletts2_tpu_torch.train.state import (AsyncSaver, TrainState, build_optimizers,
                                             find_latest_checkpoint, load_checkpoint, snapshot)
from styletts2_tpu_torch.utils import set_f32_compute

CKPT_PREFIX = {"first": "epoch_1st_", "second": "epoch_2nd_", "finetune": "epoch_ft_"}
TRAINERS = {"first": Stage1Trainer, "second": Stage2Trainer, "finetune": FinetuneTrainer}
# what stage 2 does not take from the first stage
FIRST_STAGE_IGNORED = ("bert", "bert_encoder", "predictor", "predictor_encoder", "msd", "mpd", "wd",
                       "diffusion")


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


def _load_plbert(models, cfg: Config, logger) -> None:
    """PL-BERT's pretrained weights (the reference's Utils/PLBERT/step_N.t7):
    the newest file by its step number N, its `net` without the `module.`
    and then the `encoder.` prefixes, read as a checkpoint's `bert`
    (`convert.state_dict_from_reference`: the pooler and the pretraining
    heads unread)."""
    d = cfg.PLBERT_dir
    steps = [(int(m.group(1)), name) for name in (os.listdir(d) if d and os.path.isdir(d) else ())
             if (m := re.match(r"step_(\d+)", name))]
    if not steps:
        logger.info(f"PL-BERT at random init: no step_* file in {d!r}")
        return
    path = os.path.join(d, max(steps)[1])
    try:
        net = torch.load(path, map_location="cpu", weights_only=True)["net"]
        net = {k[7:] if k.startswith("module.") else k: v for k, v in net.items()}
        net = {k[8:] if k.startswith("encoder.") else k: v for k, v in net.items()}
        sd = state_dict_from_reference({"bert": net}, cfg, keys=("bert",))
        models["bert"].load_state_dict({k[len("bert."):]: v for k, v in sd.items()})
        logger.info(f"loaded PL-BERT from {path}")
    except (OSError, RuntimeError, KeyError) as e:
        logger.warning(f"could not load PL-BERT from {path}: {type(e).__name__}: {e}")


def _load_wavlm(models, cfg: Config, logger) -> None:
    """WavLM from the Hugging Face directory (or cached hub snapshot) that
    `model_params.slm.model` names; its widths must be those the config's
    WavLM discriminator reads (`slm.hidden`, `slm.nlayers` states)."""
    name = cfg.model_params.slm.model
    path = hf_model_dir(name)
    if path is None:
        logger.info(f"WavLM at random init: no local Hugging Face directory or cached "
                    f"snapshot of {name!r}")
        return
    try:
        wavlm = wavlm_from_hf(path)
        sl = cfg.model_params.slm
        widths = (wavlm.encoder.layer_norm.normalized_shape[0], len(wavlm.encoder.layers) + 1)
        if widths != (sl.hidden, sl.nlayers):
            raise ValueError(f"{os.path.join(path, 'config.json')}: hidden {widths[0]}, "
                             f"{widths[1]} states; the config's slm has {sl.hidden}, {sl.nlayers}")
        models["wavlm"] = wavlm
        logger.info(f"loaded WavLM from {path}")
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        logger.warning(f"could not load WavLM from {path}: {type(e).__name__}: {e}")


def setup(cfg: Config, device, logger, stage: str = "first"):
    torch.manual_seed(ddp.rank_seed(0))  # dropout's draws, this rank's own
    models = build_training_models(cfg, torch.Generator().manual_seed(0), stage)
    _load_pretrained(models, cfg, logger)
    _load_wavlm(models, cfg, logger)
    if stage != "first":
        _load_plbert(models, cfg, logger)
    models.to(device)
    sharded = mesh.shard_(models)  # before the optimizers: the moments follow the shards
    if sharded:
        m = mesh.current()
        logger.info(f"tensor parallel: model index {m.model_rank} of {m.model}, data index "
                    f"{m.data_rank} of {m.data}; {len(sharded)} layers sharded")
    state = TrainState(models, build_optimizers(cfg, models, stage2=stage != "first"))
    if stage != "first":
        state.sigma_data = cfg.model_params.diffusion.dist.sigma_data
    dp = cfg.data_params
    train_loader = build_dataloader(dp.train_data, dp.root_path, ood_path=dp.OOD_data,
                                    min_length=dp.min_length,
                                    batch_size=ddp.local_batch_size(cfg.batch_size, ddp.world()),
                                    shard=(ddp.rank(), ddp.world()))
    val_loader = build_dataloader(dp.val_data, dp.root_path, ood_path=dp.OOD_data,
                                  min_length=dp.min_length, batch_size=cfg.batch_size,
                                  validation=True)
    return state, train_loader, val_loader


def run_stage(stage: str, config: Union[Config, str], max_steps: Optional[int] = None,
              device="cuda") -> TrainState:
    """Train `stage` (first, second or finetune) with `config` (a Config, or
    a config file's path); at most `max_steps` steps when given. Under a
    launcher, as one rank of a data-parallel group on `device`'s type
    (`parallel/ddp.py`)."""
    if stage not in CKPT_PREFIX:
        raise ValueError(f"unknown stage {stage!r}: one of {sorted(CKPT_PREFIX)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_stage: device {device}: no CUDA device is available")
    if ddp.launched():
        device = ddp.init(device.type)
    mesh.make_mesh(ddp.global_world(), mesh.model_parallel_from_env())
    lead = ddp.lead()
    cfg = config_from_path(config) if isinstance(config, str) else config
    log_dir = cfg.log_dir
    logger = get_logger(log_dir, rank=ddp.global_rank())
    if ddp.launched():
        k = mesh.current().model
        logger.info(f"data-parallel: rank {ddp.global_rank()} of {ddp.global_world()} on {device}, "
                    f"backend {ddp.backend()}, global batch {cfg.batch_size}"
                    + (f", model parallel {k}" if k > 1 else ""))
    config_copy = os.path.join(log_dir, os.path.basename(config) if isinstance(config, str)
                               else "config.yml")
    if lead and isinstance(config, str):
        shutil.copy(config, config_copy)
    elif lead:
        with open(config_copy, "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)
    state, train_loader, val_loader = setup(cfg, device, logger, stage)
    prefix = CKPT_PREFIX[stage]
    start(stage, cfg, state, logger)
    trainer = TRAINERS[stage](cfg, state, device)
    epochs = cfg.epochs_1st if stage == "first" else cfg.epochs_2nd
    writer, saver, timer = MetricsWriter(log_dir, enabled=lead), AsyncSaver(), StepTimer()
    debug_nan = os.environ.get("STYLETTS2_DEBUG_NAN") == "1"
    trace_step = int(os.environ.get("STYLETTS2_TRACE_STEP", "0"))
    n_batches = -ddp.max_over_ranks([-len(train_loader)])[0]  # every rank takes as many steps
    rng = np.random.default_rng(1)
    iters = 0
    try:
        for epoch in range(state.epoch, epochs):
            for i, batch in enumerate(train_loader):
                if i >= n_batches:
                    break
                with trace(os.path.join(log_dir, "traces"), lead and iters + 1 == trace_step):
                    timer.start()
                    metrics = trainer.train_step(batch, epoch, iters, rng)  # ends in a host sync
                    dt = timer.stop()
                metrics = ddp.mean_metrics(metrics)
                if metrics is None:
                    continue
                if debug_nan and not nan_check(metrics, logger):
                    bad = [n for n, p in state.models.named_parameters()
                           if not nan_check(p.detach())]
                    logger.error(f"non-finite metrics at epoch {epoch} step {state.step}: "
                                 f"{metrics}; non-finite parameters: {bad[:20]}")
                    raise FloatingPointError(f"NaN/Inf at step {state.step} (STYLETTS2_DEBUG_NAN)")
                iters += 1
                if iters % cfg.log_interval == 0:
                    metrics.update(step_sec=dt, step_sec_avg=timer.avg)
                    writer.scalars({f"train/{k}": v for k, v in metrics.items()}, state.step)
                    logger.info(f"epoch {epoch} it {state.step}: "
                                + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                if max_steps and iters >= max_steps:
                    break
            vals = [v for v in (trainer.validate(b, rng) for b in val_loader) if v is not None]
            if vals:
                agg = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
                writer.scalars({f"eval/{k}": v for k, v in agg.items()}, state.step)
                logger.info(f"epoch {epoch}: validation "
                            + " ".join(f"{k} {v:.4f}" for k, v in agg.items()))
            write_eval_artifacts(stage, cfg, trainer, val_loader, writer, epoch, rng, logger)
            state.epoch = epoch + 1
            if state.epoch % cfg.save_freq == 0:
                _save(saver, os.path.join(log_dir, f"{prefix}{state.epoch:05d}.pth"), state, lead)
            if max_steps and iters >= max_steps:
                break
        if stage == "first":
            _save(saver, os.path.join(log_dir, cfg.first_stage_path), state, lead)
        else:
            if lead:
                line = write_sigma_data(config_copy, state.sigma_data)
                if line:
                    logger.info(f"sigma_data {state.sigma_data!r} written into {config_copy}: {line}")
            _save(saver, os.path.join(log_dir, f"{stage}_final.pth"), state, lead)
    finally:
        saver.close()
        writer.close()
    ddp.barrier()
    return state


def _save(saver: AsyncSaver, path: str, state: TrainState, lead: bool) -> None:
    """A checkpoint of `state` written by rank 0; under tensor parallelism
    every rank takes part in the snapshot's gather of the shards."""
    if lead or mesh.current().model > 1:
        payload = snapshot(state)
        if lead:
            saver.submit(path, payload)


def write_eval_artifacts(stage: str, cfg: Config, trainer, val_loader, writer: MetricsWriter,
                         epoch: int, rng: np.random.Generator, logger) -> None:
    """The epoch's eval artifacts of the first validation batch (the
    trainer's `eval_artifacts`; stage 2 and finetuning sample from
    `joint_epoch` on), written as step epoch + 1. A failure is logged with
    its traceback and training carries on."""
    try:
        batch = next(iter(val_loader), None)
        if batch is None:
            return
        art = (trainer.eval_artifacts(batch, rng) if stage == "first" else
               trainer.eval_artifacts(batch, rng, sample=epoch >= cfg.loss_params.joint_epoch))
        for tag, wav in (art or {}).get("audio", {}).items():
            writer.audio(f"eval/{tag}", wav, epoch + 1)
        if art and "attn" in art:
            writer.attention(art["attn"], epoch + 1)
    except Exception as e:  # the artifacts must never stop training
        logger.warning(f"eval artifacts failed: {type(e).__name__}: {e}", exc_info=True)


def start(stage: str, cfg: Config, state: TrainState, logger) -> None:
    """Load the state `stage` starts from: its newest epoch file in
    `log_dir`; else `pretrained_model` where it exists, for finetuning
    always and for stage 2 when `second_stage_load_pretrained` says it is a
    stage-2 checkpoint (the reference's train_second.py); else, for stage
    2, the first stage's handoff. Nothing found: the seeded init."""
    latest = find_latest_checkpoint(cfg.log_dir, CKPT_PREFIX[stage])
    first_stage = os.path.join(cfg.log_dir, cfg.first_stage_path)
    pretrained = (stage == "finetune" or (stage == "second" and cfg.second_stage_load_pretrained)
                  ) and bool(cfg.pretrained_model) and os.path.exists(cfg.pretrained_model)
    if latest is not None:
        load_checkpoint(latest, state)
        logger.info(f"auto-resuming from {latest} (epoch {state.epoch})")
    elif pretrained:
        load_checkpoint(cfg.pretrained_model, state, load_only_params=cfg.load_only_params)
        logger.info(f"loaded {cfg.pretrained_model}"
                    + (" (weights only)" if cfg.load_only_params else f" (epoch {state.epoch})"))
    elif stage == "second" and os.path.exists(first_stage):
        _load_first_stage(state, first_stage, logger)


def _load_first_stage(state: TrainState, path: str, logger) -> None:
    """Stage 2's start: the first stage's weights but for the stage-2
    modules and the discriminators, then predictor_encoder as a copy of
    style_encoder (its spectral-norm vectors included)."""
    load_checkpoint(path, state, load_only_params=True, ignore_modules=FIRST_STAGE_IGNORED)
    state.models["predictor_encoder"].load_state_dict(state.models["style_encoder"].state_dict())
    logger.info(f"loaded first stage from {path}")


_SIGMA_LINE = re.compile(r'^(\s*"?sigma_data"?\s*:\s*)([^,\s]+)', re.M)


def write_sigma_data(path: str, sigma: float) -> Optional[str]:
    """Write `sigma` into the config copy at `path` as
    model_params.diffusion.dist.sigma_data (the JAX `train/run.py:321-329`).
    An existing `sigma_data:` line is edited in place, the rest of the file
    kept as it is. Without one, a JSON file is rewritten through `json` and
    a YAML file through PyYAML, the missing keys created. Returns the line
    as written, or None for a YAML file without the line where PyYAML
    cannot be imported: the file is then left as it is, and the run's
    logger warns."""
    with open(path) as f:
        text = f.read()
    sigma = float(sigma)
    m = _SIGMA_LINE.search(text)
    if m is not None:
        text = text[: m.start(2)] + repr(sigma) + text[m.end(2):]
        end = text.find("\n", m.start())
        line = text[m.start(): end if end >= 0 else len(text)].strip()
    else:
        try:
            raw, dump = parse_config(text)
        except ImportError:
            logging.getLogger("styletts2_tpu_torch").warning(
                f"{path} has no sigma_data line and PyYAML is not installed: "
                f"sigma_data {sigma!r} not written")
            return None
        raw.setdefault("model_params", {}).setdefault("diffusion", {}).setdefault(
            "dist", {})["sigma_data"] = sigma
        text, line = dump(raw), f"model_params.diffusion.dist.sigma_data: {sigma!r}"
    with open(path, "w") as f:
        f.write(text)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description="styletts2_tpu_torch training")
    ap.add_argument("stage", choices=list(CKPT_PREFIX))
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_f32_compute()
    try:
        run_stage(args.stage, args.config_path, args.max_steps, args.device)
    finally:
        ddp.finish()


if __name__ == "__main__":
    main()
