"""Finetuning (`styletts2_tpu/train/finetune.py`): the stage-2 trainer with
finetune=True. The discriminators and the aligner's s2s / mono losses act
from epoch 0; the aligner (in train mode) and the text encoder take
gradients; text_encoder, text_aligner, style_encoder and decoder are
stepped throughout; diffusion from diff_epoch, the SLM-adversarial pass from
joint_epoch."""

from __future__ import annotations

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.train.stage2 import Stage2Trainer
from styletts2_tpu_torch.train.state import TrainState


class FinetuneTrainer(Stage2Trainer):
    def __init__(self, cfg: Config, state: TrainState, device):
        super().__init__(cfg, state, device, finetune=True)
