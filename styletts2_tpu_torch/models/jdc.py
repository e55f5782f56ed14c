"""JDCNet pitch extractor (`styletts2_tpu/models/jdc.py:27-122`).

The normalised log mel (B, n_mels, T) is a one-channel image (B, 1, T,
n_mels): a conv stem (3x3 conv, BatchNorm, LeakyReLU 0.01, 3x3 conv), three
residual blocks that halve the mel axis by (1, 2) max-pooling, a BatchNorm +
LeakyReLU pool block and a (1, 4) max-pool, then a BiLSTM over (B, T, 512)
and a Linear to one class: |F0| per frame. BatchNorm runs in inference mode
on its running statistics whatever the module's mode, as the stage-1 step
calls the frozen-statistics JAX module (`train/stage1.py:157-161`).
Module names are the reference checkpoint's (`styletts2_tpu/convert.py:
convert_jdc`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.layers import BiLSTM, lecun_normal_, uniform_


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with its running statistics."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pre_conv = nn.Sequential(FrozenBatchNorm2d(cin), nn.LeakyReLU(0.01),
                                      nn.MaxPool2d((1, 2)))
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1, bias=False), FrozenBatchNorm2d(cout),
            nn.LeakyReLU(0.01), nn.Conv2d(cout, cout, 3, padding=1, bias=False),
        )
        if cin != cout:
            self.conv1by1 = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        x = self.pre_conv(x)
        sc = self.conv1by1(x) if hasattr(self, "conv1by1") else x
        return self.conv(x) + sc


class JDCNet(nn.Module):
    def __init__(self, num_class: int = 1):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.Conv2d(1, 64, 3, padding=1, bias=False), FrozenBatchNorm2d(64), nn.LeakyReLU(0.01),
            nn.Conv2d(64, 64, 3, padding=1, bias=False),
        )
        self.res_block1 = ResBlock(64, 128)
        self.res_block2 = ResBlock(128, 192)
        self.res_block3 = ResBlock(192, 256)
        self.pool_block = nn.Sequential(FrozenBatchNorm2d(256), nn.LeakyReLU(0.01))
        self.bilstm_classifier = BiLSTM(512, 256)
        self.classifier = nn.Linear(512, num_class)

    def forward(self, mel):
        """mel (B, n_mels, T) -> (F0 (B, T), GAN feature (B, 256, T, n_mels/8),
        pool-block output (B, T, 512))."""
        x = mel.transpose(1, 2)[:, None]  # (B, 1, T, M)
        x = self.conv_block(x)
        x = self.res_block3(self.res_block2(self.res_block1(x)))
        gan_feature = self.pool_block(x)
        B, _, T, _ = gan_feature.shape
        pool = F.max_pool2d(gan_feature, (1, 4))  # (B, 256, T, 2) at 80 mels
        pool_t = pool.permute(0, 2, 1, 3).reshape(B, T, -1)
        f0 = self.classifier(self.bilstm_classifier(pool_t))
        return f0[..., 0].abs(), gan_feature, pool_t


@torch.no_grad()
def init_jdc_(m: JDCNet, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's init: lecun-normal convs and classifier (zero bias),
    BatchNorm scale 1, bias 0, running mean 0 and var 1, the BiLSTM
    U(+-1/sqrt(H)) with one bias."""
    g = generator
    for mod in m.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            lecun_normal_(mod.weight, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, nn.LSTM):
            bound = 1.0 / math.sqrt(mod.hidden_size)
            for name, p in mod.named_parameters():
                if name.startswith("bias_hh"):
                    p.zero_()
                else:
                    uniform_(p, bound, g)
