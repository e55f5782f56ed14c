"""Tiny training setups (`styletts2_tpu/parallel/tiny.py`): every module,
loss and tensor-parallel layout of the real steps at shrunk channel widths,
for CPU tests, the fidelity tool's tiny runs and `bench_train.py`.

`tiny_config()` is the config; `tiny_training_setup` builds its modules
(with the JAX setup's narrower WavLM, period discriminator and aligner)
and optimizers through `training_setup`, which `bench_train.py` also
uses at full width; `synthetic_batch` is the benches' random batch, bit-equal
to the JAX one for the same numpy generator. The JAX package's
`fast_init` is not carried over: it builds flax parameters on the host to
avoid ~1500 XLA init programs, and the port's init is eager PyTorch on the
host already. Its other helpers (`tiny_models_and_variables`, `tiny_state`)
build flax variables and are folded into `tiny_training_setup`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.data.meldataset import Batch


def tiny_config() -> Config:
    """`Config()` at tiny widths, field for field the JAX package's. PL-BERT
    keeps a 1536-wide feed-forward, so the tensor-parallel layout shards a
    side of 1024 or more, as at full width."""
    cfg = Config()
    pb, mp = cfg.plbert_params, cfg.model_params
    pb.num_hidden_layers = 1
    pb.hidden_size = 128
    pb.intermediate_size = 1536
    pb.num_attention_heads = 4
    pb.embedding_size = 64
    mp.hidden_dim = 128
    mp.max_conv_dim = 128
    mp.style_dim = 64
    mp.dim_in = 32
    mp.diffusion.transformer.num_layers = 1
    mp.decoder.upsample_initial_channel = 128
    # one resblock kernel of two dilations, depth-1 text and duration encoders
    mp.decoder.resblock_kernel_sizes = [3]
    mp.decoder.resblock_dilation_sizes = [[1, 3]]
    cfg.max_len = 80
    cfg.slmadv_params.min_len = 80
    cfg.slmadv_params.max_len = 120
    mp.slm.hidden = 64
    mp.slm.nlayers = 3
    return cfg


def training_setup(cfg: Config, stage2: bool = False, device="cpu", seed: int = 0,
                   aux: Optional[Dict[str, nn.Module]] = None):
    """(models, TrainState) of `cfg`'s stage-1 modules (stage 2's too with
    `stage2`) on `device`, weights drawn from `seed` (`aux`: see
    `build_training_models`), sharded over the model axis where there is
    one (`parallel/mesh.py`, before the optimizers, as `train/run.py:setup`
    does); the stage's optimizers, and stage 2's sigma_data from the
    config. Dropout's draws are seeded from `seed` too (`torch.manual_seed`)."""
    from styletts2_tpu_torch.models.build import build_training_models
    from styletts2_tpu_torch.parallel import mesh
    from styletts2_tpu_torch.train.state import TrainState, build_optimizers

    torch.manual_seed(seed)
    models = build_training_models(cfg, torch.Generator().manual_seed(seed),
                                   "second" if stage2 else "first", aux).to(device)
    mesh.shard_(models)
    state = TrainState(models, build_optimizers(cfg, models, stage2=stage2))
    if stage2:
        state.sigma_data = cfg.model_params.diffusion.dist.sigma_data
    return models, state


def tiny_training_setup(cfg: Config, stage2: bool = False, device="cpu", seed: int = 0):
    """`training_setup` with the JAX tiny setup's narrower auxiliary modules:
    a frozen WavLM of hidden 64, 2 heads, 96 wide and 2 layers, a period
    discriminator of periods 2 and 3, an aligner of 2 layers 128 wide."""
    from styletts2_tpu_torch.models.asr import ASRCNN
    from styletts2_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from styletts2_tpu_torch.models.wavlm import WavLM

    mp = cfg.model_params
    aux = {"wavlm": WavLM(hidden=64, heads=2, intermediate=96, num_layers=2),
           "mpd": MultiPeriodDiscriminator(periods=(2, 3)),
           "text_aligner": ASRCNN(input_dim=mp.n_mels, hidden_dim=128, n_token=mp.n_token,
                                  n_layers=2, token_embedding_dim=128)}
    return training_setup(cfg, stage2, device, seed, aux)


def synthetic_batch(rng: np.random.Generator, B: int, wav_len: int = 27000, bucket: int = 48000,
                    T_text: int = 12, T_buf: int = 32) -> Batch:
    """A random batch in the loader's `Batch` layout: item b holds wav_len +
    1500 b samples of N(0, 0.5^2) noise (speech-scale: tiny amplitudes drive
    the normalisation-free discriminators toward subnormal floats), its even
    mel length, T_text random tokens in a buffer of T_buf, the first
    24000 samples as its reference wave. The bucket grows to the longest
    item rather than clip it. The JAX function's draws in its order: for the
    same `rng` state its arrays are bit-equal."""
    bucket = max(bucket, wav_len + (B - 1) * 1500)
    waves = np.zeros((B, bucket), np.float32)
    wave_lengths = np.zeros(B, np.int32)
    mel_lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = wav_len + b * 1500
        waves[b, :n] = rng.standard_normal(n).astype(np.float32) * 0.5
        wave_lengths[b] = n
        ml = n // 300 + 1
        mel_lengths[b] = ml - ml % 2
    tokens = np.zeros((B, T_buf), np.int32)
    tokens[:, :T_text] = rng.integers(4, 178, (B, T_text))
    input_lengths = np.full(B, T_text, np.int32)
    ref_len = min(24000, bucket)
    return Batch(waves=waves, wave_lengths=wave_lengths, tokens=tokens,
                 input_lengths=input_lengths, ref_tokens=tokens, ref_lengths=input_lengths,
                 mel_lengths=mel_lengths, ref_waves=waves[:, :ref_len].copy(),
                 ref_wave_lengths=np.minimum(wave_lengths, ref_len).astype(np.int32),
                 speakers=np.zeros(B, np.int32))
