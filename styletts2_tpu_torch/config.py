"""The configuration fields the synthesis path and the trainers read.

`Config()` equals `configs/config.yml` (single-speaker LJSpeech, iSTFTNet
decoder), `libritts_config()` equals `configs/config_libritts.yml`
(zero-shot multispeaker, HiFi-GAN decoder) and `finetune_config()` equals
`configs/config_ft.yml` (LJSpeech finetuning), so a machine without PyYAML
can build each; `config_from_path` builds those three files without
reading them. Unknown keys in a loaded YAML file are ignored, so the
reference-format configs load unchanged. PyYAML is imported only inside
`load_config`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

REPO_CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@dataclass
class DecoderParams:
    type: str = "istftnet"
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    upsample_rates: List[int] = field(default_factory=lambda: [10, 6])
    upsample_initial_channel: int = 512
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [20, 12])
    gen_istft_n_fft: int = 20
    gen_istft_hop_size: int = 5


@dataclass
class DiffusionTransformerParams:
    num_layers: int = 3
    num_heads: int = 8
    head_features: int = 64
    multiplier: int = 2


@dataclass
class DiffusionDistParams:
    """The EDM training noise: log sigma ~ N(mean, std); sigma_data, the
    data scale of the preconditioning, re-estimated from each stage-2 batch
    when estimate_sigma_data."""

    sigma_data: float = 0.2
    estimate_sigma_data: bool = True
    mean: float = -3.0
    std: float = 1.0


@dataclass
class DiffusionParams:
    # in training, the share of items whose PL-BERT embedding the denoiser
    # swaps for its fixed (unconditional) one
    embedding_mask_proba: float = 0.1
    transformer: DiffusionTransformerParams = field(
        default_factory=DiffusionTransformerParams
    )
    dist: DiffusionDistParams = field(default_factory=DiffusionDistParams)


@dataclass
class SLMParams:
    """The frozen speech LM of the WavLM feature loss (WavLM base plus)."""

    model: str = "microsoft/wavlm-base-plus"
    sr: int = 16000
    hidden: int = 768
    nlayers: int = 13
    initial_channel: int = 64


@dataclass
class ModelParams:
    multispeaker: bool = False
    dim_in: int = 64  # the style encoders' first width
    hidden_dim: int = 512  # also the style encoders' widest (as the reference builds them)
    n_layer: int = 3
    n_mels: int = 80  # the aligner's and pitch extractor's mel input
    n_token: int = 178
    max_dur: int = 50
    style_dim: int = 128
    dropout: float = 0.2  # the text encoder's and the prosody predictor's dropout in training
    decoder: DecoderParams = field(default_factory=DecoderParams)
    slm: SLMParams = field(default_factory=SLMParams)
    diffusion: DiffusionParams = field(default_factory=DiffusionParams)


@dataclass
class DataParams:
    """`path|phonemes|speaker` file lists, relative to `root_path`."""

    train_data: str = "Data/train_list.txt"
    val_data: str = "Data/val_list.txt"
    root_path: str = ""
    OOD_data: str = "Data/OOD_texts.txt"
    min_length: int = 50


@dataclass
class SpectParams:
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300


@dataclass
class PreprocessParams:
    sr: int = 24000
    spect_params: SpectParams = field(default_factory=SpectParams)


@dataclass
class LossParams:
    lambda_mel: float = 5.0
    lambda_gen: float = 1.0
    lambda_slm: float = 1.0
    lambda_mono: float = 1.0
    lambda_s2s: float = 1.0
    TMA_epoch: int = 50  # from this epoch on: aligner losses, GAN and WavLM terms
    lambda_F0: float = 1.0
    lambda_norm: float = 1.0
    lambda_dur: float = 1.0
    lambda_ce: float = 20.0
    lambda_sty: float = 1.0
    lambda_diff: float = 1.0
    diff_epoch: int = 20
    joint_epoch: int = 50


@dataclass
class OptimizerParams:
    lr: float = 1e-4
    bert_lr: float = 1e-5
    ft_lr: float = 1e-5


@dataclass
class SLMAdvParams:
    """Stage 2's SLM-adversarial pass: clips of min_len // 2 frames decoded
    from alignments of max_len frames, batch_percentage of the batch, the
    WavLM discriminator stepped every `iter` steps; the pass's gradients are
    divided by the predictor's norm above `thresh`, and those of the
    duration head and the diffusion model scaled by `scale`; `sig` is the
    soft alignment's Gaussian width."""

    min_len: int = 400
    max_len: int = 500
    batch_percentage: float = 0.5
    iter: int = 10
    thresh: int = 5
    scale: float = 0.01
    sig: float = 1.5


@dataclass
class PLBERTParams:
    """Phoneme-level ALBERT (Utils/PLBERT/config.yml model_params)."""

    vocab_size: int = 178
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    num_hidden_layers: int = 12
    embedding_size: int = 128


@dataclass
class Config:
    log_dir: str = "Models/LJSpeech"
    first_stage_path: str = "first_stage.pth"
    save_freq: int = 2
    log_interval: int = 10
    epochs_1st: int = 200
    epochs_2nd: int = 100
    batch_size: int = 16
    max_len: int = 400  # mel frames of a training clip
    # the static clip bucket and floor, in mel-half frames (the JAX
    # package's `clip_frame_bucket`): clip = max(40, floor_40(min(half - 1,
    # max_len // 2)))
    clip_frame_bucket: int = 40
    # finetuning starts from this stage-2 checkpoint (weights only when
    # load_only_params); so does stage 2, in place of the first stage's
    # handoff, when second_stage_load_pretrained and the file exists
    pretrained_model: str = ""
    second_stage_load_pretrained: bool = True
    load_only_params: bool = False
    # "" (f32) or "bf16": the modules of train/mp.py's BF16_MODULES compute
    # in bf16 over f32 master weights and optimizer state in training steps
    mixed_precision: str = ""
    # activation checkpointing of the decoder's Generator in training steps
    # (`styletts2_tpu/config.py:206-211`): its 24 kHz activations are
    # recomputed in the backward instead of held; inference ignores it
    remat_decoder: bool = False
    F0_path: str = "Utils/JDC/bst.t7"
    ASR_path: str = "Utils/ASR/epoch_00080.pth"
    PLBERT_dir: str = "Utils/PLBERT/"
    data_params: DataParams = field(default_factory=DataParams)
    preprocess_params: PreprocessParams = field(default_factory=PreprocessParams)
    model_params: ModelParams = field(default_factory=ModelParams)
    loss_params: LossParams = field(default_factory=LossParams)
    optimizer_params: OptimizerParams = field(default_factory=OptimizerParams)
    slmadv_params: SLMAdvParams = field(default_factory=SLMAdvParams)
    plbert_params: PLBERTParams = field(default_factory=PLBERTParams)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return _from_dict(cls, d)


def _from_dict(cls, d: Dict[str, Any]):
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = f.default_factory
        if isinstance(sub, type) and dataclasses.is_dataclass(sub) and isinstance(v, dict):
            v = _from_dict(sub, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def libritts_config() -> Config:
    """`configs/config_libritts.yml`: multispeaker, HiFi-GAN decoder at rates
    10, 5, 3, 2, and LibriTTS's training schedule."""
    return Config(
        log_dir="Models/LibriTTS", epochs_1st=50, epochs_2nd=30, max_len=300,
        model_params=ModelParams(
            multispeaker=True,
            decoder=DecoderParams(type="hifigan", upsample_rates=[10, 5, 3, 2],
                                  upsample_kernel_sizes=[20, 10, 6, 4]),
        ),
        loss_params=LossParams(TMA_epoch=5, diff_epoch=10, joint_epoch=30),
    )


def finetune_config() -> Config:
    """`configs/config_ft.yml`: `Config()`'s model finetuned at batch 8 for 50
    epochs, the aligner, GAN and diffusion losses from epoch 0, the joint
    (SLM-adversarial) phase from epoch 10."""
    return Config(log_dir="Models/Finetune", epochs_2nd=50, batch_size=8,
                  loss_params=LossParams(TMA_epoch=0, diff_epoch=0, joint_epoch=10))


def parse_config(text: str):
    """A config file's text -> (its dict, the function that writes such a
    dict back as text in the file's format). JSON (a YAML subset, as the
    trainer writes a Config's copy) needs no PyYAML; YAML goes through it
    (ImportError without it)."""
    try:
        return json.loads(text), lambda d: json.dumps(d, indent=1)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text), yaml.safe_dump


def load_config(path: str) -> Config:
    """Load a reference-format YAML config (configs/*.yml) or a JSON one
    (`parse_config`)."""
    with open(path) as f:
        return Config.from_dict(parse_config(f.read())[0])


def config_from_path(path: str) -> Config:
    """The config of a YAML file. The repository's `configs/config.yml`,
    `configs/config_libritts.yml` and `configs/config_ft.yml` are `Config()`,
    `libritts_config()` and `finetune_config()` (the tests hold them equal),
    so they need no PyYAML; any other file goes through `load_config`."""
    builtin = {REPO_CONFIGS / "config.yml": Config,
               REPO_CONFIGS / "config_libritts.yml": libritts_config,
               REPO_CONFIGS / "config_ft.yml": finetune_config}
    make = builtin.get(Path(path).resolve())
    return make() if make else load_config(path)
