"""The configuration fields the synthesis path reads.

`Config()` equals `configs/config.yml` (single-speaker LJSpeech, iSTFTNet
decoder) and `libritts_config()` equals `configs/config_libritts.yml`
(zero-shot multispeaker, HiFi-GAN decoder), so a machine without PyYAML
can build either; `config_from_path` builds those two files without
reading them. Unknown keys in a loaded YAML file are ignored, so the
reference-format configs load unchanged. PyYAML is imported only inside
`load_config`.
"""

from __future__ import annotations

import dataclasses
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
class DiffusionParams:
    transformer: DiffusionTransformerParams = field(
        default_factory=DiffusionTransformerParams
    )


@dataclass
class ModelParams:
    multispeaker: bool = False
    dim_in: int = 64  # the style encoders' first width
    hidden_dim: int = 512  # also the style encoders' widest (as the reference builds them)
    n_layer: int = 3
    n_token: int = 178
    max_dur: int = 50
    style_dim: int = 128
    decoder: DecoderParams = field(default_factory=DecoderParams)
    diffusion: DiffusionParams = field(default_factory=DiffusionParams)


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
    model_params: ModelParams = field(default_factory=ModelParams)
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
    10, 5, 3, 2."""
    return Config(model_params=ModelParams(
        multispeaker=True,
        decoder=DecoderParams(type="hifigan", upsample_rates=[10, 5, 3, 2],
                              upsample_kernel_sizes=[20, 10, 6, 4]),
    ))


def load_config(path: str) -> Config:
    """Load a reference-format YAML config (configs/*.yml)."""
    import yaml

    with open(path) as f:
        return Config.from_dict(yaml.safe_load(f))


def config_from_path(path: str) -> Config:
    """The config of a YAML file. The repository's `configs/config.yml` and
    `configs/config_libritts.yml` are `Config()` and `libritts_config()`
    (the tests hold them equal), so they need no PyYAML; any other file goes
    through `load_config`."""
    builtin = {REPO_CONFIGS / "config.yml": Config,
               REPO_CONFIGS / "config_libritts.yml": libritts_config}
    make = builtin.get(Path(path).resolve())
    return make() if make else load_config(path)
