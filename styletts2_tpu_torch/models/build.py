"""Assembly of the synthesis path's and the trainers' modules, with seeded
random weights.

`build_models(cfg, generator)` returns an `nn.ModuleDict` keyed like the
reference checkpoint's `net` dict (`module_keys(cfg)`): text_encoder, bert,
bert_encoder, predictor, decoder (iSTFTNet or HiFi-GAN, as
`decoder.type` says), diffusion, and for a multispeaker config the mel
style encoders style_encoder and predictor_encoder. Its `state_dict()`
keys are therefore `<module>.<reference torch name>`, the layout
`convert.state_dict_from_jax` produces.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models import decoder_hifigan, decoder_istft
from styletts2_tpu_torch.models.asr import ASRCNN, init_asr_
from styletts2_tpu_torch.models.diffusion.denoiser import LearnedPositionalEmbedding, Transformer1d
from styletts2_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                       MultiResSpecDiscriminator, WavLMDiscriminator,
                                                       init_discriminator_)
from styletts2_tpu_torch.models.jdc import JDCNet, init_jdc_
from styletts2_tpu_torch.models.layers import (SNConv2d, WNConv1d, WNConvTranspose1d, lecun_normal_,
                                               uniform_)
from styletts2_tpu_torch.models.plbert import PLBERT, AlbertEmbeddings
from styletts2_tpu_torch.models.predictor import ProsodyPredictor
from styletts2_tpu_torch.models.style_encoder import StyleEncoder
from styletts2_tpu_torch.models.text_encoder import TextEncoder
from styletts2_tpu_torch.models.wavlm import WavLM, init_wavlm_

BASE_MODULES = ("text_encoder", "bert", "bert_encoder", "predictor", "decoder", "diffusion")
STYLE_MODULES = ("style_encoder", "predictor_encoder")
TRAIN_MODULES = ("text_encoder", "style_encoder", "decoder", "text_aligner", "pitch_extractor",
                 "mpd", "msd")
STAGE2_MODULES = ("bert", "bert_encoder", "predictor", "predictor_encoder", "diffusion", "wd")
FROZEN_MODULES = ("wavlm",)  # never stepped and never checkpointed


class BertEncoder(nn.Linear):
    """PL-BERT hidden -> hidden_dim projection."""


def module_keys(cfg: Config) -> Tuple[str, ...]:
    """The modules synthesis with `cfg` runs: the style encoders only when
    multispeaker, where `compute_style` needs them."""
    return BASE_MODULES + (STYLE_MODULES if cfg.model_params.multispeaker else ())


def _decoder(cfg: Config) -> nn.Module:
    mp = cfg.model_params
    dec = mp.decoder
    common = dict(
        dim_in=mp.hidden_dim, style_dim=mp.style_dim,
        resblock_kernel_sizes=tuple(dec.resblock_kernel_sizes),
        upsample_rates=tuple(dec.upsample_rates),
        upsample_initial_channel=dec.upsample_initial_channel,
        resblock_dilation_sizes=tuple(map(tuple, dec.resblock_dilation_sizes)),
        upsample_kernel_sizes=tuple(dec.upsample_kernel_sizes),
        remat=cfg.remat_decoder,
    )
    if dec.type == "istftnet":
        return decoder_istft.Decoder(**common, gen_istft_n_fft=dec.gen_istft_n_fft,
                                     gen_istft_hop_size=dec.gen_istft_hop_size)
    if dec.type == "hifigan":
        return decoder_hifigan.Decoder(**common)
    raise ValueError(f"unknown decoder type {dec.type!r}")


def _text_encoder(cfg: Config) -> TextEncoder:
    mp = cfg.model_params
    return TextEncoder(mp.hidden_dim, 5, mp.n_layer, mp.n_token, dropout=mp.dropout)


def _style_encoder(cfg: Config) -> StyleEncoder:
    mp = cfg.model_params  # the reference builds it up to hidden_dim wide
    return StyleEncoder(mp.dim_in, mp.style_dim, max_conv_dim=mp.hidden_dim)


def _diffusion(cfg: Config) -> Transformer1d:
    mp = cfg.model_params
    tr = mp.diffusion.transformer
    pb = cfg.plbert_params
    return Transformer1d(
        channels=mp.style_dim * 2, context_embedding_features=pb.hidden_size,
        num_layers=tr.num_layers, num_heads=tr.num_heads,
        head_features=tr.head_features, multiplier=tr.multiplier,
        embedding_max_length=pb.max_position_embeddings,
        context_features=mp.style_dim * 2 if mp.multispeaker else 0,
    )


def build_models(cfg: Config, generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    mp = cfg.model_params
    pb = cfg.plbert_params
    models = nn.ModuleDict({
        "text_encoder": _text_encoder(cfg),
        "bert": PLBERT(pb),
        "bert_encoder": BertEncoder(pb.hidden_size, mp.hidden_dim),
        "predictor": ProsodyPredictor(mp.style_dim, mp.hidden_dim, mp.n_layer, mp.max_dur, mp.dropout),
        "decoder": _decoder(cfg),
        "diffusion": _diffusion(cfg),
    })
    if mp.multispeaker:
        for key in STYLE_MODULES:
            models[key] = _style_encoder(cfg)
    _init_weights(models, generator)
    return models


def build_training_models(cfg: Config, generator: Optional[torch.Generator] = None,
                          stage: str = "first",
                          aux: Optional[Dict[str, nn.Module]] = None) -> nn.ModuleDict:
    """The trainer's modules, keyed like the reference checkpoint:
    TRAIN_MODULES (text_encoder, style_encoder and decoder as synthesis
    builds them; the ASR aligner text_aligner, the JDC pitch_extractor and
    the mpd / msd discriminators, `styletts2_tpu/models/build.py:147-196`)
    and the frozen `wavlm`; for stage `second` or `finetune` also
    STAGE2_MODULES (bert, bert_encoder, predictor, predictor_encoder,
    diffusion and the WavLM discriminator wd; both style encoders whether
    or not the config is multispeaker). Each takes the JAX package's init
    distributions (but for `_init_weights`' one departure), drawn from `generator` in that order, so the stage-1
    modules get the same weights at every stage. `aux` maps any of
    text_aligner, pitch_extractor, mpd, msd and wavlm to a module built
    by the caller (a narrower one, as `parallel/tiny.py` builds), taken in
    place of the default and initialised alike."""
    if stage not in ("first", "second", "finetune"):
        raise ValueError(f"unknown stage {stage!r}")
    aux = aux or {}
    mp = cfg.model_params
    models = nn.ModuleDict({"text_encoder": _text_encoder(cfg),
                            "style_encoder": _style_encoder(cfg), "decoder": _decoder(cfg)})
    _init_weights(models, generator)
    extra = {
        "text_aligner": (lambda: ASRCNN(input_dim=mp.n_mels, n_token=mp.n_token), init_asr_),
        "pitch_extractor": (lambda: JDCNet(num_class=1), init_jdc_),
        "mpd": (MultiPeriodDiscriminator, init_discriminator_),
        "msd": (MultiResSpecDiscriminator, init_discriminator_),
        "wavlm": (WavLM, init_wavlm_),
    }
    unknown = sorted(set(aux) - set(extra))
    if unknown:
        raise ValueError(f"aux: not an auxiliary module: {unknown}")
    for key, (make, init) in extra.items():
        mod = aux[key] if key in aux else make()
        init(mod, generator)
        models[key] = mod
    if stage != "first":
        pb, sl = cfg.plbert_params, mp.slm
        second = nn.ModuleDict({
            "bert": PLBERT(pb),
            "bert_encoder": BertEncoder(pb.hidden_size, mp.hidden_dim),
            "predictor": ProsodyPredictor(mp.style_dim, mp.hidden_dim, mp.n_layer, mp.max_dur, mp.dropout),
            "predictor_encoder": _style_encoder(cfg),
            "diffusion": _diffusion(cfg),
            "wd": WavLMDiscriminator(sl.hidden, sl.nlayers, sl.initial_channel),
        })
        _init_weights(second, generator)
        models.update(second)
    return models


def parameter_names(cfg: Config, keys: Sequence[str]) -> Dict[str, List[str]]:
    """{module: its state_dict names} for the synthesis modules `keys` names,
    read off modules built on the meta device (no memory, no weights)."""
    unknown = sorted(set(keys) - set(module_keys(cfg)))
    if unknown:
        raise ValueError(f"not a synthesis module of this config: {unknown}")
    with torch.device("meta"):
        models = build_models(cfg)
    return {k: list(models[k].state_dict()) for k in keys}


@torch.no_grad()
def _init_weights(root: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Random weights drawn from `generator` with the JAX package's init
    distributions: lecun-normal dense kernels and zero biases; U(+-1/sqrt(fan_in))
    convs and LSTMs; weight-norm g = 1; embeddings N(0, 1/sqrt(features)),
    except PL-BERT's positional tables N(0, 0.02) and the denoiser's fixed
    embedding and Fourier weights N(0, 1); spectral-norm convs U(+-1/sqrt(fan_in))
    with their (u, v) aligned to the weight's top singular vectors. Norm
    scales and snake alphas keep their constructor values (ones / zeros).

    One departure from the JAX init: the HiFi-GAN Generator's weight-norm
    convs take g = ||v||, so that w = v at init, as in the reference (its
    `init_weights` runs after `weight_norm` and so changes nothing: torch
    computes w from g = ||v|| before every forward). With g = 1 each conv's
    rows have norm 1, ~1.7x more, and at full width half the Generator's
    output samples sit in its tanh head's saturation, where pre-TMA training
    cannot lower the mel loss. The draws are the same, so every other
    weight is too."""
    g = generator

    def uniform(t, bound):
        uniform_(t, bound, g)

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    def lecun_(mod):
        lecun_normal_(mod.weight, g)
        if mod.bias is not None:
            mod.bias.zero_()

    for mod in root.modules():
        if isinstance(mod, nn.Linear):
            lecun_(mod)
        elif isinstance(mod, (WNConv1d, WNConvTranspose1d, nn.Conv1d)):
            w = mod.weight_v if isinstance(mod, (WNConv1d, WNConvTranspose1d)) else mod.weight
            if isinstance(mod, WNConvTranspose1d):
                fan_in = w.shape[0] * w.shape[2] // mod.groups
            else:
                fan_in = w.shape[1] * w.shape[2]
            bound = 1.0 / math.sqrt(fan_in)
            uniform(w, bound)
            if isinstance(mod, (WNConv1d, WNConvTranspose1d)):
                mod.weight_g.fill_(1.0)
            if mod.bias is not None:
                uniform(mod.bias, bound)
        elif isinstance(mod, nn.LSTM):
            bound = 1.0 / math.sqrt(mod.hidden_size)
            for name, p in mod.named_parameters():
                if name.startswith("bias_hh"):
                    p.zero_()  # the JAX LSTM has one bias, b_ih + b_hh
                else:
                    uniform(p, bound)
        elif isinstance(mod, SNConv2d):
            bound = 1.0 / math.sqrt(mod.weight_orig[0].numel())
            uniform(mod.weight_orig, bound)
            if mod.bias is not None:
                uniform(mod.bias, bound)
            _align_spectral(mod, torch.randn(mod.weight_u.shape, generator=g))
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0 / math.sqrt(mod.embedding_dim))
        elif isinstance(mod, LearnedPositionalEmbedding):
            normal_(mod.weights, 1.0)
    for mod in root.modules():
        if isinstance(mod, AlbertEmbeddings):
            normal_(mod.position_embeddings.weight, 0.02)
            normal_(mod.token_type_embeddings.weight, 0.02)
        elif isinstance(mod, Transformer1d):
            normal_(mod.fixed_embedding.embedding.weight, 1.0)
            lecun_(mod.to_out[1])  # a dense layer in the JAX package
        elif isinstance(mod, decoder_hifigan.Generator):
            for conv in mod.modules():
                if isinstance(conv, (WNConv1d, WNConvTranspose1d)):
                    v = conv.weight_v
                    conv.weight_g.copy_(v.norm(dim=tuple(range(1, v.dim())), keepdim=True))



def _align_spectral(mod: SNConv2d, u: torch.Tensor, iters: int = 3) -> None:
    """Set (weight_u, weight_v) to the weight's top singular vectors by power
    iteration from `u`, as `styletts2_tpu/models/build.py:_fi_spectral_align`
    does. Random independent (u, v) would make sigma ~ ||W||_F / sqrt(n m),
    far below the top singular value, and W / sigma would amplify ~50x per
    layer through the normalisation-free SN stack."""
    w = mod.weight_orig.detach().double()
    wm = w.reshape(w.shape[0], -1)
    u = u.double()
    for _ in range(iters):
        v = wm.T @ u
        v = v / (v.norm() + 1e-12)
        u = wm @ v
        u = u / (u.norm() + 1e-12)
    mod.weight_u.copy_(u.float())
    mod.weight_v.copy_(v.float())
