"""Mixed-precision (bf16) training: `mixed_precision: bf16` in the config
(`styletts2_tpu/train/mp.py`).

The modules of BF16_MODULES, the conv- and transformer-heavy part of a step
(the decoder, both discriminators, the frozen WavLM and the two style
encoders), compute in bf16: `run` calls one with each floating parameter
cast to bf16 through `torch.func.functional_call` and each floating tensor
argument cast to bf16. The cast is linear, so a parameter's gradient comes
back f32 onto its f32 master: master weights, gradients and the optimizers'
moments stay f32, with no gradient scaler (bf16 has f32's exponent range).
The modules' own f32 islands stay f32 (weight norm, the spectral-norm
iteration and its stored vectors, the normalisation statistics, the
decoder's sine source and iSTFT head, the fused kernel's math), and every
loss upcasts its inputs. The sequence stack (the aligner, PL-BERT, the
predictor's LSTMs, the diffusion) stays f32, and the trainers upcast a bf16
module's output where it enters it. Disabled, `run` is the module's own
call and `cast_in` returns its input unchanged.

Within a trainer's step (`casts_once`) a parameter is cast once for each
version of it (an optimizer step makes a new one), not at every call: a
step runs the decoder up to three times and WavLM up to five, and the
copy's autograd node carries the gradients of every use back to the
master.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

BF16_MODULES = ("decoder", "mpd", "msd", "wavlm", "style_encoder", "predictor_encoder")
MIXED_PRECISIONS = ("", "bf16")


def enabled(cfg) -> bool:
    """Whether the config asks for bf16 training; an unknown value is an error."""
    if cfg.mixed_precision not in MIXED_PRECISIONS:
        raise ValueError(f"mixed_precision {cfg.mixed_precision!r}: one of {MIXED_PRECISIONS}")
    return cfg.mixed_precision == "bf16"


def cast_in(x, on: bool):
    """x in bf16 when `on` and x is a floating tensor, else x itself."""
    if on and torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16)
    return x


_step_casts: Optional[dict] = None  # id(master) -> (master, state, bf16 copy), in a step


def cast_param(p: torch.Tensor) -> torch.Tensor:
    """A floating parameter in bf16. Inside `casts_once` the copy is made
    once and reused while the parameter's version, its requires_grad and
    the autograd mode stay the same."""
    if not p.is_floating_point():
        return p
    if _step_casts is None:
        return p.to(torch.bfloat16)
    state = (p._version, p.requires_grad, torch.is_grad_enabled(),
             torch.is_inference_mode_enabled())
    hit = _step_casts.get(id(p))
    if hit is not None and hit[0] is p and hit[1] == state:
        return hit[2]
    copy = p.to(torch.bfloat16)
    _step_casts[id(p)] = (p, state, copy)
    return copy


def casts_once(step):
    """Decorate a trainer's step: within it `cast_param` keeps its copies,
    which are dropped when the step returns."""

    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        global _step_casts
        outer, _step_casts = _step_casts, {}
        try:
            return step(*args, **kwargs)
        finally:
            _step_casts = outer

    return wrapped


def run(models: nn.ModuleDict, key: str, on: bool, *args, **kwargs):
    """models[key](*args, **kwargs); in bf16 when `on` and key is one of
    BF16_MODULES (its parameters and floating tensor arguments cast, its
    buffers as they are)."""
    module = models[key]
    if not (on and key in BF16_MODULES):
        return module(*args, **kwargs)
    params = {n: cast_param(p) for n, p in module.named_parameters()}
    return functional_call(module, params, tuple(cast_in(a, True) for a in args),
                           {k: cast_in(v, True) for k, v in kwargs.items()})
