"""styletts2_tpu_torch — PyTorch/CUDA port of styletts2_tpu's synthesis path.

The JAX package `styletts2_tpu` is the numerical reference; this package
re-implements its single-speaker LJSpeech inference path (text encoder,
PL-BERT, style diffusion, prosody, iSTFTNet decoder) as `torch.nn.Module`s
with NCW activations, and replaces its one Pallas TPU kernel (fused
AdaIN+snake) with a hand-written CUDA kernel for Hopper (`csrc/`).

It imports neither JAX nor the JAX package, nor PyYAML at import time.
"""

__version__ = "0.1.0"

from styletts2_tpu_torch.config import Config, load_config  # noqa: F401
