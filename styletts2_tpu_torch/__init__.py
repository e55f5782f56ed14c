"""styletts2_tpu_torch — PyTorch/CUDA port of styletts2_tpu's synthesis path.

The JAX package `styletts2_tpu` is the numerical reference; this package
re-implements its inference paths as `torch.nn.Module`s with NCW
activations: single-speaker LJSpeech (text encoder, PL-BERT, style
diffusion, prosody, iSTFTNet decoder), zero-shot multispeaker LibriTTS (mel
style encoders, style-conditioned diffusion, HiFi-GAN decoder), batched
synthesis and the micro-batching HTTP server (`serve.py`). Its one Pallas
TPU kernel (fused AdaIN+snake) is a hand-written CUDA kernel for Hopper
(`csrc/`).

It imports neither JAX nor the JAX package, nor PyYAML at import time.
"""

__version__ = "0.1.0"

from styletts2_tpu_torch.config import Config, libritts_config, load_config  # noqa: F401
