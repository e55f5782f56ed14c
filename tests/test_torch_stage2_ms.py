"""Stage-2 training of the port against the JAX trainer at tiny widths, the
multispeaker config (the HiFi-GAN decoder at the LibriTTS rates): the
reference styles of the batch's reference audio feed the denoiser in the
generator's diffusion loss and sampled style; the style of a clip is taken
from another clip of the utterance.
The harness, the draws and the tolerances are those of
tests/test_torch_stage2.py; the harmonic sines are zeroed (HiFi-GAN feeds
the raw source into every stage)."""

import pytest

from test_torch_stage2 import PHASES, _check_generator


@pytest.mark.parametrize("phase", list(PHASES))
def test_generator_loss_and_grads_match_jax(phase):
    _check_generator(True, phase)
