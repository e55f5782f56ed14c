"""The port's SLM-adversarial pass against the JAX trainer at tiny widths,
single-speaker and multispeaker (the reference styles feeding the
denoiser): the generator loss through the sampled style, the soft
alignment, the decoded clip, WavLM and the WavLM discriminator, its
gradients after the reference's post-processing (divided by the
predictor's norm above thresh; the duration head and the diffusion model
scaled), and the discriminator's loss with the reconstruction regulariser
and its gradient. The harness, the draws and the tolerances are those of
tests/test_torch_stage2.py."""

import pytest

from test_torch_stage2 import _check_slm


@pytest.mark.parametrize("ms", [False, True])
def test_slm_losses_and_post_processing_match_jax(ms):
    _check_slm(ms)
