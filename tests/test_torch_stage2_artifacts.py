"""Stage 2's eval artifacts and validation losses against the JAX trainer's
(`styletts2_tpu/train/stage2.py`: `eval_artifacts`, `validate`) at tiny
widths, single-speaker (iSTFTNet) and multispeaker (HiFi-GAN, the
utterance's own styles feeding the denoiser), on the numpy-seeded weights
and batch of tests/test_torch_stage2.py.

Before joint_epoch the artifact is the predicted-prosody reconstruction of
the first 3 samples beside their clips; from it, the first sample's text
synthesised with a sampled style (5 ADPM2 steps, rounded durations, a
100-frame bucket) and trimmed to total * 600 samples. Every draw is zeroed
on both sides and the NSF source's chaotic parts too (tests/torch_parity.py),
so both samplers start from the same (zero) noise and the comparison holds
the style split, the features, the duration rounding and the alignment.

The single-speaker head is scaled to the multispeaker one's 0.01 (the
setup's 0.1 times 0.1): at 0.1 the random-init iSTFTNet opens each clip
with an exp transient (|y| ~5 in the first 70 samples against a mean of
0.02) where exp amplifies f32 reassociation, and the port's and JAX's
decoders on the same inputs part by 1.2e-3 of the peak there and by 2.5e-5
elsewhere, the decoder's inputs agreeing within 4e-6.

Tolerances: the ground-truth clips are slices of the same wave, equal; the
sampled length exactly; the waves within 1e-3 of their peak, the decoder's
bound (test_torch_decoder.py); the validation losses 1e-4 relative, as the
stage-2 losses in tests/test_torch_stage2.py, the mel loss 1e-3 (it is a
loss on the reconstruction, held to the decoder's bound).
"""

import types

import numpy as np
import pytest

from styletts2_tpu.train.stage2 import Stage2Trainer as JaxStage2
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.train import stage2 as pstage2
from styletts2_tpu_torch.train.state import TrainState
from test_torch_stage2 import SIGMA_DATA, _draws, _jax_inputs, _make_setup
from torch_parity import rel_err

_SETUPS = {}


def _setup(ms):
    """test_torch_stage2's weights and batch, built anew (its cached setup is
    shared with that file's tests), the single-speaker head scaled."""
    if ms not in _SETUPS:
        s = _make_setup(ms)
        if not ms:
            s.variables["decoder"]["params"]["generator"]["conv_post"]["g"] *= 0.1
            sd = state_dict_from_jax(s.variables, s.pcfg, keys=("decoder",))
            s.port["decoder"].load_state_dict({k.removeprefix("decoder."): v for k, v in sd.items()})
        _SETUPS[ms] = s
    return _SETUPS[ms]


def _trainers(ms):
    s = _setup(ms)
    _, params, extras = _jax_inputs(s)
    jt = object.__new__(JaxStage2)  # the trainer's state without its optimisers and mesh
    jt.cfg, jt.models, jt.multispeaker, jt._eval_fns = s.jcfg, s.models, ms, {}
    jt.state = types.SimpleNamespace(params=params, extras=extras, sigma_data=SIGMA_DATA)
    pt = pstage2.Stage2Trainer(s.pcfg, TrainState(s.port, {}, sigma_data=SIGMA_DATA), "cpu")
    return s, jt, pt


@pytest.mark.parametrize("sample", [False, True], ids=["recon", "sampled"])
@pytest.mark.parametrize("ms", [False, True], ids=["ljspeech", "multispeaker"])
def test_stage2_artifacts_match_jax(ms, sample):
    s, jt, pt = _trainers(ms)
    with _draws(ms):
        want = jt.eval_artifacts(s.batch, np.random.default_rng(5), sample=sample)["audio"]
        got = pt.eval_artifacts(s.batch, np.random.default_rng(5), sample=sample)["audio"]
    tags = ["gt_0", "sampled_0"] if sample else ["gt_0", "gt_1", "y_rec_0", "y_rec_1"]
    assert sorted(got) == sorted(want) == tags
    for tag in tags:
        if tag.startswith("gt"):
            np.testing.assert_array_equal(got[tag], want[tag])
        else:
            assert got[tag].shape == want[tag].shape
            assert len(got[tag]) > 0 and len(got[tag]) % 600 == 0
            assert np.isfinite(got[tag]).all()
            assert rel_err(got[tag], want[tag]) < 1e-3, tag


@pytest.mark.parametrize("ms", [False, True], ids=["ljspeech", "multispeaker"])
def test_stage2_validate_matches_jax(ms):
    s, jt, pt = _trainers(ms)
    with _draws(ms):
        want = jt.validate(s.batch, np.random.default_rng(7))
        got = pt.validate(s.batch, np.random.default_rng(7))
    assert sorted(got) == sorted(want) == ["F0", "dur", "mel"]
    for k, tol in (("mel", 1e-3), ("dur", 1e-4), ("F0", 1e-4)):
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), (k, got[k], want[k])
