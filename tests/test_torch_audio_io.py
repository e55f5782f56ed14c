"""The port's WAV reader and sinc resampler (styletts2_tpu_torch.utils), which
build the server's voice table, against the JAX package's on the same
inputs. Both are numpy, so the results must be bit-exact."""

import wave

import numpy as np
import pytest

from styletts2_tpu import utils as jax_utils
from styletts2_tpu_torch import utils as port_utils


@pytest.mark.parametrize("sr_in", [22050, 48000, 16000, 24000])
def test_resample_sinc_matches_jax(sr_in):
    rng = np.random.default_rng(sr_in)
    n = np.arange(int(0.4 * sr_in))
    x = (0.4 * np.sin(2 * np.pi * 210.0 * n / sr_in)
         + 0.1 * rng.standard_normal(n.size)).astype(np.float32)
    got = port_utils.resample_sinc(x, sr_in, 24000)
    want = jax_utils.resample_sinc(x, sr_in, 24000)
    assert got.dtype == np.float32 and got.shape == want.shape == (-(-n.size * 24000 // sr_in),)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_read_wav_matches_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    n = 1000
    if width == 1:
        pcm = rng.integers(0, 256, n * channels).astype(np.uint8)
    else:
        dt = {2: np.int16, 4: np.int32}[width]
        info = np.iinfo(dt)
        pcm = rng.integers(info.min, info.max, n * channels, dtype=np.int64).astype(dt)
    path = str(tmp_path / f"w{width}_{channels}.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(22050)
        f.writeframes(pcm.tobytes())
    got, sr = port_utils.read_wav(path)
    want, want_sr = jax_utils.read_wav(path)
    assert sr == want_sr == 22050 and got.shape == want.shape == (n,)
    assert got.dtype == np.float32 and np.abs(got).max() <= 1.0
    np.testing.assert_array_equal(got, want)
