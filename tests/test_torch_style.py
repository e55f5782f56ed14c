"""Port parity for the multispeaker path's style side: the mel front end,
the spectral-norm Conv2d, the 2x2 pool and the StyleEncoder, against their
JAX counterparts on the CPU.

Tolerances: 1e-5 of the peak for single f32 layers (convolutions summed in
another order); 1e-4 for the normalised log-mel, whose log turns the
FFTs' ~1e-7 relative error in the quietest bins into an absolute one; 1e-4
for the StyleEncoder, ten SN convolutions deep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import styletts2_tpu_torch.convert as pc
from styletts2_tpu.models import layers as jl
from styletts2_tpu.models.build import _fi_spectral_align
from styletts2_tpu.models.style_encoder import StyleEncoder as JaxStyleEncoder
from styletts2_tpu.ops import stft as js
from styletts2_tpu_torch.models import layers as pl
from styletts2_tpu_torch.models.style_encoder import StyleEncoder
from styletts2_tpu_torch.ops import stft as ps
from torch_parity import _fill, rel_err, t

TOL = 1e-5


def test_mel_front_end(rng):
    """preprocess_mel on ~1.5 s of harmonics plus noise, and the HTK
    filterbank built for the 16 kHz nominal rate."""
    n = np.arange(36123)
    wave = (0.3 * np.sin(2 * np.pi * 180.0 * n / 24000) + 0.1 * np.sin(2 * np.pi * 540.0 * n / 24000)
            + 0.02 * rng.standard_normal(n.size)).astype(np.float32)[None]
    want = np.asarray(js.preprocess_mel(jnp.asarray(wave)))
    got = ps.preprocess_mel(t(wave)).numpy()
    assert got.shape == want.shape == (1, 80, 1 + 36123 // 300)
    assert rel_err(got, want) < 1e-4
    np.testing.assert_array_equal(ps.mel_filterbank(1025, 80), js.mel_filterbank(1025, 80))


# (in, out, kernel, stride, padding, groups, bias): the stem, the depthwise
# learned downsample, the bias-free 1x1 shortcut and the 5x5 valid conv
@pytest.mark.parametrize("cin,cout,k,stride,pad,groups,bias", [
    (1, 8, 3, 1, 1, 1, True),
    (6, 6, 3, 2, 1, 6, True),
    (6, 12, 1, 1, 0, 1, False),
    (6, 6, 5, 1, 0, 1, True),
])
def test_snconv2d(rng, cin, cout, k, stride, pad, groups, bias):
    x = rng.standard_normal((2, 11, 13, cin)).astype(np.float32)  # NHWC, odd H and W
    mod = jl.SNConv2d(cout, (k, k), stride=(stride, stride), padding=(pad, pad), groups=groups,
                      use_bias=bias)
    shapes = jax.eval_shape(lambda key: mod.init(key, x), jax.random.PRNGKey(0))
    variables = {c: _fill(v, rng) for c, v in shapes.items()}
    want = np.asarray(mod.apply(variables, x))
    sd = {}
    pc._snconv2d(variables["params"], variables["spectral"], sd, "m")
    port = pl.SNConv2d(cin, cout, k, stride, pad, groups, bias).requires_grad_(False).eval()
    port.load_state_dict({k[2:]: t(v) for k, v in sd.items()})
    got = port(t(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("H,W", [(7, 9), (8, 9), (7, 8), (8, 8)])
def test_avg_pool_2d_2x(rng, H, W):
    """Odd W repeats the last column; odd H drops the last row."""
    x = rng.standard_normal((2, 3, H, W)).astype(np.float32)
    want = np.asarray(jl.avg_pool_2d_2x(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got = pl.avg_pool_2d_2x(t(x)).numpy()
    assert got.shape == want.shape == (2, 3, H // 2, (W + 1) // 2)
    assert rel_err(got, want) < TOL


def test_style_encoder():
    """The JAX StyleEncoder at tiny widths with filled, SN-aligned
    variables against the port's carrying the same weights, with and
    without `lengths`."""
    jmod = JaxStyleEncoder(dim_in=8, style_dim=16, max_conv_dim=32)
    shapes = jax.eval_shape(lambda key: jmod.init(key, jnp.zeros((1, 80, 96))), jax.random.PRNGKey(0))
    variables = {c: _fill(v, np.random.default_rng(3)) for c, v in shapes.items()}
    _fi_spectral_align(variables["spectral"], variables["params"])
    sd = {}
    pc._style_encoder(variables, sd)
    port = StyleEncoder(8, 16, 32).requires_grad_(False).eval()
    port.load_state_dict({k: t(v) for k, v in sd.items()})
    mel = np.random.default_rng(4).standard_normal((2, 80, 101)).astype(np.float32)
    lengths = np.asarray([101, 83], np.int32)
    with torch.inference_mode():
        for lens in (None, lengths):
            want = np.asarray(jmod.apply(variables, mel, lens))
            got = port(t(mel), None if lens is None else torch.as_tensor(lens)).numpy()
            assert got.shape == want.shape == (2, 16)
            assert rel_err(got, want) < 1e-4
        with pytest.raises(ValueError, match="80 mel frames"):
            port(t(mel[:, :, :79]))
