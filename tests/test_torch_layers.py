"""Port parity, layer by layer: styletts2_tpu_torch.models.layers, ops.stft,
utils and text against their JAX counterparts on the CPU.

Tolerance: 1e-5 relative to the output's peak for single f32 layers (the
two frameworks sum convolutions and reductions in different orders; one
layer's reassociation error is ~1e-7 of the peak), 1e-4 for the recurrent
BiLSTM, whose error grows with the number of steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import styletts2_tpu_torch.convert as pc
from styletts2_tpu.models import layers as jl
from styletts2_tpu_torch.models import layers as pl
from torch_parity import nwc_to_ncw, rel_err, t

TOL = 1e-5


def _apply(mod, *args):
    variables = mod.init(jax.random.PRNGKey(0), *args)
    return variables, np.asarray(jax.jit(mod.apply)(variables, *args))


def _randomize_gain(variables, rng):
    p = jax.tree.map(np.asarray, variables)["params"]
    p["g"] = rng.uniform(0.5, 1.5, p["g"].shape).astype(np.float32)
    return {"params": p}


def _load(module, sd):
    module.load_state_dict({k[2:]: t(v) for k, v in sd.items()})
    return module.requires_grad_(False)


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1), (1, 3, 3)])
def test_wnconv1d(rng, stride, padding, dilation):
    x = rng.standard_normal((2, 23, 6)).astype(np.float32)
    mod = jl.WNConv1d(5, 3, stride=stride, padding=padding, dilation=dilation)
    variables = _randomize_gain(mod.init(jax.random.PRNGKey(0), x), rng)
    want = np.asarray(mod.apply(variables, x))
    sd = {}
    pc._wnconv1d(variables["params"], sd, "m")
    port = _load(pl.WNConv1d(6, 5, 3, stride, padding, dilation), sd)
    got = port(nwc_to_ncw(x)).numpy().transpose(0, 2, 1)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("depthwise", [False, True])
def test_wnconv_transpose1d(rng, depthwise):
    C = 6
    x = rng.standard_normal((2, 9, C)).astype(np.float32)
    if depthwise:  # AdainResBlk1d's 2x pool
        mod = jl.WNConvTranspose1d(C, 3, stride=2, padding=1, output_padding=1, groups=C)
        port = pl.WNConvTranspose1d(C, C, 3, 2, 1, 1, groups=C)
    else:  # the Generator's upsampler (k=20, u=10)
        mod = jl.WNConvTranspose1d(4, 20, stride=10, padding=5, output_padding=0)
        port = pl.WNConvTranspose1d(C, 4, 20, 10, 5, 0)
    variables = _randomize_gain(mod.init(jax.random.PRNGKey(0), x), rng)
    want = np.asarray(mod.apply(variables, x))
    sd = {}
    pc._wnconvtr1d(variables["params"], sd, "m")
    got = _load(port, sd)(nwc_to_ncw(x)).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL


def test_norms_and_pointwise(rng):
    x = (rng.standard_normal((2, 17, 8)) * 3 + 5).astype(np.float32)
    s = rng.standard_normal((2, 4)).astype(np.float32)
    xt = nwc_to_ncw(x)

    got = pl.instance_norm(xt).numpy().transpose(0, 2, 1)
    assert rel_err(got, jl.instance_norm(jnp.asarray(x))) < TOL

    for jmod, port, ncw in ((jl.AdaIN1d(8), pl.AdaIN1d(4, 8), True),
                            (jl.AdaLayerNorm(), pl.AdaLayerNorm(4, 8), False)):
        variables, want = _apply(jmod, x, s)
        sd = {}
        pc._lin(variables["params"]["fc"], sd, "m.fc")
        port = _load(port, sd)
        got = port(xt, t(s)).numpy().transpose(0, 2, 1) if ncw else port(t(x), t(s)).numpy()
        assert rel_err(got, want) < TOL, type(port).__name__

    port = pl.ChannelLayerNorm(8).requires_grad_(False)
    port.gamma.data = t(rng.uniform(0.5, 1.5, 8))
    port.beta.data = t(rng.standard_normal(8))
    want = jl.ChannelLayerNorm().apply(
        {"params": {"gamma": port.gamma.numpy(), "beta": port.beta.numpy()}}, x)
    got = port(xt).numpy().transpose(0, 2, 1)
    assert rel_err(got, want) < TOL

    alpha = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    got = pl.snake(xt, t(alpha)[None, :, None]).numpy().transpose(0, 2, 1)
    assert rel_err(got, jl.snake(x, alpha)) < TOL
    np.testing.assert_allclose(pl.leaky_relu(xt).numpy(), np.asarray(jl.leaky_relu(x)).transpose(0, 2, 1))
    np.testing.assert_array_equal(pl.upsample_nearest_2x(xt).numpy().transpose(0, 2, 1),
                                  np.asarray(jl.upsample_nearest_2x(x)))


def test_bilstm_masks_padded_steps(rng):
    """lengths < T: padded steps output 0 and the reverse direction starts
    at each row's own last valid step."""
    B, T, C, H = 3, 11, 5, 4
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    lengths = np.asarray([11, 7, 3], np.int32)
    mod = jl.BiLSTM(H)
    variables = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), x, lengths))
    want = np.asarray(mod.apply(variables, x, lengths))
    sd = {}
    pc._bilstm(variables["params"], sd, "m")
    port = _load(pl.BiLSTM(C, H), sd)
    got = port(t(x), torch.as_tensor(lengths)).numpy()
    assert got.shape == (B, T, 2 * H)
    assert rel_err(got, want) < 1e-4
    assert np.all(got[1, 7:] == 0) and np.all(got[2, 3:] == 0)
    # full lengths and no lengths take the unpacked path
    full = port(t(x)).numpy()
    want_full = np.asarray(mod.apply(variables, x, np.full(B, T, np.int32)))
    assert rel_err(full, want_full) < 1e-4


def test_stft_istft(rng):
    from styletts2_tpu.ops import stft as js
    from styletts2_tpu_torch.ops import stft as ps

    x = rng.standard_normal((2, 605)).astype(np.float32)
    mag_j, ph_j = js.stft_magphase(jnp.asarray(x), 20, 5, 20)
    mag_p, ph_p = ps.stft_magphase(t(x), 20, 5, 20)
    assert rel_err(mag_p.numpy(), mag_j) < TOL
    mag = rng.uniform(0.1, 2.0, (2, 11, 40)).astype(np.float32)
    phase = rng.uniform(-3, 3, (2, 11, 40)).astype(np.float32)
    want = np.asarray(js.istft(jnp.asarray(mag), jnp.asarray(phase), 20, 5, 20))
    got = ps.istft(t(mag), t(phase), 20, 5, 20).numpy()
    assert got.shape == want.shape == (2, 5 * 39)
    assert rel_err(got, want) < TOL
    np.testing.assert_array_equal(ps.hann_window(20), js.hann_window(20))


def test_duration_to_alignment_and_text():
    from styletts2_tpu import text as jt
    from styletts2_tpu.utils import duration_to_alignment as j_aln
    from styletts2_tpu_torch import text as ptext
    from styletts2_tpu_torch.utils import duration_to_alignment as p_aln

    dur = np.asarray([[2, 3, 1, 0], [1, 1, 0, 0]], np.int32)
    np.testing.assert_array_equal(p_aln(torch.as_tensor(dur), 9).numpy(), np.asarray(j_aln(dur, 9)))

    assert ptext.SYMBOLS == jt.SYMBOLS and len(ptext.SYMBOLS) == 178
    s = "ðɪ kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps! #" + "".join(jt.SYMBOLS)
    np.testing.assert_array_equal(ptext.encode_text(s), jt.encode_text(s))
