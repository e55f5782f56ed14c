"""The fused AdaIN+snake op of the port on the CPU: its plain version against
the JAX composition and the Pallas kernel (interpret mode), and the
wrapper's CPU contract. The CUDA kernel itself is compared with the plain
version on the card, in tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: 1e-5 absolute in f32 (the same arithmetic in another summation
order; outputs are O(1)), 2e-2 in bf16 as tests/test_pallas.py (one bf16
rounding of an O(1) output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.ops.pallas_kernels import _adain_snake_ref, fused_adain_snake
from styletts2_tpu_torch.ops.adain_snake import adain_snake, adain_snake_ref


def _inputs(rng, B, T, C, mean=0.0):
    x = (rng.standard_normal((B, T, C)) + mean).astype(np.float32)
    gamma = (rng.standard_normal((B, C)) * 0.1).astype(np.float32)
    beta = (rng.standard_normal((B, C)) * 0.1).astype(np.float32)
    alpha = (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32)
    return x, gamma, beta, alpha


def _port(x, gamma, beta, alpha, dtype=torch.float32):
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).to(dtype)
    out = adain_snake_ref(xt, *(torch.from_numpy(a).to(dtype) for a in (gamma, beta, alpha)))
    return out.float().numpy().transpose(0, 2, 1)


# the tests/test_pallas.py cases (T=24 takes the Pallas wrapper's jnp fallback,
# T=128 its kernel) and an odd T below 64
@pytest.mark.parametrize("B,T,C", [(2, 24, 256), (3, 128, 256), (2, 37, 128)])
def test_plain_matches_jax_and_pallas_f32(rng, B, T, C):
    x, gamma, beta, alpha = _inputs(rng, B, T, C)
    want = np.asarray(_adain_snake_ref(x, gamma, beta, jnp.asarray(alpha).reshape(1, 1, C)))
    pallas = np.asarray(fused_adain_snake(x, gamma, beta, alpha, interpret=True))
    got = _port(x, gamma, beta, alpha)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


def test_plain_matches_pallas_bf16(rng):
    B, T, C = 2, 160, 256
    x, gamma, beta, alpha = _inputs(rng, B, T, C)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, gamma, beta, alpha)]
    pallas = fused_adain_snake(*(jnp.asarray(a) for a in bf), interpret=True)
    got = _port(*(np.asarray(a, np.float32) for a in bf), dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=2e-2, rtol=2e-2)


def test_plain_uses_centred_variance(rng):
    """A row whose mean is 1e3 times its spread keeps its normalisation."""
    x, gamma, beta, alpha = _inputs(rng, 1, 64, 4, mean=3000.0)
    x64 = x.astype(np.float64)
    xhat = (x64 - x64.mean(1, keepdims=True)) / np.sqrt(x64.var(1, keepdims=True) + 1e-5)
    y = (1 + gamma[:, None]) * xhat + beta[:, None]
    want = y + np.sin(alpha * y) ** 2 / alpha
    np.testing.assert_allclose(_port(x, gamma, beta, alpha), want, atol=1e-3)


def test_wrapper_cpu_contract(rng):
    x, gamma, beta, alpha = (torch.from_numpy(a) for a in _inputs(rng, 1, 16, 8))
    x = x.transpose(1, 2).contiguous()
    before = adain_snake.launches
    torch.testing.assert_close(adain_snake(x, gamma, beta, alpha),
                               adain_snake_ref(x, gamma, beta, alpha))
    assert adain_snake.launches == before  # only kernel launches count
    with pytest.raises(RuntimeError, match="backward"):
        adain_snake(x.requires_grad_(True), gamma, beta, alpha)
