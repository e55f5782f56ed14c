"""The fused AdaIN+snake op of the port on the CPU: its plain version against
the JAX composition and the Pallas kernel (interpret mode), its plain
backward and its autograd Function against the JAX custom VJP's `_bwd` and
`jax.vjp` of the JAX composition, the wrapper's CPU contract, and the
kernels' launch plan (`_plan`) at the main paths' shapes. The CUDA kernels
themselves are compared with the plain versions on the card, in
tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: 1e-5 absolute in f32 (the same arithmetic in another summation
order; outputs are O(1)), 2e-2 in bf16 as tests/test_pallas.py (one bf16
rounding of an O(1) output). The gradients' sums over T (and over B and T
for dalpha) reach O(10): 1e-5 of the gradient's peak in f32 against `_bwd`
(the same f32 formula), 2e-4 absolute and 1e-3 relative against autodiff
of the composition (another formula, as tests/test_pallas.py holds `_bwd`
to it), one bf16 rounding (2e-2 relative) for bf16 cotangents.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from styletts2_tpu.ops.pallas_kernels import _adain_snake_ref, _bwd, fused_adain_snake
from styletts2_tpu_torch.ops.adain_snake import (AdainSnake, Limits, _plan, adain_snake,
                                                 adain_snake_bwd_ref, adain_snake_ref)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# the Pallas kernel unjitted: a jitted call would fill fused_adain_snake's trace
# cache, and tests/test_pallas.py, which watches pallas_call while that function
# traces, may run later in the same process
pallas_adain_snake = fused_adain_snake.__wrapped__


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
    pallas = np.asarray(pallas_adain_snake(x, gamma, beta, alpha, interpret=True))
    got = _port(x, gamma, beta, alpha)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


def test_plain_matches_pallas_bf16(rng):
    B, T, C = 2, 160, 256
    x, gamma, beta, alpha = _inputs(rng, B, T, C)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, gamma, beta, alpha)]
    pallas = pallas_adain_snake(*(jnp.asarray(a) for a in bf), interpret=True)
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
    # an input that needs a gradient goes through the autograd Function, whose
    # CPU backward is the plain port of `_bwd`; neither counts a launch
    leaves = [a.clone().requires_grad_(True) for a in (x, gamma, beta, alpha)]
    bwd_before = adain_snake.bwd_launches
    y = adain_snake(*leaves)
    assert type(y.grad_fn).__name__ == "AdainSnakeBackward"
    torch.testing.assert_close(y, adain_snake_ref(x, gamma, beta, alpha))
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    got = torch.autograd.grad(y, leaves, dy)
    for g, w in zip(got, adain_snake_bwd_ref(x, gamma, beta, alpha, dy)):
        torch.testing.assert_close(g, w)
    assert (adain_snake.launches, adain_snake.bwd_launches) == (before, bwd_before)
    with torch.no_grad():  # no graph wanted: the forward alone
        assert adain_snake(*leaves).grad_fn is None


def test_wrapper_cpu_route_keeps_the_dtype_and_computes_in_f32(rng):
    """A bf16 x through the wrapper on the CPU (its plain route): the output
    is bf16 and is the f32 (here f64) result rounded once; gamma, beta and
    alpha may come in bf16 too. The backward gives each gradient in its
    primal's dtype, from f32 math."""
    x, gamma, beta, alpha = _inputs(rng, 2, 300, 16, mean=20.0)
    xb = _ncw(x).bfloat16()
    gb, bb, ab = (torch.from_numpy(a).bfloat16() for a in (gamma, beta, alpha))
    xd, gd, bd, ad = (t.double() for t in (xb, gb, bb, ab))
    xhat = (xd - xd.mean(-1, keepdim=True)) / torch.sqrt(xd.var(-1, unbiased=False, keepdim=True)
                                                        + 1e-5)
    z = (1 + gd[:, :, None]) * xhat + bd[:, :, None]
    want = (z + torch.sin(ad[None, :, None] * z) ** 2 / ad[None, :, None]).bfloat16()
    got = adain_snake(xb, gb, bb, ab)
    assert got.dtype == torch.bfloat16
    # f32 statistics of a row whose mean is 20x its spread: at most one ulp off
    assert float((got.double() - want.double()).abs().max()) <= 2.0 ** -7 * float(want.abs().max())
    leaves = [t.clone().requires_grad_(True) for t in (xb, gb, bb, ab)]
    y = adain_snake(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4
    for g, w in zip(grads, adain_snake_bwd_ref(xb, gb, bb, ab, torch.ones_like(y))):
        assert torch.equal(g, w)


def _ncw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 2, 1)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# the tests/test_pallas.py VJP case, an odd T and a longer row
@pytest.mark.parametrize("B,T,C", [(2, 12, 128), (2, 37, 24), (1, 500, 16)])
def test_plain_backward_matches_jax_bwd_and_autodiff(rng, B, T, C):
    x, gamma, beta, alpha = _inputs(rng, B, T, C)
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    want = _bwd(tuple(jnp.asarray(a) for a in (x, gamma, beta, alpha)), jnp.asarray(dy))
    _, pull = jax.vjp(lambda x, g, b, a: _adain_snake_ref(x, g, b, a.reshape(1, 1, C)),
                      x, gamma, beta, alpha)
    auto = pull(jnp.asarray(dy))
    port_in = (_ncw(x), torch.from_numpy(gamma), torch.from_numpy(beta), torch.from_numpy(alpha))
    plain = adain_snake_bwd_ref(*port_in, _ncw(dy))
    leaves = [a.clone().requires_grad_(True) for a in port_in]
    fn = torch.autograd.grad(AdainSnake.apply(*leaves), leaves, _ncw(dy))
    for name, p, f, w, a in zip(("dx", "dgamma", "dbeta", "dalpha"), plain, fn, want, auto):
        p, f = p.numpy(), f.numpy()
        if name == "dx":
            p, f = p.transpose(0, 2, 1), f.transpose(0, 2, 1)
        assert p.shape == w.shape and p.dtype == np.float32, name
        np.testing.assert_array_equal(f, p)  # the Function's CPU backward is the plain one
        assert _rel(p, w) < 1e-5, name
        np.testing.assert_allclose(p, np.asarray(a), atol=2e-4, rtol=1e-3, err_msg=name)


def test_plain_backward_bf16_matches_jax_bwd(rng):
    """bf16 x and dy: f32 math inside, the cotangents back in the primal
    dtypes, as `_bwd` returns them."""
    B, T, C = 2, 160, 256
    x, gamma, beta, alpha = _inputs(rng, B, T, C)
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    xb, dyb = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, dy))
    want = _bwd((jnp.asarray(xb), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(alpha)),
                jnp.asarray(dyb))
    got = adain_snake_bwd_ref(_ncw(xb).bfloat16(), torch.from_numpy(gamma),
                              torch.from_numpy(beta), torch.from_numpy(alpha),
                              _ncw(dyb).bfloat16())
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 3
    np.testing.assert_allclose(got[0].float().numpy().transpose(0, 2, 1),
                               np.asarray(want[0], np.float32), atol=2e-2, rtol=2e-2)
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g.numpy(), w) < 1e-5


def _slices(T, k, S, head):
    """Each rank's (lo, hi, a0) as the kernels' `slice_of` computes them
    (csrc/adain_snake.cu) for a row whose first 16-byte boundary is `head`
    elements in: [lo, hi) is the rank's part of the row, a0 the start of its
    aligned middle."""
    head = min(T, head)
    out = []
    for r in range(k):
        lo = 0 if r == 0 else min(T, head + r * S)
        hi = T if r == k - 1 else min(T, head + (r + 1) * S)
        out.append((lo, hi, head if r == 0 else lo))
    return out


# every shape the main paths give K1 and K2 (chip_smoke.py's cases, the
# staged and batched graphs' among them), and a row too long for the
# cluster's shared memory
PLAN_CASES = sorted({(shape, False)
                     for shape, _ in chip_smoke.KERNEL_CASES + chip_smoke.GRAPH_CASES}
                    | {(shape, True) for shape, _ in chip_smoke.BWD_CASES}) + [((1, 32, 480000), False)]
# an H100 SXM's room: 132 SMs; 227 KB of shared memory per block and 228 KB
# per SM, 1 KB of which each block reserves; up to 512 bytes of the kernels'
# own (static) shared memory
H100 = Limits(sms=132, block=227 * 1024 - 512, pair=228 * 1024 // 2 - 1024 - 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,backward", PLAN_CASES)
def test_plan(shape, backward, dtype):
    """The launch plan: a cluster size that divides the grid, slices that
    cover T exactly at every row alignment, shared memory within the
    block's limit, at least one block per SM for an utterance's rows at
    B = 1, and streaming where the slice cannot fit."""
    B, C, T = shape
    plan = _plan(B, C, T, dtype, H100, backward)
    size = 2 if dtype == torch.bfloat16 else 4
    vec, arrays = 16 // size, 2 if backward else 1
    grid = B * C * plan.k
    assert plan.k in (1, 2, 4, 8) and grid % plan.k == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.slice % vec == 0 and plan.slice * plan.k >= T > plan.slice * (plan.k - 1) - vec
    for head in range(vec):
        parts = _slices(T, plan.k, plan.slice, head)
        assert parts[0][0] == 0 and parts[-1][1] == T
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        for lo, hi, a0 in parts:
            middle = (hi - a0) // vec * vec
            assert lo <= a0 <= hi and a0 - lo < vec and hi - a0 - middle < vec
            assert a0 == T or (a0 - min(T, head)) % vec == 0  # on a 16-byte boundary
            assert middle <= plan.slice  # the shared memory holds it
    assert plan.smem <= H100.block
    if plan.smem:
        assert plan.smem == arrays * plan.slice * size
    else:
        assert arrays * plan.slice * size > H100.block and plan.k == 8
    if B == 1 and T >= 4000:  # a single utterance's decoder rows fill the SMs
        assert grid >= H100.sms
    if shape == (1, 32, 480000):
        assert (plan.smem == 0) == (dtype == torch.float32)
    assert _plan(B, C, T, dtype, H100, backward, 4).k == 4  # a forced k is taken
