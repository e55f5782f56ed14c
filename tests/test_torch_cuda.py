"""The port's CUDA kernels (the fused AdaIN+snake forward, K1, and its
backward, K2) against their plain PyTorch versions, on the card.

Marked `gpu`: it needs an NVIDIA GPU and nvcc, and skips elsewhere. It
imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:
    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerance: atol = rtol = 1e-4 in f32 (the kernel sums the statistics in
another order than torch), 2e-2 in bf16 (one bf16 rounding of an O(1)
output, as tests/test_pallas.py). The backward's row sums (dgamma, dbeta)
and dalpha's sum over B and T add up to 3.8e5 f32 terms in another order
than torch: rtol 1e-4 with atol 1e-4 of the gradient's peak; dx in bf16 is
one bf16 rounding of an O(1) value (2e-2).
"""

import pytest
import torch

from styletts2_tpu_torch.ops.adain_snake import adain_snake, adain_snake_bwd_ref, adain_snake_ref

pytestmark = pytest.mark.gpu

# the iSTFTNet path's stage-0 and stage-1 shapes at an 8 s utterance, the
# HiFi-GAN path's four stages at an 8 s utterance (F = 320 frames: 20F,
# 100F, 300F, 600F) and its last stage batched by the server, the JAX
# tests' cases, odd T below 64 and T = 1
CASES = [
    ((1, 256, 8000), torch.float32),
    ((1, 128, 48001), torch.float32),
    ((1, 256, 6400), torch.float32),
    ((1, 128, 32000), torch.float32),
    ((1, 64, 96000), torch.float32),
    ((1, 32, 192000), torch.float32),
    ((8, 32, 192000), torch.float32),
    ((2, 256, 24), torch.float32),
    ((3, 256, 128), torch.float32),
    ((2, 256, 160), torch.bfloat16),
    ((2, 100, 37), torch.float32),
    ((2, 3, 1), torch.float32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype", CASES)
def test_kernel_matches_plain(cuda, shape, dtype):
    B, C, T = shape
    g = torch.Generator(cuda).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    gamma = torch.randn((B, C), generator=g, device=cuda) * 0.1
    beta = torch.randn((B, C), generator=g, device=cuda) * 0.1
    alpha = torch.rand((C,), generator=g, device=cuda) + 0.5
    with torch.inference_mode():
        before = adain_snake.launches
        got = adain_snake(x, gamma, beta, alpha)
        torch.cuda.synchronize()
        assert adain_snake.launches == before + 1
        want = adain_snake_ref(x, gamma, beta, alpha)
    assert got.dtype == dtype and got.shape == x.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn((1, 4, 16), device=cuda)
    p = torch.zeros((1, 4), device=cuda)
    a = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        adain_snake(x.transpose(1, 2), p, p, a)  # not contiguous
    with pytest.raises(TypeError):
        adain_snake(x.half(), p, p, a)
    with pytest.raises(ValueError):
        adain_snake(x, p, p, torch.ones(3, device=cuda))


# the stage-1 training shapes at batch 16 and a 200-frame clip (the
# Generator's 256- and 128-channel stages), an odd small shape and bf16
BWD_CASES = [
    ((16, 256, 4000), torch.float32),
    ((16, 128, 24001), torch.float32),
    ((2, 100, 37), torch.float32),
    ((2, 256, 160), torch.bfloat16),
]


def _close(got, want, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("shape,dtype", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    B, C, T = shape
    g = torch.Generator(cuda).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    gamma = torch.randn((B, C), generator=g, device=cuda) * 0.1
    beta = torch.randn((B, C), generator=g, device=cuda) * 0.1
    alpha = torch.rand((C,), generator=g, device=cuda) + 0.5
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta, alpha)]
    fwd, bwd = adain_snake.launches, adain_snake.bwd_launches
    y = adain_snake(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (adain_snake.launches, adain_snake.bwd_launches) == (fwd + 1, bwd + 1)
    plain = adain_snake_bwd_ref(x, gamma, beta, alpha, dy)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta, alpha)]
    auto = torch.autograd.grad(adain_snake_ref(*ref_leaves), ref_leaves, dy)
    for name, k, p, a in zip(("dx", "dgamma", "dbeta", "dalpha"), got, plain, auto):
        assert k.dtype == p.dtype and k.shape == p.shape, name
        _close(k, p, k.dtype)
        _close(k, a, k.dtype)


def test_backward_kernel_rejects_what_it_cannot_take(cuda):
    from styletts2_tpu_torch.ops.adain_snake import adain_snake_bwd

    x = torch.randn((1, 4, 16), device=cuda)
    p = torch.zeros((1, 4), device=cuda)
    a = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        adain_snake_bwd(x, p, p, a, torch.randn((1, 16, 4), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError):
        adain_snake_bwd(x, p, p, a, torch.randn((1, 4, 16), device=cuda).bfloat16())
