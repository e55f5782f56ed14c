"""The port's CUDA kernels (the fused AdaIN+snake forward, K1, and its
backward, K2) against their plain PyTorch versions, on the card; the
synthesis paths' CUDA graphs against the same programs run eagerly; the
BiLSTM's precision on the card against f64.

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

import contextlib

import pytest
import torch

from styletts2_tpu_torch.ops.adain_snake import (_forward_kernel, _limits, adain_snake,
                                                 adain_snake_bwd, adain_snake_bwd_ref,
                                                 adain_snake_ref, plan_of)

pytestmark = pytest.mark.gpu

# the iSTFTNet path's stage-0 and stage-1 shapes at an 8 s utterance, the
# HiFi-GAN path's four stages at an 8 s utterance (F = 320 frames: 20F,
# 100F, 300F, 600F) and its last stage batched by the server, the JAX
# tests' cases, odd T below 64, T = 1, rows that stream from global memory
# (their slices exceed shared memory; the second with odd T) and bf16 at k = 8
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
    ((1, 32, 480000), torch.float32),
    ((1, 8, 480001), torch.float32),
    ((1, 32, 192000), torch.bfloat16),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, cuda, seed):
    """Seeded (x, gamma, beta, alpha, dy) on the card for x of `shape`."""
    B, C, T = shape
    g = torch.Generator(cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    gamma = torch.randn((B, C), generator=g, device=cuda) * 0.1
    beta = torch.randn((B, C), generator=g, device=cuda) * 0.1
    alpha = torch.rand((C,), generator=g, device=cuda) + 0.5
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return x, gamma, beta, alpha, dy


@pytest.mark.parametrize("shape,dtype", CASES)
def test_kernel_matches_plain(cuda, shape, dtype):
    x, gamma, beta, alpha, _ = _inputs(shape, dtype, cuda, 0)
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
    shifted = torch.randn(4 * 16 + 1, device=cuda)[1:].view(1, 4, 16)  # contiguous, 4 bytes in
    with pytest.raises(ValueError):
        adain_snake(shifted, p, p, a)  # not on a 16-byte boundary
    want = adain_snake_ref(shifted, p, p, a)
    torch.testing.assert_close(adain_snake(shifted.clone(), p, p, a), want, atol=1e-4, rtol=1e-4)


# the stage-1 training shapes at batch 16 and a 200-frame clip (the
# Generator's 256- and 128-channel stages), an odd small shape, bf16 and a
# row that streams from global memory with odd T
BWD_CASES = [
    ((16, 256, 4000), torch.float32),
    ((16, 128, 24001), torch.float32),
    ((2, 100, 37), torch.float32),
    ((2, 256, 160), torch.bfloat16),
    ((1, 16, 240001), torch.float32),
]


def _close(got, want, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("shape,dtype", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    x, gamma, beta, alpha, dy = _inputs(shape, dtype, cuda, 1)
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
    x = torch.randn((1, 4, 16), device=cuda)
    p = torch.zeros((1, 4), device=cuda)
    a = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        adain_snake_bwd(x, p, p, a, torch.randn((1, 16, 4), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError):
        adain_snake_bwd(x, p, p, a, torch.randn((1, 4, 16), device=cuda).bfloat16())
    shifted = torch.randn(4 * 16 + 2, device=cuda)[2:].view(1, 4, 16)  # 8 bytes in
    with pytest.raises(ValueError):
        adain_snake_bwd(x, p, p, a, shifted)
    with pytest.raises(ValueError):
        adain_snake_bwd(shifted, p, p, a, x)


def test_limits_are_the_cards(cuda):
    """The plan's room is read from the card: its SMs, and shared memory
    within its per-block and per-SM limits."""
    props = torch.cuda.get_device_properties(cuda)
    lim = _limits(torch.cuda.current_device())
    assert lim.sms == props.multi_processor_count
    assert 0 < lim.pair < lim.block <= 227 * 1024  # Hopper's opt-in limit per block


# the ragged edges of a row split over a cluster of k blocks, k forced: odd T,
# not divisible by k, at every k; T < 16, so that ranks past the row's end
# have empty slices; bf16 at k = 8
SPLIT_CASES = [((2, 5, 1001), torch.float32, k) for k in (1, 2, 4, 8)] + [
    ((1, 3, 13), torch.float32, 8),
    ((2, 4, 5), torch.float32, 4),
    ((2, 5, 1001), torch.bfloat16, 8),
]


@pytest.mark.parametrize("shape,dtype,k", SPLIT_CASES)
def test_split_rows_match_plain(cuda, shape, dtype, k):
    x, gamma, beta, alpha, dy = _inputs(shape, dtype, cuda, 2)
    assert plan_of(x, k=k).k == k
    got = _forward_kernel(x, gamma, beta, alpha, k=k)
    grads = adain_snake_bwd(x, gamma, beta, alpha, dy, k=k)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), adain_snake_ref(x, gamma, beta, alpha).float(),
                               atol=tol, rtol=tol)
    for name, kern, plain in zip(("dx", "dgamma", "dbeta", "dalpha"), grads,
                                 adain_snake_bwd_ref(x, gamma, beta, alpha, dy)):
        assert kern.dtype == plain.dtype and kern.shape == plain.shape, name
        _close(kern, plain, kern.dtype)


# a row split over 8 blocks (HiFi-GAN's last stage), over 2 with odd T
# (iSTFTNet's stage 1; K2 at the training shape), and one block per row
@pytest.mark.parametrize("shape", [(1, 32, 192000), (1, 128, 48001), (16, 128, 24001), (2, 256, 6400)])
def test_kernels_are_deterministic(cuda, shape):
    """Two launches on the same input give the same bits: the cluster's
    partials merge in rank order, with no atomics."""
    x, gamma, beta, alpha, dy = _inputs(shape, torch.float32, cuda, 3)
    with torch.inference_mode():
        assert torch.equal(adain_snake(x, gamma, beta, alpha), adain_snake(x, gamma, beta, alpha))
    first, second = (adain_snake_bwd(x, gamma, beta, alpha, dy) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fidelity_step_launches_the_kernels(cuda):
    """One pre-TMA step of the fidelity tool's tiny model (three resblock
    kernels, 48 AdaIN+snake rows per decoder run) on the card: 48 K1 and
    48 K2 launches, finite metrics."""
    import numpy as np

    from styletts2_tpu_torch import fidelity

    cfg = fidelity.fidelity_config("tiny")
    cfg.model_params.decoder.resblock_kernel_sizes = [3, 7, 11]
    cfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]] * 3
    trainer = fidelity.build_trainer(cfg, cuda)
    rng = np.random.default_rng(fidelity.TRAIN_SEED)
    k1, k2 = adain_snake.launches, adain_snake.bwd_launches
    m = trainer.train_step(fidelity.speechlike_batch(rng, 2), 0, 0, rng)
    assert (adain_snake.launches - k1, adain_snake.bwd_launches - k2) == (48, 48)
    assert all(np.isfinite(v) for v in m.values()), m


def _tp_layers_worker(rank, init_file, out):
    """One of two gloo ranks on cuda:0: a column/row pair and to_kv-style
    split (parts 2) against the full layers on the same inputs."""
    import torch.distributed as dist
    from torch import nn

    from styletts2_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    try:
        m = mesh.make_mesh(2, 2)
        g = torch.manual_seed(0)  # both ranks build the same layers and input
        col, row = nn.Linear(64, 256), nn.Linear(256, 64)
        kv = nn.Linear(64, 256, bias=False)
        for lin in (col, row, kv):
            lin.to("cuda")
        x = torch.randn(3, 5, 64, generator=g).cuda().requires_grad_()
        want = row(torch.nn.functional.gelu(col(x))) + kv(x).chunk(2, dim=-1)[0].sum()
        want.square().sum().backward()
        scol, srow, skv = (mesh.ShardedLinear(lin, d, p, m.model, m.model_rank)
                           for lin, d, p in ((col, 0, 1), (row, 1, 1), (kv, 0, 2)))
        xs = x.detach().clone().requires_grad_()
        k_half = skv(xs).chunk(2, dim=-1)[0]  # this rank's heads of the key half
        got = srow(torch.nn.functional.gelu(scol(xs))) + mesh.reduce_from_model(k_half.sum())
        got.square().sum().backward()
        errs = [float((got - want).abs().max() / want.abs().max().detach()),
                float((xs.grad - x.grad).abs().max() / x.grad.abs().max())]
        for lin, s in ((col, scol), (row, srow), (kv, skv)):
            full = s.gather(s.weight.grad, "weight")
            errs.append(float((full - lin.weight.grad).abs().max() / lin.weight.grad.abs().max()))
        torch.save(errs, f"{out}{rank}")
    finally:
        mesh.reset()
        dist.destroy_process_group()


def test_tensor_parallel_layers_match_the_full_ones(cuda, tmp_path):
    """Two gloo ranks on cuda:0 at model parallel 2: the sharded pair's
    output, the input's gradient and every weight's gathered gradient
    within 1e-5 of the full layers' (f32, TF32 off; only the sums' order
    differs)."""
    import torch.multiprocessing as mp

    mp.spawn(_tp_layers_worker, args=(str(tmp_path / "rdv"), str(tmp_path / "errs")), nprocs=2)
    for rank in range(2):
        errs = torch.load(tmp_path / f"errs{rank}")
        assert max(errs) <= 1e-5, errs


def _tiny_synthesizer(config, device, **kw):
    """A Synthesizer of `config` ("ljspeech": iSTFTNet, 48 K1 per decode;
    "libritts": multispeaker HiFi-GAN, 96) at narrow widths, seed 0."""
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.inference import Synthesizer

    cfg = libritts_config() if config == "libritts" else Config()
    cfg.plbert_params.num_hidden_layers = 1
    cfg.plbert_params.hidden_size = 64
    cfg.plbert_params.intermediate_size = 128
    cfg.plbert_params.num_attention_heads = 2
    cfg.model_params.hidden_dim = 64
    cfg.model_params.style_dim = 32
    cfg.model_params.dim_in = 16
    cfg.model_params.diffusion.transformer.num_layers = 1
    cfg.model_params.decoder.upsample_initial_channel = 64
    return Synthesizer(cfg, seed=0, device=device, **kw)


FUSED_TEXT = "ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt."


@pytest.mark.parametrize("config,per_decode", [("ljspeech", 48), ("libritts", 96)])
def test_fused_graph_replay_equals_eager(cuda, config, per_decode):
    """`inference_fused` on the card is one CUDA graph: a replay equals an
    eager run of the same program with the same seed, same-seed replays
    are bit-equal and another seed's differ, and each replay adds the K1
    launches its capture recorded (the capture itself adds none)."""
    import numpy as np

    from styletts2_tpu_torch.inference import _mix, _pack
    from styletts2_tpu_torch.text import encode_text

    syn = _tiny_synthesizer(config, cuda)
    ref_s = (0.5 * np.random.default_rng(0).standard_normal((1, 64))).astype(np.float32) \
        if syn.multispeaker else None
    kw = dict(frame_budget=120, ref_s=ref_s, diffusion_steps=3, speed=4.0)
    before = adain_snake.launches
    wav = syn.inference_fused(FUSED_TEXT, seed=0, **kw)
    (graph,) = syn.graphs.values()  # one program: no other graph
    assert graph.k1 == per_decode
    assert adain_snake.launches - before == 2 * per_decode  # the warm-up and one replay
    before = adain_snake.launches
    again, other = (syn.inference_fused(FUSED_TEXT, seed=s, **kw) for s in (0, 1))
    assert adain_snake.launches - before == 2 * per_decode and len(syn.graphs) == 1
    assert np.array_equal(wav, again) and not np.array_equal(wav, other)
    inputs = syn._inputs(encode_text(FUSED_TEXT), ref_s, None, _mix(0.3, 0.7, speed=4.0), 0)
    with torch.inference_mode():
        eager = _pack(*syn._fused(torch.Generator(cuda).manual_seed(0), **inputs,
                                  frame_budget=120, steps=3, scale=1.0)).cpu().numpy()
    eager = eager[: int(eager[-1]) * 600]
    assert eager.shape == wav.shape and np.isfinite(wav).all()
    assert np.abs(wav - eager).max() <= 1e-5 * np.abs(eager).max()


def test_phase_a_graph_equals_staged(cuda):
    """Synthesizer(phase_a="fused") on the card: text, style and duration
    replayed as one graph (no K1 in it), then the prosody and decode
    graphs, the durations and the waveform those of the staged chain."""
    import numpy as np

    staged = _tiny_synthesizer("ljspeech", cuda)
    fused = _tiny_synthesizer("ljspeech", cuda, phase_a="fused")
    want = staged.synthesize(FUSED_TEXT, diffusion_steps=3, speed=4.0, seed=2)
    got = fused.synthesize(FUSED_TEXT, diffusion_steps=3, speed=4.0, seed=2)
    assert [k[0] for k in fused.graphs] == ["phase_a", "prosody", "decode"]
    assert [k[0] for k in staged.graphs] == ["text", "style", "duration", "prosody", "decode"]
    assert [g.k1 for g in fused.graphs.values()] == [0, 0, 48]
    np.testing.assert_array_equal(got.pred_dur, want.pred_dur)
    assert got.wav.shape == want.wav.shape
    assert np.abs(got.wav - want.wav).max() <= 1e-5 * np.abs(want.wav).max()


def test_graphs_of_one_synthesizer_share_a_pool(cuda):
    """A Synthesizer's graphs share the first one's memory pool: the
    phase-A, prosody and decode graphs of a request and two
    `inference_fused` graphs (budgets 120 and 60) replayed in turn each
    give what their first call gave, bit for bit."""
    import numpy as np

    syn = _tiny_synthesizer("ljspeech", cuda, phase_a="fused")
    calls = [lambda: syn.synthesize(FUSED_TEXT, diffusion_steps=3, speed=4.0, seed=1).wav,
             lambda: syn.inference_fused(FUSED_TEXT, frame_budget=120, diffusion_steps=3,
                                         speed=4.0),
             lambda: syn.inference_fused(FUSED_TEXT, frame_budget=60, diffusion_steps=3,
                                         speed=4.0)]
    first = [call() for call in calls]
    graphs = list(syn.graphs.values())
    assert len(graphs) == 5
    assert all(g.graph.pool() == graphs[0].graph.pool() for g in graphs)
    for _ in range(2):
        for call, want in zip(calls[::-1], first[::-1]):
            np.testing.assert_array_equal(call(), want)


@contextlib.contextmanager
def _eager_chain(syn):
    """Within it, `syn`'s requests run the same chain of programs eagerly on
    the card: each program method called directly where it would replay."""
    syn._dispatch = lambda key, program, inputs, generator: program(
        generator, **{k: v.to(syn.device) for k, v in inputs.items()})
    try:
        yield
    finally:
        del syn._dispatch


@pytest.mark.parametrize("config,per_decode", [("ljspeech", 48), ("libritts", 96)])
def test_staged_and_batched_chains_equal_eager(cuda, config, per_decode):
    """`inference` (staged) and `inference_batch` of 3 mixed-length texts on
    the card: one graph per program and key, the chain of replays equal bit
    for bit to the same programs run eagerly on the card, same-seed calls
    bit-equal and another seed's different, each call one decode replay of
    the K1 its capture recorded; both chains unchanged after keys of another
    B, T and F were captured and replayed in between."""
    import numpy as np

    syn = _tiny_synthesizer(config, cuda)
    ref_s = (0.5 * np.random.default_rng(0).standard_normal((3, 64))).astype(np.float32) \
        if syn.multispeaker else None
    texts = [FUSED_TEXT, "hˈɛloʊ.", "ɐ ʃˈɔːɹt wˈʌn."]
    calls = [lambda seed: [syn.synthesize(FUSED_TEXT, diffusion_steps=3, speed=4.0, seed=seed,
                                          ref_s=None if ref_s is None else ref_s[:1]).wav],
             lambda seed: syn.inference_batch(texts, ref_s=ref_s, diffusion_steps=3, speed=4.0,
                                              seed=seed)]
    for call in calls:
        first = call(0)
        before = adain_snake.launches
        again, other = call(0), call(1)
        assert adain_snake.launches - before == 2 * per_decode
        with _eager_chain(syn):
            eager = call(0)
        for a, b, c, e in zip(first, again, other, eager):
            assert np.isfinite(a).all() and np.array_equal(a, b) and np.array_equal(a, e)
            assert not np.array_equal(a, c)
    kinds = [k[0] for k in syn.graphs]
    assert kinds == ["text", "style", "duration", "prosody", "decode", "phase_a", "prosody",
                     "decode"], kinds
    assert all(g.k1 == (per_decode if k[0] == "decode" else 0) for k, g in syn.graphs.items())
    want = [call(0) for call in calls]
    syn.synthesize(" ".join([FUSED_TEXT] * 3), diffusion_steps=3, speed=1.0, seed=5,
                   ref_s=None if ref_s is None else ref_s[:1])  # another T and F
    syn.inference_batch(texts[:2], diffusion_steps=3, speed=4.0, seed=6,
                        ref_s=None if ref_s is None else ref_s[:2])  # another B
    assert len(syn.graphs) > 8
    for call, w in zip(calls[::-1], want[::-1]):
        for a, b in zip(call(0), w):
            np.testing.assert_array_equal(a, b)


def test_pcm16_on_the_card(cuda):
    """`inference(pcm16=True)` on the card: its decode graph ends in int16
    clamp(wav * 32767), the host divides by 32767: the f32 chain's waveform
    scaled, clamped and truncated, the same length."""
    import numpy as np

    syn = _tiny_synthesizer("ljspeech", cuda)
    kw = dict(diffusion_steps=3, speed=4.0, seed=1)
    f32, _ = syn.inference(FUSED_TEXT, **kw)
    pcm, _ = syn.inference(FUSED_TEXT, pcm16=True, **kw)
    assert any(k[0] == "decode" and k[3] for k in syn.graphs)  # its own graph
    want = np.trunc(np.clip(f32 * np.float32(32767.0), -32768, 32767))
    assert pcm.shape == f32.shape
    np.testing.assert_array_equal(np.round(pcm * 32767.0), want)


def bilstm_errors(shape, device, seed=0):
    """The port's BiLSTM at (B, T, C, H) on `device`, train mode, full rows:
    the relative L2 errors of its output, input gradient and weight
    gradients against the same layer in f64 on the CPU."""
    from styletts2_tpu_torch.models.layers import BiLSTM

    B, T, C, H = shape
    g = torch.Generator().manual_seed(seed)
    ref = BiLSTM(C, H).double()
    with torch.no_grad():
        for w in ref.parameters():
            w.copy_(torch.randn(w.shape, generator=g, dtype=torch.float64) * 0.1)
    x, dy = torch.randn(B, T, C, generator=g), torch.randn(B, T, 2 * H, generator=g)
    lstm = BiLSTM(C, H).to(device)
    lstm.load_state_dict({k: v.float() for k, v in ref.state_dict().items()})
    lstm.train()
    xs = [x.double().requires_grad_(), x.to(device).requires_grad_()]
    outs = [ref(xs[0]), lstm(xs[1])]
    outs[0].backward(dy.double())
    outs[1].backward(dy.to(device))

    def rel(a, b):
        return float((a.detach().double().cpu() - b.detach()).norm() / b.detach().norm())

    grads = [torch.cat([w.grad.flatten() for w in m.parameters()]) for m in (ref, lstm)]
    return rel(outs[1], outs[0]), rel(xs[1].grad, xs[0].grad), rel(grads[1], grads[0])


@pytest.mark.parametrize("shape", [(16, 200, 640, 256), (2, 40, 96, 32)])
def test_bilstm_is_f32_on_the_card(cuda, shape):
    """The port's BiLSTM on the card (the prosody predictor's shared LSTM at
    full width and batch 16, and at the narrow width of chip_smoke.py's
    phase 19) within 2e-6 of an f64 reference in its output and gradients,
    as f32 on the CPU is. cuDNN's unpacked path, which it ran before, reads
    5.8e-6 / 6.1e-6 at the narrow width (TF32 off) and 1.1e-6 at the full
    one; the packed path is f32 at both."""
    errs = bilstm_errors(shape, cuda)
    assert max(errs) <= 2e-6, errs
