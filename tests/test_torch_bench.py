"""The port's benches (`styletts2_tpu_torch/bench.py`, `bench_train.py`)
and their fixtures against the JAX package's:

- `parallel/tiny.py:synthetic_batch` is bit-equal to the JAX one for the
  same numpy generator, at the tiny defaults and the `--full-size`
  arguments;
- on the same (converted) weights, `bench.calibrate_speed` gives the JAX
  bench's speed (to 1e-6) and `headline_once`'s timed waveform the JAX
  bench's sample count exactly (random draws zeroed on both sides: the
  durations follow the sampled style);
- the FLOP counter of `bench_train` equals hand formulas exactly for
  Linear, Conv1d, Conv2d, ConvTranspose1d and a bidirectional LSTM
  (forward and backward), and its cuDNN RNN formula on packed and padded
  shapes;
- `bench_train --device cpu` prints one JSON line with the JAX bench's
  keys for stage first and second;
- `bench.bench` (a tiny-width synthesizer on the CPU) returns the JAX
  bench's keys and extras, the single-dispatch `fused_rtf` and
  `fused_latency_p50_ms` among them.
The ratio of the port's FLOP count to XLA's for the tiny stage-1 step is
`tools/flops_torch_vs_jax.py`'s (it compiles the JAX step: minutes).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from styletts2_tpu.parallel.tiny import synthetic_batch as jax_synthetic_batch
from styletts2_tpu_torch import bench, bench_train
from styletts2_tpu_torch.parallel.tiny import synthetic_batch
from torch_parity import jax_models_and_params, port_cfg, zero_noise
from torch_tiny_train import small_aux_builders

# bench_train.py:180-196, the JSON line's keys
JAX_TRAIN_KEYS = {"stage", "devices", "mesh", "batch", "widths", "mixed_precision", "backend",
                  "device_kind", "steps_per_sec", "sec_per_step", "audio_hours_per_hour",
                  "flops_per_step", "mfu", "compile_sec", "g_loss"}


@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("full_size", [False, True])
def test_synthetic_batch_is_bit_equal_to_jax(B, full_size):
    kw = dict(wav_len=126000, bucket=150000, T_text=110, T_buf=128) if full_size else {}
    got = synthetic_batch(np.random.default_rng(0), B, **kw)
    want = jax_synthetic_batch(np.random.default_rng(0), B, **kw)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        assert np.array_equal(g, w), f.name


def test_calibrated_speed_and_length_match_jax_bench(four_threads):
    """The bench text at 5 steps on the same weights (tiny widths, one
    resblock kernel, a 32-wide Generator): the JAX bench's calibration
    (`bench.py:69-73`: a seed-0 call, speed = max(natural / 8, 1)) and its
    timed call at that speed against `calibrate_speed` and `headline_once`."""
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer
    from styletts2_tpu.parallel.tiny import tiny_config
    from styletts2_tpu_torch.convert import state_dict_from_jax
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg = tiny_config()
    jcfg.plbert_params.intermediate_size = 256
    jcfg.model_params.decoder.upsample_initial_channel = 32
    _, params = jax_models_and_params(jcfg, seed=0)
    jsyn = JaxSynthesizer(jcfg, params=params)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    with zero_noise():
        wav, _ = jsyn.inference(bench.TEXT, diffusion_steps=5, seed=0, pcm16=True)
        want_speed = max(len(wav) / 24000.0 / 8.0, 1.0)
        want_len = len(jsyn.inference(bench.TEXT, diffusion_steps=5, seed=0, pcm16=True,
                                      speed=want_speed)[0])
        speed, natural = bench.calibrate_speed(psyn, bench.TEXT, diffusion_steps=5)
        stats, timed_speed = bench.headline_once(psyn, n_runs=1)
    assert want_speed > 1.0  # the random-init durations run long: the pin engages
    assert abs(speed - want_speed) < 1e-6 and timed_speed == speed
    assert natural == len(wav) / 24000.0
    assert round(want_len / 24000.0, 2) == stats["audio_sec_per_utt"]
    assert len(psyn.inference(bench.TEXT, diffusion_steps=5, seed=0, speed=speed)[0]) == want_len
    assert set(stats) == {"rtf", "audio_sec_per_utt", "latency_p50_ms", "latency_p95_ms",
                          "latency_mean_ms", "n_runs", "natural_uncalibrated_sec"}


def _counted(module, *inputs):
    """FLOPs of module(*inputs) and the backward of its output's sum."""
    def step():
        out = module(*inputs)
        out = out[0] if isinstance(out, tuple) else out
        out.sum().backward()

    return bench_train.count_flops(step)


def test_flop_counter_matches_hand_formulas():
    """Forward 2 flops per multiply-add; the backward's input and weight
    gradients twice that (every input takes a gradient)."""
    torch.manual_seed(0)
    B = 3
    x = torch.randn(B, 16, requires_grad=True)
    assert _counted(torch.nn.Linear(16, 24), x) == 3 * 2 * B * 16 * 24
    x = torch.randn(B, 4, 20, requires_grad=True)  # same padding: 20 outputs
    assert _counted(torch.nn.Conv1d(4, 6, 5, padding=2), x) == 3 * 2 * B * 6 * 20 * 4 * 5
    x = torch.randn(B, 3, 8, 10, requires_grad=True)
    assert _counted(torch.nn.Conv2d(3, 5, 3, padding=1), x) == 3 * 2 * B * 5 * 8 * 10 * 3 * 9
    x = torch.randn(B, 4, 11, requires_grad=True)  # each input sample meets K x C_out weights
    assert _counted(torch.nn.ConvTranspose1d(4, 6, 4, stride=2), x) == 3 * 2 * B * 11 * 4 * 6 * 4
    T, I, H = 7, 8, 16
    x = torch.randn(B, T, I, requires_grad=True)
    lstm = torch.nn.LSTM(I, H, batch_first=True, bidirectional=True)
    assert _counted(lstm, x) == 3 * 2 * (2 * 4 * H * (I + H)) * T * B


def test_cudnn_rnn_formula():
    """The card's fused LSTM op: 2 * (|W_ih| + |W_hh|) per time step, layer,
    direction and item; a packed input's first axis counts the steps of
    every item; the backward twice the forward."""
    I, H, T, B = 8, 16, 7, 3
    w = [(4 * H, I), (4 * H, H), (4 * H,), (4 * H,)] * 2  # two directions
    per_step = 2 * 2 * 4 * H * (I + H)
    tail = [4, None, (2, B, H), (2, B, H), 2, H, 0, 1, True, 0.0, True, True]
    assert bench_train._cudnn_rnn_flop((T, B, I), w, *tail, [], None) == per_step * T * B
    assert bench_train._cudnn_rnn_flop((12, I), w, *tail, [3, 3, 2, 2, 1, 1], None) == per_step * 12
    back = [4, None, (2, B, H), (2, B, H), (T, B, 2 * H), None, None, None, 2, H, 0, 1, True,
            0.0, True, True]
    assert bench_train._cudnn_rnn_backward_flop((T, B, I), w, *back, [], None) == \
        2 * per_step * T * B


@pytest.fixture
def four_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("stage", ["first", "second"])
def test_bench_train_prints_the_jax_keys(stage, capsys, four_threads):
    """One step of each stage at the tiny widths on the CPU (the resolution
    discriminator narrowed as in the other tiny training tests: it takes
    most of a CPU step and changes no key)."""
    with small_aux_builders():
        bench_train.main(["--device", "cpu", "--stage", stage, "--steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == JAX_TRAIN_KEYS
    assert out["stage"] == stage and out["widths"] == "tiny" and out["batch"] == 2
    assert out["backend"] == "cpu" and out["mfu"] is None and out["mesh"] is None
    assert out["flops_per_step"] > 0 and np.isfinite(out["g_loss"]) and out["sec_per_step"] > 0


# bench.py:236-311, the synthesis line's extras (the bf16 decoder's without PCM16)
JAX_BENCH_EXTRA = {"audio_sec_per_utt", "latency_p50_ms", "latency_p95_ms", "latency_mean_ms",
                   "n_runs", "natural_uncalibrated_sec", "rtf_runs", "rtf_min", "rtf_max",
                   "n_procs", "batched_B8_rtf", "batched_B8_latency_ms", "fused_rtf",
                   "fused_latency_p50_ms", "bf16_decoder_rtf"}


def test_bench_reports_the_jax_keys(monkeypatch, four_threads):
    """`bench.bench` on the CPU at tiny widths, one process, one timed call
    a path at ~2 s of audio: the JAX bench's keys, its extras with the
    fused path's RTF and p50 latency."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer

    def tiny(device, **kw):
        cfg = Config()
        cfg.plbert_params.num_hidden_layers = 1
        cfg.plbert_params.hidden_size = 64
        cfg.plbert_params.intermediate_size = 128
        cfg.plbert_params.num_attention_heads = 2
        cfg.model_params.hidden_dim = 64
        cfg.model_params.style_dim = 32
        cfg.model_params.dim_in = 16
        cfg.model_params.diffusion.transformer.num_layers = 1
        cfg.model_params.decoder.upsample_initial_channel = 32
        cfg.model_params.decoder.resblock_kernel_sizes = [3]
        cfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]]
        return Synthesizer(cfg, seed=0, device=device, **kw)

    timed = bench._timed
    monkeypatch.setattr(bench, "_synthesizer", tiny)
    monkeypatch.setattr(bench, "_timed", lambda fn, n: timed(fn, 1))  # one timed call a path
    monkeypatch.setattr(bench, "TARGET_AUDIO_SEC", 2.0)  # ~2 s utterances: a CPU's budget
    out = bench.bench("cpu", n_procs=1)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert set(out["extra"]) == JAX_BENCH_EXTRA
    assert out["extra"]["fused_rtf"] > 0 and out["extra"]["fused_latency_p50_ms"] > 0
    assert out["value"] > 0 and out["extra"]["n_procs"] == 1
