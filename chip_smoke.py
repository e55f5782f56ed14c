#!/usr/bin/env python3
"""Smoke run of the PyTorch port (styletts2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the exit code is non-zero:
  1. device: the card's name and power limit; TF32 off for convs and matmuls
  2. build: compile the CUDA kernel from styletts2_tpu_torch/csrc/
  3. kernel: the fused AdaIN+snake kernel against its plain PyTorch version
     at both decoders' shapes of an 8 s utterance, the server's batched
     HiFi-GAN shape, the JAX tests' shapes and an odd T; CUDA-event times of
     both at the main paths' shapes
  4. LJSpeech path: full-width Config() synthesis with seeded random weights
     answers 3 requests; each waveform is finite, sum(durations) * 600 long,
     and its decode launched the kernel 48 times
  5. LJSpeech reference: a short request on the card agrees with the same
     weights on the CPU (plain version), random draws and the chaotic source
     phase zeroed
  6. LibriTTS path: full-width libritts_config() (multispeaker, HiFi-GAN)
     with seeded random weights; compute_style of a seeded ~3 s voice on the
     card agrees with the CPU; 3 requests with that style, each finite,
     sum(durations) * 600 - 50 long, 96 launches per decode; one
     LFinference carries the style over
  7. serving: the CLI's server (serve.parse_args and make_server: the
     LibriTTS config built without PyYAML, a voice directory, the default
     15 ms window) on 127.0.0.1 answers 8 concurrent /tts requests of mixed
     lengths with 24 kHz WAVs in at least one fused batch, 96 launches per
     decode call; the burst's wall time and aggregate RTF
  8. LibriTTS references: a request and an inference_batch of 3 texts on the
     card agree with the CPU, random draws from the host, the harmonic sines
     zeroed and the Generator's head kept out of tanh's saturation
Every number line carries the card's name and power limit. Then a JSON line
of the kernels and, last, {"ok": true, "device": {...}}.
It needs a CUDA device and the repository beside it; without either it
exits non-zero before printing a result.
"""

import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from pathlib import Path

import numpy as np
import torch

BENCH_TEXT = (
    "ðɪ kwˈɪk bɹˈaʊn fˈɑːks dʒˈʌmps ˈoʊvɚ ðə lˈeɪzi dˈɔːɡ, "
    "ænd ðə sˈʌn sˈɛts slˈoʊli bɪhˈaɪnd ðə mˈaʊntənz."
)
REQUESTS = [
    (BENCH_TEXT, 0),
    ("ðɪs ɪz ɐ ʃˈɔːɹt ɹᵻkwˈɛst.", 1),
    ("hˈɪɹ ɪz ɐ lˈɔŋɡɚ wˈʌn, wɪð tˈuː klˈɔːzᵻz ænd ɐ kˈɑːmə.", 2),
]
SERVE_TEXTS = [  # 8 concurrent requests of mixed lengths
    REQUESTS[1][0], REQUESTS[2][0], BENCH_TEXT, "hˈɛloʊ ðɛɹ.",
    "ðə wˈɛðɚ ɪz nˈaɪs tədˈeɪ.", REQUESTS[1][0], "wˌʌn, tˈuː, θɹˈiː, fˈɔːɹ.", REQUESTS[2][0],
]
TARGET_AUDIO_SEC = 8.0  # random-init durations run ~8x long; pin the length
SAMPLES_PER_FRAME = 600  # at 24 kHz, as styletts2_tpu_torch.inference
CALLS_PER_DECODE = 48  # iSTFTNet: 8 AdaINResBlock1 x 3 dilations x 2
CALLS_PER_HIFIGAN_DECODE = 96  # HiFi-GAN: 4 stages x 4 AdaINResBlock1 x 3 dilations x 2
KERNEL_CASES = [  # (B, C, T), dtype name
    ((1, 256, 8000), "float32"),  # iSTFTNet stage-0 blocks at an 8 s utterance (F = 400)
    ((1, 128, 48001), "float32"),  # iSTFTNet stage-1 blocks: 120 F + 1
    ((1, 256, 6400), "float32"),  # HiFi-GAN stages at an 8 s utterance (F = 320): 20 F
    ((1, 128, 32000), "float32"),  # 100 F
    ((1, 64, 96000), "float32"),  # 300 F
    ((1, 32, 192000), "float32"),  # 600 F
    ((8, 32, 192000), "float32"),  # the last stage of a server batch of 8
    ((2, 256, 24), "float32"),  # tests/test_pallas.py cases
    ((3, 256, 128), "float32"),
    ((2, 256, 160), "bfloat16"),
    ((2, 100, 37), "float32"),  # odd T below 64
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
REPO = Path(__file__).resolve().parent


def _ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_draws(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` with every random draw taken from one seeded CPU
    generator, so that two devices decode the same inputs, and the NSF
    source's chaotic parts zeroed (tests/torch_parity.py): the iSTFTNet
    source's STFT phase, atan2 of ~0-magnitude bins that flips under any
    float reassociation, and the harmonic sines that HiFi-GAN takes raw,
    whose phase reaches ~1e5 rad, where f32 rounding in another summation
    order is O(1e-2) rad. A random-init decoder amplifies either to O(1)."""
    import styletts2_tpu_torch.models.decoder_istft as pdi

    host = torch.Generator().manual_seed(0)
    rand, randn, magphase, sines = torch.rand, torch.randn, pdi.stft_magphase, pdi.SineGen.forward

    def draw(f):
        return lambda size, generator=None, device=None, dtype=None: f(
            size, generator=host, dtype=dtype).to(device)

    def zero_phase(*a):
        mag, phase = magphase(*a)
        return mag, torch.zeros_like(phase)

    def zero_sines(self, f0, generator=None):
        uv = (f0 > self.voiced_threshold).float()
        return torch.zeros(f0.shape[:2] + (self.dim,), device=f0.device), uv

    torch.rand, torch.randn, pdi.stft_magphase = draw(rand), draw(randn), zero_phase
    pdi.SineGen.forward = zero_sines if getattr(fn.__self__, "hifigan", False) else sines
    try:
        return fn(*args, **kwargs)
    finally:
        torch.rand, torch.randn, pdi.stft_magphase = rand, randn, magphase
        pdi.SineGen.forward = sines


class _Counts:
    """Kernel launches, plain-version calls and decoder calls of one phase:
    `with _Counts(op, decoder) as c:` sets them to 0 on entry and reads them
    on exit."""

    def __init__(self, op, decoder):
        self.op, self.decoder = op, decoder

    def __enter__(self):
        self.plain_calls, self.decodes = 0, 0
        self._plain = self.op.adain_snake_ref

        def plain(*a, **k):
            self.plain_calls += 1
            return self._plain(*a, **k)

        def decode(module, args):
            self.decodes += 1

        self.op.adain_snake_ref = plain
        self._hook = self.decoder.register_forward_pre_hook(decode)
        self.op.adain_snake.launches = 0
        return self

    def __exit__(self, *exc):
        self.launches = self.op.adain_snake.launches
        self.op.adain_snake_ref = self._plain
        self._hook.remove()

    def check(self, per_decode, what):
        if self.plain_calls or self.launches != per_decode * self.decodes or not self.decodes:
            raise RuntimeError(f"{what}: {self.launches} kernel launches for {self.decodes} "
                               f"decodes, {self.plain_calls} plain-version calls")


def _requests(op, syn, tag, smi, per_decode, trim, **kwargs):
    """REQUESTS through `syn.synthesize(text, seed=..., **kwargs)`: each
    waveform finite and sum(durations) * 600 - trim samples long, each decode
    `per_decode` kernel launches; one line each. Returns the first result."""
    first = None
    for i, (text, seed) in enumerate(REQUESTS):
        before = op.adain_snake.launches
        t0 = time.perf_counter()
        r = syn.synthesize(text, seed=seed, **kwargs)
        lat = time.perf_counter() - t0
        n = op.adain_snake.launches - before
        audio = len(r.wav) / 24000.0
        if not np.isfinite(r.wav).all():
            raise RuntimeError(f"[{tag}] request {i}: non-finite waveform")
        if len(r.wav) != int(r.pred_dur.sum()) * SAMPLES_PER_FRAME - trim:
            raise RuntimeError(f"[{tag}] request {i}: {len(r.wav)} samples for "
                               f"{r.pred_dur.sum()} frames")
        if n != per_decode:
            raise RuntimeError(f"[{tag}] request {i}: kernel launched {n} times, not {per_decode}")
        print(f"[{tag}] request {i}: {len(r.pred_dur)} tokens, {int(r.pred_dur.sum())} frames, "
              f"{audio:.3f} s audio, latency {lat * 1e3:.1f} ms, RTF {audio / lat:.2f}x, "
              f"kernel launches {n} [{smi}]", flush=True)
        first = first or r
    return first


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _voice(seconds=3.0, sr=24000):
    """A seeded reference voice: a gliding pitch with 5 harmonics, plus noise."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6)) + 0.02 * rng.standard_normal(t.size)
    return wav.astype(np.float32)


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    sys.path.insert(0, str(REPO))
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.inference import Synthesizer
    from styletts2_tpu_torch.ops import adain_snake as op
    from styletts2_tpu_torch import serve

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = op.build()
    print(f"[2 build] {lib.relative_to(Path(op.__file__).resolve().parents[2])} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel vs plain
    g = torch.Generator(dev).manual_seed(0)
    max_err = 0.0
    timings = {}
    for (B, C, T), dt in KERNEL_CASES:
        dtype = getattr(torch, dt)
        x = (torch.randn((B, C, T), generator=g, device=dev) * 2 + 0.5).to(dtype)
        gamma = torch.randn((B, C), generator=g, device=dev) * 0.1
        beta = torch.randn((B, C), generator=g, device=dev) * 0.1
        alpha = torch.rand((C,), generator=g, device=dev) + 0.5
        with torch.inference_mode():
            got = op.adain_snake(x, gamma, beta, alpha)
            torch.cuda.synchronize()
            want = op.adain_snake_ref(x, gamma, beta, alpha)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt], rtol=TOL[dt])
        line = f"[3 kernel] ({B},{C},{T}) {dt}: max_abs_err {err:.3e} (tol {TOL[dt]:g})"
        if dt == "float32":
            max_err = max(max_err, err)
        if T >= 6400:  # the main paths' shapes
            iters = 200 if x.numel() < 10 ** 7 else 50
            with torch.inference_mode():
                run_k = lambda: op.adain_snake(x, gamma, beta, alpha)  # noqa: E731
                run_p = lambda: op.adain_snake_ref(x, gamma, beta, alpha)  # noqa: E731
                p1, k1, k2, p2 = (_ms(f, iters) for f in (run_p, run_k, run_k, run_p))
            timings[(B, C, T)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            line += f"; kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms [{smi}]"
        print(line, flush=True)
        del x
    slower = [f"{c}: {k:.4f} vs {p:.4f} ms" for c, (k, p) in timings.items() if k > p]
    print(f"[3 kernel] slower than plain at: {'; '.join(slower) or 'no shape'} [{smi}]", flush=True)

    # 4. LJSpeech path
    t0 = time.perf_counter()
    syn = Synthesizer(Config(), seed=0, device=dev)
    n_params = sum(p.numel() for p in syn.models.parameters())
    print(f"[4 main] Synthesizer(Config()) on {dev}: {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    natural = syn.synthesize(BENCH_TEXT, seed=0)  # calibration; also the warm-up
    speed = max(len(natural.wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
    with _Counts(op, syn.models["decoder"]) as lj:
        _requests(op, syn, "4 main", smi, CALLS_PER_DECODE, 0, speed=speed)
    lj.check(CALLS_PER_DECODE, "LJSpeech path")
    print(f"[4 main] speed {speed:.3f} (natural {len(natural.wav) / 24000.0:.2f} s); "
          f"{lj.launches} kernel launches, 0 plain-version calls", flush=True)

    # 5. reference: the same weights on the CPU, through the plain version
    ref_syn = Synthesizer(Config(), seed=0, device="cpu")
    noise = np.random.default_rng(0).standard_normal((1, 1, 256)).astype(np.float32)
    got = _host_draws(syn.synthesize, REQUESTS[1][0], noise=noise, speed=speed)
    want = _host_draws(ref_syn.synthesize, REQUESTS[1][0], noise=noise, speed=speed)
    del ref_syn
    if not np.array_equal(got.pred_dur, want.pred_dur):
        raise RuntimeError(f"durations differ: {got.pred_dur} vs {want.pred_dur}")
    if not (np.isfinite(got.wav).all() and np.isfinite(want.wav).all()):
        raise RuntimeError("non-finite waveform in the reference comparison")
    s_err, w_err = _rel(got.s_pred, want.s_pred), _rel(got.wav, want.wav)
    print(f"[5 reference] GPU vs CPU: durations equal, style rel err {s_err:.2e} (tol 1e-4), "
          f"waveform rel err {w_err:.2e} (tol 1e-3)", flush=True)
    if not (s_err < 1e-4 and w_err < 1e-3):
        raise RuntimeError("GPU and CPU disagree")
    del syn

    # 6. LibriTTS path: multispeaker, HiFi-GAN
    t0 = time.perf_counter()
    ms = Synthesizer(libritts_config(), seed=0, device=dev)
    ms_cpu = Synthesizer(libritts_config(), seed=0, device="cpu")
    n_params = sum(p.numel() for p in ms.models.parameters())
    print(f"[6 libritts] Synthesizer(libritts_config()) on {dev} and cpu: {n_params} parameters, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    voice = _voice()
    t0 = time.perf_counter()
    ref_s = ms.compute_style(voice)
    style_ms = (time.perf_counter() - t0) * 1e3
    ref_cpu = ms_cpu.compute_style(voice)
    err = _rel(ref_s, ref_cpu)
    print(f"[6 libritts] compute_style of {len(voice) / 24000:.1f} s: {style_ms:.1f} ms (first call), "
          f"GPU vs CPU rel err {err:.2e} (tol 1e-4) [{smi}]", flush=True)
    if not (np.isfinite(ref_s).all() and err < 1e-4):
        raise RuntimeError("compute_style: GPU and CPU disagree")
    natural = ms.synthesize(BENCH_TEXT, ref_s=ref_s, seed=0)  # calibration; also the warm-up
    ms_speed = max(len(natural.wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
    for text, seed in REQUESTS[1:]:  # warm-up at the other requests' shapes: warm latencies
        ms.synthesize(text, ref_s=ref_s, seed=seed, speed=ms_speed)
    with _Counts(op, ms.models["decoder"]) as lt:
        first = _requests(op, ms, "6 libritts", smi, CALLS_PER_HIFIGAN_DECODE, 50,
                          ref_s=ref_s, speed=ms_speed)
        s_prev = first.s_pred
        wav, s_lf = ms.LFinference(REQUESTS[2][0], s_prev, ref_s=ref_s, seed=3, speed=ms_speed)
        if not (np.isfinite(wav).all() and (len(wav) + 100) % SAMPLES_PER_FRAME == 0):
            raise RuntimeError(f"LFinference: {len(wav)} samples or a non-finite waveform")
    lt.check(CALLS_PER_HIFIGAN_DECODE, "LibriTTS path")
    if not np.isfinite(s_lf).all():
        raise RuntimeError("LFinference: non-finite style")
    print(f"[6 libritts] LFinference carried request 0's style: {len(wav) / 24000:.3f} s; "
          f"speed {ms_speed:.3f} (natural "
          f"{len(natural.wav) / 24000.0:.2f} s); {lt.launches} kernel launches in {lt.decodes} "
          f"decodes, 0 plain-version calls", flush=True)
    # 7. serving: the CLI's server (`python -m styletts2_tpu_torch.serve`
    # --config configs/config_libritts.yml --voices DIR, its defaults otherwise:
    # no PyYAML, seed-0 weights, window 15 ms, max batch 8) with the seeded
    # voice as a 22.05 kHz WAV, served on a thread instead of the main one
    build_dir = Path(op.__file__).resolve().parents[1] / "_build"
    with tempfile.TemporaryDirectory(dir=build_dir) as vdir:
        pcm = (np.clip(_voice(sr=22050), -1, 1) * 32767).astype(np.int16)
        with wave.open(str(Path(vdir) / "seeded.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(22050)
            f.writeframes(pcm.tobytes())
        args = serve.parse_args(["--config", str(REPO / "configs" / "config_libritts.yml"),
                                 "--voices", vdir, "--port", "0"])
        t0 = time.perf_counter()
        server = serve.make_server(args)
    print(f"[7 serving] make_server: {args.device}, voices {sorted(server.voices)}, max batch "
          f"{args.max_batch}, window {args.window_ms} ms; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    port = server.start_background(args.host, args.port)
    try:
        body = {"voice": "seeded", "speed": ms_speed, "seed": 0}

        def burst():
            results = [None] * len(SERVE_TEXTS)

            def go(i):
                results[i] = _post(port, dict(body, text=SERVE_TEXTS[i]))

            threads = [threading.Thread(target=go, args=(i,)) for i in range(len(SERVE_TEXTS))]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            return results, time.perf_counter() - t0

        burst()  # warm-up at the batched shapes
        stats0 = dict(server.batcher.stats)
        with _Counts(op, server.syn.models["decoder"]) as sv:
            results, wall = burst()
        sv.check(CALLS_PER_HIFIGAN_DECODE, "serving")
        audio = 0.0
        for i, res in enumerate(results):
            if res is None or res[0] != 200 or res[1] != "audio/wav":
                raise RuntimeError(f"serving request {i}: {res and res[:2]}")
            with wave.open(io.BytesIO(res[2])) as f:
                frames = f.getnframes()
                if f.getframerate() != 24000 or frames <= 0 or (frames + 50) % SAMPLES_PER_FRAME:
                    raise RuntimeError(f"serving request {i}: {frames} frames at {f.getframerate()} Hz")
            audio += frames / 24000.0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
            stats = json.loads(resp.read())["stats"]
        batches = stats["batches"] - stats0["batches"]
        fused = stats["batched_requests"] - stats0["batched_requests"]
        if fused < 2:
            raise RuntimeError(f"serving: no fused batch ({stats})")
        print(f"[7 serving] {len(results)} concurrent requests, {audio:.3f} s audio in {wall * 1e3:.1f} "
              f"ms wall (window {args.window_ms} ms): aggregate RTF {audio / wall:.2f}x; {batches} "
              f"batches ({fused} requests fused), "
              f"{sv.decodes} decode calls, {sv.launches} kernel launches "
              f"({CALLS_PER_HIFIGAN_DECODE} per decode), 0 plain-version calls [{smi}]", flush=True)
    finally:
        server.close()
        del server

    # 8. LibriTTS references: a request and a batch on the card and on the CPU.
    # The random-init Generator drives its tanh head ~200x into saturation, so
    # the waveform's unsaturated samples would carry the head input's absolute
    # error; both copies get the head gain tests/torch_parity.py gives it.
    for m in (ms, ms_cpu):
        m.models["decoder"].generator.conv_post.weight_g.mul_(0.01)
    noise = np.random.default_rng(1).standard_normal((1, 1, 256)).astype(np.float32)
    got = _host_draws(ms.synthesize, REQUESTS[1][0], ref_s=ref_cpu, noise=noise, speed=ms_speed)
    want = _host_draws(ms_cpu.synthesize, REQUESTS[1][0], ref_s=ref_cpu, noise=noise,
                       speed=ms_speed)
    if not np.array_equal(got.pred_dur, want.pred_dur):
        raise RuntimeError(f"libritts durations differ: {got.pred_dur} vs {want.pred_dur}")
    s_err, w_err = _rel(got.s_pred, want.s_pred), _rel(got.wav, want.wav)
    print(f"[8 reference] GPU vs CPU request: durations equal, style rel err {s_err:.2e} (tol 1e-4), "
          f"waveform rel err {w_err:.2e} (tol 1e-3)", flush=True)
    if not (np.isfinite(got.wav).all() and s_err < 1e-4 and w_err < 1e-3):
        raise RuntimeError("libritts request: GPU and CPU disagree")
    texts = [REQUESTS[1][0], "hˈɛloʊ ðɛɹ.", REQUESTS[2][0]]
    refs = np.concatenate([ref_cpu, ref_cpu * 0.5, -ref_cpu])
    got = _host_draws(ms.inference_batch, texts, ref_s=refs, speed=ms_speed)
    want = _host_draws(ms_cpu.inference_batch, texts, ref_s=refs, speed=ms_speed)
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.isfinite(g).all():
            raise RuntimeError(f"batch item {i}: {g.shape} vs {w.shape} or non-finite")
        errs.append(_rel(g, w))
    print(f"[8 reference] GPU vs CPU inference_batch of 3: lengths equal {[len(g) for g in got]}, "
          f"waveform rel errs {', '.join(f'{e:.2e}' for e in errs)} (tol 1e-3)", flush=True)
    if max(errs) >= 1e-3:
        raise RuntimeError("inference_batch: GPU and CPU disagree")

    k_ms, p_ms = timings[(8, 32, 192000)]  # the largest shape
    print(json.dumps({"kernels": [{
        "name": "adain_snake", "route": "cuda",
        "source": "styletts2_tpu_torch/csrc/adain_snake.cu",
        "replaces": "styletts2_tpu/ops/pallas_kernels.py:38",
        "launches": lj.launches + lt.launches + sv.launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
