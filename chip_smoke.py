#!/usr/bin/env python3
"""Smoke run of the PyTorch port (styletts2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the exit code is non-zero:
  1. device: the card's name and power limit; TF32 off for convs and matmuls
     (`utils.set_f32_compute`, as the entry points) and the flags after it
  2. build: compile the CUDA kernel from styletts2_tpu_torch/csrc/
  3. kernel: the fused AdaIN+snake kernel (K1) against its plain PyTorch
     version at both decoders' shapes of an 8 s utterance and of
     `inference_fused`'s 600-frame budget (phase 26), the server's
     batched HiFi-GAN shape and the training shapes, each in f32 and bf16
     (the bf16 decoder, bf16 training), the JAX tests' shapes, an odd T,
     rows that stream from global memory, and rows split over a forced
     cluster of k blocks (odd T at every k in both dtypes, T < 16); two
     launches give the same bits. At the main paths' shapes, the card's
     time (CUDA graphs of many calls, CUDA events) of the kernel and the
     plain version, cold (inputs rotated over 3x the L2) and warm, beside
     the bound (bytes at 3.35 TB/s; a bf16 row is half an f32 one's),
     F.instance_norm's time as a yardstick, and an eager call's time (the
     host's launch included)
  4. LJSpeech path: full-width Config() synthesis with seeded random weights
     answers 3 requests; each waveform is finite, sum(durations) * 600 long,
     and its decode launched the kernel 48 times
  5. LJSpeech reference: a short request on the card (its graphs captured
     anew) agrees with the same weights on the CPU (plain version), the
     card's draws fed to the CPU (`_SharedDraws`) and the chaotic source
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
     card agree with the CPU, the card's draws fed to the CPU, the harmonic
     sines zeroed and the Generator's head kept out of tanh's saturation
  9. backward kernel: the fused op's backward kernel (K2) against its plain
     version (`adain_snake_bwd_ref`) and against autograd through
     `adain_snake_ref`, at the training shapes (batch 16 and the SLM pass's
     8, a 200-frame clip) in f32 and bf16, an odd small shape, a streamed
     row and forced clusters; two launches give the same bits; cold and
     warm times of both on the card (CUDA graphs) at the training shapes,
     beside the bound
 10. stage-1 training: `train.run.run_stage("first", Config(), ...)` on a
     seeded fixture of 32 utterances of 6-9 s at full width, batch 16,
     max_len 400, TMA from epoch 1 of 2: 2 pre-TMA and 2 TMA steps, each
     with finite losses and 48 forward and 48 backward kernel launches, 0
     plain-version calls; step times, peak memory, the decoder's change; a
     second call resumes from the epoch-2 checkpoint and takes one more step.
     Each epoch's eval artifacts (`_Artifacts`): one decode (48 K1), finite
     reconstructions, clips and attention written to eval_audio/ and
     eval_attn/
 11. training reference: one stage-1 step at reduced width, the same weights
     on the card and on the CPU (eval mode, draws from the host, the source's
     STFT phase zeroed), before TMA on the soft alignment and from TMA on the
     monotonic one: the losses and every stepped module's gradient agree
 12. stage 2: `run_stage("second", Config(), ...)` at full width from the
     port's own first stage (a 1-step `run_stage("first")`), on phase 10's
     fixture: 2 steps each before diffusion, with it and joint (the
     SLM-adversarial pass; the WavLM discriminator every 2 steps), each with
     finite metrics, 96 K1 and 36 K2 launches (144 and 84-96 joint:
     `_stage2_launches`), a positive
     slm_valid_frac when joint, the predictor, PL-BERT, diffusion, decoder
     and wd moving just when the phase steps them; 0 plain-version calls;
     peak memory, sigma_data before and after and the line written into the
     config copy; a second call resumes from epoch_2nd_00002.pth. Batch 16,
     or the largest that fits (the OOM is printed). Each epoch's eval
     artifacts as phase 10's, the joint epoch's the fully sampled utterance
     (5 ADPM2 steps, a decode of 48 K1 launches)
 13. finetune: 2 steps of `run_stage("finetune")` on configs/config_ft.yml
     (built without PyYAML) from phase 12's second_final.pth, weights only,
     joint from epoch 0; the same checks
 14. stage-2 reference: a joint step's generator and SLM losses at reduced
     width, the same weights on the card and on the CPU (eval mode, draws
     from the host, the source's STFT phase zeroed): losses within 1e-4,
     every module's gradient within 3e-2 (L2)
 15. bf16 serving (`bf16_serving_phase`): `Synthesizer(decoder_dtype=
     "bfloat16")` of Config() and libritts_config() at full width answers
     3 requests each, 48 / 96 K1 launches per decode all with a bf16 x, 0
     plain-version calls; durations equal to an f32 synthesizer's with the
     same bf16-rounded decoder weights, both warm latencies and the
     bf16-vs-f32 compute MCD (printed); the JAX package's bf16 test case
     (tests/test_bf16.py) on each served decoder, its MCD held <= 2.5 dB for
     iSTFTNet and printed for HiFi-GAN; 8 concurrent requests through
     `serve --decoder-dtype bfloat16`
 16. bf16 training (`bf16_training_phase`): `mixed_precision: "bf16"` at
     batch 16, max_len 400 on phase 10's fixture through `run_stage`: 2
     stage-1 steps from TMA on and 2 stage-2 steps of each phase, every
     step's K1/K2 launches at the f32 counts and all with a bf16 x, the
     first step of each stage within 0.15 of an f32 step from the same
     weights and draws, f32 master weights and Adam moments; step times and
     peak memory beside phases 10 and 12's
 17. reference checkpoints (`reference_phase`): seeded full-width weights of
     Config() and libritts_config() written as the reference's `.pth`
     (`reference_net`: `module.` prefixes, the diffusion UNet under `unet.`
     and `diffusion.net.`, ALBERT's pooler, LSTM biases split in two
     nonzero halves); `python -m styletts2_tpu_torch.demo --ckpt` in 3
     subprocesses at once (LJSpeech, LJSpeech --longform, LibriTTS with a
     22.05 kHz --ref_wav), each exiting 0 with a finite 24 kHz WAV as long
     as the same request in this process; `serve --ckpt` answering 3
     requests with 48 / 96 K1 launches per decode and 0 plain-version calls,
     its weights the port layout's and a request within 1e-4 of the
     port-layout Synthesizer's (host draws, the chaotic source parts
     zeroed); the diffusion sampler family on the card against the CPU with
     handed draws, within 1e-4
 18. remat (`remat_phase`): Config()'s stage-1 TMA step and stage-2 joint
     step at full width, batch 16, f32, each from the same weights, batch
     and draws with `remat_decoder` off and on: losses within 1e-5, every
     optimizer step's gradients within 3e-2 (L2), K1 per differentiated
     decoder run doubled by the recompute (48 -> 96) and K2 equal, 0
     plain-version calls; both peaks and step times; then the joint step
     with remat up the batch ladder (24, 32, ...) to the first batch that
     does not fit, and one bf16 joint step with remat
 19. LibriTTS stage 2 (`libritts_stage2_phase`): `run_stage("second",
     libritts_config())` with remat at full width from the port's own first
     stage, 2 steps each before diffusion, with it and joint, checked as
     phase 12's (96 K1 per HiFi-GAN decoder run, 192 per differentiated
     one); a reduced-width multispeaker HiFi-GAN joint step card vs CPU as
     phase 14's; the port's BiLSTM on the card against f64 within 2e-6
     (`lstm_precision_check`: cuDNN's unpacked path, which this step's
     F0Ntrain ran, rounds below f32 at its narrow width)
 20. data-parallel (`ddp_wavlm_phase`): `python -m torch.distributed.run
     --standalone --nproc_per_node 1` of `train.run first --max_steps 2`
     (through this script's --train-child, which counts the launches) on
     phase 10's fixture at full width: one NCCL rank whose losses equal an
     unlaunched run's, its log naming the backend, K1 and K2 launched, 0
     plain-version calls, its second step traced (STYLETTS2_TRACE_STEP).
     One card: more ranks are shown by the CPU test (two gloo ranks)
 21. WavLM from a directory: a full-width Hugging Face layout (config.json,
     model.safetensors, pytorch_model.bin) written from seeded weights and
     read on the card by `convert.wavlm_from_hf`, its hidden states equal
     to the module's; phase 20's runs load it ("loaded WavLM")
 22. fidelity (`fidelity_phase`): `styletts2_tpu_torch.fidelity.run` at full
     width, Config() (iSTFTNet, 250 pre-TMA steps at batch 16) and
     libritts_config() (HiFi-GAN, 30 at batch 8) of 5 s pseudo-speech, f32:
     48 / 96 K1 and K2 per step, 0 plain-version calls, the mel loss falling
     (iSTFTNet; HiFi-GAN's printed), the bf16-vs-f32 decoder MCD at random
     init and trained (iSTFTNet held <= 2.5 dB, HiFi-GAN printed)
 23. tensor parallelism (`tp_phase`): two ranks on cuda:0 over gloo at
     model parallel 2 (`--tp-child` under torch.distributed.run), a
     full-width stage-1 TMA step and stage-2 joint step at batch 4 each
     equal to the unlaunched step from the same weights (losses within
     1e-5, gradients within 3e-2), K1/K2 per rank the unlaunched run's;
     each rank's parameters, peak memory and step time
 24. benches (`bench_phase`): `bench.headline_once` in process on Config()
     (48 K1 per decode, 0 plain-version calls, RTF > 0); `python -m
     styletts2_tpu_torch.bench` with STYLETTS2_BENCH_PROCS=2 (exit 0, its
     JSON line, the fused extras); `bench_train` at full width, 1 timed step, stage 1 (TMA)
     in f32 and stage 2 (joint) in bf16: each step's K1/K2 as its stage's,
     finite metrics, a non-null MFU against the H100 peak
 25. notebooks (`notebook_phase`): the three `examples/torch/` notebooks at
     full width on cuda, 48 K1 per decoder run, K2 from the finetune step,
     0 plain-version calls
 26. single dispatch (`fused_phase`): `inference_fused` (frame budget 600)
     captured as one CUDA graph for Config() and libritts_config(), each
     with the f32 and the bf16 decoder: each replay equals an eager run of
     the same program on the card (1e-5 of its peak in f32, one bf16
     rounding with the bf16 decoder), same-seed replays are bit-equal and
     another seed's differ, the profiler counts K1 48 / 96 times in one
     replay, as many as the replay adds to the count, 0 plain-version
     calls; capture time, the graph's pool, p50 / p95, RTF, host launches
     and the device's busy share (the staged path's: phase 27); every shape
     K1 runs at in the graphs is one of phase 3's.
     A second graph (10 steps) captured into the first's pool, both replays
     unchanged after it. One f32 replay per config against the same
     program on the CPU, same weights, inputs and draws: waveform within
     1e-3. `Synthesizer(phase_a="fused")` against the staged path:
     durations equal, waveform within 1e-5
 27. staged and batched graphs (`staged_graphs_phase`): the JAX
     Synthesizer's chain of programs, one CUDA graph per program and key
     (text, style, duration or phase A; prosody, decode), for Config() and
     libritts_config() with the f32 and the bf16 decoder: `synthesize`
     staged and with the fused phase A, `inference_batch` at B = 1 and at
     B = 8 of mixed lengths, each chain of replays against the same programs
     run eagerly on the card (f32 bit-equal, one bf16 rounding with the
     bf16 decoder), same-seed calls bit-equal and another seed's different,
     each call one decode replay of 48 / 96 K1 (recorded, counted and seen
     by the profiler), 0 plain-version calls; every chain unchanged after a
     request of another text and frame bucket; every shape K1 ran at one of
     phase 3's; capture s per key, the graph count and pool, p50 / p95, RTF,
     host launches and the device's busy ms beside the eager chain's
Phase 3 and 9 also check and time K1 and K2 at LibriTTS stage 2's HiFi-GAN
training shapes (f32); phase 3 also at `inference_fused`'s budget-600
decoder shapes, both dtypes, and checks it untimed at phase 27's
(GRAPH_CASES). Phases 4-8, 15, 17, 24 and 25 synthesize through the
graphs; `_Counts` counts a decode replay as a decoder run and its recorded
K1 launches by dtype (`GRAPHS`). After each phase (or pair) a "[n done]" line gives the
smoke's wall so far. Every number line carries the card's name and power limit. Then a JSON line
of the kernels (f32 and bf16 times) and, last, {"ok": true, "device": {...}}.
It needs a CUDA device and the repository beside it; without either it
exits non-zero before printing a result.
"""

import collections
import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
import types
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
# the main paths' shapes, each in f32 and, for the bf16 decoder and bf16
# training, in bf16
MAIN_SHAPES = [
    (1, 256, 8000),  # iSTFTNet stage-0 blocks at an 8 s utterance (F = 400)
    (1, 128, 48001),  # iSTFTNet stage-1 blocks: 120 F + 1
    (1, 256, 6400),  # HiFi-GAN stages at an 8 s utterance (F = 320): 20 F
    (1, 128, 32000),  # 100 F
    (1, 64, 96000),  # 300 F
    (1, 32, 192000),  # 600 F
    # inference_fused decodes its whole budget of 600 frames (phase 26):
    (1, 256, 12000),  # iSTFTNet stage 0 and HiFi-GAN stage 0: 20 x 600
    (1, 128, 72001),  # iSTFTNet stage 1: 120 x 600 + 1
    (1, 128, 60000),  # HiFi-GAN stages 1-3: 100, 300, 600 x 600
    (1, 64, 180000),
    (1, 32, 360000),
    (8, 32, 192000),  # the last stage of a server batch of 8
    (16, 256, 4000),  # stage-1 training: batch 16, a 200-frame clip
    (16, 128, 24001),
    (8, 256, 4000),  # stage 2's SLM pass: 8 clips of 200 frames
    (8, 128, 24001),
]
TRAIN_SHAPES = MAIN_SHAPES[-4:]
# LibriTTS stage 2 (phase 19, f32): the HiFi-GAN Generator's stages at
# batch 16 and libritts_config()'s clip of 120 mel-half frames (max_len 300:
# a 240-frame F0 curve, 72000 samples), and the SLM pass's 8 clips of 200
# (slmadv min_len 400: 120000 samples); (8, 256, 4000) is already above
HIFIGAN_TRAIN_SHAPES = [(16, 256, 2400), (16, 128, 12000), (16, 64, 36000), (16, 32, 72000),
                        (8, 128, 20000), (8, 64, 60000), (8, 32, 120000)]
KERNEL_CASES = [(shape, dt) for dt in ("float32", "bfloat16") for shape in MAIN_SHAPES] + [
    (shape, "float32") for shape in HIFIGAN_TRAIN_SHAPES] + [
    ((2, 256, 24), "float32"),  # tests/test_pallas.py cases
    ((3, 256, 128), "float32"),
    ((2, 256, 160), "bfloat16"),
    ((2, 100, 37), "float32"),  # odd T below 64
]
BWD_CASES = [(shape, dt) for dt in ("float32", "bfloat16") for shape in TRAIN_SHAPES] + [
    (shape, "float32") for shape in HIFIGAN_TRAIN_SHAPES] + [
    ((2, 100, 37), "float32"),  # an odd small shape
    ((2, 256, 160), "bfloat16"),
]
# (shape, dtype, cluster size k or None for the plan's own) beyond the main
# paths: rows split over a forced cluster of k blocks, with odd T not
# divisible by k at every k in both dtypes (a bf16 row of odd T starts 2
# bytes off a 16-byte boundary), and T < 16 (ranks past the row's end);
# then rows whose slices exceed shared memory and stream (odd T)
SPLIT_CASES = [((2, 5, 1001), dt, k) for dt in ("float32", "bfloat16") for k in (1, 2, 4, 8)] + [
    ((1, 3, 13), "float32", 8), ((2, 4, 5), "float32", 4)]
EDGE_CASES = SPLIT_CASES + [((1, 32, 480000), "float32", None), ((1, 8, 480001), "float32", None)]
BWD_EDGE_CASES = SPLIT_CASES + [((1, 16, 240001), "float32", None)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak HBM3 bandwidth
ROTATE_BYTES = 3 * 50 * 2 ** 20  # cold timings rotate over inputs of 3x the 50 MB L2
TRAIN_TEXTS = [BENCH_TEXT] + SERVE_TEXTS
CALLS_PER_STEP = 48  # forward and backward launches per stage-1 generator step
SMALL = {"max_len": 80, "model_params": {  # the reduced width of phase 11
    "hidden_dim": 64, "style_dim": 32, "dim_in": 16,
    "decoder": {"upsample_initial_channel": 64, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]]}}}
GRAD_TOL = 3e-2  # L2 of the gradient difference over its norm, per module
MCD_BOUND = 2.5  # dB, bf16 against f32 compute (the JAX package's tests/test_bf16.py)
STEP_TOL = 0.15  # a bf16 step's losses against f32's (tests/test_mixed_precision.py)
# phase 27's graphs: the staged and batched paths at the pinned utterance's
# frame bucket (F = 400) at B = 1 and 8 and at SHORT_TEXT's (F = 100), the
# iSTFTNet stages (20 F, 120 F + 1) and HiFi-GAN's (20, 100, 300, 600 F),
# both dtypes; held against the plain version in phase 3, not timed
GRAPH_CASES = [((B, C, T), dt) for dt in ("float32", "bfloat16")
               for B, C, T in sorted({(B, C, T) for B, F in ((1, 400), (8, 400), (1, 100))
                                      for C, T in ((256, 20 * F), (128, 120 * F + 1),
                                                   (128, 100 * F), (64, 300 * F), (32, 600 * F))})
               if ((B, C, T), dt) not in KERNEL_CASES]
STAGE2_BATCHES = (16, 12, 8)  # phase 12 runs at the first that fits the card
REPO = Path(__file__).resolve().parent


def _ms(fn, iters=200, warmup=20, sets=((),)):
    """CUDA-event ms per call of fn(*args), args taken in turn from `sets`."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, sets=((),)):
    """Device ms per call of fn(*args), args taken in turn from `sets`: the
    calls captured in one CUDA graph and replayed, so that the time is the
    card's and not the host's launch overhead (at B = 1 the host takes
    longer to launch a kernel than the card to run it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: builds, plans, allocations
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _turns(fns, sets, iters, warmup=3, graph=True):
    """Each of fns timed twice in turns (A, B, ..., B, A), on the card
    (`graph_ms`) or per eager call (`_ms`, the host's launch included):
    one (first, second) pair of ms per function."""
    order = list(fns) + list(reversed(fns))
    t = [graph_ms(f, iters, sets) if graph else _ms(f, iters, warmup, sets) for f in order]
    return [(t[i], t[len(t) - 1 - i]) for i in range(len(fns))]


def rotation(args, nbytes):
    """Input sets for cold-L2 timing: `args` and copies of it, enough that
    the calls between two uses of one set read ROTATE_BYTES of other inputs
    (`nbytes` per set)."""
    n = max(2, -(-ROTATE_BYTES // nbytes) + 1)
    return [args] + [tuple(t.clone() for t in args) for _ in range(n - 1)]


def bound_ms(shape, dtype, backward=False):
    """The least time of one K1 (K2 when `backward`) call on the card: each
    input byte read once and each output byte written once at the HBM rate.
    K1 reads x, gamma, beta, alpha and writes out; K2 reads x, dy, gamma,
    beta, alpha and writes dx, dgamma, dbeta and the per-row dalpha."""
    B, C, T = shape
    size = 2 if dtype in ("bfloat16", torch.bfloat16) else 4
    rows = (3 if backward else 2) * B * C * T * size
    vectors = (2 * B * C + C + (3 * B * C if backward else 0)) * 4
    return (rows + vectors) / HBM_BYTES_PER_S * 1e3


def kernel_inputs(g, dev, shape, dtype, with_dy=False):
    """Seeded (x, gamma, beta, alpha[, dy]) on `dev` for x of `shape`."""
    B, C, T = shape
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = torch.randn((B, C), generator=g, device=dev) * 0.1
    beta = torch.randn((B, C), generator=g, device=dev) * 0.1
    alpha = torch.rand((C,), generator=g, device=dev) + 0.5
    if not with_dy:
        return x, gamma, beta, alpha
    return x, gamma, beta, alpha, torch.randn(shape, generator=g, device=dev).to(dtype)


def _zero_sines(self, f0, generator=None):
    """SineGen.forward with the harmonic sines zeroed (the voicing kept)."""
    uv = (f0 > self.voiced_threshold).float()
    return torch.zeros(f0.shape[:2] + (self.dim,), device=f0.device), uv


def _noise_source(self, f0, generator=None):
    """SineGen.forward with the harmonic sines zeroed and its noise kept.
    With no noise the source is constant, and the AdaINs of the Generator's
    noise branch normalise its rounding: then their dgamma and dbeta, which
    the style encoder's gradient sums, move by a large share of their norm
    under a 1e-7 change of the weights (tools/conditioning_torch.py)."""
    uv = (f0.float() > self.voiced_threshold).float()
    amp = uv * self.noise_std + (1.0 - uv) * self.sine_amp / 3.0
    return amp * torch.randn(f0.shape[:2] + (self.dim,), device=f0.device), uv


def _zero_phase(magphase):
    """`stft_magphase` with its phase zeroed (atan2 of ~0-magnitude bins
    flips under any float reassociation)."""
    def zeroed(*a):
        mag, phase = magphase(*a)
        return mag, torch.zeros_like(phase)
    return zeroed


def _host_draws(fn, *args, zero_sines=False, noise_source=False, **kwargs):
    """`fn(*args, **kwargs)` with every random draw taken from one seeded CPU
    generator, so that two devices decode the same inputs, and the NSF
    source's chaotic parts zeroed (tests/torch_parity.py): the iSTFTNet
    source's STFT phase, atan2 of ~0-magnitude bins that flips under any
    float reassociation, and the harmonic sines that HiFi-GAN takes raw
    (`fn` a HiFi-GAN Synthesizer's method, or `zero_sines`), whose phase
    reaches ~1e5 rad, where f32 rounding in another summation order is
    O(1e-2) rad. A random-init decoder amplifies either to O(1).
    `noise_source`: the sines zeroed and the source's noise kept
    (`_noise_source`)."""
    import styletts2_tpu_torch.models.decoder_istft as pdi

    host = torch.Generator().manual_seed(0)
    rand, randn, magphase, sines = torch.rand, torch.randn, pdi.stft_magphase, pdi.SineGen.forward

    def draw(f):
        return lambda size, generator=None, device=None, dtype=None: f(
            size, generator=host, dtype=dtype).to(device)

    torch.rand, torch.randn, pdi.stft_magphase = draw(rand), draw(randn), _zero_phase(magphase)
    hifigan = zero_sines or getattr(getattr(fn, "__self__", None), "hifigan", False)
    pdi.SineGen.forward = _noise_source if noise_source else _zero_sines if hifigan else sines
    try:
        return fn(*args, **kwargs)
    finally:
        torch.rand, torch.randn, pdi.stft_magphase = rand, randn, magphase
        pdi.SineGen.forward = sines


class _SharedDraws:
    """While entered: a request on the card's CUDA graphs and then the same
    request on the CPU take the same draws, and the NSF source's chaotic
    parts are zeroed in both (the iSTFTNet source's STFT phase, as
    `_host_draws` zeroes it; HiFi-GAN's harmonic sines, `_zero_sines`, or
    with `noise_source` the sines alone, `_noise_source`). On the card the
    draws a graph's capture records are kept (each draw's tensor stays
    alive in the graph's pool, so after the replay it holds what the replay
    drew), and with `outside` so are the draws made outside the programs
    (the starting noise); a graph's warm-up draws are not. After `feed()` every draw
    takes the next kept one, moved to the CPU. The Synthesizers must
    capture their graphs inside (the source's parts are captured as they
    are at capture): clear `syn.graphs` first. `left()` counts the kept
    draws not taken."""

    def __init__(self, hifigan, noise_source=False, outside=True):
        self.hifigan, self.noise_source, self.outside = hifigan, noise_source, outside
        self.kept, self._feed = [], None

    def __enter__(self):
        self._zeroed = _chaos_zeroed(self.hifigan, self.noise_source)
        self._zeroed.__enter__()
        self._saved = torch.rand, torch.randn

        def shared(f):
            def draw(size, *, generator=None, device=None, dtype=None):
                if self._feed is not None:  # the CPU run: the card's draws, in order
                    t = next(self._feed)
                    if tuple(t.shape) != tuple(size):
                        raise RuntimeError(f"the CPU draws {tuple(size)}, the card drew "
                                           f"{tuple(t.shape)}")
                    return t.to("cpu", dtype or t.dtype)
                out = f(size, generator=generator, device=device, dtype=dtype)
                if torch.cuda.is_current_stream_capturing() or (
                        self.outside and not GRAPHS.building):
                    self.kept.append(out)
                return out
            return draw

        torch.rand, torch.randn = shared(torch.rand), shared(torch.randn)
        return self

    def feed(self):
        self._feed = iter(self.kept)

    def left(self):
        return sum(1 for _ in self._feed)

    def __exit__(self, *exc):
        torch.rand, torch.randn = self._saved
        self._zeroed.__exit__(*exc)


@contextlib.contextmanager
def _chaos_zeroed(hifigan, noise_source=False):
    """The NSF source's chaotic parts zeroed, as `_host_draws` zeroes them
    (with `noise_source` HiFi-GAN's sines alone), the draws left as they
    are: for two Synthesizers on the card whose graphs, captured inside,
    draw the same from the same seed."""
    import styletts2_tpu_torch.models.decoder_istft as pdi

    magphase, sines = pdi.stft_magphase, pdi.SineGen.forward
    pdi.stft_magphase = _zero_phase(magphase)
    if hifigan:
        pdi.SineGen.forward = _noise_source if noise_source else _zero_sines
    try:
        yield
    finally:
        pdi.stft_magphase, pdi.SineGen.forward = magphase, sines


def reference_net(state_dict, seed=0):
    """The port's state_dict {"module.name": tensor} as the `net` of a
    reference StyleTTS 2 checkpoint, {module: state_dict}, in the layout the
    reference's DataParallel training writes: `module.` on every key; the
    diffusion weights under `unet.` and again under `diffusion.net.` (the
    reference's KDiffusion holds the same UNet); ALBERT's pooler and
    position ids beside PL-BERT; each LSTM bias b (bias_ih + bias_hh) split
    into (b - r, r), r seeded and nonzero, as a trained LSTM holds it."""
    g = torch.Generator().manual_seed(seed)
    net = collections.defaultdict(dict)
    for name, v in state_dict.items():
        key, rest = name.split(".", 1)
        if "bias_hh" in rest:
            continue  # written with its bias_ih
        if "bias_ih" in rest:
            hh = rest.replace("bias_ih", "bias_hh")
            r = 0.1 * torch.randn(v.shape, generator=g)
            net[key][f"module.{rest}"] = v + state_dict[f"{key}.{hh}"] - r
            net[key][f"module.{hh}"] = r
        elif key == "diffusion":
            net[key][f"module.unet.{rest}"] = v
            net[key][f"module.diffusion.net.{rest}"] = v.clone()
        else:
            net[key][f"module.{rest}"] = v
    if "bert" in net:
        bert = net["bert"]
        hidden = bert["module.encoder.embedding_hidden_mapping_in.weight"].shape[0]
        positions = bert["module.embeddings.position_embeddings.weight"].shape[0]
        bert["module.pooler.weight"] = torch.randn((hidden, hidden), generator=g) / hidden ** 0.5
        bert["module.pooler.bias"] = torch.zeros(hidden)
        bert["module.embeddings.position_ids"] = torch.arange(positions)[None]
    return dict(net)


class _Tally:
    """While entered: the kernels' launches by (kernel, x's dtype name), K1
    as `_forward_kernel` is called and K2 as `adain_snake_bwd` is, and the
    plain versions' calls (`plain`); `shapes[kernel]` the (x's shape, dtype
    name) pairs each was called at."""

    WRAPPED = {"_forward_kernel": "K1", "adain_snake_bwd": "K2", "adain_snake_ref": "plain",
               "adain_snake_bwd_ref": "plain"}

    def __init__(self, op):
        self.op, self.n = op, collections.Counter()
        self.shapes = collections.defaultdict(set)

    def __enter__(self):
        self._saved = {name: getattr(self.op, name) for name in self.WRAPPED}

        def counted(key, fn):
            def call(x, *a, **k):
                dtype = str(x.dtype).split(".")[-1]
                self.n[key, dtype] += 1
                self.shapes[key].add((tuple(x.shape), dtype))
                return fn(x, *a, **k)
            return call

        for name, key in self.WRAPPED.items():
            setattr(self.op, name, counted(key, self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.op, name, fn)

    @property
    def plain(self):
        return sum(v for (key, _), v in self.n.items() if key == "plain")

    def since(self, before):
        """The launches by (kernel, dtype) since the snapshot `before`."""
        return {k: v - before.get(k, 0) for k, v in self.n.items()
                if k[0] != "plain" and v - before.get(k, 0)}


class _GraphWatch:
    """Installed once, before the first phase (`install`): K1's launches by
    x's dtype over the whole smoke (`dtypes`), an eager launch when it is
    made and a launch recorded into a CUDA graph (`inference._Graph`) at
    each replay of the graph, which keeps its capture's (`k1_dtypes`);
    `replays`, the replays of graphs that hold K1 (one decode each);
    `building`, whether a graph is being built (its warm-up or capture)."""

    def __init__(self):
        self.dtypes, self.replays, self.building = collections.Counter(), 0, False

    def install(self, op):
        from styletts2_tpu_torch import inference

        cls = inference._Graph
        forward, init, call = op._forward_kernel, cls.__init__, cls.__call__
        capture = []

        def counted(x, *a, **k):
            dtype = str(x.dtype).split(".")[-1]
            inside = capture and torch.cuda.is_current_stream_capturing()  # a `_Graph`'s capture
            (capture[-1] if inside else self.dtypes)[dtype] += 1
            return forward(x, *a, **k)

        def build(graph, *a, **k):
            capture.append(collections.Counter())
            self.building = True
            try:
                init(graph, *a, **k)
            finally:
                self.building = False
                graph.k1_dtypes = capture.pop()

        def replay(graph, *a, **k):
            out = call(graph, *a, **k)
            self.dtypes.update(graph.k1_dtypes)
            self.replays += bool(graph.k1)
            return out

        op._forward_kernel, cls.__init__, cls.__call__ = counted, build, replay


GRAPHS = _GraphWatch()


class _Counts:
    """Kernel launches (and their dtypes), plain-version calls and decoder
    runs of one phase: `with _Counts(op, decoder) as c:` sets them to 0 on
    entry and reads them on exit. A decoder run is an eager call of the
    decoder (a graph's warm-up among them; `eager`) or a replay of a graph
    that holds K1 (`replays`); a graph's capture runs none."""

    def __init__(self, op, decoder):
        self.op, self.decoder = op, decoder

    def __enter__(self):
        self.eager = 0

        def decode(module, args):
            self.eager += not torch.cuda.is_current_stream_capturing()

        self._hook = self.decoder.register_forward_pre_hook(decode)
        self._tally = _Tally(self.op).__enter__()
        self._replays, self._dtypes = GRAPHS.replays, collections.Counter(GRAPHS.dtypes)
        self.op.adain_snake.launches = 0
        return self

    def __exit__(self, *exc):
        self.launches = self.op.adain_snake.launches
        self._tally.__exit__(*exc)
        self.plain_calls = self._tally.plain
        self.replays = GRAPHS.replays - self._replays
        self.decodes = self.eager + self.replays
        self.dtypes = dict(GRAPHS.dtypes - self._dtypes)
        self._hook.remove()

    def check(self, per_decode, what, dtype="float32"):
        if self.plain_calls or self.launches != per_decode * self.decodes or not self.decodes \
                or self.dtypes != {dtype: self.launches}:
            raise RuntimeError(f"{what}: {self.launches} kernel launches ({self.dtypes}) for "
                               f"{self.decodes} decodes, {self.plain_calls} plain-version calls")


class _Artifacts:
    """While entered: every `eval_artifacts` call of the trainers (stage 1,
    stage 2, finetuning), with the step its files carry (the epoch it
    closes, + 1), whether it sampled, its audio tags, whether all it
    returned is finite, and its K1 launches. `check` holds each call to one
    decode (48 launches) and its files in `log_dir`."""

    def __init__(self, op):
        self.op, self.calls = op, []

    def __enter__(self):
        from styletts2_tpu_torch.train.stage1 import Stage1Trainer
        from styletts2_tpu_torch.train.stage2 import Stage2Trainer

        self._saved = [(cls, cls.eval_artifacts) for cls in (Stage1Trainer, Stage2Trainer)]
        for cls, fn in self._saved:
            def wrapped(trainer, batch, rng, *a, _fn=fn, **k):
                k1 = self.op.adain_snake.launches
                try:
                    art = _fn(trainer, batch, rng, *a, **k) or {}
                except Exception as e:  # run_stage logs it and carries on: `check` raises
                    self.calls.append({"step": trainer.state.epoch + 1, "error": repr(e)})
                    raise
                arrays = list(art.get("audio", {}).values()) + ([art["attn"]] if "attn" in art else [])
                self.calls.append({"step": trainer.state.epoch + 1, "sample": k.get("sample", False),
                                   "tags": sorted(art.get("audio", {})), "attn": "attn" in art,
                                   "finite": all(np.isfinite(x).all() for x in arrays),
                                   "k1": self.op.adain_snake.launches - k1})
                return art or None
            cls.eval_artifacts = wrapped
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved:
            cls.eval_artifacts = fn

    @property
    def k1(self):
        return sum(c["k1"] for c in self.calls)

    def check(self, log_dir, tag, epochs, joint_epoch=None, per_decode=CALLS_PER_DECODE):
        """Raise unless there was one call for each of the `epochs` the run
        took and every one decoded once (`per_decode` K1 launches), returned finite
        arrays and left them as 24 kHz WAVs (and stage 1's attention as
        .npy) in `log_dir`, sampling exactly from `joint_epoch` on (stage
        2); print one line."""
        log_dir = Path(log_dir)
        if [c["step"] - 1 for c in self.calls] != list(epochs):
            raise RuntimeError(f"[{tag}] eval artifacts {self.calls} for epochs {list(epochs)}")
        for c in self.calls:
            if "error" in c:
                raise RuntimeError(f"[{tag}] eval artifacts at step {c['step']}: {c['error']}")
            want_tags = (["gt_0", "sampled_0"] if c["sample"] else
                         [f"{t}_{b}" for t in ("gt", "y_rec") for b in range(3)])
            sample = joint_epoch is not None and c["step"] - 1 >= joint_epoch
            if c["k1"] != per_decode or not c["finite"] or c["tags"] != want_tags or \
                    c["sample"] != sample or c["attn"] != (joint_epoch is None):
                raise RuntimeError(f"[{tag}] eval artifacts: {c}")
            for t in c["tags"]:
                with wave.open(str(log_dir / "eval_audio" / f"eval_{t}_step{c['step']}.wav")) as f:
                    if f.getframerate() != 24000 or f.getnframes() <= 0:
                        raise RuntimeError(f"[{tag}] eval_{t}_step{c['step']}.wav: {f.getnframes()} "
                                           f"frames at {f.getframerate()} Hz")
            if c["attn"] and not np.isfinite(np.load(log_dir / "eval_attn" /
                                                     f"attn_step{c['step']}.npy")).all():
                raise RuntimeError(f"[{tag}] attn_step{c['step']}.npy: non-finite")
        print(f"[{tag}] eval artifacts at steps {[c['step'] for c in self.calls]} (sampled: "
              f"{[c['step'] for c in self.calls if c['sample']]}): finite, written to eval_audio/"
              + (" and eval_attn/" if joint_epoch is None else "")
              + f", K1 {self.k1} ({per_decode} per call)", flush=True)


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


def _write_voice(path, sr):
    """`_voice` as a 16-bit WAV at `sr`."""
    pcm = (np.clip(_voice(sr=sr), -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _utterance(rng, seconds, sr=24000):
    """A seeded utterance in the style of `_voice`: a gliding pitch of its own
    with 5 harmonics, plus noise."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100.0, 220.0) + 30.0 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6)) + 0.02 * rng.standard_normal(t.size)
    return wav.astype(np.float32)


def training_fixture(root: Path, n: int = 32):
    """n seeded 24 kHz WAVs of 6-9 s (so that every batch reaches the full
    clip of 200 half-frames) with the smoke's sentences as their text, and
    train (all), val (the first 16) and OOD lists; returns the DataParams."""
    from styletts2_tpu_torch.config import DataParams

    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        pcm = (np.clip(_utterance(rng, rng.uniform(6.0, 9.0)), -1, 1) * 32767).astype(np.int16)
        with wave.open(str(root / f"u{i:02d}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes(pcm.tobytes())
        lines.append(f"u{i:02d}.wav|{TRAIN_TEXTS[i % len(TRAIN_TEXTS)]}|0")
    (root / "train.txt").write_text("\n".join(lines))
    (root / "val.txt").write_text("\n".join(lines[:16]))
    (root / "ood.txt").write_text("\n".join(TRAIN_TEXTS))
    return fixture_params(root)


def fixture_params(root: Path):
    """The DataParams of the fixture `training_fixture` wrote in `root`."""
    from styletts2_tpu_torch.config import DataParams

    return DataParams(train_data=str(root / "train.txt"), val_data=str(root / "val.txt"),
                      root_path=str(root), OOD_data=str(root / "ood.txt"))


def _close(got, want, dtype):
    """assert_close at the dtype's tolerance, absolute part relative to the peak."""
    tol = TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


def _stage1_grads(models, cfg, device, batch, starts, use_mono, tma):
    """One stage-1 generator loss and its backward, eval mode: (the losses,
    {stepped module: its flattened gradient on the host}). The LSTMs alone
    run in train mode, which cuDNN needs for their backward and which
    changes nothing else (they have no dropout)."""
    from styletts2_tpu_torch import losses as L
    from styletts2_tpu_torch.train.stage1 import GEN_KEYS, Stage1Trainer
    from styletts2_tpu_torch.train.state import TrainState

    keys = GEN_KEYS + (("text_aligner",) if tma else ())
    for k, m in models.items():
        m.eval().requires_grad_(k in keys)
        m.zero_grad(set_to_none=True)
        for lstm in m.modules():
            if isinstance(lstm, torch.nn.LSTM):
                lstm.train()
    trainer = Stage1Trainer(cfg, TrainState(models, {}), device)
    tensors = trainer._tensors(batch)
    clip = 40
    y, w, aux = trainer.forward_recon(*tensors, starts, starts, clip, bool(use_mono))
    g_loss, metrics = trainer.generator_losses(y, w, aux, tensors[1], tensors[2], tma)
    if tma:
        metrics["gen"] = L.generator_adv_loss(models["mpd"](w, y), models["msd"](w, y))
        g_loss = g_loss + cfg.loss_params.lambda_gen * metrics["gen"]
    g_loss.backward()
    losses = {k: float(v.detach()) for k, v in metrics.items()}
    losses["g_loss"] = float(g_loss.detach())
    grads = {k: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().flatten()
                           for p in models[k].parameters()]).cpu() for k in keys}
    return losses, grads


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _plan_text(plan, shape):
    B, C, _ = shape
    return (f"k={plan.k} ({B * C * plan.k} blocks of {plan.threads}), slice {plan.slice}, "
            + (f"{plan.smem / 1024:.1f} KB shared" if plan.smem else "streamed"))


def _times_text(name, pairs):
    return f"{name} " + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in pairs)


def kernel_phase(op, dev, smi):
    """Phase 3: K1 against its plain version at every case, twice (the same
    bits), and at forced cluster sizes; cold and warm times at the main
    paths' shapes in both dtypes. Returns ({dtype name: max abs error},
    {(shape, dtype name): {"cold": (kernel, plain), "warm": ..., "bound":
    ms}})."""
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(0)
    max_err, timings = {"float32": 0.0, "bfloat16": 0.0}, {}
    cases = [(shape, dt, None) for shape, dt in KERNEL_CASES + GRAPH_CASES] + EDGE_CASES
    for shape, dt, k in cases:
        dtype = getattr(torch, dt)
        args = kernel_inputs(g, dev, shape, dtype)
        with torch.inference_mode():
            got = op._forward_kernel(*args, k=k)
            again = op._forward_kernel(*args, k=k)
            torch.cuda.synchronize()
            want = op.adain_snake_ref(*args)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt], rtol=TOL[dt])
        if not torch.equal(got, again):
            raise RuntimeError(f"K1 {shape} {dt}: two launches differ")
        plan = op.plan_of(args[0], k=k)
        line = (f"[3 kernel] {shape} {dt}, {_plan_text(plan, shape)}: max_abs_err {err:.3e} "
                f"(tol {TOL[dt]:g}), repeat bit-equal")
        max_err[dt] = max(max_err[dt], err)
        if (shape, dt) in KERNEL_CASES and shape[2] >= 2400:  # the main paths' shapes
            iters = 30 if args[0].numel() < 10 ** 7 else 12
            nbytes = args[0].numel() * args[0].element_size()
            bound = bound_ms(shape, dt)
            with torch.inference_mode():
                fns = (op.adain_snake_ref, op.adain_snake)
                (pc, kc) = _turns(fns, rotation(args, nbytes), iters)
                (pw, kw) = _turns(fns, [args], iters)
                (_, ke) = _turns(fns, [args], iters, graph=False)
                inorm = [graph_ms(lambda x, *_: F.instance_norm(x), iters, sets)
                         for sets in (rotation(args, nbytes), [args])]
            cold = (kc[0] + kc[1]) / 2
            timings[shape, dt] = {"cold": (cold, (pc[0] + pc[1]) / 2),
                                  "warm": ((kw[0] + kw[1]) / 2, (pw[0] + pw[1]) / 2),
                                  "bound": bound}
            line += (f"; card ms: {_times_text('kernel cold', [kc])} warm {kw[0]:.4f}/{kw[1]:.4f}, "
                     f"{_times_text('plain cold', [pc])} warm {pw[0]:.4f}/{pw[1]:.4f}; bound "
                     f"{bound:.4f}, cold share {bound / cold:.0%}; yardstick F.instance_norm "
                     f"(less work) cold {inorm[0]:.4f} warm {inorm[1]:.4f}; an eager call "
                     f"{ke[0]:.4f}/{ke[1]:.4f} [{smi}]")
        print(line, flush=True)
        del args, got, again, want
    torch.cuda.empty_cache()
    slower = [f"{c}: {t['cold'][0]:.4f} vs {t['cold'][1]:.4f} ms" for c, t in timings.items()
              if t["cold"][0] > t["cold"][1]]
    print(f"[3 kernel] slower than plain (cold) at: {'; '.join(slower) or 'no shape'} [{smi}]",
          flush=True)
    return max_err, timings


def backward_phase(op, dev, smi):
    """Phase 9: the backward kernel against its plain version and autograd
    through the forward's plain version, twice (the same bits), and at
    forced cluster sizes; cold and warm times at the training shapes.
    Returns ({dtype name: dx's max abs error}, {(shape, dtype name):
    {"cold": (kernel ms, plain ms), "warm": ..., "bound": ms}})."""
    g = torch.Generator(dev).manual_seed(1)
    bwd_err, bwd_timings = {"float32": 0.0, "bfloat16": 0.0}, {}
    for shape, dt, k in [(shape, dt, None) for shape, dt in BWD_CASES] + BWD_EDGE_CASES:
        dtype = getattr(torch, dt)
        args = kernel_inputs(g, dev, shape, dtype, with_dy=True)
        got = op.adain_snake_bwd(*args, k=k)
        again = op.adain_snake_bwd(*args, k=k)
        torch.cuda.synchronize()
        plain = op.adain_snake_bwd_ref(*args)
        leaves = [t.clone().requires_grad_(True) for t in args[:4]]
        auto = torch.autograd.grad(op.adain_snake_ref(*leaves), leaves, args[4])
        errs = []
        for a, b, p, au in zip(got, again, plain, auto):
            if a.dtype != p.dtype or a.shape != p.shape:
                raise RuntimeError(f"backward kernel: {a.dtype} {tuple(a.shape)} vs {p.dtype} "
                                   f"{tuple(p.shape)}")
            if not torch.equal(a, b):
                raise RuntimeError(f"K2 {shape} {dt}: two launches differ")
            _close(a, p, a.dtype)
            _close(a, au, a.dtype)
            errs.append(float((a.float() - p.float()).abs().max() / p.float().abs().max()))
        plan = op.plan_of(args[0], True, k)
        line = (f"[9 backward] {shape} {dt}, {_plan_text(plan, shape)}: rel err vs plain dx "
                f"{errs[0]:.2e}, dgamma {errs[1]:.2e}, dbeta {errs[2]:.2e}, dalpha {errs[3]:.2e}; "
                f"dx max abs err {float((got[0].float() - plain[0].float()).abs().max()):.3e} "
                f"(tol {TOL[dt]:g} of each peak, and against autograd); repeat bit-equal")
        bwd_err[dt] = max(bwd_err[dt], float((got[0].float() - plain[0].float()).abs().max()))
        if (shape, dt) in BWD_CASES and shape[2] >= 2400:  # the training shapes
            nbytes = 2 * args[0].numel() * args[0].element_size()
            bound = bound_ms(shape, dt, backward=True)
            fns = (op.adain_snake_bwd_ref, op.adain_snake_bwd)
            with torch.inference_mode():
                (pc, kc) = _turns(fns, rotation(args, nbytes), 10)
                (pw, kw) = _turns(fns, [args], 10)
            cold = (kc[0] + kc[1]) / 2
            bwd_timings[shape, dt] = {"cold": (cold, (pc[0] + pc[1]) / 2),
                                  "warm": ((kw[0] + kw[1]) / 2, (pw[0] + pw[1]) / 2),
                                  "bound": bound}
            line += (f"; card ms: {_times_text('kernel cold', [kc])} warm {kw[0]:.4f}/{kw[1]:.4f}, "
                     f"{_times_text('plain cold', [pc])} warm {pw[0]:.4f}/{pw[1]:.4f}; bound "
                     f"{bound:.4f}, cold share {bound / cold:.0%} [{smi}]")
        print(line, flush=True)
        del args, got, again, plain, auto, leaves
    torch.cuda.empty_cache()
    return bwd_err, bwd_timings


def training_phase(op, build_dir, smi):
    """Phase 10: stage-1 training at full width through `run_stage`, then a
    resumed call. Returns the forward and backward kernel launches of both
    calls and the first call's {"tma": TMA step ms, "peak": bytes}."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.train import run as train_run
    from styletts2_tpu_torch.train.stage1 import Stage1Trainer

    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        cfg = Config()
        cfg.data_params = training_fixture(Path(tdir) / "data")
        cfg.log_dir = str(Path(tdir) / "logs")
        cfg.loss_params.TMA_epoch, cfg.epochs_1st, cfg.log_interval = 1, 2, 1
        steps, before = [], {}
        train_step, tally = Stage1Trainer.train_step, _Tally(op)

        def timed_step(self, batch, epoch, iters, rng):
            if not before:
                before.update({n: p.detach().clone() for n, p in
                               self.models["decoder"].named_parameters()})
            k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
            t0 = time.perf_counter()
            m = train_step(self, batch, epoch, iters, rng)  # ends in a host sync (the metrics)
            steps.append({"epoch": epoch, "ms": (time.perf_counter() - t0) * 1e3, "metrics": m,
                          "k1": op.adain_snake.launches - k1, "k2": op.adain_snake.bwd_launches - k2})
            return m

        Stage1Trainer.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        op.adain_snake.launches = op.adain_snake.bwd_launches = 0
        arts = _Artifacts(op)
        try:
            tally.__enter__()
            arts.__enter__()
            t0 = time.perf_counter()
            state = train_run.run_stage("first", cfg, device="cuda")
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            dec_delta = float(torch.sqrt(sum(((p.detach() - before[n]) ** 2).sum() for n, p in
                                              state.models["decoder"].named_parameters())))
            dec_norm = float(torch.sqrt(sum((v ** 2).sum() for v in before.values())))
            n_params = sum(p.numel() for p in state.models.parameters())
            first_steps, first_epoch = len(steps), state.epoch
            del state
            torch.cuda.empty_cache()
            cfg.epochs_1st = 3  # the second call resumes from epoch_1st_00002.pth
            state = train_run.run_stage("first", cfg, max_steps=1, device="cuda")
            resumed = (state.step, state.epoch)
            del state
        finally:
            Stage1Trainer.train_step = train_step
            arts.__exit__()
            tally.__exit__()
        arts.check(cfg.log_dir, "10 training", sorted({st["epoch"] for st in steps}))
        train_k1, train_k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
        log = (Path(cfg.log_dir) / "train.log").read_text()
        written = sorted(p.name for p in Path(cfg.log_dir).iterdir())
        evals = [json.loads(x) for x in (Path(cfg.log_dir) / "metrics.jsonl").read_text().splitlines()
                 if "eval/mel" in x]
    torch.cuda.empty_cache()
    k1_step = CALLS_PER_STEP * (2 if cfg.remat_decoder else 1)  # the recompute under remat
    for i, st in enumerate(steps):
        m = st["metrics"]
        if m is None or not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"training step {i}: metrics {m}")
        if (st["k1"], st["k2"]) != (k1_step, CALLS_PER_STEP):
            raise RuntimeError(f"training step {i}: {st['k1']} forward and {st['k2']} backward "
                               f"kernel launches, not {k1_step} and {CALLS_PER_STEP}")
        phase = "TMA" if st["epoch"] >= cfg.loss_params.TMA_epoch else "pre-TMA"
        print(f"[10 training] step {i} (epoch {st['epoch']}, {phase}): {st['ms']:.1f} ms; launches "
              f"K1 {st['k1']} K2 {st['k2']}; " + " ".join(f"{k}={v:.4f}" for k, v in m.items())
              + f" [{smi}]", flush=True)
    pre = [st["ms"] for st in steps[:first_steps] if st["epoch"] < cfg.loss_params.TMA_epoch]
    tma = [st["ms"] for st in steps[:first_steps] if st["epoch"] >= cfg.loss_params.TMA_epoch]
    if len(pre) < 2 or len(tma) < 2 or first_epoch != 2:
        raise RuntimeError(f"training: {len(pre)} pre-TMA and {len(tma)} TMA steps, epoch {first_epoch}")
    if tally.plain or train_k1 != k1_step * len(steps) + CALLS_PER_DECODE * len(evals) + \
            arts.k1 or train_k2 != CALLS_PER_STEP * len(steps):
        raise RuntimeError(f"training: {train_k1} forward / {train_k2} backward launches for "
                           f"{len(steps)} steps, {len(evals)} validations and {len(arts.calls)} "
                           f"eval artifacts, {tally.plain} plain calls")
    if not (np.isfinite(dec_delta) and dec_delta > 0):
        raise RuntimeError(f"training: the decoder moved by {dec_delta}")
    resume = [x for x in log.splitlines() if "auto-resuming from" in x]
    if not resume or "epoch_1st_00002.pth (epoch 2)" not in resume[-1] or \
            resumed != (first_steps + 1, 3) or "first_stage.pth" not in written:
        raise RuntimeError(f"training resume: {resume}, (step, epoch) {resumed}, files {written}")
    val_mel = ", ".join(f"{e['eval/mel']:.4f}" for e in evals)
    print(f"[10 training] run_stage('first', Config()): {n_params} parameters, batch {cfg.batch_size}, "
          f"max_len {cfg.max_len}; {len(pre)} pre-TMA steps {', '.join(f'{t:.1f}' for t in pre)} ms, "
          f"{len(tma)} TMA steps {', '.join(f'{t:.1f}' for t in tma)} ms; validation mel "
          f"{val_mel}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; the decoder moved {dec_delta:.4e} (norm {dec_norm:.4e}); "
          f"launches K1 {train_k1} K2 {train_k2} ({CALLS_PER_STEP} each per step, K1 48 per "
          f"validation and per eval artifact), 0 plain-version calls; wall {wall:.1f} s [{smi}]",
          flush=True)
    print(f"[10 training] {resume[-1].split(': ', 1)[-1]}; then 1 step to (step, epoch) {resumed}; "
          f"files {written}", flush=True)
    return train_k1, train_k2, {"tma": tma, "peak": peak}


def training_reference_phase(dev):
    """Phase 11: one stage-1 step at reduced width, the same weights on the
    card and on the CPU."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.models.build import build_training_models

    small = Config.from_dict(SMALL)
    cpu_models = build_training_models(small, torch.Generator().manual_seed(0))
    gpu_models = copy.deepcopy(cpu_models).to(dev)
    rng = np.random.default_rng(2)
    batch = types.SimpleNamespace(
        waves=(0.2 * rng.standard_normal((2, 48000))).astype(np.float32),
        tokens=rng.integers(1, 178, (2, 12)).astype(np.int32),
        input_lengths=np.asarray([12, 9]), mel_lengths=np.asarray([160, 140]))
    starts = np.asarray([3, 5])
    for use_mono, tma in ((0, False), (1, True)):
        got_l, got_g = _host_draws(_stage1_grads, gpu_models, small, dev, batch, starts, use_mono, tma)
        want_l, want_g = _host_draws(_stage1_grads, cpu_models, small, "cpu", batch, starts,
                                     use_mono, tma)
        l_err = max(abs(got_l[k] - v) / abs(v) for k, v in want_l.items())
        g_err = {k: float((got_g[k] - v).norm() / v.norm()) for k, v in want_g.items()}
        print(f"[11 training reference] {'TMA' if tma else 'pre-TMA'}, use_mono {use_mono}: losses "
              + " ".join(f"{k}={v:.5f}" for k, v in got_l.items())
              + f"; rel err {l_err:.2e} (tol 1e-4); gradient L2 rel err "
              + ", ".join(f"{k} {e:.2e}" for k, e in g_err.items()) + f" (tol {GRAD_TOL:g})",
              flush=True)
        if not (l_err < 1e-4 and max(g_err.values()) < GRAD_TOL):
            raise RuntimeError("stage-1 step: GPU and CPU disagree")
    del cpu_models, gpu_models


def _flat(module):
    """The module's parameters, flattened into one host tensor: a snapshot
    that takes no device memory from the step it brackets."""
    return torch.cat([p.detach().flatten().cpu() for p in module.parameters()])


def _moves(cfg, epoch, iters, finetune=False):
    """{module: whether a stage-2 step of `epoch` (the run's `iters`-th)
    steps it} for the modules phases 12-13 watch."""
    lp = cfg.loss_params
    diff_on, joint_on = epoch >= lp.diff_epoch, epoch >= lp.joint_epoch
    return {"predictor": True, "bert": True, "diffusion": diff_on,
            "decoder": joint_on or finetune,
            "wd": joint_on and (iters + 1) % cfg.slmadv_params.iter == 0}


def _stage2_launches(joint, decoder_trained, slm_sampled, remat=False, per_decode=CALLS_PER_DECODE):
    """(K1, K2) of a stage-2 step: `per_decode` K1 per decoder run
    (y_rec_gt_pred, y_rec, and when joint the SLM pass's y_pred: 48
    iSTFTNet, 96 HiFi-GAN), twice that for each differentiated run (y_rec,
    y_pred) under `remat` (the backward's recompute); K2 per differentiated
    run: all of them where the noise branch takes a gradient too, less
    that branch's quarter (one AdaINResBlock1 of four per upsampling stage)
    where it does not. The noise branch sees only the detached harmonic
    source, its own weights and the style: it takes a gradient where the
    decoder is trained or the style is (the SLM pass's sampled style), as
    in JAX's VJP."""
    noise = per_decode // 4
    k2 = per_decode - (0 if decoder_trained else noise)
    trained = 1
    if joint:
        k2 += per_decode - (0 if slm_sampled else noise)
        trained += 1
    return per_decode * ((3 if joint else 2) + (trained if remat else 0)), k2


def _per_decode(cfg):
    """K1 launches of one decoder run of `cfg`: 48 iSTFTNet, 96 HiFi-GAN."""
    return CALLS_PER_HIFIGAN_DECODE if cfg.model_params.decoder.type == "hifigan" else CALLS_PER_DECODE


def _f32_masters(state, tag):
    """Raise unless every parameter of the bf16 module set and its Adam
    moments are f32 (bf16 training keeps its masters f32)."""
    from styletts2_tpu_torch.train.mp import BF16_MODULES

    for k in set(BF16_MODULES) & set(state.models):
        opt = state.opts.get(k)
        for n, p in state.models[k].named_parameters():
            moments = opt.state.get(p, {}) if opt is not None else {}
            bad = [m for m, v in moments.items() if torch.is_tensor(v) and v.dtype != torch.float32]
            if p.dtype != torch.float32 or bad:
                raise RuntimeError(f"{tag}: {k}.{n} is {p.dtype}, moments {bad} not f32")


def _stage2_run(op, stage, cfg, smi, tag, **kwargs):
    """`run_stage(stage, cfg, device="cuda", **kwargs)` with every step
    timed and checked: finite metrics, K1/K2 launches as the phase's decoder
    runs make them (48 K1 each, 48 K2 each that takes a gradient), a
    positive slm_valid_frac in joint steps, the watched modules moving just
    when the phase steps them, every step's launches with an x of the
    config's precision (bf16 under `mixed_precision: bf16`); then 48 f32 K1
    per validation batch, 0 plain-version calls over the run, and f32
    master weights and Adam moments. Returns (the steps, the final state's
    sigma_data, the peak memory, K1 and K2 launches, the train.log text)."""
    from styletts2_tpu_torch.train import run as train_run
    from styletts2_tpu_torch.train.stage2 import Stage2Trainer

    step_dtype = "bfloat16" if cfg.mixed_precision == "bf16" else "float32"
    per_decode = _per_decode(cfg)
    tally = _Tally(op)

    steps, train_step, validate = [], Stage2Trainer.train_step, Stage2Trainer.validate
    n_val = [0]

    def timed_step(self, batch, epoch, iters, rng):
        watched = {k: _flat(self.models[k]) for k in ("predictor", "bert", "diffusion", "decoder", "wd")}
        k1, k2, by = op.adain_snake.launches, op.adain_snake.bwd_launches, dict(tally.n)
        t0 = time.perf_counter()
        m = train_step(self, batch, epoch, iters, rng)  # ends in a host sync (the metrics)
        ms = (time.perf_counter() - t0) * 1e3
        moved = {k: not torch.equal(v, _flat(self.models[k])) for k, v in watched.items()}
        del watched
        steps.append({"epoch": epoch, "iters": iters, "ms": ms, "metrics": m, "moved": moved,
                      "k1": op.adain_snake.launches - k1, "k2": op.adain_snake.bwd_launches - k2,
                      "dtypes": {dt for _, dt in tally.since(by)},
                      "batch": len(batch.mel_lengths)})
        return m

    def counted_validate(self, batch, rng):
        out = validate(self, batch, rng)
        n_val[0] += out is not None
        return out

    Stage2Trainer.train_step, Stage2Trainer.validate = timed_step, counted_validate
    torch.cuda.reset_peak_memory_stats()
    op.adain_snake.launches = op.adain_snake.bwd_launches = 0
    arts = _Artifacts(op)
    try:
        with tally, arts:
            state = train_run.run_stage(stage, cfg, device="cuda", **kwargs)
        sigma = state.sigma_data
        _f32_masters(state, tag)
        del state
    finally:
        Stage2Trainer.train_step, Stage2Trainer.validate = train_step, validate
    peak = torch.cuda.max_memory_allocated()
    k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
    torch.cuda.empty_cache()
    log = (Path(cfg.log_dir) / "train.log").read_text()
    for i, st in enumerate(steps):
        m, lp = st["metrics"], cfg.loss_params
        joint = st["epoch"] >= lp.joint_epoch
        phase = "joint" if joint else "diffusion" if st["epoch"] >= lp.diff_epoch else "pre-diffusion"
        want = _stage2_launches(joint, joint or stage == "finetune", m and m.get("slm_sampled"),
                                cfg.remat_decoder, per_decode)
        expect = _moves(cfg, st["epoch"], st["iters"], stage == "finetune")
        print(f"[{tag}] step {i} (epoch {st['epoch']}, {phase}, batch {st['batch']}): {st['ms']:.1f} ms; "
              f"launches K1 {st['k1']} K2 {st['k2']}; moved {sorted(k for k, v in st['moved'].items() if v)}; "
              + " ".join(f"{k}={v:.4f}" for k, v in (m or {}).items()) + f" [{smi}]", flush=True)
        if m is None or not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{tag} step {i}: metrics {m}")
        if (st["k1"], st["k2"]) != want or st["dtypes"] != {step_dtype}:
            raise RuntimeError(f"{tag} step {i}: K1 {st['k1']} K2 {st['k2']} with x in "
                               f"{st['dtypes']}, not {want} in {step_dtype}")
        if joint and not m["slm_valid_frac"] > 0:
            raise RuntimeError(f"{tag} step {i}: slm_valid_frac {m['slm_valid_frac']}")
        if st["moved"] != expect:
            raise RuntimeError(f"{tag} step {i}: moved {st['moved']}, expected {expect}")
    arts.check(cfg.log_dir, tag, sorted({st["epoch"] for st in steps}), cfg.loss_params.joint_epoch,
               per_decode)
    val_f32 = tally.n["K1", "float32"] - sum(st["k1"] for st in steps if step_dtype == "float32")
    if tally.plain or k1 != sum(st["k1"] for st in steps) + per_decode * n_val[0] + arts.k1 \
            or k2 != sum(st["k2"] for st in steps) or \
            val_f32 != per_decode * n_val[0] + arts.k1:
        raise RuntimeError(f"{tag}: {k1} K1 / {k2} K2 launches for {len(steps)} steps, "
                           f"{n_val[0]} validation batches and {len(arts.calls)} eval artifacts, "
                           f"{tally.plain} plain calls")
    return steps, sigma, peak, k1, k2, log


def stage2_phase(op, build_dir, smi):
    """Phases 12 and 13: stage 2 at full width through `run_stage` from the
    port's own first stage, a resumed call, then finetuning from its
    weights. Returns the K1 and K2 launches of all their calls and phase
    12's first call's {"ms": {phase: step ms}, "peak": bytes}."""
    from styletts2_tpu_torch.config import Config, config_from_path
    from styletts2_tpu_torch.train import run as train_run

    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        data = training_fixture(Path(tdir) / "data")
        for batch in STAGE2_BATCHES:  # the largest batch the card holds
            cfg = Config()
            cfg.data_params, cfg.batch_size, cfg.log_interval = data, batch, 1
            cfg.log_dir = str(Path(tdir) / f"logs_{batch}")
            cfg.epochs_1st, cfg.epochs_2nd, cfg.slmadv_params.iter = 1, 3, 2
            cfg.loss_params.diff_epoch, cfg.loss_params.joint_epoch = 1, 2
            try:
                train_run.run_stage("first", cfg, max_steps=1, device="cuda")  # the handoff
                t0 = time.perf_counter()
                steps, sigma, peak, k1, k2, log = _stage2_run(op, "second", cfg, smi, "12 stage 2")
                break
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e).splitlines()[0]
            torch.cuda.empty_cache()  # after the failed attempt's frames are gone
            print(f"[12 stage 2] batch {batch}: {oom}; trying a smaller batch [{smi}]", flush=True)
        else:
            raise RuntimeError("stage 2: no batch fits the card")
        wall = time.perf_counter() - t0
        launches = [k1, k2]
        summary = {"ms": _phase_ms(cfg, steps), "peak": peak}
        phases = [st["epoch"] for st in steps]
        if phases != [0, 0, 1, 1, 2, 2] or not steps[-1]["moved"]["wd"]:
            raise RuntimeError(f"stage 2: epochs {phases}, wd moved {[st['moved']['wd'] for st in steps]}")
        written = [x for x in log.splitlines() if "sigma_data" in x and "written into" in x]
        if "loaded first stage" not in log or not written or \
                not (0 < sigma != cfg.model_params.diffusion.dist.sigma_data):
            raise RuntimeError(f"stage 2: handoff or sigma_data write-back missing ({sigma}, {written})")
        print(f"[12 stage 2] run_stage('second', Config()) from the port's first stage: batch "
              f"{cfg.batch_size}, max_len {cfg.max_len}, {len(steps)} steps in {wall:.1f} s wall; "
              f"peak memory {peak / 2 ** 30:.2f} GiB; sigma_data {cfg.model_params.diffusion.dist.sigma_data}"
              f" -> {sigma!r}; config copy: {written[-1].split(': ', 2)[-1]}; launches K1 {k1} "
              f"K2 {k2}, 0 plain-version calls [{smi}]", flush=True)

        # the resumed call: epoch 2 again, one step
        steps, _, _, k1, k2, log = _stage2_run(op, "second", cfg, smi, "12 stage 2 resumed",
                                               max_steps=1)
        launches = [launches[0] + k1, launches[1] + k2]
        resume = [x for x in log.splitlines() if "auto-resuming from" in x]
        if not resume or "epoch_2nd_00002.pth (epoch 2)" not in resume[-1] or len(steps) != 1:
            raise RuntimeError(f"stage 2 resume: {resume}, {len(steps)} steps")
        print(f"[12 stage 2] {resume[-1].split(': ', 1)[-1]}; then 1 joint step", flush=True)

        # 13. finetune from stage 2's weights
        ft = config_from_path(str(REPO / "configs" / "config_ft.yml"))
        ft.data_params, ft.log_interval, ft.log_dir = data, 1, str(Path(tdir) / "ft")
        ft.pretrained_model = str(Path(cfg.log_dir) / "second_final.pth")
        ft.load_only_params, ft.loss_params.joint_epoch = True, 0
        t0 = time.perf_counter()
        steps, sigma, peak, k1, k2, log = _stage2_run(op, "finetune", ft, smi, "13 finetune",
                                                      max_steps=2)
        launches = [launches[0] + k1, launches[1] + k2]
        if len(steps) != 2 or f"loaded {ft.pretrained_model} (weights only)" not in log:
            raise RuntimeError(f"finetune: {len(steps)} steps; log {log[-500:]}")
        print(f"[13 finetune] run_stage('finetune', configs/config_ft.yml) from second_final.pth "
              f"(weights only): batch {ft.batch_size}, 2 steps in {time.perf_counter() - t0:.1f} s "
              f"wall; peak memory {peak / 2 ** 30:.2f} GiB; sigma_data -> {sigma!r}; launches K1 {k1} "
              f"K2 {k2}, 0 plain-version calls [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return launches, summary


def _phase_ms(cfg, steps):
    """{stage-2 phase: its steps' ms}."""
    lp, out = cfg.loss_params, {}
    for st in steps:
        phase = ("joint" if st["epoch"] >= lp.joint_epoch else
                 "diffusion" if st["epoch"] >= lp.diff_epoch else "pre-diffusion")
        out.setdefault(phase, []).append(st["ms"])
    return out


def _stage2_losses_and_grads(models, cfg, device, batch, starts):
    """A joint stage-2 step's generator loss (no adversarial term) and SLM
    generator loss with their backward, eval mode: (losses, {module:
    flattened gradient on the host}). The LSTMs alone run in train mode
    (cuDNN's LSTM backward needs it; one layer, no dropout)."""
    from styletts2_tpu_torch.train.stage2 import SLM_KEYS, Stage2Trainer
    from styletts2_tpu_torch.train.state import TrainState

    trainer = Stage2Trainer(cfg, TrainState(models, {}, sigma_data=0.2), device)
    keys = trainer.gen_keys(True, True)

    def modes(trainable):
        trainer._modes(False, trainable)
        for m in models.values():
            m.zero_grad(set_to_none=True)
            for lstm in m.modules():
                if isinstance(lstm, torch.nn.LSTM):
                    lstm.train()

    def grads(ks):
        return {k: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().flatten()
                              for n, p in models[k].named_parameters() if "bias_hh" not in n]).cpu()
                for k in ks}

    modes(keys)
    t = trainer._tensors(batch)
    g_loss, _, metrics, aux = trainer.generator_forward(t, starts, starts, 40, True, True, 3, 0.2,
                                                        train=False)
    g_loss.backward()
    losses = {k: float(v.detach()) for k, v in metrics.items()}
    out = {f"gen {k}": g for k, g in grads(keys).items()}
    modes(SLM_KEYS)
    slm, _, valid = trainer.slm_generator_loss(t, aux, 3, False, 0.2)
    slm.backward()
    losses["slm_gen"] = float(slm.detach())
    out.update({f"slm {k}": g for k, g in grads(SLM_KEYS).items()})
    if not bool(valid.all()):
        raise RuntimeError(f"stage-2 reference: SLM validity {valid.tolist()}")
    return losses, out


def stage2_reference_case(libritts=False):
    """Phase 14's reduced-width joint stage-2 step (19's with `libritts`:
    multispeaker, HiFi-GAN): (config, seed-0 models on the CPU, batch, clip
    starts)."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.models.build import build_training_models

    small = dict(SMALL, slmadv_params={"min_len": 80, "max_len": 120})
    if libritts:
        small["model_params"] = dict(SMALL["model_params"], multispeaker=True, decoder=dict(
            SMALL["model_params"]["decoder"], type="hifigan", upsample_rates=[10, 5, 3, 2],
            upsample_kernel_sizes=[20, 10, 6, 4]))
    small = Config.from_dict(small)
    models = build_training_models(small, torch.Generator().manual_seed(0), stage="second")
    rng = np.random.default_rng(3)
    waves = (0.2 * rng.standard_normal((2, 48000))).astype(np.float32)
    batch = types.SimpleNamespace(
        waves=waves, tokens=rng.integers(1, 178, (2, 12)).astype(np.int32),
        input_lengths=np.asarray([12, 9]), mel_lengths=np.asarray([160, 140]),
        ref_tokens=rng.integers(1, 178, (2, 10)).astype(np.int32), ref_lengths=np.asarray([10, 7]),
        ref_waves=waves, ref_wave_lengths=np.asarray([48000, 48000]))
    return small, models, batch, np.asarray([3, 5])


def stage2_reference_phase(dev, tag="14 stage-2 reference", libritts=False):
    """Phase 14 (19 with `libritts`, the HiFi-GAN source's harmonic sines
    zeroed and its noise kept, `_noise_source`): `stage2_reference_case`'s
    step, the same weights on the card and on the CPU, losses within 1e-4
    and each module's gradient within GRAD_TOL (L2). The CPU step's own
    conditioning: tools/conditioning_torch.py."""
    small, cpu_models, batch, starts = stage2_reference_case(libritts)
    gpu_models = copy.deepcopy(cpu_models).to(dev)
    got_l, got_g = _host_draws(_stage2_losses_and_grads, gpu_models, small, dev, batch, starts,
                               noise_source=libritts)
    want_l, want_g = _host_draws(_stage2_losses_and_grads, cpu_models, small, "cpu", batch, starts,
                                 noise_source=libritts)
    l_err = max(abs(got_l[k] - v) / abs(v) for k, v in want_l.items())
    g_err = {k: float((got_g[k] - v).norm() / v.norm()) for k, v in want_g.items()}
    print(f"[{tag}] joint step: losses " + " ".join(f"{k}={v:.5f}" for k, v in got_l.items())
          + f"; rel err {l_err:.2e} (tol 1e-4); gradient L2 rel err "
          + ", ".join(f"{k} {e:.2e}" for k, e in g_err.items()) + f" (tol {GRAD_TOL:g})", flush=True)
    if not (l_err < 1e-4 and max(g_err.values()) < GRAD_TOL):
        raise RuntimeError("stage-2 step: GPU and CPU disagree")
    del cpu_models, gpu_models


def serve_burst(op, serve, build_dir, smi, tag, speed, extra=(), dtype="float32"):
    """The CLI's server (`python -m styletts2_tpu_torch.serve --config
    configs/config_libritts.yml --voices DIR` and `extra`, its defaults
    otherwise: no PyYAML, seed-0 weights, window 15 ms, max batch 8) with
    the seeded voice as a 22.05 kHz WAV, served on a thread instead of the
    main one: warm-up bursts until one captures no CUDA graph (at most 4),
    then SERVE_TEXTS as
    concurrent /tts requests, each a 24 kHz WAV, in at least one fused
    batch, 96 launches per decode call, all with an x of `dtype`. Returns
    (the burst's _Counts, its wall s)."""
    with tempfile.TemporaryDirectory(dir=build_dir) as vdir:
        _write_voice(Path(vdir) / "seeded.wav", 22050)
        args = serve.parse_args(["--config", str(REPO / "configs" / "config_libritts.yml"),
                                 "--voices", vdir, "--port", "0", *extra])
        t0 = time.perf_counter()
        server = serve.make_server(args)
    print(f"[{tag}] make_server: {args.device}, decoder {args.decoder_dtype or 'float32'}, voices "
          f"{sorted(server.voices)}, max batch {args.max_batch}, window {args.window_ms} ms; built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    port = server.start_background(args.host, args.port)
    try:
        body = {"voice": "seeded", "speed": speed, "seed": 0}

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

        graphs = server.syn.graphs
        for warmups in range(1, 5):  # warm-up bursts until one captures no graph
            n = len(graphs)
            burst()
            if len(graphs) == n:
                break
        captured = len(graphs)
        stats0 = dict(server.batcher.stats)
        with _Counts(op, server.syn.models["decoder"]) as sv:
            results, wall = burst()
        sv.check(CALLS_PER_HIFIGAN_DECODE, tag, dtype)
        audio = 0.0
        for i, res in enumerate(results):
            if res is None or res[0] != 200 or res[1] != "audio/wav":
                raise RuntimeError(f"[{tag}] request {i}: {res and res[:2]}")
            with wave.open(io.BytesIO(res[2])) as f:
                frames = f.getnframes()
                if f.getframerate() != 24000 or frames <= 0 or (frames + 50) % SAMPLES_PER_FRAME:
                    raise RuntimeError(f"[{tag}] request {i}: {frames} frames at {f.getframerate()} Hz")
            audio += frames / 24000.0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
            stats = json.loads(resp.read())["stats"]
        batches = stats["batches"] - stats0["batches"]
        fused = stats["batched_requests"] - stats0["batched_requests"]
        if fused < 2:
            raise RuntimeError(f"[{tag}] no fused batch ({stats})")
        print(f"[{tag}] {len(results)} concurrent requests, {audio:.3f} s audio in {wall * 1e3:.1f} "
              f"ms wall (window {args.window_ms} ms): aggregate RTF {audio / wall:.2f}x; {batches} "
              f"batches ({fused} requests fused), {sv.decodes} decode calls, {sv.launches} kernel "
              f"launches ({CALLS_PER_HIFIGAN_DECODE} per decode, x {dtype}), 0 plain-version "
              f"calls; "
              f"{warmups} warm-up bursts; CUDA graphs {captured} before it, {len(graphs)} after "
              f"{sorted(collections.Counter(k[:2] for k in graphs).items())} [{smi}]", flush=True)
    finally:
        server.close()
        del server
    return sv, wall


JAX_CASE = dict(text="ðɪs ɪz ɐ tˈɛst.", diffusion_steps=3, seed=4)  # tests/test_bf16.py's


def _bf16_pair(cfg, seed=0):
    """(bf16 Synthesizer, f32 Synthesizer) of `cfg` whose decoders hold the
    same bf16-rounded weights (the JAX package's tests/test_bf16.py method:
    what differs is the decoder's compute)."""
    from styletts2_tpu_torch.inference import Synthesizer

    syn16 = Synthesizer(cfg, seed=seed, device="cuda", decoder_dtype="bfloat16")
    syn32 = Synthesizer(cfg, seed=seed, device="cuda")
    with torch.no_grad():
        for p32, p16 in zip(syn32.models["decoder"].parameters(),
                            syn16.models["decoder"].parameters()):
            p32.copy_(p16.float())
    return syn16, syn32


def bf16_serving_phase(op, serve, build_dir, smi):
    """Phase 15: the bf16 decoder. For Config() and libritts_config() at full
    width (seed-0 weights, the LibriTTS requests with the seeded voice's
    style): `Synthesizer(cfg, decoder_dtype="bfloat16")` answers REQUESTS
    with 48 / 96 K1 launches per decode, every one with a bf16 x, and 0
    plain-version calls; then each request again on it and on an f32
    Synthesizer whose decoder holds the same bf16-rounded weights, warm, in
    turns: equal durations, finite waveforms of the expected length, both
    latencies and the bf16-vs-f32 compute MCD (printed). Then the JAX
    package's own bound (tests/test_bf16.py: full width with one PL-BERT
    and one denoiser layer, its text, noise, steps and seed): the served
    decoder's bf16-vs-f32 compute MCD, held to MCD_BOUND dB for iSTFTNet, the
    model that test bounds, and printed for HiFi-GAN, whose bf16 decoder
    reads ~5 dB at full width in the JAX package too when every bf16 op is
    rounded (tests/test_torch_bf16.py). Then a burst through `serve
    --decoder-dtype bfloat16`. Returns the K1 launches of its counted runs."""
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.eval import mcd

    launches, speed = 0, 1.0
    for name, make, per_decode, trim in (("LJSpeech", Config, CALLS_PER_DECODE, 0),
                                         ("LibriTTS", libritts_config, CALLS_PER_HIFIGAN_DECODE, 50)):
        tag = f"15 bf16 {name}"
        syn16, syn32 = _bf16_pair(make())
        kw = {"ref_s": syn16.compute_style(_voice())} if syn16.multispeaker else {}
        natural = syn16.synthesize(BENCH_TEXT, seed=0, **kw)  # calibration; also the warm-up
        speed = max(len(natural.wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
        for syn in (syn16, syn32):  # warm-up at every request's shapes
            for text, seed in REQUESTS:
                syn.synthesize(text, seed=seed, speed=speed, **kw)
        with _Counts(op, syn16.models["decoder"]) as c:
            _requests(op, syn16, tag, smi, per_decode, trim, speed=speed, **kw)
        c.check(per_decode, tag, "bfloat16")
        launches += c.launches
        for i, (text, seed) in enumerate(REQUESTS):
            out, lat = {}, {"bf16": [], "f32": []}
            for key, syn in (("bf16", syn16), ("f32", syn32), ("f32", syn32), ("bf16", syn16)):
                t0 = time.perf_counter()
                out.setdefault(key, syn.synthesize(text, seed=seed, speed=speed, **kw))
                lat[key].append((time.perf_counter() - t0) * 1e3)
            r16, r32 = out["bf16"], out["f32"]
            if not np.array_equal(r16.pred_dur, r32.pred_dur):
                raise RuntimeError(f"[{tag}] request {i}: durations {r16.pred_dur} vs {r32.pred_dur}")
            n = int(r16.pred_dur.sum()) * SAMPLES_PER_FRAME - trim
            if not (len(r16.wav) == len(r32.wav) == n and np.isfinite(r16.wav).all()):
                raise RuntimeError(f"[{tag}] request {i}: {len(r16.wav)} / {len(r32.wav)} samples, "
                                   f"not {n}, or non-finite")
            audio = n / 24000.0
            print(f"[{tag}] request {i}: {audio:.3f} s audio, durations equal to the f32 "
                  f"synthesizer's; bf16-vs-f32 compute MCD {mcd(r16.wav, r32.wav, use_dtw=False):.4f}"
                  f" dB; warm latency bf16 {', '.join(f'{t:.1f}' for t in lat['bf16'])} ms (RTF "
                  f"{audio / np.mean(lat['bf16']) * 1e3:.2f}x), f32 "
                  f"{', '.join(f'{t:.1f}' for t in lat['f32'])} ms (RTF "
                  f"{audio / np.mean(lat['f32']) * 1e3:.2f}x) [{smi}]", flush=True)
        del syn16, syn32
        cfg = make()
        cfg.plbert_params.num_hidden_layers = 1
        cfg.model_params.diffusion.transformer.num_layers = 1
        syn16, syn32 = _bf16_pair(cfg)
        noise = np.random.default_rng(1).standard_normal(
            (1, 1, 2 * cfg.model_params.style_dim)).astype(np.float32)
        r32, r16 = (syn.synthesize(noise=noise, **JAX_CASE, **kw) for syn in (syn32, syn16))
        if not (np.array_equal(r16.pred_dur, r32.pred_dur) and np.isfinite(r16.wav).all()):
            raise RuntimeError(f"[{tag}] JAX's test case: durations differ or non-finite")
        score = mcd(r16.wav, r32.wav, use_dtw=False)
        held = "held" if not syn16.hifigan else "not held"
        print(f"[{tag}] JAX's bf16 test case (tests/test_bf16.py) on the served decoder: "
              f"{len(r16.wav) / 24000.0:.3f} s audio, bf16-vs-f32 compute MCD {score:.4f} dB "
              f"(bound {MCD_BOUND}, {held}) [{smi}]", flush=True)
        if not syn16.hifigan and score > MCD_BOUND:
            raise RuntimeError(f"[{tag}] JAX's test case: bf16-vs-f32 compute MCD {score:.4f} dB")
        del syn16, syn32
        torch.cuda.empty_cache()
    sv, _ = serve_burst(op, serve, build_dir, smi, "15 bf16 serving", speed,  # LibriTTS's
                        ("--decoder-dtype", "bfloat16"), "bfloat16")
    return launches + sv.launches


def _stage1_run(op, cfg, smi, tag, **kwargs):
    """`run_stage("first", cfg, device="cuda", **kwargs)` with every step
    timed and checked: finite metrics, 48 K1 and 48 K2 launches, each with
    an x of the config's precision; 0 plain-version calls; f32 masters and
    Adam moments. Returns (the steps, the peak memory, K1 and K2
    launches)."""
    from styletts2_tpu_torch.train import run as train_run
    from styletts2_tpu_torch.train.stage1 import Stage1Trainer

    step_dtype = "bfloat16" if cfg.mixed_precision == "bf16" else "float32"
    steps, train_step, tally = [], Stage1Trainer.train_step, _Tally(op)

    def timed_step(self, batch, epoch, iters, rng):
        k1, k2, by = op.adain_snake.launches, op.adain_snake.bwd_launches, dict(tally.n)
        t0 = time.perf_counter()
        m = train_step(self, batch, epoch, iters, rng)  # ends in a host sync (the metrics)
        steps.append({"epoch": epoch, "ms": (time.perf_counter() - t0) * 1e3, "metrics": m,
                      "k1": op.adain_snake.launches - k1, "k2": op.adain_snake.bwd_launches - k2,
                      "dtypes": {dt for _, dt in tally.since(by)}})
        return m

    Stage1Trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    op.adain_snake.launches = op.adain_snake.bwd_launches = 0
    try:
        with tally:
            state = train_run.run_stage("first", cfg, device="cuda", **kwargs)
        _f32_masters(state, tag)
        del state
    finally:
        Stage1Trainer.train_step = train_step
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    for i, st in enumerate(steps):
        m = st["metrics"]
        print(f"[{tag}] step {i} (epoch {st['epoch']}): {st['ms']:.1f} ms; launches K1 {st['k1']} "
              f"K2 {st['k2']} with x in {sorted(st['dtypes'])}; "
              + " ".join(f"{k}={v:.4f}" for k, v in (m or {}).items()) + f" [{smi}]", flush=True)
        if m is None or not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{tag} step {i}: metrics {m}")
        k1_step = CALLS_PER_STEP * (2 if cfg.remat_decoder else 1)  # the recompute under remat
        if (st["k1"], st["k2"]) != (k1_step, CALLS_PER_STEP) or st["dtypes"] != {step_dtype}:
            raise RuntimeError(f"{tag} step {i}: K1 {st['k1']} K2 {st['k2']} in {st['dtypes']}")
    if tally.plain or not steps:
        raise RuntimeError(f"{tag}: {len(steps)} steps, {tally.plain} plain-version calls")
    return steps, peak, op.adain_snake.launches, op.adain_snake.bwd_launches


def _tracks(want, got, tag):
    """Raise unless every loss of the bf16 step `got` is within STEP_TOL of
    the f32 step's `want` (relative, floored at 1e-3); print them."""
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-3) for k, v in want.items()
           if not k.startswith("step_sec")}  # the step meters: times, not losses
    print(f"[{tag}] first step, bf16 vs f32 from the same weights and draws: rel err "
          + ", ".join(f"{k} {e:.2e}" for k, e in rel.items()) + f" (tol {STEP_TOL})", flush=True)
    if max(rel.values()) > STEP_TOL:
        raise RuntimeError(f"{tag}: the bf16 step's losses stray from f32's: {rel}")


def bf16_training_phase(op, build_dir, smi, f32_stage1, f32_stage2):
    """Phase 16: `mixed_precision: "bf16"` training of Config() at full
    width, batch 16, max_len 400, on phase 10's fixture, through
    `run_stage`. Stage 1 from TMA on: one f32 step, then two bf16 steps
    from the same weights, batches and draws; stage 2 from the bf16 first
    stage: one f32 step, then two bf16 steps of each phase (before
    diffusion, with it, joint; `wd` every 2 steps). Every step as phases
    10 and 12 check it, its launches all with a bf16 x; each stage's first
    bf16 step within STEP_TOL of the f32 one; f32 masters and moments; step
    times and peak memory beside phases 10 and 12's f32 ones. Returns the K1
    and K2 launches."""
    from styletts2_tpu_torch.config import Config

    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        data = training_fixture(Path(tdir) / "data")

        def config(name, mixed):
            cfg = Config()
            cfg.data_params, cfg.log_dir, cfg.log_interval = data, str(Path(tdir) / name), 1
            cfg.mixed_precision, cfg.epochs_1st, cfg.loss_params.TMA_epoch = mixed, 1, 0
            cfg.epochs_2nd, cfg.slmadv_params.iter = 3, 2
            cfg.loss_params.diff_epoch, cfg.loss_params.joint_epoch = 1, 2
            return cfg

        def config2(name, mixed):  # stage 2 from the bf16 first stage
            cfg = config(name, mixed)
            cfg.first_stage_path = str(Path(tdir) / "first_bf16" / "first_stage.pth")
            return cfg

        ref, _, k1, k2 = _stage1_run(op, config("first_f32", ""), smi, "16 stage 1 f32",
                                     max_steps=1)
        steps, peak, a1, a2 = _stage1_run(op, config("first_bf16", "bf16"), smi, "16 stage 1 bf16",
                                          max_steps=2)
        launches = [k1 + a1, k2 + a2]
        _tracks(ref[0]["metrics"], steps[0]["metrics"], "16 stage 1")
        bf16_ms = ", ".join(f"{st['ms']:.1f}" for st in steps)
        print(f"[16 stage 1] bf16 TMA steps {bf16_ms} ms, peak "
              f"{peak / 2 ** 30:.2f} GiB; f32 (phase 10) "
              f"{', '.join(f'{t:.1f}' for t in f32_stage1['tma'])} ms, {f32_stage1['peak'] / 2 ** 30:.2f}"
              f" GiB [{smi}]", flush=True)

        ref, *_, k1, k2, _ = _stage2_run(op, "second", config2("second_f32", ""), smi,
                                         "16 stage 2 f32", max_steps=1)
        cfg = config2("second_bf16", "bf16")
        steps, _, peak, a1, a2, log = _stage2_run(op, "second", cfg, smi, "16 stage 2 bf16")
        launches = [launches[0] + k1 + a1, launches[1] + k2 + a2]
        if [st["epoch"] for st in steps] != [0, 0, 1, 1, 2, 2] or "loaded first stage" not in log:
            raise RuntimeError(f"16 stage 2: epochs {[st['epoch'] for st in steps]}")
        _tracks(ref[0]["metrics"], steps[0]["metrics"], "16 stage 2")
        ms16 = _phase_ms(cfg, steps)
        print("[16 stage 2] bf16 steps " + "; ".join(
            f"{ph} {', '.join(f'{t:.1f}' for t in ms)} ms (f32, phase 12: "
            f"{', '.join(f'{t:.1f}' for t in f32_stage2['ms'][ph])})" for ph, ms in ms16.items())
              + f"; peak {peak / 2 ** 30:.2f} GiB (f32: {f32_stage2['peak'] / 2 ** 30:.2f}) [{smi}]",
              flush=True)
    torch.cuda.empty_cache()
    return launches


DEMO_TEXT = REQUESTS[1][0]
LONG_TEXT = "hˈɛloʊ ðɛɹ. " + REQUESTS[1][0]
REF_TOL = 1e-4  # the bias split changes only an LSTM bias's rounding: far below phase 5's 1e-3


def _demo(args):
    """`python -m styletts2_tpu_torch.demo *args` started from the checkout."""
    return subprocess.Popen([sys.executable, "-m", "styletts2_tpu_torch.demo", *map(str, args)],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _sampler_checks(sd, cfg, dev, smi):
    """The diffusion sampler family at full width (Config()'s denoiser with
    the file's weights, a 40-token PL-BERT context): each sampler and the
    v-diffusion loss on the card against the CPU, the same numpy draws
    handed to both; within REF_TOL of the peak."""
    from styletts2_tpu_torch.models.build import _diffusion
    from styletts2_tpu_torch.models.diffusion import sampler as S

    cpu = _diffusion(cfg)
    cpu.load_state_dict({k[len("diffusion."):]: v for k, v in sd.items() if k.startswith("diffusion.")})
    cpu.eval().requires_grad_(False)
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(17)
    emb = rng.standard_normal((1, 40, cfg.plbert_params.hidden_size)).astype(np.float32)
    shape = (1, 1, 2 * cfg.model_params.style_dim)
    steps = 5

    def normals(n):
        return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]

    noise, x0 = normals(2)
    churn = normals(steps - 1)
    inpaint = [normals(S.inpaint_draws(steps)) for _ in range(2)]
    sigmas = rng.uniform(size=(1,)).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[..., : shape[-1] // 2] = 1.0

    def run(mod, dev):
        def t(x):
            return torch.from_numpy(np.asarray(x)).to(dev)

        e, lengths = t(emb), torch.tensor([40])

        def net(x, c_noise):
            return mod(x, c_noise, e, embedding_lengths=lengths)

        denoise = S.make_denoise_fn(net, 0.2)
        out = {name: S.SAMPLERS[name](denoise, t(noise), steps, churn=[t(c) for c in churn], **kw)
               for name, kw in (("aeuler", {}), ("karras", {"s_churn": 1.0}))}
        out["v"] = S.sample_v(net, t(noise), steps)
        out["inpaint"] = S.inpaint_adpm2(denoise, t(noise), t(mask), steps,
                                         draws=[t(d) for d in inpaint[0]])
        out["span"] = S.span_by_span_compose(denoise, t(noise), 2, steps,
                                             draws=[[t(d) for d in ds] for ds in inpaint])
        out["vloss"] = S.vdiffusion_loss(net, t(x0), sigmas=t(sigmas), noise=t(noise))[None]
        return {k: v.cpu().numpy() for k, v in out.items()}

    with torch.inference_mode():
        t0 = time.perf_counter()
        got = run(card, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = run(cpu, "cpu")
    errs = {k: _rel(got[k], want[k]) for k in want}
    print("[17 samplers] full-width denoiser, card vs CPU with handed draws: rel err "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (tol {REF_TOL:g}); all six on the card {ms:.1f} ms (first call) [{smi}]", flush=True)
    if not all(np.isfinite(v).all() for v in got.values()) or max(errs.values()) >= REF_TOL:
        raise RuntimeError(f"samplers: card and CPU disagree: {errs}")


def reference_phase(op, serve, dev, build_dir, smi):
    """Phase 17: the reference's own checkpoint layout. For Config() and
    libritts_config() at full width, seeded port weights written as a
    reference `.pth` (`reference_net`); the demo CLI in 3 subprocesses at
    once (LJSpeech, LJSpeech --longform, LibriTTS with a 22.05 kHz
    --ref_wav), each exiting 0 with a finite 24 kHz WAV as long as the same
    request in this process; `serve --ckpt` answering 3 requests with
    48 / 96 K1 launches per decode and 0 plain-version calls, its weights
    those of the port's layout (the LSTM bias halves summing to the bias)
    and its request agreeing with the port-layout Synthesizer's; the
    sampler family on the card. Returns the counted K1 launches."""
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.inference import Synthesizer
    from styletts2_tpu_torch.models.build import build_models
    from styletts2_tpu_torch.utils import read_wav, resample_linear

    cases = {"LJSpeech": ("config.yml", Config, CALLS_PER_DECODE, 0),
             "LibriTTS": ("config_libritts.yml", libritts_config, CALLS_PER_HIFIGAN_DECODE, 50)}
    launches, start = 0, time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        tdir = Path(tdir)
        voice = tdir / "voice_22k.wav"
        _write_voice(voice, 22050)
        files, sds = {}, {}
        for name, (_, make, _, _) in cases.items():
            t0 = time.perf_counter()
            sds[name] = build_models(make(), torch.Generator().manual_seed(7)).state_dict()
            net = reference_net(sds[name], seed=8)
            files[name] = tdir / f"{name}_epochs_2nd_00020.pth"
            torch.save({"net": net, "epoch": 20, "iters": 0}, files[name])
            print(f"[17 reference ckpt] {name}: {files[name].name}, {sum(len(v) for v in net.values())} "
                  f"tensors in {len(net)} modules, {files[name].stat().st_size / 2 ** 20:.0f} MiB, "
                  f"written in {time.perf_counter() - t0:.1f} s", flush=True)
            del net
        cfg_path = {name: REPO / "configs" / yml for name, (yml, *_) in cases.items()}
        demos = {"LJSpeech": ["--config", cfg_path["LJSpeech"], "--ckpt", files["LJSpeech"],
                              "--text", DEMO_TEXT],
                 "LJSpeech --longform": ["--config", cfg_path["LJSpeech"], "--ckpt",
                                         files["LJSpeech"], "--text", LONG_TEXT, "--longform"],
                 "LibriTTS --ref_wav": ["--config", cfg_path["LibriTTS"], "--ckpt",
                                        files["LibriTTS"], "--text", DEMO_TEXT, "--ref_wav", voice]}
        t0 = time.perf_counter()
        procs = {k: _demo([*a, "--out", tdir / f"demo{i}.wav", "--seed", 3])
                 for i, (k, a) in enumerate(demos.items())}
        outs = {k: p.communicate(timeout=600) + (p.returncode, time.perf_counter() - t0)
                for k, p in procs.items()}
        for k, (out, err, rc, wall) in outs.items():
            if rc != 0:
                raise RuntimeError(f"demo {k}: exit {rc}\n{err[-3000:]}")

        for name, (_, make, per_decode, trim) in cases.items():
            tag = f"17 serve --ckpt {name}"
            args = serve.parse_args(["--config", str(cfg_path[name]), "--ckpt", str(files[name]),
                                     "--port", "0"])
            t0 = time.perf_counter()
            server = serve.make_server(args)
            built = time.perf_counter() - t0
            port = server.start_background(args.host, args.port)
            syn = server.syn
            try:
                natural = syn.synthesize(BENCH_TEXT, seed=0)  # calibration; also the warm-up
                speed = max(len(natural.wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
                for text, seed in REQUESTS:  # warm-up at the requests' shapes
                    _post(port, {"text": text, "seed": seed, "speed": speed})
                lat = []
                with _Counts(op, syn.models["decoder"]) as c:
                    for text, seed in REQUESTS:
                        t1 = time.perf_counter()
                        code, ctype, body = _post(port, {"text": text, "seed": seed, "speed": speed})
                        lat.append((time.perf_counter() - t1) * 1e3)
                        with wave.open(io.BytesIO(body)) as f:
                            frames = f.getnframes()
                        if code != 200 or ctype != "audio/wav" or frames <= 0 or \
                                (frames + trim) % SAMPLES_PER_FRAME:
                            raise RuntimeError(f"[{tag}] {code} {ctype}, {frames} samples")
                c.check(per_decode, tag)
                launches += c.launches
            finally:
                server.close()
            print(f"[{tag}] make_server in {built:.1f} s; 3 requests, warm HTTP latency "
                  f"{', '.join(f'{t:.1f}' for t in lat)} ms (speed {speed:.3f}); {c.launches} K1 "
                  f"launches in {c.decodes} decodes ({per_decode} per decode), 0 plain-version "
                  f"calls [{smi}]", flush=True)

            # the weights: the port's layout, the LSTM bias halves summing to the bias
            got = syn.models.state_dict()
            sd = sds[name]
            bad = [k for k, v in sd.items() if "bias_ih" not in k and "bias_hh" not in k
                   and not torch.equal(got[k].cpu(), v)]
            sums = max(float((got[k].cpu() + got[k.replace("bias_ih", "bias_hh")].cpu()
                              - v - sd[k.replace("bias_ih", "bias_hh")]).abs().max())
                       for k, v in sd.items() if "bias_ih" in k)
            if got.keys() != sd.keys() or bad or sums > 1e-6:
                raise RuntimeError(f"[{tag}] weights: {bad[:5]}, LSTM bias sums off by {sums}")

            # the demo subprocesses: the same requests here, the same lengths
            for k, (out, err, rc, wall) in outs.items():
                if not k.startswith(name):
                    continue
                wav, sr = read_wav(str(tdir / f"demo{list(demos).index(k)}.wav"))
                if "--longform" in k:
                    want = syn.long_form(LONG_TEXT, diffusion_steps=5, embedding_scale=1.0)
                else:
                    ref_s = None
                    if "--ref_wav" in k:
                        w, vsr = read_wav(str(voice))
                        ref_s = syn.compute_style(resample_linear(w, vsr, 24000))
                    want, _ = syn.inference(DEMO_TEXT, ref_s=ref_s, seed=3)
                if sr != 24000 or len(wav) != len(want) or not np.isfinite(wav).all():
                    raise RuntimeError(f"demo {k}: {len(wav)} samples at {sr} Hz, not {len(want)}")
                print(f"[17 demo] {k}: exit 0 after {wall:.1f} s (3 demos at once); "
                      f"{out.strip().splitlines()[-1]}; {len(wav)} samples at 24 kHz, as this "
                      f"process's [{smi}]", flush=True)

            # agreement with the port's layout: the same seed, the chaotic source parts zeroed
            mine = Synthesizer(make(), state_dict=sd, device=dev)
            if syn.hifigan:  # phase 8's head gain: out of tanh's saturation
                for m in (syn, mine):
                    m.models["decoder"].generator.conv_post.weight_g.mul_(0.01)
            noise = np.random.default_rng(1).standard_normal(
                (1, 1, 2 * syn.style_dim)).astype(np.float32)
            syn.graphs.clear()  # both capture with the source's chaotic parts zeroed
            with _chaos_zeroed(syn.hifigan):
                a, b = (m.synthesize(REQUESTS[1][0], noise=noise, speed=speed) for m in (syn, mine))
            s_err, w_err = _rel(a.s_pred, b.s_pred), _rel(a.wav, b.wav)
            print(f"[{tag}] against the port-layout weights: durations "
                  f"{'equal' if np.array_equal(a.pred_dur, b.pred_dur) else 'DIFFER'}, style rel "
                  f"err {s_err:.2e}, waveform rel err {w_err:.2e} (tol {REF_TOL:g})", flush=True)
            if not (np.array_equal(a.pred_dur, b.pred_dur) and np.isfinite(a.wav).all()
                    and s_err < REF_TOL and w_err < REF_TOL):
                raise RuntimeError(f"[{tag}] the reference file and the port's layout disagree")
            del server, syn, mine
            torch.cuda.empty_cache()
        _sampler_checks(sds["LJSpeech"], Config(), dev, smi)
    print(f"[17 reference ckpt] phase 17 in {time.perf_counter() - start:.1f} s wall; {launches} "
          f"counted K1 launches [{smi}]", flush=True)
    return launches


REMAT_LADDER = (24, 32, 40, 48, 56, 64)  # phase 18 climbs these with remat until one does not fit
LOSS_TOL = 1e-5  # phases 18 and 20: losses against the reference run's, relative
WAVLM_TOL = 1e-5  # phase 21: the read WavLM's hidden states against the module's


def _full_gradient(module):
    """The module's gradient flattened in `parameters()` order, zeros where
    none arrived, every shard gathered to its full tensor (a collective of
    the model group where the module is sharded)."""
    from styletts2_tpu_torch.parallel import mesh

    sharded = mesh.sharded_parameters(module)
    parts = []
    for n, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        parts.append((sharded[n][0].gather(g, sharded[n][1]) if n in sharded else g).detach()
                     .flatten())
    return torch.cat(parts)


def _spied_step(op, trainer_cls, cfg, models, init, batch, epoch, remat, record=False,
                follow=None):
    """One `train_step` of `trainer_cls` at `epoch` from the weights `init`
    (a host state_dict) with the decoder's Generator checkpointed or not,
    fresh optimizers, the same seeds: {"metrics", "grads" (per optimizer
    step, {module: its flattened gradient on the host}), "k1", "k2",
    "runs" (decoder runs, differentiated decoder runs), "dtypes", "ms",
    "peak"}; with `record` also "after" (per optimizer step, {module: its
    parameters after it, on the host}). With `follow`, a recorded run's
    "after", each optimizer step's modules are set to that run's weights
    after it, so that every step's gradient is taken from the same weights
    as that run's. Modules sharded over a model axis (`parallel/mesh.py`,
    phase 23) take their slices of `init` and `follow`, and their gradients
    are gathered (a collective of the model group)."""
    from styletts2_tpu_torch.parallel import mesh
    from styletts2_tpu_torch.train import stage1, stage2
    from styletts2_tpu_torch.train.state import TrainState, build_optimizers

    for key, mod in models.items():
        mod.load_state_dict(mesh.local_state_dict(mod, {n[len(key) + 1:]: v for n, v in init.items()
                                                        if n.startswith(key + ".")}))
    models["decoder"].generator.remat = remat
    cfg = copy.deepcopy(cfg)
    cfg.remat_decoder = remat
    module = stage1 if trainer_cls is stage1.Stage1Trainer else stage2
    state = TrainState(models, build_optimizers(cfg, models, stage2=module is stage2), sigma_data=0.2)
    out = {"grads": [], "runs": [0, 0], "after": []}
    step_modules = module.step_modules

    def spy(ms, opts, keys):
        out["grads"].append({k: _full_gradient(ms[k]).cpu() for k in keys})
        step_modules(ms, opts, keys)
        if record:
            out["after"].append({k: [p.detach().to("cpu", copy=True) for p in ms[k].parameters()]
                                 for k in keys})
        if follow is not None:
            with torch.no_grad():
                for k in keys:
                    names = [n for n, _ in ms[k].named_parameters()]
                    full = dict(zip(names, follow[len(out["grads"]) - 1][k]))
                    local = mesh.local_state_dict(ms[k], full)
                    for n, p in ms[k].named_parameters():
                        p.copy_(local[n])

    def decoder_run(mod, args):
        out["runs"][0] += 1
        out["runs"][1] += torch.is_grad_enabled()

    hook = models["decoder"].register_forward_pre_hook(decoder_run)
    module.step_modules, tally = spy, _Tally(op)
    k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with tally:
            torch.manual_seed(0)
            t0 = time.perf_counter()
            out["metrics"] = trainer_cls(cfg, state, "cuda").train_step(
                batch, epoch, 0, np.random.default_rng(3))  # ends in a host sync (the metrics)
            out["ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        module.step_modules = step_modules
        hook.remove()
        for m in models.values():
            m.zero_grad(set_to_none=True)
        del state
    out["peak"] = torch.cuda.max_memory_allocated()
    out.update(k1=op.adain_snake.launches - k1, k2=op.adain_snake.bwd_launches - k2,
               dtypes={dt for (key, dt) in tally.n if key != "plain"}, plain=tally.plain)
    torch.cuda.empty_cache()
    return out


def _fixture_batch(data, size):
    """The first training batch of `size` from the fixture `data`."""
    from styletts2_tpu_torch.data.meldataset import build_dataloader

    loader = build_dataloader(data.train_data, data.root_path, ood_path=data.OOD_data,
                              min_length=data.min_length, batch_size=size)
    loader.prefetch = 0
    return next(iter(loader))


def remat_phase(op, build_dir, smi):
    """Phase 18: `remat_decoder` at full width. Config()'s stage-1 TMA step
    and stage-2 joint step (wd stepped) at batch 16, f32, each from the same
    weights, batch and draws with the Generator checkpointed and not: the
    logged losses within LOSS_TOL and every optimizer step's per-module
    gradient within GRAD_TOL (L2), each step of the remat run taken from
    the off-run's weights (a gradient within rounding of 0 moves a weight
    by Adam's +-lr either way, and the SLM pass amplifies such moves: 3.75e-2
    on the card when the runs diverge freely); K1 per differentiated
    decoder run twice the off-run's (the backward's recompute) and K2
    equal, 0 plain-version calls; both peaks and step times, from a pair
    of free runs after the first. Then the joint step with remat at
    the batches of REMAT_LADDER until one does not fit, and one bf16 joint
    step with remat. Returns (K1, K2) launches."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.models.build import build_training_models
    from styletts2_tpu_torch.train.stage1 import Stage1Trainer
    from styletts2_tpu_torch.train.stage2 import Stage2Trainer

    start = time.perf_counter()
    launches = [0, 0]
    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        data = training_fixture(Path(tdir) / "data", n=max(REMAT_LADDER))
        cfg = Config()
        cfg.data_params, cfg.slmadv_params.iter = data, 1
        models = build_training_models(cfg, torch.Generator().manual_seed(0), "second").cuda()
        init = {k: v.detach().cpu().clone() for k, v in models.state_dict().items()}
        batch = _fixture_batch(data, 16)
        cases = (("stage-1 TMA", Stage1Trainer, cfg.loss_params.TMA_epoch),
                 ("stage-2 joint", Stage2Trainer, cfg.loss_params.joint_epoch))
        for name, trainer_cls, epoch in cases:
            # the reference first (also this process's warm-up for the case), then off and on,
            # timed, then on again, each optimizer step from the reference's weights
            def step(remat, **kw):
                return _spied_step(op, trainer_cls, cfg, models, init, batch, epoch, remat, **kw)

            ref = step(False, record=True)
            off, on = step(False), step(True)
            same = step(True, follow=ref.pop("after"))
            for r in (off, on):
                launches[0] += r["k1"]
                launches[1] += r["k2"]
            rel = {k: abs(same["metrics"][k] - v) / max(abs(v), 1e-6)
                   for k, v in ref["metrics"].items()}

            def grad_err(x, y):
                return [max(float((a[k] - b[k]).norm() / max(float(b[k].norm()), 1e-30)) for k in b)
                        for a, b in zip(x["grads"], y["grads"])]

            g_err = grad_err(same, ref)
            runs, trained = off["runs"]
            print(f"[18 remat] {name}, batch 16, f32: losses rel err {max(rel.values()):.2e} (tol "
                  f"{LOSS_TOL:g}); gradient L2 rel err per optimizer step "
                  f"{', '.join(f'{e:.2e}' for e in g_err)} (tol {GRAD_TOL:g}; free runs "
                  f"{', '.join(f'{e:.2e}' for e in grad_err(on, off))}); K1 {off['k1']} -> "
                  f"{on['k1']} for {runs} decoder runs, {trained} differentiated; K2 {off['k2']} "
                  f"-> {on['k2']}; peak {off['peak'] / 2 ** 30:.2f} -> {on['peak'] / 2 ** 30:.2f} "
                  f"GiB; step {off['ms']:.1f} -> {on['ms']:.1f} ms [{smi}]", flush=True)
            if off["runs"] != on["runs"] or on["k1"] != off["k1"] + trained * CALLS_PER_DECODE \
                    or off["k1"] != runs * CALLS_PER_DECODE or on["k2"] != off["k2"] or not off["k2"]:
                raise RuntimeError(f"[18 remat] {name}: launches {off['k1']}/{off['k2']} -> "
                                   f"{on['k1']}/{on['k2']} for runs {off['runs']}, {on['runs']}")
            if off["plain"] or on["plain"] or same["plain"] or max(rel.values()) > LOSS_TOL or \
                    len(same["grads"]) != len(ref["grads"]) or max(g_err) > GRAD_TOL \
                    or not all(np.isfinite(v) for v in on["metrics"].values()):
                raise RuntimeError(f"[18 remat] {name}: {rel}, {g_err}")
            del ref, off, on, same

        largest = 16
        for size in REMAT_LADDER:  # the joint step with remat, up the ladder
            try:
                r = _spied_step(op, Stage2Trainer, cfg, models, init, _fixture_batch(data, size),
                                cfg.loss_params.joint_epoch, True)
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e).splitlines()[0]
                torch.cuda.empty_cache()
                print(f"[18 remat] stage-2 joint, batch {size}, remat: does not fit: {oom} [{smi}]",
                      flush=True)
                break
            launches[0] += r["k1"]
            launches[1] += r["k2"]
            largest = size
            print(f"[18 remat] stage-2 joint, batch {size}, remat: {r['ms']:.1f} ms, peak "
                  f"{r['peak'] / 2 ** 30:.2f} GiB, finite "
                  f"{all(np.isfinite(v) for v in r['metrics'].values())} [{smi}]", flush=True)
            if not all(np.isfinite(v) for v in r["metrics"].values()) or r["plain"]:
                raise RuntimeError(f"[18 remat] batch {size}: {r['metrics']}")
        else:
            oom = None
        print(f"[18 remat] the largest stage-2 joint batch that fits with remat, f32: {largest}"
              + ("" if oom else f" (the ladder's top; {REMAT_LADDER[-1]} fits)") + f" [{smi}]",
              flush=True)

        bf16 = copy.deepcopy(cfg)
        bf16.mixed_precision = "bf16"
        for _ in range(2):  # the second: the first bf16 step of the process warms up
            r = _spied_step(op, Stage2Trainer, bf16, models, init, batch, cfg.loss_params.joint_epoch,
                            True)
            launches[0] += r["k1"]
            launches[1] += r["k2"]
        runs, trained = r["runs"]
        print(f"[18 remat] stage-2 joint, batch 16, bf16, remat: {r['ms']:.1f} ms, peak "
              f"{r['peak'] / 2 ** 30:.2f} GiB; K1 {r['k1']} K2 {r['k2']} with x in {sorted(r['dtypes'])}"
              f" [{smi}]", flush=True)
        if not all(np.isfinite(v) for v in r["metrics"].values()) or r["plain"] or \
                r["dtypes"] != {"bfloat16"} or r["k1"] != (runs + trained) * CALLS_PER_DECODE:
            raise RuntimeError(f"[18 remat] bf16: {r['metrics']}, K1 {r['k1']} in {r['dtypes']}")
        del models, init, r
    torch.cuda.empty_cache()
    print(f"[18 remat] phase 18 in {time.perf_counter() - start:.1f} s wall [{smi}]", flush=True)
    return launches


def libritts_stage2_phase(op, build_dir, smi, dev):
    """Phase 19: `libritts_config()` stage 2 at full width through
    `run_stage("second")` from the port's own first stage, with
    `remat_decoder`: 2 steps each before diffusion, with it and joint at the
    first of STAGE2_BATCHES that fits, checked as phase 12 checks its steps
    (96 K1 per HiFi-GAN decoder run, 192 per differentiated one); then a
    reduced-width joint step card vs CPU as phase 14's. Returns (K1, K2)."""
    from styletts2_tpu_torch.config import libritts_config
    from styletts2_tpu_torch.train import run as train_run

    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        data = training_fixture(Path(tdir) / "data")
        for batch in STAGE2_BATCHES:
            cfg = libritts_config()
            cfg.data_params, cfg.batch_size, cfg.log_interval = data, batch, 1
            cfg.log_dir, cfg.remat_decoder = str(Path(tdir) / f"logs_{batch}"), True
            cfg.epochs_1st, cfg.epochs_2nd, cfg.slmadv_params.iter = 1, 3, 2
            cfg.loss_params.diff_epoch, cfg.loss_params.joint_epoch = 1, 2
            try:
                train_run.run_stage("first", cfg, max_steps=1, device="cuda")  # the handoff
                t0 = time.perf_counter()
                steps, sigma, peak, k1, k2, log = _stage2_run(op, "second", cfg, smi,
                                                              "19 libritts stage 2")
                break
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e).splitlines()[0]
            torch.cuda.empty_cache()
            print(f"[19 libritts stage 2] batch {batch}: {oom}; trying a smaller batch [{smi}]",
                  flush=True)
        else:
            raise RuntimeError("libritts stage 2: no batch fits the card")
        wall = time.perf_counter() - t0
        if [st["epoch"] for st in steps] != [0, 0, 1, 1, 2, 2] or "loaded first stage" not in log:
            raise RuntimeError(f"libritts stage 2: epochs {[st['epoch'] for st in steps]}")
        ms = _phase_ms(cfg, steps)
        print(f"[19 libritts stage 2] run_stage('second', libritts_config()), remat: batch "
              f"{cfg.batch_size}, max_len {cfg.max_len}, {len(steps)} steps in {wall:.1f} s wall; "
              + "; ".join(f"{ph} {', '.join(f'{t:.1f}' for t in v)} ms" for ph, v in ms.items())
              + f"; peak {peak / 2 ** 30:.2f} GiB; sigma_data -> {sigma!r}; launches K1 {k1} K2 {k2}, "
              f"0 plain-version calls [{smi}]", flush=True)
    torch.cuda.empty_cache()
    stage2_reference_phase(dev, "19 libritts reference", libritts=True)
    lstm_precision_check(dev, smi)
    return k1, k2


LSTM_TOL = 2e-6  # a BiLSTM's output and gradients against f64, relative L2 (f32 on the CPU: <6e-7)


def lstm_precision_check(dev, smi):
    """Phase 19's repaired module: the port's BiLSTM on the card, train
    mode, at the prosody predictor's full width (batch 16, 200 frames) and
    at phase 19's narrow width, its output, input gradient and weight
    gradients within LSTM_TOL of an f64 reference on the CPU
    (tests/test_torch_cuda.py::bilstm_errors). cuDNN's unpacked path reads
    5.8e-6 at the narrow width (tools/lstm_precision_torch.py), where
    tools/conditioning_torch.py --bisect found F0Ntrain's shared LSTM
    departing from the CPU beyond its conditioning."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import bilstm_errors

    for shape in ((16, 200, 640, 256), (2, 40, 96, 32)):
        errs = bilstm_errors(shape, dev)
        print(f"[19 lstm] BiLSTM (B, T, C, H) {shape} on the card against f64: output "
              f"{errs[0]:.2e}, input gradient {errs[1]:.2e}, weight gradients {errs[2]:.2e} "
              f"(tol {LSTM_TOL:g}) [{smi}]", flush=True)
        if max(errs) > LSTM_TOL:
            raise RuntimeError(f"[19 lstm] BiLSTM {shape}: {errs} against f64")


def train_child(argv):
    """`chip_smoke.py --train-child OUT ARGS...`: `train.run.main(ARGS)` with
    the kernels' launches and the plain versions' calls counted, written as
    JSON to OUT (phase 20 runs it under torch.distributed.run)."""
    sys.path.insert(0, str(REPO))
    from styletts2_tpu_torch.ops import adain_snake as op
    from styletts2_tpu_torch.train import run as train_run

    out, args = argv[0], argv[1:]
    op.adain_snake.launches = op.adain_snake.bwd_launches = 0
    with _Tally(op) as tally:
        train_run.main(args)
    Path(out).write_text(json.dumps({"k1": op.adain_snake.launches, "k2": op.adain_snake.bwd_launches,
                                     "plain": tally.plain}))


def write_hf_wavlm(path: Path, seed=0):
    """A full-width WavLM (base plus widths) from seeded weights in the
    Hugging Face layout: config.json, model.safetensors (the positional
    conv's weight norm as parametrizations.weight.original0 / 1) and
    pytorch_model.bin (as weight_g / weight_v), each with HF's unread
    masked_spec_embed. Returns the port's WavLM with those weights."""
    from styletts2_tpu_torch.models.wavlm import CONV_DIM, CONV_KERNELS, CONV_STRIDES, WavLM, init_wavlm_

    path.mkdir(parents=True)
    wavlm = WavLM()
    init_wavlm_(wavlm, torch.Generator().manual_seed(seed))
    sd = {k: v.detach().clone() for k, v in wavlm.state_dict().items()}
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    g = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()  # dim=2 weight norm: v = w, |v| g = w
    sd["masked_spec_embed"] = torch.zeros(768)
    pos = "encoder.pos_conv_embed.conv"
    forms = {"model.safetensors": {f"{pos}.parametrizations.weight.original0": g,
                                   f"{pos}.parametrizations.weight.original1": w},
             "pytorch_model.bin": {f"{pos}.weight_g": g, f"{pos}.weight_v": w}}
    for name, extra in forms.items():
        tensors = dict(sd, **extra)
        if name.endswith(".bin"):
            torch.save(tensors, path / name)
            continue
        header, blobs, offset = {}, [], 0
        for k, v in tensors.items():
            b = v.contiguous().numpy().astype("<f4").tobytes()
            header[k] = {"dtype": "F32", "shape": list(v.shape), "data_offsets": [offset, offset + len(b)]}
            blobs.append(b)
            offset += len(b)
        head = json.dumps(header).encode()
        (path / name).write_bytes(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    (path / "config.json").write_text(json.dumps({
        "model_type": "wavlm", "hidden_size": 768, "num_attention_heads": 12,
        "intermediate_size": 3072, "num_hidden_layers": 12, "conv_dim": [CONV_DIM] * 7,
        "conv_kernel": list(CONV_KERNELS), "conv_stride": list(CONV_STRIDES),
        "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16}))
    return wavlm


def ddp_wavlm_phase(op, build_dir, smi, dev):
    """Phases 20 and 21. 21: a full-width WavLM directory in the Hugging
    Face layout from seeded weights (`write_hf_wavlm`), read on the card by
    `convert.wavlm_from_hf` from model.safetensors and, without it, from
    pytorch_model.bin: hidden states equal to the port module's with the
    same weights (within WAVLM_TOL of the peak: the reader folds the
    positional conv's weight norm, which rounds its weight). 20: `python -m torch.distributed.run --standalone
    --nproc_per_node 1 chip_smoke.py --train-child ... first --max_steps 2`
    (`train.run.main` as one NCCL rank) on phase 10's fixture at full width,
    batch 16, its WavLM from that directory and its second step traced
    (STYLETTS2_TRACE_STEP): its losses equal an unlaunched run's from the
    same seed, its log names the backend and "loaded WavLM", K1 and K2
    launched, 0 plain-version calls. One card: more ranks than one are
    shown by the CPU test (tests/test_torch_ddp.py). Returns (K1, K2)."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.convert import wavlm_from_hf

    launches = [0, 0]
    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        tdir = Path(tdir)
        t0 = time.perf_counter()
        wavlm = write_hf_wavlm(tdir / "wavlm-base-plus").to(dev).eval()
        wav = torch.from_numpy(_voice(2.0, 16000)[None]).to(dev)
        errs = {}
        with torch.inference_mode():
            want = wavlm(wav)
            for fmt in ("model.safetensors", "pytorch_model.bin"):
                got = wavlm_from_hf(str(tdir / "wavlm-base-plus")).to(dev).eval()(wav)
                errs[fmt] = max(_rel(g.cpu(), w.cpu()) for g, w in zip(got, want))
                (tdir / "wavlm-base-plus" / fmt).rename(tdir / fmt)  # the other form next
        for fmt in errs:
            (tdir / fmt).rename(tdir / "wavlm-base-plus" / fmt)
        print(f"[21 wavlm] full-width WavLM directory (config.json, model.safetensors, "
              f"pytorch_model.bin) read on the card: {len(want)} hidden states, rel err against the "
              f"port module with the same weights " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f" (tol {WAVLM_TOL:g}); {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
        if max(errs.values()) > WAVLM_TOL:
            raise RuntimeError(f"[21 wavlm] the reader disagrees: {errs}")
        del wavlm, got, want

        cfg = Config()
        cfg.data_params = training_fixture(tdir / "data")
        cfg.epochs_1st, cfg.save_freq, cfg.log_interval = 1, 100, 1
        cfg.model_params.slm.model = str(tdir / "wavlm-base-plus")
        runs = {}
        for name in ("unlaunched", "launched"):
            cfg.log_dir = str(tdir / name)
            path = tdir / f"{name}.json"
            path.write_text(json.dumps(dataclasses.asdict(cfg)))  # JSON: no PyYAML on the card
            args = ["first", "--config_path", str(path), "--max_steps", "2"]
            t0 = time.perf_counter()
            if name == "launched":
                env = dict(os.environ, STYLETTS2_TRACE_STEP="2")
                res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                      "--nproc_per_node", "1", str(REPO / "chip_smoke.py"),
                                      "--train-child", str(tdir / "counts.json"), *args],
                                     cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
                if res.returncode:
                    raise RuntimeError(f"[20 ddp] launched run: exit {res.returncode}\n{res.stderr[-3000:]}")
                counts = json.loads((tdir / "counts.json").read_text())
            else:
                k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
                with _Tally(op) as tally:
                    from styletts2_tpu_torch.train import run as train_run
                    train_run.main(args)
                counts = {"k1": op.adain_snake.launches - k1, "k2": op.adain_snake.bwd_launches - k2,
                          "plain": tally.plain}
                torch.cuda.empty_cache()
            launches[0] += counts["k1"]
            launches[1] += counts["k2"]
            log = (Path(cfg.log_dir) / "train.log").read_text()
            train = [json.loads(x) for x in (Path(cfg.log_dir) / "metrics.jsonl").read_text().splitlines()
                     if '"train/mel"' in x]
            runs[name] = {"counts": counts, "log": log, "train": train,
                          "wall": time.perf_counter() - t0}
        a, b = runs["launched"], runs["unlaunched"]
        keys = [k for k in b["train"][0] if k.startswith("train/") and "step_sec" not in k]
        rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6) for x, y in zip(a["train"], b["train"])
                  for k in keys)
        backend = [x for x in a["log"].splitlines() if "data-parallel: rank" in x]
        traces = list((tdir / "launched" / "traces").glob("*.json"))
        kernels = collections.Counter()
        for t in traces:
            for e in json.loads(t.read_text()).get("traceEvents", []):
                name = e.get("name", "")
                if e.get("cat") == "kernel" and "adain_snake" in name:
                    kernels["K2" if "bwd" in name else "K1"] += 1
        print(f"[20 ddp] torch.distributed.run --nproc_per_node 1, train.run first --max_steps 2: "
              f"{backend[-1].split(': ', 1)[-1] if backend else 'no rank line'}; "
              f"{len(a['train'])} steps, losses against the unlaunched run: max rel err {rel:.2e} "
              f"(tol {LOSS_TOL:g}); K1 {a['counts']['k1']} K2 {a['counts']['k2']} (unlaunched "
              f"{b['counts']['k1']} / {b['counts']['k2']}), {a['counts']['plain']} plain-version "
              f"calls; its traced step {len(traces)} trace file(s), device kernel events {dict(kernels)}; "
              f"wall {a['wall']:.1f} s launched, {b['wall']:.1f} s in-process. One card: runs on more "
              f"ranks than one are held to one process's step by the CPU test, two gloo ranks "
              f"(tests/test_torch_ddp.py) [{smi}]", flush=True)
        if not backend or "backend nccl" not in backend[-1] or "rank 0 of 1" not in backend[-1] or \
                len(a["train"]) != 2 or len(b["train"]) != 2 or rel > LOSS_TOL or \
                a["counts"] != b["counts"] or a["counts"]["plain"] or not a["counts"]["k2"] or \
                len(traces) != 1:
            raise RuntimeError(f"[20 ddp] {backend}, {a['counts']}, {b['counts']}, rel {rel}, "
                               f"{len(traces)} traces")
        for name, r in runs.items():
            loaded = [x for x in r["log"].splitlines() if "loaded WavLM from" in x]
            if not loaded:
                raise RuntimeError(f"[21 wavlm] the {name} run did not load WavLM: {r['log'][-2000:]}")
        print(f"[21 wavlm] both stage-1 runs of phase 20: {loaded[-1].split(': ', 1)[-1]}", flush=True)
    torch.cuda.empty_cache()
    return launches

# phase 22: pre-TMA steps and batch of each config, 5 s clips. iSTFTNet's
# bf16-vs-f32 MCD is still chaos at 60 steps of 8 (2.99 dB), stays near 2.4
# dB at batch 8 from step 150 on, and at batch 16 falls through the 2.5 dB
# bound between steps 100 and 150, to 2.03-2.42 at 250 (2.2827 with the
# tool's seeded, deterministic run; PERF.md §6); HiFi-GAN's mel loss
# plateaus or rises as its tanh head clips, so more steps add nothing (its
# loss falls 47.8% in 60 steps, most of it in the first 25)
FIDELITY_RUNS = {"ljspeech": (250, 16), "libritts": (30, 8)}
TP_BATCH = 4  # phase 23: the unlaunched step and two ranks' steps fit one card together
MEDIAN_GRID = 1e-4  # phase 23: TPRLS's median picked on values rounded to this


def fidelity_phase(op, smi):
    """Phase 22: trained-weights fidelity at full width through
    `styletts2_tpu_torch.fidelity.run`: Config() (iSTFTNet) and
    libritts_config() (HiFi-GAN), FIDELITY_RUNS' pre-TMA steps and batches
    (250 at 16, 30 at 8) of 5 s pseudo-speech clips, f32, TF32 off. Every step
    launches 48 / 96 K1 and as many K2 (each counted around its
    `train_step`), 0 plain-version calls; the losses are finite and the
    mean of the last 10 mel losses is below the first 10's; the
    bf16-vs-f32 decoder MCD on the held-out batch at random init, every 125
    steps and trained, held <= MCD_BOUND for iSTFTNet and printed for
    HiFi-GAN (the 50-step curves come from the 300- and 600-step runs of
    the module, PERF.md §6); the share of output samples at |y| >= 0.99.
    Returns (K1, K2) launches, the MCD evaluations' included."""
    from styletts2_tpu_torch import fidelity
    from styletts2_tpu_torch.train.stage1 import Stage1Trainer

    launches = [0, 0]
    for config, per_step in (("ljspeech", CALLS_PER_DECODE), ("libritts", CALLS_PER_HIFIGAN_DECODE)):
        steps, train_step = [], Stage1Trainer.train_step

        def counted(self, *a, **k):
            k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
            out = train_step(self, *a, **k)
            steps.append((op.adain_snake.launches - k1, op.adain_snake.bwd_launches - k2))
            return out

        t0 = time.perf_counter()
        k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
        Stage1Trainer.train_step = counted
        try:
            with _Tally(op) as tally:
                r = fidelity.run(config, *FIDELITY_RUNS[config], device="cuda", mcd_every=125,
                                 log=lambda m: print(f"[22 fidelity] {m} [{smi}]", flush=True))
        finally:
            Stage1Trainer.train_step = train_step
        launches[0] += op.adain_snake.launches - k1
        launches[1] += op.adain_snake.bwd_launches - k2
        torch.cuda.empty_cache()
        curve = ", ".join(f"{n}: {v:.4f}" for n, v in r["bf16_vs_f32_mcd_dB_curve"])
        print(f"[22 fidelity] {config} full width, {r['steps']} pre-TMA steps at batch "
              f"{r['batch']} of {r['wav_len']}-sample clips: mel first 10 "
              f"{r['mel_loss_first10']:.4f} -> last 10 {r['mel_loss_last10']:.4f} "
              f"({r['mel_loss_drop_pct']:.1f}% drop); bf16-vs-f32 MCD random init "
              f"{r['bf16_vs_f32_mcd_dB_random_init']:.4f} dB, trained "
              f"{r['bf16_vs_f32_mcd_dB_trained']:.4f} dB (per item "
              f"{', '.join(f'{x:.3f}' for x in r['bf16_vs_f32_mcd_dB_trained_per_item'])}); curve "
              f"{curve}; output samples at |y| >= 0.99: {r['saturated_share_random_init']:.4f} "
              f"at random init, {r['saturated_share_trained']:.4f} trained; step {r['step_ms_median']:.1f} ms median, peak {r['peak_gib']:.2f} GiB; K1/K2 "
              f"per step {sorted(set(steps))}, {tally.plain} plain-version calls; "
              f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
        if len(steps) != r["steps"] or set(steps) != {(per_step, per_step)} or tally.plain:
            raise RuntimeError(f"[22 fidelity] {config}: launches per step {sorted(set(steps))} "
                               f"(want {per_step} each), {tally.plain} plain-version calls")
        if not (np.isfinite(r["mel_losses"]).all() and len(r["mel_losses"]) == r["steps"]):
            raise RuntimeError(f"[22 fidelity] {config}: mel losses {r['mel_losses']}")
        if not r["mel_loss_last10"] < r["mel_loss_first10"]:
            raise RuntimeError(f"[22 fidelity] {config}: the mel loss did not fall: {r['mel_losses']}")
        if not np.isfinite(r["bf16_vs_f32_mcd_dB_trained"]) or (
                config == "ljspeech" and r["bf16_vs_f32_mcd_dB_trained"] > MCD_BOUND):
            raise RuntimeError(f"[22 fidelity] {config}: trained bf16-vs-f32 MCD "
                               f"{r['bf16_vs_f32_mcd_dB_trained']} dB (bound {MCD_BOUND} iSTFTNet)")
    return launches


@contextlib.contextmanager
def _rounding_stable():
    """Phase 23's comparison of steps that round otherwise (a sharded
    matmul's partial sums), the source's chaotic parts taken out as
    `_host_draws` takes them out: the NSF source's harmonic sines zeroed
    and its noise kept (`_noise_source`: their phase, a cumulative sum of
    F0 over a 5 s clip, turns a 3e-6 change of the predicted F0 into a
    change of the Generator's activations that moves the SLM pass's
    gradients by 1-7e-2) and the STFT phase zeroed (atan2 of ~0-magnitude
    bins flips under any rounding, tests/torch_parity.py); TPRLS's lower
    median picked on values rounded to MEDIAN_GRID (its middle two elements
    can lie within rounding of each other, tests/test_torch_ddp.py); and
    cuDNN's deterministic algorithms, so that the runs differ by the
    sharding's rounding alone and not by the order of a convolution
    backward's atomic sums too."""
    import styletts2_tpu_torch.models.decoder_istft as pdi

    magphase, median, sines = pdi.stft_magphase, torch.median, pdi.SineGen.forward
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def rounded(x, *a, **k):
        if a or k:
            return median(x, *a, **k)
        flat = x.reshape(-1)
        return flat[median(torch.round(flat.detach() / MEDIAN_GRID), dim=0).indices]

    pdi.stft_magphase, torch.median, pdi.SineGen.forward = (_zero_phase(magphase), rounded,
                                                            _noise_source)
    try:
        yield
    finally:
        pdi.stft_magphase, torch.median, pdi.SineGen.forward = magphase, median, sines
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn


def _tp_cases(cfg):
    from styletts2_tpu_torch.train.stage1 import Stage1Trainer
    from styletts2_tpu_torch.train.stage2 import Stage2Trainer

    return (("stage-1 TMA", Stage1Trainer, cfg.loss_params.TMA_epoch),
            ("stage-2 joint", Stage2Trainer, cfg.loss_params.joint_epoch))


def _tp_setup(data_root):
    """Phase 23's config (Config() on the fixture in `data_root`, wd every
    step), modules from seed 0 on the card, their weights on the host, batch."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.models.build import build_training_models

    cfg = Config()
    cfg.data_params, cfg.slmadv_params.iter = fixture_params(data_root), 1
    models = build_training_models(cfg, torch.Generator().manual_seed(0), "second").cuda()
    init = {k: v.detach().cpu().clone() for k, v in models.state_dict().items()}
    return cfg, models, init, _fixture_batch(cfg.data_params, TP_BATCH)


def tp_phase(op, build_dir, smi):
    """Phase 23: tensor parallelism. Config() at full width, batch TP_BATCH:
    the unlaunched stage-1 TMA step and stage-2 joint step (model parallel
    1), then `python -m torch.distributed.run --nproc_per_node 2
    chip_smoke.py --tp-child` with STYLETTS2_TPU_MODEL_PARALLEL=2: two ranks
    on cuda:0 over gloo (NCCL refuses two ranks on one device; the model
    group's collectives and the checkpoint gather are all_reduce, which
    gloo runs on CUDA tensors), model parallel 2, data 1. Each rank takes
    each step from the same weights as the unlaunched run (every optimizer
    step's modules set to its weights after it, phase 18's `follow`), the
    NSF source's STFT phase zeroed and TPRLS's median on rounded values on
    both sides (`_rounding_stable`): the ranks' losses equal, within
    LOSS_TOL of the unlaunched run's, every optimizer step's gradients
    (gathered) within GRAD_TOL; each rank's K1/K2 launches the unlaunched
    run's, 0 plain-version calls; each rank's parameters, peak memory and
    step time beside the unlaunched run's. Returns (K1, K2) launches."""
    start = time.perf_counter()
    launches = [0, 0]
    with tempfile.TemporaryDirectory(dir=build_dir) as tdir:
        tdir = Path(tdir)
        training_fixture(tdir / "data", n=TP_BATCH)
        cfg, models, init, batch = _tp_setup(tdir / "data")
        total = sum(p.numel() for p in models.parameters())
        refs = {}
        with _rounding_stable():
            for name, trainer_cls, epoch in _tp_cases(cfg):
                ref = _spied_step(op, trainer_cls, cfg, models, init, batch, epoch, False, record=True)
                torch.save(ref.pop("after"), tdir / f"follow_{name.replace(' ', '_')}.pt")
                refs[name] = ref
        del models, init
        torch.cuda.empty_cache()
        env = dict(os.environ, STYLETTS2_TPU_MODEL_PARALLEL="2")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", "2", str(REPO / "chip_smoke.py"), "--tp-child",
                              str(tdir)], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=900)
        if res.returncode:
            raise RuntimeError(f"[23 tp] ranks: exit {res.returncode}\n{res.stdout[-2000:]}\n"
                               f"{res.stderr[-4000:]}")
        wall = time.perf_counter() - t0
        ranks = [torch.load(tdir / f"tp_rank{r}.pt", weights_only=False) for r in range(2)]
        print(f"[23 tp] model parallel 2 on one card (gloo, cuda:0 twice), data 1, batch {TP_BATCH}: "
              f"{ranks[0]['sharded']} layers sharded; parameters {total} unlaunched, "
              f"{', '.join(str(r['params']) for r in ranks)} per rank "
              f"({2 * (total - ranks[0]['params'])} "
              f"sharded in halves); the ranks' run {wall:.1f} s wall [{smi}]", flush=True)
        for name, _, _ in _tp_cases(cfg):
            ref, got = refs[name], [r[name] for r in ranks]
            rel = {k: abs(got[0]["metrics"][k] - v) / max(abs(v), 1e-6)
                   for k, v in ref["metrics"].items()}
            g_err = [max(float((a[k] - b[k]).norm() / max(float(b[k].norm()), 1e-30)) for k in b)
                     for a, b in zip(got[0]["grads"], ref["grads"])]
            for g in got:
                launches[0] += g["k1"]
                launches[1] += g["k2"]
            runs, trained = ref["runs"]
            print(f"[23 tp] {name}: losses rel err {max(rel.values()):.2e} (tol {LOSS_TOL:g}); "
                  f"gradient L2 rel err per optimizer step {', '.join(f'{e:.2e}' for e in g_err)} "
                  f"(tol {GRAD_TOL:g}); K1/K2 per rank {[(g['k1'], g['k2']) for g in got]}, "
                  f"unlaunched {ref['k1']}/{ref['k2']} for {runs} decoder runs; peak "
                  f"{', '.join(f'{g['peak'] / 2 ** 30:.2f}' for g in got)} GiB per rank, unlaunched "
                  f"{ref['peak'] / 2 ** 30:.2f}; step {', '.join(f'{g['ms']:.1f}' for g in got)} ms "
                  f"per rank (two ranks share the card), unlaunched {ref['ms']:.1f} ms [{smi}]",
                  flush=True)
            if got[0]["metrics"] != got[1]["metrics"] or max(rel.values()) > LOSS_TOL or \
                    len(g_err) != len(ref["grads"]) or max(g_err) > GRAD_TOL or \
                    any(g["plain"] or (g["k1"], g["k2"]) != (ref["k1"], ref["k2"]) for g in got) or \
                    ref["plain"] or ref["k1"] != runs * CALLS_PER_DECODE or not ref["k2"] or \
                    not all(np.isfinite(v) for v in got[0]["metrics"].values()):
                raise RuntimeError(f"[23 tp] {name}: {rel}, {g_err}, "
                                   f"{[(g['k1'], g['k2'], g['plain']) for g in got]}, {ref['k1']}")
    torch.cuda.empty_cache()
    print(f"[23 tp] phase 23 in {time.perf_counter() - start:.1f} s wall [{smi}]", flush=True)
    return launches


def tp_child(argv):
    """`chip_smoke.py --tp-child DIR` as one rank of phase 23 under
    torch.distributed.run: gloo on cuda:0, the mesh of
    STYLETTS2_TPU_MODEL_PARALLEL, phase 23's modules sharded, each case's
    step following the unlaunched run's weights in DIR; writes
    DIR/tp_rank{r}.pt (rank 0 adds the gathered gradients)."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from styletts2_tpu_torch.ops import adain_snake as op
    from styletts2_tpu_torch.parallel import mesh
    from styletts2_tpu_torch.utils import set_f32_compute

    set_f32_compute()
    tdir = Path(argv[0])
    torch.cuda.set_device(0)  # both ranks on the one card: gloo, not NCCL
    dist.init_process_group("gloo")
    try:
        rank = dist.get_rank()
        mesh.make_mesh(dist.get_world_size(), mesh.model_parallel_from_env())
        cfg, models, init, batch = _tp_setup(tdir / "data")
        out = {"sharded": len(mesh.shard_(models)),
               "params": sum(p.numel() for p in models.parameters())}
        with _rounding_stable():
            for name, trainer_cls, epoch in _tp_cases(cfg):
                follow = torch.load(tdir / f"follow_{name.replace(' ', '_')}.pt", weights_only=False)
                r = _spied_step(op, trainer_cls, cfg, models, init, batch, epoch, False, follow=follow)
                out[name] = {k: r[k] for k in ("metrics", "k1", "k2", "plain", "ms", "peak", "runs")}
                if rank == 0:
                    out[name]["grads"] = r["grads"]
                del follow, r
        torch.save(out, tdir / f"tp_rank{rank}.pt")
    finally:
        mesh.reset()
        dist.destroy_process_group()


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}  # bench.py's line


def _zero_counts(op):
    op.adain_snake.launches = op.adain_snake.bwd_launches = 0


def _bench_train_run(op, smi, argv, tag):
    """`bench_train.run` on the card with every step's K1 / K2 launches and
    metrics recorded; raise unless each step launched as its stage's step
    does (stage 1 from TMA: 48 / 48; stage 2 joint: `_stage2_launches`)
    with x in the run's dtype, 0 plain-version calls, finite metrics and a
    non-null MFU. Returns (the result, K1, K2)."""
    from styletts2_tpu_torch import bench_train
    from styletts2_tpu_torch.train.stage1 import Stage1Trainer
    from styletts2_tpu_torch.train.stage2 import Stage2Trainer

    args = bench_train.parse_args(argv)
    cls = Stage2Trainer if args.stage == "second" else Stage1Trainer
    dtype = "bfloat16" if args.mp == "bf16" else "float32"
    steps, train_step = [], cls.train_step

    def counted(self, *a, **k):
        k1, k2, by = op.adain_snake.launches, op.adain_snake.bwd_launches, dict(tally.n)
        m = train_step(self, *a, **k)
        steps.append({"k1": op.adain_snake.launches - k1, "k2": op.adain_snake.bwd_launches - k2,
                      "dtypes": {dt for _, dt in tally.since(by)}, "metrics": m})
        return m

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cls.train_step = counted
    try:
        with _Tally(op) as tally:
            _zero_counts(op)
            r = bench_train.run(args)
            k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
    finally:
        cls.train_step = train_step
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    wants = [(CALLS_PER_STEP * (1 + args.remat), CALLS_PER_STEP) if cls is Stage1Trainer else
             _stage2_launches(True, True, st["metrics"]["slm_sampled"], args.remat)
             for st in steps]
    got = [(st["k1"], st["k2"]) for st in steps]
    line = {k: v for k, v in r.items() if k != "metrics"}
    print(f"[{tag}] bench_train {' '.join(argv)}: {json.dumps(line)}; {len(steps)} steps "
          f"(warm-up, {args.steps} timed, 1 counted), K1/K2 per step {got}, peak "
          f"{peak / 2 ** 30:.2f} GiB, {tally.plain} plain-version calls; "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    if got != wants or any(st["dtypes"] != {dtype} for st in steps) or tally.plain:
        raise RuntimeError(f"[{tag}] launches per step {got} with x in "
                           f"{[st['dtypes'] for st in steps]}, want {wants} in {dtype}; "
                           f"{tally.plain} plain-version calls")
    if k1 != sum(g[0] for g in got) or k2 != sum(g[1] for g in got):
        raise RuntimeError(f"[{tag}] {k1} K1 / {k2} K2 launches outside the steps' {got}")
    if not all(np.isfinite(v) for st in steps for v in st["metrics"].values()) \
            or len(steps) != args.steps + 2 or r["mfu"] is None or not r["mfu"] > 0 \
            or not r["flops_per_step"]:
        raise RuntimeError(f"[{tag}] metrics {[st['metrics'] for st in steps]}, result {line}")
    return r, k1, k2


def bench_phase(op, smi):
    """Phase 24: the port's benches on the card.
    - `bench.headline_once` in process on Config() (seeded weights): the
      calibration, a warm-up and 20 timed calls, each decode 48 f32 K1
      launches, 0 plain-version calls, RTF > 0;
    - `python -m styletts2_tpu_torch.bench` with STYLETTS2_BENCH_PROCS=2 as
      a subprocess (its `--headline-worker` a third process): exit 0, one
      JSON last line with the bench's keys, the batched, bf16 and fused
      extras, a positive value;
    - `bench_train.run` at full width, 1 timed step: stage 1 (TMA) in f32
      and stage 2 (joint) with `--mp bf16`, each step's K1 / K2 as its
      stage's (`_bench_train_run`), finite metrics, a non-null MFU.
    Returns (K1, K2) of the in-process runs."""
    from styletts2_tpu_torch import bench
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer

    start = time.perf_counter()
    syn = Synthesizer(Config(), seed=0, device="cuda")
    with _Counts(op, syn.models["decoder"]) as c:
        stats, speed = bench.headline_once(syn)
    c.check(CALLS_PER_DECODE, "bench headline")
    del syn
    torch.cuda.empty_cache()
    print(f"[24 bench] headline_once in process: {json.dumps(stats)}, speed {speed:.4f}; "
          f"{c.launches} K1 launches in {c.decodes} decodes, 0 plain-version calls [{smi}]",
          flush=True)
    if not stats["rtf"] > 0 or c.replays != stats["n_runs"] + 2:  # one replay a call
        raise RuntimeError(f"[24 bench] headline: {stats}, {c.decodes} decodes")

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "styletts2_tpu_torch.bench"], cwd=REPO,
                         env=dict(os.environ, STYLETTS2_BENCH_PROCS="2", PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"[24 bench] python -m styletts2_tpu_torch.bench exited "
                           f"{out.returncode}:\n{out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    extra = line.get("extra", {})
    print(f"[24 bench] python -m styletts2_tpu_torch.bench (2 processes) in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(line)} [{smi}]", flush=True)
    if set(line) != BENCH_KEYS or not line["value"] > 0 or extra.get("n_procs") != 2 or not (
            extra.get("batched_B8_rtf", 0) > 0 and extra.get("bf16_decoder_rtf", 0) > 0
            and extra.get("fused_rtf", 0) > 0 and extra.get("fused_latency_p50_ms", 0) > 0):
        raise RuntimeError(f"[24 bench] bench line {line}")

    _, k1a, k2a = _bench_train_run(op, smi, ["--full-size", "--stage", "first", "--steps", "1"],
                                   "24 bench")
    _, k1b, k2b = _bench_train_run(op, smi, ["--full-size", "--stage", "second", "--mp", "bf16",
                                             "--steps", "1"], "24 bench")
    print(f"[24 bench] phase 24 in {time.perf_counter() - start:.1f} s wall [{smi}]", flush=True)
    return c.launches + k1a + k1b, k2a + k2b


NOTEBOOKS = ("demo_ljspeech.ipynb", "demo_libritts.ipynb", "finetune_demo.ipynb")


def notebook_phase(op, smi):
    """Phase 25: the port's three example notebooks (`examples/torch/`) at
    full width on the card (STYLETTS2_DEMO_DEVICE=cuda, no LITE), every code
    cell run in order in a fresh namespace in a temporary directory: each
    decoder run launches 48 K1 (the notebooks' decoders are iSTFTNet), the
    finetune notebook's training step K2 too, 0 plain-version calls.
    Returns (K1, K2)."""
    from styletts2_tpu_torch.models import decoder_hifigan, decoder_istft

    start, launches = time.perf_counter(), [0, 0]
    decoders = (decoder_istft.Decoder, decoder_hifigan.Decoder)
    env = {"STYLETTS2_DEMO_DEVICE": "cuda", "STYLETTS2_DEMO_LITE": "0"}
    saved_env, cwd = {k: os.environ.get(k) for k in env}, os.getcwd()
    for name in NOTEBOOKS:
        nb = json.loads((REPO / "examples" / "torch" / name).read_text())
        runs = [0]

        def count(module, args):  # eager runs; a graph's capture runs none
            runs[0] += isinstance(module, decoders) and not torch.cuda.is_current_stream_capturing()

        t0 = time.perf_counter()
        hook = torch.nn.modules.module.register_module_forward_pre_hook(count)
        os.environ.update(env)
        try:
            with tempfile.TemporaryDirectory() as tmp, _Tally(op) as tally:
                os.chdir(tmp)
                _zero_counts(op)
                replays, ns = GRAPHS.replays, {}
                for i, cell in enumerate(nb["cells"]):
                    if cell["cell_type"] == "code":
                        exec(compile("".join(cell["source"]), f"{name}:cell{i}", "exec"), ns)
                k1, k2 = op.adain_snake.launches, op.adain_snake.bwd_launches
                runs[0] += GRAPHS.replays - replays  # decode graphs' replays
                os.chdir(cwd)
        finally:
            os.chdir(cwd)
            hook.remove()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        del ns
        torch.cuda.empty_cache()
        print(f"[25 notebooks] {name} at full width on cuda: {time.perf_counter() - t0:.1f} s, "
              f"{runs[0]} decoder runs, K1 {k1} K2 {k2} "
              f"({dict((f'{key} {dt}', n) for (key, dt), n in tally.n.items())}) [{smi}]",
              flush=True)
        if k1 != CALLS_PER_DECODE * runs[0] or not runs[0] or tally.plain or \
                (k2 > 0) != (name == "finetune_demo.ipynb"):
            raise RuntimeError(f"[25 notebooks] {name}: {k1} K1 / {k2} K2 launches for "
                               f"{runs[0]} decoder runs, {tally.plain} plain-version calls")
        launches[0] += k1
        launches[1] += k2
    print(f"[25 notebooks] phase 25 in {time.perf_counter() - start:.1f} s wall [{smi}]",
          flush=True)
    return launches


FUSED_BUDGET = 600  # frames: the JAX inference_fused's default, 15 s of audio
FUSED_RUNS = 10  # warm calls timed per path
BF16_ROUNDING = 2.0 ** -8  # one bf16 rounding, relative to the peak


def _profiled(fn):
    """One call of fn under torch.profiler, read from its Chrome trace as
    tools/profile_torch_synth.py reads it: the host wall (ms), the card's
    busy time (`observability.device_busy_ms`) and share of the wall, the
    kernels the card ran, the launches the host made (kernel and graph
    launches) and K1's kernels."""
    from torch.profiler import ProfilerActivity, profile

    from styletts2_tpu_torch.observability import device_busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        ev = json.loads(Path(f"{tmp}/trace.json").read_text())["traceEvents"]
    busy = device_busy_ms(ev)
    launches = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and (e["name"].startswith(("cudaLaunch", "cuLaunch"))
                     or e["name"] == "cudaGraphLaunch")]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            "kernels": len(kernels), "host_launches": len(launches),
            "k1": sum("adain_snake_kernel<" in e["name"] for e in kernels)}


def _timed_ms(fn, runs=FUSED_RUNS):
    """Host ms of `runs` warm calls of fn, each ending in a device sync
    (the waveform comes back to the host)."""
    from styletts2_tpu_torch.bench import _timed

    return 1e3 * _timed(fn, runs)


class _FusedCase:
    """Phase 26 on one Synthesizer: `inference_fused` at the bench's
    utterance (budget 600) captured at its first call and held against an
    eager run of the same program (`Synthesizer._fused`) on the card,
    same-seed replays bit-equal and another seed's different, each replay
    adding the K1 its capture recorded; warm timings of it (`time`; the
    staged path's graphs are timed in phase 27), and later one profiled call
    (`profile`: torch.profiler leaves the host slower for the rest of the
    process, so every path is timed before any is profiled). Every shape the graph gives
    K1 must be one of phase 3's KERNEL_CASES, where K1 was held against its
    plain version. `k1` sums its launches."""

    def __init__(self, op, syn, tag, smi, per_decode, speed, ref_s=None):
        from styletts2_tpu_torch.inference import _mix, _pack
        from styletts2_tpu_torch.text import encode_text

        self.op, self.syn, self.tag, self.smi, self.per_decode = op, syn, tag, smi, per_decode
        self.kw = dict(frame_budget=FUSED_BUDGET, ref_s=ref_s, speed=speed)
        self.fused = lambda seed=0: syn.inference_fused(BENCH_TEXT, seed=seed, **self.kw)
        with _Tally(op) as tally:
            before = op.adain_snake.launches
            wav = self.fused()
            key, self.graph = next((k, g) for k, g in syn.graphs.items() if k[0] == "fused")
            again, other = self.fused(), self.fused(seed=1)
            inputs = syn._inputs(encode_text(BENCH_TEXT), ref_s, None,
                                 _mix(0.3, 0.7, speed=speed), 0)
            with torch.inference_mode():
                eager = _pack(*syn._fused(**inputs, frame_budget=FUSED_BUDGET, steps=5, scale=1.0,
                                          generator=torch.Generator(syn.device).manual_seed(0)))
            eager = eager.cpu().numpy()
            eager = eager[: int(eager[-1]) * SAMPLES_PER_FRAME]
            self.k1 = op.adain_snake.launches - before
        decodes = 5  # the warm-up, 3 replays, the eager run
        err = _rel(wav, eager) if wav.shape == eager.shape else float("inf")
        tol = 1e-5 if syn.decoder_dtype == torch.float32 else BF16_ROUNDING
        shapes = sorted(tally.shapes["K1"])
        unchecked = [c for c in shapes if c not in KERNEL_CASES]
        print(f"[{tag}] graph {key}: capture {self.graph.capture_s:.2f} s (warm-up and record), "
              f"pool {self.graph.pool_bytes / 2 ** 20:.1f} MiB, K1 {self.graph.k1} per replay; "
              f"replay vs eager on the card rel err {err:.2e} (tol {tol:g}), same seed bit-equal "
              f"{np.array_equal(wav, again)}, seed 1 differs {not np.array_equal(wav, other)}; "
              f"K1 {self.k1} in {decodes} decodes at {[c[0] for c in shapes]}, "
              f"{len(unchecked)} of them not held in phase 3, {tally.plain} plain-version calls "
              f"[{smi}]", flush=True)
        if unchecked or not shapes:
            raise RuntimeError(f"[{tag}] K1 ran at {unchecked}, not held against its plain "
                               f"version in phase 3")
        if not (np.isfinite(wav).all() and len(wav) % SAMPLES_PER_FRAME == 0 and err <= tol
                and np.array_equal(wav, again) and not np.array_equal(wav, other)):
            raise RuntimeError(f"[{tag}] inference_fused: replay vs eager {err:.2e}, or "
                               f"same-seed replays differ, or seeds 0 and 1 agree")
        if self.graph.k1 != per_decode or self.k1 != per_decode * decodes or tally.plain:
            raise RuntimeError(f"[{tag}] K1: {self.graph.k1} recorded, {self.k1} counted for "
                               f"{decodes} decodes of {per_decode}; {tally.plain} plain calls")
        self.wav = wav

    def time(self):
        before = self.op.adain_snake.launches
        self.lat = _timed_ms(self.fused)
        self.k1 += self.op.adain_snake.launches - before
        if self.k1 != self.per_decode * (5 + FUSED_RUNS):
            raise RuntimeError(f"[{self.tag}] K1 {self.k1} after the timed calls")

    def shared_pool(self):
        """A second graph on the same Synthesizer (10 diffusion steps, a key
        of the bench's extended sweep), captured into the first graph's
        pool: the memory it adds beside the first's own pool, and after it
        each graph's replay bit-equal to its earlier one."""
        before = self.op.adain_snake.launches
        wav10 = self.syn.inference_fused(BENCH_TEXT, diffusion_steps=10, **self.kw)
        first, second = (g for k, g in self.syn.graphs.items() if k[0] == "fused")
        same = (np.array_equal(self.fused(), self.wav) and np.array_equal(
            self.syn.inference_fused(BENCH_TEXT, diffusion_steps=10, **self.kw), wav10))
        counted = self.op.adain_snake.launches - before
        self.k1 += counted
        print(f"[{self.tag}] a second graph (10 diffusion steps) captured into the first's pool "
              f"added {second.pool_bytes / 2 ** 20:.1f} MiB to it (the first's own: "
              f"{first.pool_bytes / 2 ** 20:.1f} MiB); then each graph's replay bit-equal to its "
              f"earlier one: {same}; K1 {counted} [{self.smi}]", flush=True)
        if not same or counted != 4 * self.per_decode:  # the warm-up and three replays
            raise RuntimeError(f"[{self.tag}] graphs sharing a pool: replays differ, or K1 "
                               f"{counted}")

    def profile(self):
        before = self.op.adain_snake.launches
        prof = _profiled(self.fused)
        counted = self.op.adain_snake.launches - before
        self.k1 += counted
        if not prof["k1"] == counted == self.graph.k1:
            raise RuntimeError(f"[{self.tag}] the profiler saw {prof['k1']} K1 in one replay, "
                               f"which counted {counted}, its capture recorded {self.graph.k1}")
        _path_line(self.tag, f"inference_fused (budget {FUSED_BUDGET})", self.wav, self.lat, prof,
                   self.smi, f", K1 {prof['k1']} in the replay (profiler)")


def _path_line(tag, what, wav, lat, prof, smi, extra=""):
    audio = len(wav) / 24000.0
    print(f"[{tag}] {what}: {audio:.3f} s audio, p50 {np.percentile(lat, 50):.2f} ms, p95 "
          f"{np.percentile(lat, 95):.2f} ms, RTF {audio / (lat.mean() / 1e3):.1f}x over {len(lat)} "
          f"warm calls; one profiled call: {prof['host_launches']} host launches, "
          f"{prof['kernels']} kernels, device busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} "
          f"ms ({100 * prof['busy_share']:.1f}%){extra} [{smi}]", flush=True)


def _replay_against_cpu(op, cfg, tag, smi, speed, ref_s=None, text=BENCH_TEXT):
    """One replay of `inference_fused` (budget 600, f32) of `text` (the
    phase's utterance, ~309 of the 600 frames) on the card against
    the same program run eagerly on the CPU, K1 there its plain version,
    from the same weights, inputs and draws, held as phase 5 holds the
    staged path: equal lengths, the waveform within 1e-3. The graph is
    captured on a fresh Synthesizer with its draws kept (each draw's tensor
    stays alive in the graph's pool, so after the replay it holds what the
    replay drew), and the CPU run takes those draws in order. The source's
    chaotic parts are zeroed in both: the iSTFTNet source's STFT phase, as
    `_host_draws` zeroes it, and HiFi-GAN's harmonic sines, its noise kept
    (`_noise_source`, as phase 23: a constant source leaves the Generator's
    noise-branch AdaINs normalising their rows' rounding); HiFi-GAN's head
    gets phase 8's gain. Returns K1's launches on the card."""
    from styletts2_tpu_torch.inference import Synthesizer, _mix, _pack
    from styletts2_tpu_torch.text import encode_text

    card, host = (Synthesizer(cfg(), seed=0, device=d) for d in ("cuda", "cpu"))
    if card.hifigan:
        for m in (card, host):
            m.models["decoder"].generator.conv_post.weight_g.mul_(0.01)
    with _SharedDraws(card.hifigan, noise_source=True, outside=False) as draws:
        before = op.adain_snake.launches
        wav = card.inference_fused(text, frame_budget=FUSED_BUDGET, ref_s=ref_s, speed=speed)
        launches = op.adain_snake.launches - before
        inputs = card._inputs(encode_text(text), ref_s, None, _mix(0.3, 0.7, speed=speed), 0)
        draws.feed()
        with torch.inference_mode():
            want = _pack(*host._fused(torch.Generator(), **{k: v.cpu() for k, v in inputs.items()},
                                      frame_budget=FUSED_BUDGET, steps=5, scale=1.0)).numpy()
        left, kept = draws.left(), draws.kept
    want = want[: int(want[-1]) * SAMPLES_PER_FRAME]
    err = _rel(wav, want) if wav.shape == want.shape else float("inf")
    print(f"[{tag}] a replay against the CPU's eager run of the program (plain K1), the same "
          f"weights, inputs and {len(kept)} draws: {len(wav)} / {len(want)} samples, waveform "
          f"rel err {err:.2e} (tol 1e-3) [{smi}]", flush=True)
    if not (kept and not left and np.isfinite(wav).all() and err < 1e-3):
        raise RuntimeError(f"[{tag}] inference_fused: the card's replay and the CPU disagree "
                           f"({err:.2e}), or {left} of {len(kept)} draws were not taken")
    return launches


def fused_phase(op, smi):
    """Phase 26: the JAX Synthesizer's single-dispatch paths as CUDA graphs,
    K1 inside, at full width with seeded weights: `inference_fused` (budget
    600) for Config() and libritts_config() (the seeded voice), each with
    the f32 and the bf16 decoder (`_FusedCase`), and
    `Synthesizer(Config(), phase_a="fused")` against the staged path
    (durations equal, waveform within 1e-5 of its peak; its phase-A graph
    launches no K1, each decode 48). The utterance is pinned to ~7.85 s as
    the bench pins it; `phase_a="fused"` is the LJSpeech f32 Synthesizer's
    `phase_a_mode` set for the call. Every path is timed, then each is profiled once. A
    second graph shares the LJSpeech f32 graph's pool (`shared_pool`), and
    one f32 replay per config is held against the CPU
    (`_replay_against_cpu`). Returns the phase's K1 launches and its four
    Synthesizers (name, Synthesizer, K1 per decode, speed, style), which
    phase 27 takes on."""
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.inference import Synthesizer

    start, cases = time.perf_counter(), []
    for name, cfg, per_decode in (("LJSpeech", Config, CALLS_PER_DECODE),
                                  ("LibriTTS", libritts_config, CALLS_PER_HIFIGAN_DECODE)):
        speed = ref_s = None
        for dtype in ("float32", "bfloat16"):
            syn = Synthesizer(cfg(), seed=0, device="cuda", decoder_dtype=dtype)
            if speed is None:  # the f32 staged path's natural length, as bench.calibrate_speed
                ref_s = syn.compute_style(_voice()) if syn.multispeaker else None
                natural = syn.synthesize(BENCH_TEXT, ref_s=ref_s, seed=0).wav
                speed = max(len(natural) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
                if name == "LJSpeech":
                    lj_speed = speed
                else:
                    ms_speed, ms_ref_s = speed, ref_s
            cases.append(_FusedCase(op, syn, f"26 fused {name} {dtype}", smi, per_decode, speed,
                                    ref_s))
    for case in cases:
        case.time()
    cases[0].shared_pool()

    fa = cases[0].syn  # LJSpeech f32: its staged chain, then phase A as one program
    want = fa.synthesize(BENCH_TEXT, seed=0, speed=lj_speed)

    def call():
        fa.phase_a_mode = "fused"
        try:
            return fa.synthesize(BENCH_TEXT, seed=0, speed=lj_speed)
        finally:
            fa.phase_a_mode = "staged"

    with _Counts(op, fa.models["decoder"]) as c:
        got, got2 = call(), call()
        key, graph = next((k, g) for k, g in fa.graphs.items() if k[0] == "phase_a")
        lat = _timed_ms(call)
    c.check(CALLS_PER_DECODE, "26 fused phase A")
    err = _rel(got.wav, want.wav) if got.wav.shape == want.wav.shape else float("inf")
    print(f"[26 fused phase A] graph {key}: capture {graph.capture_s:.2f} s, pool "
          f"{graph.pool_bytes / 2 ** 20:.1f} MiB, K1 {graph.k1} per replay; against staged: "
          f"durations equal {np.array_equal(got.pred_dur, want.pred_dur)}, waveform rel err "
          f"{err:.2e} (tol 1e-5), style rel err {_rel(got.s_pred, want.s_pred):.2e}; two calls "
          f"bit-equal {np.array_equal(got.wav, got2.wav)}; K1 {c.launches} in {c.decodes} "
          f"decodes [{smi}]", flush=True)
    if not (np.array_equal(got.pred_dur, want.pred_dur) and err <= 1e-5 and graph.k1 == 0
            and np.array_equal(got.wav, got2.wav)):
        raise RuntimeError("[26 fused phase A] phase_a='fused' disagrees with 'staged'")
    for case in cases:
        case.profile()
    before = op.adain_snake.launches
    prof = _profiled(call)
    _path_line("26 fused phase A", "phase_a='fused' inference", got.wav, lat, prof, smi)
    k1 = sum(case.k1 for case in cases) + c.launches + op.adain_snake.launches - before
    syns = [(case.tag.split()[2], case.syn, case.per_decode, case.kw["speed"], case.kw["ref_s"])
            for case in cases]
    del cases, fa
    k1 += _replay_against_cpu(op, Config, "26 fused LJSpeech vs CPU", smi, lj_speed)
    k1 += _replay_against_cpu(op, libritts_config, "26 fused LibriTTS vs CPU", smi, ms_speed,
                              ms_ref_s)
    torch.cuda.empty_cache()
    print(f"[26 fused] phase 26 in {time.perf_counter() - start:.1f} s wall [{smi}]", flush=True)
    return k1, syns


STAGED_RUNS = 10  # warm calls timed per path in phase 27 (the eager chain: half, at least 3)
SHORT_TEXT = "hˈɛloʊ ðɛɹ."  # phase 27's other key: another text bucket and frame bucket


class _ChainCase:
    """Phase 27 on one Synthesizer and one path (`call(seed)`: staged
    `synthesize`, `synthesize` with the fused phase A, `inference_batch` of
    one text or of SERVE_TEXTS): the chain of graph replays against the same
    chain of programs run eagerly on the card (f32 bit-equal, the bf16
    decoder within one bf16 rounding of the peak), same-seed calls
    bit-equal, another seed's different, each call one decode replay of
    per_decode K1; `time` times the graphs and, with `time_eager`, the
    eager chain (`eager_chain`, tests/test_torch_cuda.py's) over half as
    many calls, `profile` profiles them, `again` holds the replays to their
    first output after other keys ran."""

    def __init__(self, op, syn, tag, what, call, per_decode, smi, eager_chain, time_eager=True,
                 runs=STAGED_RUNS, profiled=True):
        self.op, self.syn, self.tag, self.what, self.call = op, syn, tag, what, call
        self.eager_chain = eager_chain
        self.per_decode, self.smi, self.time_eager = per_decode, smi, time_eager
        self.runs, self.profiled = runs, profiled
        keys = set(syn.graphs)
        self.first = call(0)
        self.keys = [k for k in syn.graphs if k not in keys]
        before = op.adain_snake.launches
        again, other = call(0), call(1)
        self.k1 = op.adain_snake.launches - before
        with eager_chain(syn):
            eager = call(0)
        tol = 0.0 if syn.decoder_dtype == torch.float32 else BF16_ROUNDING
        errs = [_rel(g, e) if g.shape == e.shape else float("inf")
                for g, e in zip(self.first, eager)]
        decode = [syn.graphs[k] for k in syn.graphs if k[0] == "decode" and k[1] == len(self.first)]
        print(f"[{tag}] {what}: {len(self.keys)} new graphs {[k[0] for k in self.keys]}, capture "
              f"{', '.join(f'{syn.graphs[k].capture_s:.2f}' for k in self.keys)} s; replays vs the "
              f"eager chain on the card max rel err {max(errs):.2e} (tol {tol:g}), same seed "
              f"bit-equal {all(map(np.array_equal, self.first, again))}, seed 1 differs "
              f"{not all(map(np.array_equal, self.first, other))}; K1 {self.k1} in 2 calls "
              f"[{smi}]", flush=True)
        if not (max(errs) <= tol and all(np.isfinite(w).all() for w in self.first)
                and all(map(np.array_equal, self.first, again))
                and not all(map(np.array_equal, self.first, other))):
            raise RuntimeError(f"[{tag}] {what}: the replays and the eager chain disagree, or "
                               f"same-seed calls differ, or seeds 0 and 1 agree")
        if self.k1 != 2 * per_decode or not decode or any(g.k1 != per_decode for g in decode):
            raise RuntimeError(f"[{tag}] {what}: K1 {self.k1} in 2 calls, decode graphs "
                               f"{[g.k1 for g in decode]}, not {per_decode} each")

    def again(self):
        same = all(map(np.array_equal, self.call(0), self.first))
        if not same:
            raise RuntimeError(f"[{self.tag}] {self.what}: changed after other keys ran")
        return same

    def time(self):
        self.lat = _timed_ms(lambda: self.call(0), self.runs)
        if self.time_eager:
            with self.eager_chain(self.syn):
                self.call(0)
                self.eager_lat = _timed_ms(lambda: self.call(0), max(self.runs // 2, 3))

    def profile(self):
        if not self.profiled:
            audio = sum(len(w) for w in self.first) / 24000.0
            p50 = np.percentile(self.lat, 50)
            print(f"[{self.tag}] {self.what}, graphs: {audio:.3f} s audio, p50 {p50:.2f} ms, p95 "
                  f"{np.percentile(self.lat, 95):.2f} ms, RTF {audio / (p50 / 1e3):.1f}x over "
                  f"{len(self.lat)} warm calls (its graphs are phase A's, profiled above) "
                  f"[{self.smi}]", flush=True)
            return
        before = self.op.adain_snake.launches
        prof = _profiled(lambda: self.call(0))
        counted = self.op.adain_snake.launches - before
        if not prof["k1"] == counted == self.per_decode:
            raise RuntimeError(f"[{self.tag}] {self.what}: the profiler saw {prof['k1']} K1 in one "
                               f"call, which counted {counted}, not {self.per_decode}")
        rows = [("graphs", self.lat, prof)]
        if self.time_eager:
            with self.eager_chain(self.syn):
                rows.append(("eager chain", self.eager_lat, _profiled(lambda: self.call(0))))
        audio = sum(len(w) for w in self.first) / 24000.0
        for name, lat, pr in rows:
            p50 = np.percentile(lat, 50)
            print(f"[{self.tag}] {self.what}, {name}: {audio:.3f} s audio, p50 {p50:.2f} ms, p95 "
                  f"{np.percentile(lat, 95):.2f} ms, RTF {audio / (p50 / 1e3):.1f}x over "
                  f"{len(lat)} warm calls; one profiled call: {pr['host_launches']} host launches, "
                  f"{pr['kernels']} kernels ({pr['k1']} K1), device busy {pr['busy_ms']:.2f} ms of "
                  f"{pr['wall_ms']:.2f} ({100 * pr['busy_share']:.1f}%), of the p50 "
                  f"{100 * pr['busy_ms'] / p50:.1f}% [{self.smi}]", flush=True)
        return prof


def staged_graphs_phase(op, smi, syns):
    """Phase 27: the JAX Synthesizer's staged and batched programs as CUDA
    graphs (`inference._run`: text -> style -> duration or phase A, then
    prosody -> decode; one graph per program and key) on phase 26's
    Synthesizers (`syns`: Config() and libritts_config() with the seeded
    voice at full width, each with the f32 and the bf16 decoder, the
    utterance pinned as the bench pins it): `synthesize` staged and with the
    fused phase A (`phase_a_mode`), and `inference_batch` of one text and of
    SERVE_TEXTS (B = 8, mixed lengths), each a `_ChainCase`; then a request
    of another text and frame bucket (SHORT_TEXT) and each path again,
    unchanged; every shape K1 ran at is one of phase 3's; each path timed
    (B = 8 and the eager chains over half the calls) and profiled but
    B = 1, whose graphs are the fused phase A path's, beside its eager chain
    (staged and B = 8; the other two chains are the staged one's with phase
    A fused); the graph count and the pool. Returns its K1 launches."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import _eager_chain

    start, launches = time.perf_counter(), op.adain_snake.launches
    for name, syn, per_decode, speed, ref_s in syns:
        tag = f"27 graphs {name} {str(syn.decoder_dtype).split('.')[-1]}"
        kw = {} if ref_s is None else {"ref_s": ref_s}
        refs = None if ref_s is None else np.repeat(ref_s, len(SERVE_TEXTS), axis=0)

        def synthesize(seed, fused=False, syn=syn, kw=kw, speed=speed):
            syn.phase_a_mode = "fused" if fused else "staged"
            try:
                return [syn.synthesize(BENCH_TEXT, seed=seed, speed=speed, **kw).wav]
            finally:
                syn.phase_a_mode = "staged"

        paths = (("staged inference", synthesize, {}),
                 ("inference, phase_a='fused'", lambda seed, f=synthesize: f(seed, True),
                  {"time_eager": False}),
                 ("inference_batch B=1", lambda seed, syn=syn, kw=kw, speed=speed:
                  syn.inference_batch([BENCH_TEXT], seed=seed, speed=speed, **kw),
                  {"time_eager": False, "profiled": False}),
                 ("inference_batch B=8", lambda seed, syn=syn, refs=refs, speed=speed:
                  syn.inference_batch(SERVE_TEXTS, ref_s=refs, seed=seed, speed=speed),
                  {"runs": STAGED_RUNS // 2}))
        with _Tally(op) as tally:
            cases = [_ChainCase(op, syn, tag, what, call, per_decode, smi, _eager_chain, **opts)
                     for what, call, opts in paths]
            other = syn.synthesize(SHORT_TEXT, seed=2, speed=speed, **kw)
            same = all(case.again() for case in cases[::-1])
        shapes = sorted(tally.shapes["K1"])
        unchecked = [c for c in shapes if c not in KERNEL_CASES + GRAPH_CASES]
        pool = sum(g.pool_bytes for g in syn.graphs.values()) / 2 ** 20
        print(f"[{tag}] a request of another text and frame bucket ({len(other.wav)} samples) "
              f"and then every path again: unchanged {same}; {len(syn.graphs)} graphs "
              f"{sorted(collections.Counter(k[0] for k in syn.graphs).items())}, pool "
              f"{pool:.1f} MiB; K1 ran at {[c[0] for c in shapes]}, {len(unchecked)} of them not "
              f"held in phase 3, {tally.plain} plain-version calls [{smi}]", flush=True)
        if unchecked or tally.plain:
            raise RuntimeError(f"[{tag}] K1 at {unchecked} not held in phase 3, or "
                               f"{tally.plain} plain-version calls")
        for case in cases:
            case.time()
        for case in cases:
            case.profile()
        del cases
    del syns, syn
    torch.cuda.empty_cache()
    print(f"[27 graphs] phase 27 in {time.perf_counter() - start:.1f} s wall [{smi}]", flush=True)
    return op.adain_snake.launches - launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    start = time.perf_counter()

    def done(phase):  # where the smoke's wall goes, against its time limit
        print(f"[{phase} done] {time.perf_counter() - start:.1f} s into the smoke [{smi}]",
              flush=True)

    sys.path.insert(0, str(REPO))
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.inference import Synthesizer
    from styletts2_tpu_torch.ops import adain_snake as op
    from styletts2_tpu_torch import serve
    from styletts2_tpu_torch.utils import set_f32_compute

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    set_f32_compute()  # as the entry points do
    dev = torch.device("cuda")
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    # 2. build
    GRAPHS.install(op)
    t0 = time.perf_counter()
    lib = op.build()
    print(f"[2 build] {lib.relative_to(Path(op.__file__).resolve().parents[2])} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    max_err, timings = kernel_phase(op, dev, smi)  # 3
    done(3)

    # 4. LJSpeech path
    t0 = time.perf_counter()
    syn = Synthesizer(Config(), seed=0, device=dev)
    n_params = sum(p.numel() for p in syn.models.parameters())
    print(f"[4 main] Synthesizer(Config()) on {dev}: {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    natural = syn.synthesize(BENCH_TEXT, seed=0)  # calibration; also the warm-up
    speed = max(len(natural.wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
    for text, seed in REQUESTS:  # warm-up: each request's graphs captured, warm latencies
        syn.synthesize(text, seed=seed, speed=speed)
    with _Counts(op, syn.models["decoder"]) as lj:
        _requests(op, syn, "4 main", smi, CALLS_PER_DECODE, 0, speed=speed)
    lj.check(CALLS_PER_DECODE, "LJSpeech path")
    print(f"[4 main] speed {speed:.3f} (natural {len(natural.wav) / 24000.0:.2f} s); "
          f"{lj.launches} kernel launches, 0 plain-version calls", flush=True)

    # 5. reference: the same weights on the CPU, through the plain version; the
    # card's graphs captured anew with the source's phase zeroed, their draws fed to the CPU
    ref_syn = Synthesizer(Config(), seed=0, device="cpu")
    noise = np.random.default_rng(0).standard_normal((1, 1, 256)).astype(np.float32)
    syn.graphs.clear()
    with _SharedDraws(False) as draws:
        got = syn.synthesize(REQUESTS[1][0], noise=noise, speed=speed)
        draws.feed()
        want = ref_syn.synthesize(REQUESTS[1][0], noise=noise, speed=speed)
        if not draws.kept or draws.left():
            raise RuntimeError(f"[5 reference] {draws.left()} of {len(draws.kept)} draws not taken")
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
    done(5)

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
    for text, seed in REQUESTS:  # warm-up: each request's graphs captured, warm latencies
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
    # 7. serving: the CLI's server
    build_dir = Path(op.__file__).resolve().parents[1] / "_build"
    sv, _ = serve_burst(op, serve, build_dir, smi, "7 serving", ms_speed)
    done(7)

    # 8. LibriTTS references: a request and a batch on the card and on the CPU.
    # The random-init Generator drives its tanh head ~200x into saturation, so
    # the waveform's unsaturated samples would carry the head input's absolute
    # error; both copies get the head gain tests/torch_parity.py gives it.
    # The card's graphs are captured anew with the sines zeroed, their draws fed to the CPU.
    for m in (ms, ms_cpu):
        m.models["decoder"].generator.conv_post.weight_g.mul_(0.01)
    noise = np.random.default_rng(1).standard_normal((1, 1, 256)).astype(np.float32)

    def shared(fn, *args, **kwargs):
        ms.graphs.clear()
        with _SharedDraws(True) as draws:
            got = getattr(ms, fn)(*args, **kwargs)
            draws.feed()
            want = getattr(ms_cpu, fn)(*args, **kwargs)
            if draws.left():
                raise RuntimeError(f"[8 reference] {fn}: {draws.left()} draws not taken")
        ms.graphs.clear()
        return got, want

    got, want = shared("synthesize", REQUESTS[1][0], ref_s=ref_cpu, noise=noise, speed=ms_speed)
    if not np.array_equal(got.pred_dur, want.pred_dur):
        raise RuntimeError(f"libritts durations differ: {got.pred_dur} vs {want.pred_dur}")
    s_err, w_err = _rel(got.s_pred, want.s_pred), _rel(got.wav, want.wav)
    print(f"[8 reference] GPU vs CPU request: durations equal, style rel err {s_err:.2e} (tol 1e-4), "
          f"waveform rel err {w_err:.2e} (tol 1e-3)", flush=True)
    if not (np.isfinite(got.wav).all() and s_err < 1e-4 and w_err < 1e-3):
        raise RuntimeError("libritts request: GPU and CPU disagree")
    texts = [REQUESTS[1][0], "hˈɛloʊ ðɛɹ.", REQUESTS[2][0]]
    refs = np.concatenate([ref_cpu, ref_cpu * 0.5, -ref_cpu])
    got, want = shared("inference_batch", texts, ref_s=refs, speed=ms_speed)
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.isfinite(g).all():
            raise RuntimeError(f"batch item {i}: {g.shape} vs {w.shape} or non-finite")
        errs.append(_rel(g, w))
    print(f"[8 reference] GPU vs CPU inference_batch of 3: lengths equal {[len(g) for g in got]}, "
          f"waveform rel errs {', '.join(f'{e:.2e}' for e in errs)} (tol 1e-3)", flush=True)
    if max(errs) >= 1e-3:
        raise RuntimeError("inference_batch: GPU and CPU disagree")

    del ms, ms_cpu
    done(8)
    bwd_err, bwd_timings = backward_phase(op, dev, smi)  # 9
    done(9)
    train_k1, train_k2, f32_stage1 = training_phase(op, build_dir, smi)  # 10
    done(10)
    training_reference_phase(dev)  # 11
    done(11)
    (stage2_k1, stage2_k2), f32_stage2 = stage2_phase(op, build_dir, smi)  # 12, 13
    done(13)
    stage2_reference_phase(dev)  # 14
    done(14)
    bf16_k1 = bf16_serving_phase(op, serve, build_dir, smi)  # 15
    done(15)
    mp_k1, mp_k2 = bf16_training_phase(op, build_dir, smi, f32_stage1, f32_stage2)  # 16
    done(16)
    ref_k1 = reference_phase(op, serve, dev, build_dir, smi)  # 17
    done(17)
    remat_k1, remat_k2 = remat_phase(op, build_dir, smi)  # 18
    done(18)
    lt2_k1, lt2_k2 = libritts_stage2_phase(op, build_dir, smi, dev)  # 19
    done(19)
    ddp_k1, ddp_k2 = ddp_wavlm_phase(op, build_dir, smi, dev)  # 20, 21
    done(21)
    fid_k1, fid_k2 = fidelity_phase(op, smi)  # 22
    done(22)
    tp_k1, tp_k2 = tp_phase(op, build_dir, smi)  # 23
    done(23)
    bench_k1, bench_k2 = bench_phase(op, smi)  # 24
    done(24)
    nb_k1, nb_k2 = notebook_phase(op, smi)  # 25
    done(25)
    fused_k1, syns = fused_phase(op, smi)  # 26
    done(26)
    graphs_k1 = staged_graphs_phase(op, smi, syns)  # 27
    done(27)

    def row(t, shape, dtype):
        return {"shape": list(shape), "dtype": dtype, "ms": t["cold"][0], "plain_ms": t["cold"][1],
                "warm_ms": t["warm"][0], "bound_ms": t["bound"]}

    # f32: a server batch's last stage, and training; bf16: the same shapes
    fwd_shape, bwd_shape = (8, 32, 192000), (16, 128, 24001)
    fwd, bwd = timings[fwd_shape, "float32"], bwd_timings[bwd_shape, "float32"]
    print(json.dumps({"kernels": [{
        "name": "adain_snake", "route": "cuda",
        "source": "styletts2_tpu_torch/csrc/adain_snake.cu",
        "replaces": "styletts2_tpu/ops/pallas_kernels.py:38",
        "launches": lj.launches + lt.launches + sv.launches + train_k1 + stage2_k1 + bf16_k1 + mp_k1
        + ref_k1 + remat_k1 + lt2_k1 + ddp_k1 + fid_k1 + tp_k1 + bench_k1 + nb_k1 + fused_k1
        + graphs_k1,
        "max_abs_err": max_err["float32"],
        "ms": fwd["cold"][0], "plain_ms": fwd["cold"][1], "bound_ms": fwd["bound"],
        "bound_by": "bytes", "library_ms": None, "shape": list(fwd_shape),
        "bf16": dict(row(timings[fwd_shape, "bfloat16"], fwd_shape, "bfloat16"),
                     max_abs_err=max_err["bfloat16"]),
    }, {
        "name": "adain_snake_bwd", "route": "cuda",
        "source": "styletts2_tpu_torch/csrc/adain_snake.cu",
        "replaces": "styletts2_tpu/ops/pallas_kernels.py:117",
        "launches": train_k2 + stage2_k2 + mp_k2 + remat_k2 + lt2_k2 + ddp_k2 + fid_k2 + tp_k2
        + bench_k2 + nb_k2,
        "max_abs_err": bwd_err["float32"],
        "ms": bwd["cold"][0], "plain_ms": bwd["cold"][1], "bound_ms": bwd["bound"],
        "bound_by": "bytes", "library_ms": None, "shape": list(bwd_shape),
        "bf16": dict(row(bwd_timings[bwd_shape, "bfloat16"], bwd_shape, "bfloat16"),
                     max_abs_err=bwd_err["bfloat16"]),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-child"]:
        train_child(sys.argv[2:])
    elif sys.argv[1:2] == ["--tp-child"]:
        tp_child(sys.argv[2:])
    else:
        main()
