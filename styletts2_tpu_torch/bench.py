"""Synthesis benchmark of the PyTorch port (the repository's `bench.py`):
single-stream RTF of the LJSpeech config as the headline, batched and
bf16-decoder numbers in "extra".

    python -m styletts2_tpu_torch.bench [--device cuda]
    STYLETTS2_BENCH_FULL=1 python -m styletts2_tpu_torch.bench [--device cuda]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
`value` is single-stream RTF (audio seconds / wall seconds) of `Config()`
(iSTFTNet, full width, seeded random weights, 5 diffusion steps) on ~8 s
utterances, the MEDIAN over STYLETTS2_BENCH_PROCS (default 3)
process-separated runs: this process and N - 1 `--headline-worker`
subprocesses, each building its own Synthesizer; the runs ride in
extra.rtf_{runs,min,max}. vs_baseline is RTF / 20, the fraction of the 20x
real-time per-card target of BASELINE.json. The utterance is pinned to ~8 s
through the speed control (`calibrate_speed`): random-init durations run
~8x long. Each run times 20 calls after a warm-up (`headline_once`); a call
returns the waveform on the host, so it ends in a device sync. "extra" adds
the latency percentiles, the batched aggregate RTF (`inference_batch`,
B = 8), the single-dispatch path's RTF and p50 latency (`inference_fused`
at its 600-frame budget, one CUDA graph on a card; the first call
captures it; `fused_rtf`, `fused_latency_p50_ms`) and the bf16 decoder's
single-stream RTF.

STYLETTS2_BENCH_FULL=1 prints instead the extended matrix
(`bench_extended`, indented JSON): LibriTTS zero-shot (10 steps, CFG 1.5),
B = 32 and long-form with a HiFi-GAN decoder, and the steps x CFG sweep.

Where it departs from the JAX bench: no PCM16 output and no compile cache
(nothing is compiled but the CUDA graph, at its first call), and no caught
failures: a failing phase or worker raises, so the bench never exits 0
with a phase missing. It runs on the card unless `--device cpu` asks for
the CPU, in f32 with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

SR = 24000
TARGET_AUDIO_SEC = 8.0
STEPS = 5
N_RUNS = 20
TEXT = (
    "ðɪ kwˈɪk bɹˈaʊn fˈɑːks dʒˈʌmps ˈoʊvɚ ðə lˈeɪzi dˈɔːɡ, "
    "ænd ðə sˈʌn sˈɛts slˈoʊli bɪhˈaɪnd ðə mˈaʊntənz."
)


def _timed(fn: Callable[[], object], n: int) -> np.ndarray:
    """Wall seconds of `n` calls of `fn`, each on its own."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    return np.asarray(lat)


def calibrate_speed(syn, text: str, **kw) -> Tuple[float, float]:
    """(speed, natural seconds): the speed that pins `text` to ~8 s of
    audio, from one seed-0 call at speed 1 (`kw` goes to `inference`):
    max(natural / 8, 1)."""
    wav, _ = syn.inference(text, seed=0, **kw)
    natural = len(wav) / SR
    return max(natural / TARGET_AUDIO_SEC, 1.0), natural


def headline_once(syn, text: str = TEXT, steps: int = STEPS,
                  n_runs: int = N_RUNS) -> Tuple[Dict, float]:
    """One single-stream measurement on `syn`: calibrate the speed, one
    warm-up call, then `n_runs` timed calls. Returns (the JAX bench's stats
    dict, the speed)."""
    speed, natural = calibrate_speed(syn, text, diffusion_steps=steps)

    def single():
        return syn.inference(text, diffusion_steps=steps, seed=0, speed=speed)[0]

    audio_sec = len(single()) / SR
    lat = _timed(single, n_runs)
    stats = {
        "rtf": round(audio_sec / float(np.mean(lat)), 3),
        "audio_sec_per_utt": round(audio_sec, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
        "latency_p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 1),
        "latency_mean_ms": round(float(np.mean(lat)) * 1e3, 1),
        "n_runs": n_runs,
        "natural_uncalibrated_sec": round(natural, 2),
    }
    return stats, speed


def _synthesizer(device: str, **kw):
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer

    return Synthesizer(Config(), seed=0, device=device, **kw)


def _backend(device: str) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return f"cuda {torch.cuda.get_device_name(torch.device(device))}"
    return torch.device(device).type


def _worker_rtf(device: str) -> float:
    """The headline RTF of one `--headline-worker` subprocess."""
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "styletts2_tpu_torch.bench", "--headline-worker",
                          "--device", device], capture_output=True, text=True, timeout=900,
                         cwd=root, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"headline worker exited {out.returncode}:\n{out.stderr[-4000:]}")
    return float(json.loads(out.stdout.strip().splitlines()[-1])["rtf"])


def bench(device: str = "cuda", n_procs: int = 3) -> Dict:
    """The headline and its extras as the one JSON object `main` prints."""
    syn = _synthesizer(device)  # builds the kernel before any worker starts
    stats, speed = headline_once(syn)
    rtf_runs = [stats["rtf"]] + [_worker_rtf(device) for _ in range(n_procs - 1)]
    rtf = float(np.median(rtf_runs))
    extra = dict(stats)
    del extra["rtf"]
    extra.update({"rtf_runs": rtf_runs, "rtf_min": min(rtf_runs), "rtf_max": max(rtf_runs),
                  "n_procs": len(rtf_runs)})

    # batched serving: 8 streams in one inference_batch call
    texts = [TEXT] * 8

    def batched():
        return syn.inference_batch(texts, diffusion_steps=STEPS, speed=speed)

    batch_audio = sum(len(w) for w in batched()) / SR  # the first call warms up
    blat = _timed(batched, 8)
    extra["batched_B8_rtf"] = round(batch_audio / float(np.mean(blat)), 1)
    extra["batched_B8_latency_ms"] = round(float(np.mean(blat)) * 1e3, 1)

    # the single-dispatch path (a CUDA graph on a card), at the same speed
    def fused():
        return syn.inference_fused(TEXT, diffusion_steps=STEPS, seed=0, speed=speed)

    fwav = fused()  # captures the graph
    flat = _timed(fused, 10)
    extra["fused_rtf"] = round(len(fwav) / SR / float(np.mean(flat)), 1)
    extra["fused_latency_p50_ms"] = round(float(np.percentile(flat, 50)) * 1e3, 1)

    # the bf16 decoder, single stream, at the f32 path's speed
    syn16 = _synthesizer(device, decoder_dtype="bfloat16")

    def single16():
        return syn16.inference(TEXT, diffusion_steps=STEPS, seed=0, speed=speed)[0]

    w16 = single16()
    l16 = _timed(single16, 10)
    extra["bf16_decoder_rtf"] = round(len(w16) / SR / float(np.mean(l16)), 1)
    dtype = str(syn.decoder_dtype).split(".")[-1]
    return {
        "metric": (f"single-stream synthesis RTF (audio-sec/wall-sec), LJSpeech iSTFTNet, "
                   f"{STEPS} diffusion steps, ~{stats['audio_sec_per_utt']:.1f}s utterances, "
                   f"staged pipeline, decoder {dtype}, {_backend(device)}"),
        "value": round(rtf, 3),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 20.0, 4),
        "extra": extra,
    }


def bench_extended(device: str = "cuda") -> Dict:
    """BASELINE.json configs 2-4, as the JAX bench's `bench_extended`:
      2. LibriTTS zero-shot: `libritts_config()`, the style of a seeded 3 s
         reference wave, 10 diffusion steps, embedding_scale 1.5;
      3. B = 32 batched synthesis (4 texts of other lengths x 8) and a
         4-sentence long-form passage, `Config()` with a HiFi-GAN decoder
         at rates 10, 5, 3, 2;
      4. the diffusion steps x CFG scale sweep on `Config()`, each setting's
         first call and the mean style distance between step counts."""
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.inference import Synthesizer

    out = {}
    # ---- config 2: LibriTTS zero-shot
    syn_ms = Synthesizer(libritts_config(), seed=0, device=device)
    rng = np.random.default_rng(0)
    ref_wav = rng.standard_normal(SR * 3).astype(np.float32) * 0.05
    ref_s = syn_ms.compute_style(ref_wav)
    speed_ms, _ = calibrate_speed(syn_ms, TEXT, ref_s=ref_s, diffusion_steps=10,
                                  embedding_scale=1.5)

    def zs():
        return syn_ms.inference(TEXT, ref_s=ref_s, diffusion_steps=10, embedding_scale=1.5,
                                seed=0, speed=speed_ms)[0]

    w = zs()
    lat = _timed(zs, 10)
    out["libritts_zeroshot"] = {
        "diffusion_steps": 10, "embedding_scale": 1.5,
        "audio_sec": round(len(w) / SR, 2),
        "rtf": round(len(w) / SR / float(np.mean(lat)), 1),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
    }
    del syn_ms

    # ---- config 3: B = 32 batched + long-form, HiFi-GAN decoder
    cfg_hg = Config()
    cfg_hg.model_params.decoder.type = "hifigan"
    cfg_hg.model_params.decoder.upsample_rates = [10, 5, 3, 2]
    cfg_hg.model_params.decoder.upsample_kernel_sizes = [20, 10, 6, 4]
    syn_hg = Synthesizer(cfg_hg, seed=0, device=device)
    texts = [
        TEXT,
        "ðɪs ɪz ɐ ʃˈɔːɹtɚ sˈɛntəns.",
        "wˈʌn mˈoːɹ ˈʌtɚɹəns wɪð ɐ dˈɪfɹənt lˈɛŋkθ fɔːɹ mˈæskɪŋ.",
        "ænd ɐ fˈoːɹθ wˈʌn tə ɹˈaʊnd ˈaʊt ðə bˈʌkɪts hˈɪɹ tədˈeɪ.",
    ] * 8
    speed_hg, _ = calibrate_speed(syn_hg, texts[0], diffusion_steps=5)

    def b32():
        return syn_hg.inference_batch(texts, diffusion_steps=5, speed=speed_hg)

    batch_audio = sum(len(x) for x in b32()) / SR
    blat = _timed(b32, 4)
    out["batched_B32_hifigan"] = {
        "batch": 32,
        "audio_sec_total": round(batch_audio, 1),
        "aggregate_rtf": round(batch_audio / float(np.mean(blat)), 1),
        "batch_latency_ms": round(float(np.mean(blat)) * 1e3, 1),
    }
    para = ("ðɪs ɪz ðə fˈɜːst sˈɛntəns. hˈɪɹ ɪz ɐ sˈɛkənd wˈʌn. "
            "ðə θˈɜːd kˈæɹiz ðə stˈaɪl fˈoːɹwɚd. ænd ðə lˈæst klˈoʊzɪz ɪt.")

    def lf():
        return syn_hg.long_form(para, t=0.7, diffusion_steps=5, speed=speed_hg)

    w_lf = lf()
    llat = _timed(lf, 4)
    out["long_form_hifigan"] = {
        "sentences": 4,
        "audio_sec": round(len(w_lf) / SR, 2),
        "rtf": round(len(w_lf) / SR / float(np.mean(llat)), 1),
    }
    del syn_hg

    # ---- config 4: diffusion steps x CFG scale sweep (LJSpeech)
    syn = Synthesizer(Config(), seed=0, device=device)
    speed, _ = calibrate_speed(syn, TEXT, diffusion_steps=5)
    sweep, styles = [], {}
    for steps in (3, 5, 10):
        for scale in (1.0, 1.5):
            def call(steps=steps, scale=scale):
                return syn.inference(TEXT, diffusion_steps=steps, embedding_scale=scale, seed=0,
                                     speed=speed)

            t0 = time.perf_counter()
            w, s_out = call()
            first = time.perf_counter() - t0
            lat = _timed(call, 5)
            styles[steps, scale] = np.asarray(s_out)
            sweep.append({
                "steps": steps, "scale": scale,
                "rtf": round(len(w) / SR / float(np.mean(lat)), 1),
                "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
                "first_call_s": round(first, 2),
            })
    out["diffusion_sweep"] = {
        "grid": sweep,
        "style_mean_abs_delta_3v5": round(float(np.abs(styles[3, 1.0] - styles[5, 1.0]).mean()), 4),
        "style_mean_abs_delta_5v10": round(float(np.abs(styles[5, 1.0] - styles[10, 1.0]).mean()), 4),
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--headline-worker", action="store_true",
                    help="one process-separated headline run: print its stats as JSON")
    args = ap.parse_args(argv)
    from styletts2_tpu_torch.utils import set_f32_compute

    set_f32_compute()
    if args.headline_worker:
        print(json.dumps(headline_once(_synthesizer(args.device))[0]))
    elif os.environ.get("STYLETTS2_BENCH_FULL"):
        print(json.dumps(bench_extended(args.device), indent=1))
    else:
        n_procs = max(int(os.environ.get("STYLETTS2_BENCH_PROCS", "3")), 1)
        print(json.dumps(bench(args.device, n_procs)))


if __name__ == "__main__":
    main()
