"""The synthesis entry: one run of a cell whose configuration is a
StyleTTS 2 Synthesizer (the entry of every configuration that names no
`harness`).

Set-up: the weights drawn on the card from the seed (`weights`), one speed
for the run's requests (`reference.synth.speed_for`), the program's
Synthesizer built from those weights and, for the HTTP cells, its
TTSServer (the CLI's defaults from the cell's file, voices from seeded
reference waves written under TMPDIR); then every CUDA-graph key the
cell's traffic can reach is captured (`warm`) and the load generator
process waits. The window: the cell's requests for `seconds`, each
request's latency at the client. Then the card's peak memory is read, the
program is freed, the reference recomputes a draw of the window's calls
(`check`), and with `trace` the per-layer readers read the calls, the
counters and the profiler's trace of a slice of the window.
"""

from __future__ import annotations

import atexit
import copy
import gc
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import wave
import zipfile
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, harness, spec, traffic, weights, yardstick
from benchmark.harness import CALL, Tracer, log
from benchmark.reference import synth
from benchmark.reference.model import Reference, param_specs

SR, SAMPLES_PER_FRAME, FRAME_BUCKET, TEXT_BUCKET = 24000, 600, 100, 64
WAIT_S = 60.0  # how long after the window a run waits for answers
FAILURES_LOGGED = 5  # failed requests whose cause a run logs


def _bucket(n: int, step: int) -> int:
    return max(step, -(-int(n) // step) * step)


class Recorder:
    """The Synthesizer as the server sees it: each `inference_batch` call is
    timed, spanned ("bench.call") and recorded with its batch."""

    def __init__(self, syn, trim: int, tracer: Tracer):
        self._syn, self._trim, self._tracer = syn, trim, tracer
        self.calls: List[dict] = []

    def __getattr__(self, name):
        return getattr(self._syn, name)

    def inference_batch(self, texts, ref_s=None, **kw):
        traced = self._tracer.before()
        t0 = time.monotonic()
        with record_function(CALL):
            wavs = self._syn.inference_batch(texts, ref_s=ref_s, **kw)
        t1 = time.monotonic()
        self.calls.append({"t0": t0, "t1": t1, "texts": list(texts), "traced": traced,
                           "frames": [(len(w) + self._trim) // SAMPLES_PER_FRAME for w in wavs]})
        self._tracer.after(t1)
        return wavs


class Run:
    """What the per-layer readers read (`metrics/*.py`)."""

    def __init__(self, cell, seed: int, seconds: float, cfg: dict):
        self.cell, self.seed, self.seconds, self.cfg = cell, seed, seconds, cfg
        self.window = (0.0, 0.0)  # monotonic seconds
        self.requests: List[dict] = []  # due, sent, done, ok, audio_s
        self.calls: List[dict] = []  # t0, t1, texts, tokens, frames, traced
        self.counters: Dict[str, Dict] = {}  # name -> {"before": x, "after": y}
        self.trace: Optional[list] = None  # Chrome trace events of the traced slice
        self.device_name = ""
        self.peak_flops = 0.0
        self._flops: Optional[Callable] = None
        self.reference: Optional[Reference] = None

    def flops(self) -> Callable:
        """FLOPs of one request at (tokens, frames): `yardstick.FlopModel`."""
        if self._flops is None:
            self._flops = yardstick.FlopModel.fit(self.reference)
        return self._flops

    def calls_in_window(self) -> List[dict]:
        lo, hi = self.window
        return [c for c in self.calls if c["t0"] >= lo and c["t1"] <= hi]


# ---------------------------------------------------------------------------
# set-up

def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    sd = weights.make(param_specs(cfg), seed, device)
    for name, value in cfg.get("weight_overrides", {}).items():
        sd[name].fill_(value)
    return sd


def write_voices(waves: Dict[str, np.ndarray], where: str) -> None:
    for name, w in waves.items():
        with wave.open(os.path.join(where, f"{name}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(synth.pcm16(w).tobytes())


def read_voice(path: str) -> np.ndarray:
    with wave.open(path) as f:
        return np.frombuffer(f.readframes(f.getnframes()), np.int16).astype(np.float32) / 32768.0


def warm(call: Callable, tok_range, speed: float, pad: int, batches) -> int:
    """Capture every (batch, text bucket, frame bucket) the traffic can
    reach. At the run's speed an answer's frames are its tokens times the
    frames per token (measured first: each text bucket's middle length in a
    batch of the largest size, every row another voice) plus the pad; so
    for each text bucket, each frame bucket its lengths reach at the least
    and the most frames per token seen, and each batch size, a batch of the
    length in the bucket whose frames fall nearest the frame bucket's middle
    is synthesized (a miss moves the length one token a try, three tries).
    `call(texts, speed)` returns the answers' frames. Returns the number of
    calls."""
    lo, hi = tok_range
    buckets = [T for T in range(_bucket(lo, TEXT_BUCKET), _bucket(hi, TEXT_BUCKET) + 1,
                                TEXT_BUCKET)]
    span = {T: (max(lo, T - TEXT_BUCKET + 1), min(hi, T)) for T in buckets}
    text = lambda L: traffic.text_of(L - 1, random.Random(L))
    ratios = []
    for T in buckets:
        L = sum(span[T]) // 2
        ratios += [(f - pad) / L for f in call([text(L)] * max(batches), speed)]
    r_lo, r_hi, r_mid = min(ratios), max(ratios), float(np.median(ratios))
    n = len(buckets)
    for T in buckets:
        L_lo, L_hi = span[T]
        frames = {_bucket(r * L + pad, FRAME_BUCKET) for L in range(L_lo, L_hi + 1)
                  for r in (r_lo, r_hi)}
        for F in sorted(frames):
            L0 = min(L_hi, max(L_lo, round((F - FRAME_BUCKET / 2 - pad) / r_mid)))
            for B in batches:
                L = L0
                for _ in range(3):
                    got = _bucket(max(call([text(L)] * B, speed)), FRAME_BUCKET)
                    n += 1
                    if got == F:
                        break
                    L = min(L_hi, max(L_lo, L + (1 if got < F else -1)))
    return n


# ---------------------------------------------------------------------------
# the window

def _reap(p: subprocess.Popen) -> None:
    """At exit, a load generator still running (a run that failed) is ended."""
    if p.poll() is None:
        p.kill()
    p.wait()


def _loadgen(plan: dict) -> subprocess.Popen:
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(plan, f)
    p = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen", path], cwd=str(spec.ROOT),
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    p.plan_path = path
    atexit.register(_reap, p)
    if p.stdout.readline().strip() != "ready":
        raise RuntimeError("the load generator did not start")
    return p


def _set_up(cell: spec.Cell, seed: int, scheds: List[list], dev: torch.device,
            tracer: Tracer) -> SimpleNamespace:
    """Everything before the window but the server's start: weights, the
    reference, voices, the run's speed, the Synthesizer (and its TTSServer
    for an HTTP cell), and the capture of every key that a request of
    `scheds` (the schedules this process will offer) can reach."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer
    from styletts2_tpu_torch.serve import TTSServer

    cfg, wl = cell.config, cell.workload
    s = SimpleNamespace(ms=bool(cfg["model_params"]["multispeaker"]), smp=cfg["sampler"],
                        http=wl["entry"] == "http", server=None, rec=None)
    s.trim, s.pad = (50, 0) if s.ms else (0, 5)
    smp = s.smp
    sd = make_weights(cfg, seed, dev)
    s.ref = ref = Reference(cfg, sd)
    s.tmp = tempfile.mkdtemp(prefix="bench_")
    s.ref_styles = {}
    if wl.get("voices"):
        write_voices(traffic.voice_waves(wl, seed), s.tmp)
        s.ref_styles = {v: ref.style(read_voice(os.path.join(s.tmp, f"{v}.wav"))).cpu().numpy()
                        for v in traffic.voice_names(wl)}
    rng = random.Random(seed ^ 0xCA1)
    calib = traffic.texts(8, wl["tokens"], rng)
    names = sorted(s.ref_styles)
    calib_feats = (np.concatenate([s.ref_styles[names[i % len(names)]] for i in range(8)])
                   if s.ms else None)
    s.speed = speed = synth.speed_for(ref, calib, cfg["durations"]["frames_per_token"], seed,
                                      smp["sigma_data"], calib_feats)
    s.syn = syn = Synthesizer(Config.from_dict(cfg), state_dict=sd, seed=seed, device=str(dev),
                              sigma_data=smp["sigma_data"])
    lengths = [r.tokens for sched in scheds for r in sched]
    tok_range = (min(min(lengths), 1 + wl["tokens"]["min"]), max(lengths))
    s.kw = kw = dict(alpha=smp["alpha"], beta=smp["beta"], diffusion_steps=smp["diffusion_steps"],
                     embedding_scale=smp["embedding_scale"])
    trim = s.trim
    if s.http:
        voices = TTSServer.load_voices(syn, s.tmp) if wl.get("voices") else None
        s.rec = Recorder(syn, trim, tracer)
        srv = wl["server"]
        s.server = TTSServer(s.rec, voices, srv["max_batch"], srv["window_ms"])

        names = sorted(voices or {})

        def call(texts, sp):
            refs = None if not names else np.concatenate(
                [voices[names[i % len(names)]] for i in range(len(texts))])
            return [(len(w) + trim) // SAMPLES_PER_FRAME
                    for w in syn.inference_batch(texts, ref_s=refs, speed=sp, **kw)]

        s.n_warm = warm(call, tok_range, speed, s.pad, range(1, srv["max_batch"] + 1))
    else:
        def call(texts, sp):
            w, _ = syn.inference(texts[0], speed=sp, **kw)
            return [(len(w) + trim) // SAMPLES_PER_FRAME]

        s.n_warm = warm(call, tok_range, speed, s.pad, [1])
    return s


def _plan(wl: dict, port: int, seconds: float, sched: list, speed: float) -> dict:
    """The load generator's plan: each request's id, due time and body."""
    bodies = []
    for r in sched:
        body = {"text": r.text, "speed": speed}
        if r.voice:
            body["voice"] = r.voice
        bodies.append([r.id, r.due, json.dumps(body, ensure_ascii=False)])
    load = wl["load"]
    return {"port": port, "kind": load["kind"], "clients": load.get("clients", 0),
            "seconds": seconds, "wait_s": WAIT_S, "requests": bodies}


def _http_window(lp: subprocess.Popen, sched: list, t0: float, end: float) -> List[dict]:
    """The load generator's window from `t0` to `end`: each request due (or
    sent) in it, with its start, its last byte and its audio; the first
    failures' causes logged."""
    lp.stdin.write(f"go {t0!r}\n")
    lp.stdin.flush()
    out = json.loads(lp.stdout.readline())
    res = {r["id"]: r for r in out["results"]}
    late = out["late_s"]
    if late:
        log(f"load generator: {len(late)} sent, late p50 {1e3 * np.median(late):.3f} ms, "
            f"max {1e3 * max(late):.3f} ms")
    why, requests = [], []
    for r in sched:
        x = res.get(r.id)
        ok = x is not None and x["status"] == 200
        start = t0 + r.due if r.due is not None else (x["sent"] if x else None)
        if start is None or start >= end:
            continue  # a closed loop's request never sent in the window
        if not ok:
            why.append(f"request {r.id}: " + (x["error"] if x else "no answer"))
        audio = (x["bytes"] - 44) / 2 / SR if ok else 0.0
        requests.append({"id": r.id, "start": start, "done": x["done"] if x else None,
                         "ok": ok, "audio_s": audio})
    for w in why[:FAILURES_LOGGED]:
        log(w)
    if len(why) > FAILURES_LOGGED:
        log(f"... {len(why) - FAILURES_LOGGED} more failed")
    return requests


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, keep: Optional[dict] = None, control: bool = False) -> dict:
    """One run of `cell` (`t_start`: the process's start on
    `time.perf_counter`, from which set-up is counted; `keep["run"]`: the
    `Run` the readers read); with `control`, the drawn calls' answers are
    the reference's own computed with TF32 on (the control of PERF.md's
    "How correct is decided"), judged as the program's are."""
    cfg, wl = cell.config, cell.workload
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, cfg)
    if keep is not None:
        keep["run"] = run
    sched = traffic.schedule(wl, seed, seconds)
    tracer = Tracer(trace)
    s = _set_up(cell, seed, [sched], dev, tracer)
    ms, trim, pad, smp, http = s.ms, s.trim, s.pad, s.smp, s.http
    ref, syn, server, rec, tmp, speed, kw = s.ref, s.syn, s.server, s.rec, s.tmp, s.speed, s.kw
    ref_styles, n_warm = s.ref_styles, s.n_warm
    del s  # the program is freed before the reference runs, below
    run.reference = ref
    lp = None
    if http:
        port = server.start_background()
        lp = _loadgen(_plan(wl, port, seconds, sched, speed))
    if dev.type == "cuda":
        if trace:
            harness.load_cupti(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.counters["graphs"] = {"before": len(syn.graphs)}
    keys_before = set(syn.graphs)
    if http:
        run.counters["batcher"] = {"before": dict(server.batcher.stats)}
    log(f"set-up: speed {speed:.4f}, {n_warm} warm-up calls, {len(syn.graphs)} graphs")

    # ---- the window
    t0 = time.monotonic() + 0.05
    setup_s = time.perf_counter() + (t0 - time.monotonic()) - t_start
    end = t0 + seconds
    run.window = (t0, end)
    tracer.start_at = t0 + harness.TRACE_AT * seconds
    if http:
        run.requests = _http_window(lp, sched, t0, end)
        run.calls = rec.calls
    else:
        i, calls = 0, []
        while time.monotonic() < end:
            r = sched[i % len(sched)]
            traced = tracer.before()
            a = time.monotonic()
            try:
                with record_function(CALL):
                    w, _ = syn.inference(r.text, speed=speed, **kw)
                ok = True
            except Exception as e:  # reported as a failed request
                log(f"request {r.id}: {type(e).__name__}: {e}")
                w, ok = np.zeros(0, np.float32), False
            b = time.monotonic()
            tracer.after(b)
            calls.append({"t0": a, "t1": b, "texts": [r.text], "traced": traced, "ids": [r.id],
                          "frames": [(len(w) + trim) // SAMPLES_PER_FRAME], "wav": w})
            run.requests.append({"id": r.id, "start": a, "done": b, "ok": ok,
                                 "audio_s": len(w) / SR})
            i += 1
        run.calls = calls
    tracer.stop()
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    run.counters["graphs"]["after"] = len(syn.graphs)
    if http:
        run.counters["batcher"]["after"] = dict(server.batcher.stats)
    per_token = [(f - pad) / len(synth.encode(t)) for c in run.calls
                 for f, t in zip(c["frames"], c["texts"])]
    log(f"window: {len(run.requests)} requests, {len(run.calls)} calls, captured "
        f"{sorted(k for k in syn.graphs if k not in keys_before)}; frames per token "
        f"{min(per_token, default=0):.3f}-{max(per_token, default=0):.3f}")
    run.trace = tracer.events()
    if run.trace is not None:
        log(f"trace: profiler start {tracer.start_s:.3f} s, {tracer.calls} calls traced, "
            f"{sum(e.get('name') == 'bench.call' for e in run.trace)} call spans, "
            f"{sum(e.get('cat') == 'kernel' for e in run.trace)} kernels")

    # ---- the outputs of the window, judged
    text_id = {r.text: r.id for r in sched}
    voice_of = {r.id: r.voice for r in sched}
    done_ok = {q["id"] for q in run.requests if q["ok"]}
    for c in run.calls:
        c.setdefault("ids", [text_id[t] for t in c["texts"]])
        c["tokens"] = [len(synth.encode(t)) for t in c["texts"]]
    finished = [c for c in run.calls if c["t0"] >= t0 and c["t0"] < end
                and all(i in done_ok for i in c["ids"])]
    drawn = check.draw(finished, wl["check"]["batches"], seed)
    answers: Dict[int, np.ndarray] = {}
    if http:
        ids = sorted({i for c in drawn for i in c["ids"]})
        path = os.path.join(tmp, "answers.npz")
        lp.stdin.write("dump " + path + " " + " ".join(map(str, ids)) + "\n")
        lp.stdin.flush()
        lp.stdout.readline()
        with zipfile.ZipFile(path) as z:
            for i in ids:
                answers[i] = np.load(z.open(f"{i}.npy"))
        lp.stdin.close()
        lp.wait(timeout=30)
        os.remove(lp.plan_path)
        server.close()
    else:
        for c in drawn:
            answers[c["ids"][0]] = c["wav"]
    for c in run.calls:
        c.pop("wav", None)
    del syn
    server = rec = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged = [{"texts": c["texts"], "ids": c["ids"], "speed": speed, "seed": 0,
               "feats": (np.concatenate([ref_styles[voice_of[i]] for i in c["ids"]])
                         if ms else None)} for c in drawn]
    if control:
        answers = tf32_answers(ref, judged, http, smp)
    numbers = check.judge(ref, judged, answers, trim=trim, wav16=http, sampler=smp)
    attempted = len(run.requests)
    failed = sum(1 for q in run.requests if not q["ok"])
    numbers["failed"] = failed
    correct = bool(drawn) and check.verdict(numbers)

    # ---- metrics
    if trace and dev.type == "cuda":
        run.device_name = torch.cuda.get_device_name(0)
        run.peak_flops = yardstick.peak_f32(run.device_name)
    result = harness.result(cell, trace, run, correct=correct, attempted=attempted, failed=failed,
                            e2e={} if trace else dict(harness.end_to_end(run.requests, end,
                                                                         seconds),
                                                      setup_s=setup_s),
                            dev=dev, peak=peak, numbers=numbers, limits=check.LIMITS)
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    os.rmdir(tmp)
    return result


def sweep(cell: spec.Cell, seed: int, seconds: float, rates: List[float], repeats: int,
          device: str = "cuda") -> Iterator[dict]:
    """Windows of an open-loop HTTP cell at each of `rates`, `repeats`
    windows a rate, after one set-up that captures every key the rates'
    schedules reach (each window a load generator of its own; nothing is
    judged). Yields one dict a window: its end-to-end metrics, failures,
    batch mean, the Batcher's window waits, the graphs it captured, and the
    later half's median latency over the earlier half's (a queue that
    grows reads well above 1)."""
    wl = cell.workload
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scheds = {}
    for rate in rates:
        w = copy.deepcopy(wl)
        w["load"]["rate_per_s"] = rate
        scheds[rate] = traffic.schedule(w, seed, seconds)
    s = _set_up(cell, seed, list(scheds.values()), dev, Tracer(False))
    port = s.server.start_background()
    log(f"set-up: speed {s.speed:.4f}, {s.n_warm} warm-up calls, {len(s.syn.graphs)} graphs")
    try:
        for rate in rates:
            for k in range(repeats):
                lp = _loadgen(_plan(wl, port, seconds, scheds[rate], s.speed))
                before, graphs = dict(s.server.batcher.stats), len(s.syn.graphs)
                t0 = time.monotonic() + 0.05
                end = t0 + seconds
                reqs = _http_window(lp, scheds[rate], t0, end)
                lp.stdin.close()
                lp.wait(timeout=30)
                os.remove(lp.plan_path)
                after = s.server.batcher.stats
                lat = [(q["done"] - q["start"]) * 1e3
                       for q in sorted(reqs, key=lambda q: q["start"]) if q["ok"]]
                h = len(lat) // 2
                yield {"rate_per_s": rate, "window": k,
                       **harness.end_to_end(reqs, end, seconds),
                       "attempted": len(reqs), "failed": sum(not q["ok"] for q in reqs),
                       "batch_mean": (after["requests"] - before["requests"])
                       / max(1, after["batches"] - before["batches"]),
                       "window_waits": after["window_waits"] - before["window_waits"],
                       "captured": len(s.syn.graphs) - graphs,
                       "later_over_earlier_median": float(np.median(lat[h:]) / np.median(lat[:h]))
                       if h else float("nan")}
    finally:
        s.server.close()
        shutil.rmtree(s.tmp, ignore_errors=True)


def tf32_answers(ref: Reference, judged: List[dict], wav16: bool, smp: dict) -> Dict[int, np.ndarray]:
    """The reference's answers to the judged calls with TF32 on in cuBLAS
    and cuDNN: the precision below the configuration's."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        out = {}
        for c in judged:
            rows = synth.synthesize(ref, c["texts"], c["feats"], alpha=smp["alpha"],
                                    beta=smp["beta"], steps=smp["diffusion_steps"],
                                    scale=smp["embedding_scale"], speed=c["speed"],
                                    seed=c["seed"], sigma_data=smp["sigma_data"], wav16=wav16)
            out.update({i: row.candidates[0] for i, row in zip(c["ids"], rows)})
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

