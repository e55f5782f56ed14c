"""One run of one benchmark cell on the card.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Set-up: the cell's configuration and traffic by name (`spec`), the
weights drawn on the card from the seed (`weights`), one speed for the
run's requests (`reference.synth.speed_for`), the program's Synthesizer
built from those weights and, for the HTTP cells, its TTSServer (the CLI's
defaults from the cell's file, voices from seeded reference waves written
under TMPDIR); then every CUDA-graph key the cell's traffic can reach is
captured (`warm`) and the load generator process waits. The window: the
cell's requests for S seconds, each request's latency at the client. Then
the card's peak memory is read, the program is freed, the reference
recomputes a draw of the window's calls (`check`), and with --trace 1 the
per-layer readers read the calls, the counters and the profiler's trace of
a slice of the window. The last line of standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import atexit  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import wave  # noqa: E402
import zipfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "styletts2_tpu")
SR, SAMPLES_PER_FRAME, FRAME_BUCKET, TEXT_BUCKET = 24000, 600, 100, 64
# the traced slice: from 30% of the window, ~2 s of calls or 12 calls, whichever ends first
TRACE_AT, TRACE_S, TRACE_CALLS = 0.3, 2.0, 12
WAIT_S = 60.0  # how long after the window a run waits for answers


def _fixed_caches(root: Path) -> None:
    """Every kernel cache inside the checkout, at fixed paths (K1's nvcc
    build goes to the program's own styletts2_tpu_torch/_build/)."""
    base = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


_fixed_caches(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from benchmark import check, spec, traffic, weights, yardstick  # noqa: E402
from benchmark.reference import synth  # noqa: E402
from benchmark.reference.model import Reference, param_specs  # noqa: E402


def _bucket(n: int, step: int) -> int:
    return max(step, -(-int(n) // step) * step)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Tracer:
    """The profiler over a slice of the window, started and stopped at call
    boundaries on the thread that calls the program."""

    def __init__(self, on: bool):
        self.on, self.prof, self.state = on, None, "wait"
        self.start_at = math.inf
        self.t_start = None
        self.calls = 0

    def before(self) -> bool:
        if self.on and self.state == "wait" and time.monotonic() >= self.start_at:
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                           torch.profiler.ProfilerActivity.CUDA])
            t = time.monotonic()
            self.prof.start()
            self.state, self.t_start = "tracing", time.monotonic()
            self.start_s = self.t_start - t
        self.calls += self.state == "tracing"
        return self.state == "tracing"

    def after(self, t1: float) -> None:
        if self.state == "tracing" and (t1 >= self.t_start + TRACE_S or self.calls >= TRACE_CALLS):
            self.stop()

    def stop(self) -> None:
        if self.state == "tracing":
            torch.cuda.synchronize()
            self.prof.stop()
            self.state = "done"

    def events(self) -> Optional[list]:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


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
        with record_function("bench.call"):
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
    p = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen", path], cwd=str(ROOT),
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    p.plan_path = path
    atexit.register(_reap, p)
    if p.stdout.readline().strip() != "ready":
        raise RuntimeError("the load generator did not start")
    return p


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START, control: bool = False,
             keep: Optional[dict] = None) -> dict:
    """One run of `cell`; with `control`, the drawn calls' answers are
    the reference's own computed with TF32 on (the control of PERF.md's
    "How correct is decided"), judged as the program's are."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer
    from styletts2_tpu_torch.serve import TTSServer

    cfg, wl = cell.config, cell.workload
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, cfg)
    if keep is not None:
        keep["run"] = run
    ms = bool(cfg["model_params"]["multispeaker"])
    trim, pad = (50, 0) if ms else (0, 5)
    smp = cfg["sampler"]
    http = wl["entry"] == "http"
    sd = make_weights(cfg, seed, dev)
    ref = Reference(cfg, sd)
    run.reference = ref
    sched = traffic.schedule(wl, seed, seconds)
    tmp = tempfile.mkdtemp(prefix="bench_")
    ref_styles: Dict[str, np.ndarray] = {}
    if wl.get("voices"):
        write_voices(traffic.voice_waves(wl, seed), tmp)
        ref_styles = {v: ref.style(read_voice(os.path.join(tmp, f"{v}.wav"))).cpu().numpy()
                      for v in traffic.voice_names(wl)}
    rng = random.Random(seed ^ 0xCA1)
    calib = traffic.texts(8, wl["tokens"], rng)
    names = sorted(ref_styles)
    calib_feats = (np.concatenate([ref_styles[names[i % len(names)]] for i in range(8)])
                   if ms else None)
    speed = synth.speed_for(ref, calib, cfg["durations"]["frames_per_token"], seed,
                            smp["sigma_data"], calib_feats)
    syn = Synthesizer(Config.from_dict(cfg), state_dict=sd, seed=seed, device=device,
                      sigma_data=smp["sigma_data"])
    tracer = Tracer(trace)
    lengths = [r.tokens for r in sched]
    tok_range = (min(min(lengths), 1 + wl["tokens"]["min"]), max(lengths))
    kw = dict(alpha=smp["alpha"], beta=smp["beta"], diffusion_steps=smp["diffusion_steps"],
              embedding_scale=smp["embedding_scale"])
    server = lp = None
    if http:
        voices = TTSServer.load_voices(syn, tmp) if wl.get("voices") else None
        rec = Recorder(syn, trim, tracer)
        srv = wl["server"]
        server = TTSServer(rec, voices, srv["max_batch"], srv["window_ms"])

        names = sorted(voices or {})

        def call(texts, s):
            refs = None if not names else np.concatenate(
                [voices[names[i % len(names)]] for i in range(len(texts))])
            return [(len(w) + trim) // SAMPLES_PER_FRAME
                    for w in syn.inference_batch(texts, ref_s=refs, speed=s, **kw)]

        n_warm = warm(call, tok_range, speed, pad, range(1, srv["max_batch"] + 1))
        port = server.start_background()
        bodies = []
        for r in sched:
            body = {"text": r.text, "speed": speed}
            if r.voice:
                body["voice"] = r.voice
            bodies.append([r.id, r.due, json.dumps(body, ensure_ascii=False)])
        load = wl["load"]
        lp = _loadgen({"port": port, "kind": load["kind"], "clients": load.get("clients", 0),
                       "seconds": seconds, "wait_s": WAIT_S, "requests": bodies})
    else:
        def call(texts, s):
            w, _ = syn.inference(texts[0], speed=s, **kw)
            return [(len(w) + trim) // SAMPLES_PER_FRAME]

        n_warm = warm(call, tok_range, speed, pad, [1])
    if dev.type == "cuda":
        if trace:  # the profiler's first start loads CUPTI: not inside the window
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=dev).add_(1)
                torch.cuda.synchronize()
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
    tracer.start_at = t0 + TRACE_AT * seconds
    if http:
        lp.stdin.write(f"go {t0!r}\n")
        lp.stdin.flush()
        out = json.loads(lp.stdout.readline())
        res = {r["id"]: r for r in out["results"]}
        late = out["late_s"]
        if late:
            log(f"load generator: {len(late)} sent, late p50 {1e3 * np.median(late):.3f} ms, "
                f"max {1e3 * max(late):.3f} ms")
        for r in sched:
            x = res.get(r.id)
            ok = x is not None and x["status"] == 200
            start = t0 + r.due if r.due is not None else (x["sent"] if x else None)
            if start is None or start >= end:
                continue  # a closed loop's request never sent in the window
            audio = (x["bytes"] - 44) / 2 / SR if ok else 0.0
            run.requests.append({"id": r.id, "start": start, "done": x["done"] if x else None,
                                 "ok": ok, "audio_s": audio})
        run.calls = rec.calls
    else:
        i, calls = 0, []
        while time.monotonic() < end:
            r = sched[i % len(sched)]
            traced = tracer.before()
            a = time.monotonic()
            try:
                with record_function("bench.call"):
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
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": {}}
    if not trace:
        values = dict(end_to_end(run.requests, end, seconds), setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        if dev.type == "cuda":
            run.device_name = torch.cuda.get_device_name(0)
            run.peak_flops = yardstick.peak_f32(run.device_name)
        for m in cell.per_layer:
            v = spec.reader(cell.home, m["name"])(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["device"] = device_info(dev, peak, run if trace else None)
    if trace and run.trace is not None:
        result["breakdown"] = breakdown(run)
    result["checked"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]} for k in numbers}
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    os.rmdir(tmp)
    return result


def end_to_end(requests: List[dict], end: float, seconds: float) -> Dict[str, float]:
    """The latency percentiles of every request (from when it was due, or
    sent, to its last byte; one that failed or never finished ranks above
    all) and the seconds of audio answered inside the window per second."""
    lat = [(q["done"] - q["start"]) * 1e3 if q["ok"] else None for q in requests]
    audio = sum(q["audio_s"] for q in requests if q["ok"] and q["done"] <= end)
    return {"latency_p50_ms": yardstick.percentile(lat, 50),
            "latency_p95_ms": yardstick.percentile(lat, 95),
            "audio_s_per_s": audio / seconds}


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


def device_info(dev, peak: int, run: Optional[Run]) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": peak}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    if run is not None and run.trace is not None:
        win = [e for e in run.trace if e.get("name") == "bench.call" and e.get("cat") == "user_annotation"]
        merged = yardstick.intervals(run.trace)
        a = min(e["ts"] for e in win) if win else 0.0
        b = max(e["ts"] + e["dur"] for e in win) if win else 0.0
        out["busy_s"] = yardstick.busy_within(merged, a, b) / 1e6
        out["window_s"] = (b - a) / 1e6
    return out


def breakdown(run: Run) -> dict:
    """The slice's device operations that took most time, and its longest
    idle gaps by what the host was doing (the innermost host span on the
    calling thread at the gap's middle; outside a call: waiting for work)."""
    ev = run.trace
    calls = [e for e in ev if e.get("name") == "bench.call" and e.get("cat") == "user_annotation"]
    if not calls:
        return {"device_ops": [], "idle_gaps": []}
    a = min(e["ts"] for e in calls)
    b = max(e["ts"] + e["dur"] for e in calls)
    ops: Dict[str, float] = {}
    for e in ev:
        if e.get("cat") in yardstick.DEVICE_WORK and a <= e["ts"] <= b:
            ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    tid = calls[0]["tid"]
    host = sorted((e for e in ev if e.get("tid") == tid and e.get("ph") == "X"
                   and e.get("cat") in ("user_annotation", "cpu_op", "cuda_runtime")),
                  key=lambda e: e["ts"])
    gaps: Dict[str, float] = {}
    merged = yardstick.intervals(ev)
    prev = a
    for lo, hi in merged + [(b, b)]:
        lo, hi = max(lo, a), min(hi, b)
        if lo > prev:
            mid = (prev + lo) / 2
            inner = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            label = min(inner, key=lambda e: e["dur"])["name"] if inner else "host: between calls"
            gaps[label] = gaps.get(label, 0.0) + (lo - prev) / 1e6
        prev = max(prev, hi)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}")
        return 3
    for k, v in result["checked"].items():
        log(f"checked {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
