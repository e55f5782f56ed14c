"""HTTP text-to-speech server with micro-batching, on the PyTorch port.

The port's own copy of `styletts2_tpu/serve.py` (it cannot import that
module: the JAX package's config imports PyYAML on import). Concurrent
requests that arrive within a short window and share their sampler
settings are fused into one `Synthesizer.inference_batch` call, and the
waveforms are fanned back out. One worker thread runs the model, so the
card sees one stream of work; concurrency comes from batching.

Stdlib HTTP (http.server + threading); no web framework.

Endpoints:
    GET  /healthz          liveness, the config's kind and the batcher's counts
    GET  /voices           voice names loaded from --voices at startup
    POST /tts              JSON {"text": "...", optional: "voice", "alpha",
                           "beta", "diffusion_steps", "embedding_scale",
                           "speed", "seed", "raw_text"} -> audio/wav (24 kHz
                           16-bit PCM). The text is pre-phonemized IPA, as in
                           the reference notebooks; with "raw_text": true it is
                           plain text for `text.phonemize` (espeak-ng), and a
                           server without the phonemizer answers 501.

Run (on a CUDA card; --device cpu for a machine without one):
    python -m styletts2_tpu_torch.serve --config configs/config_libritts.yml \\
        [--ckpt epochs_2nd_00020.pth] [--voices refdir/] [--port 8760] [--max-batch 8] \\
        [--window-ms 15] [--device cuda] [--decoder-dtype bfloat16]
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

SR = 24000


def wav_bytes(data: np.ndarray, sr: int = SR) -> bytes:
    """float32 [-1, 1] mono -> an in-memory 16-bit PCM WAV file."""
    from styletts2_tpu_torch.utils import write_wav

    buf = io.BytesIO()
    write_wav(buf, data, sr)
    return buf.getvalue()


@dataclass
class _Request:
    text: str
    ref_s: Optional[np.ndarray]  # (1, 2*style_dim) or None
    params: tuple  # (alpha, beta, steps, scale, speed, seed): the batching key
    done: threading.Event = field(default_factory=threading.Event)
    wav: Optional[np.ndarray] = None
    error: Optional[str] = None


class Batcher:
    """One worker thread draining a queue into batched synthesis.

    Requests are grouped by their sampler settings (alpha, beta,
    diffusion_steps, embedding_scale, speed, seed): only identical settings
    share one `inference_batch` call, and a request with other settings
    waits for the next group. Per-request reference styles are batched
    (stacked to (B, D))."""

    def __init__(self, synthesizer, max_batch: int = 8, window_ms: float = 15.0):
        self.syn = synthesizer
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, req: _Request, timeout: float = 120.0) -> _Request:
        self.q.put(req)
        if not req.done.wait(timeout):
            req.error = req.error or "synthesis timed out"
        return req

    def close(self):
        self._stop.set()
        self.q.put(None)  # wake the worker
        self._thread.join(timeout=10)

    def _collect(self):
        """Block for one request, then gather compatible ones for window_ms."""
        first = self.q.get()
        if first is None:
            return []
        group, leftovers = [first], []
        deadline = time.monotonic() + self.window_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            (group if nxt.params == first.params else leftovers).append(nxt)
        for r in leftovers:
            self.q.put(r)
        return group

    def _run(self):
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            self.stats["requests"] += len(group)
            self.stats["batches"] += 1
            if len(group) > 1:
                self.stats["batched_requests"] += len(group)
            alpha, beta, steps, scale, speed, seed = group[0].params
            try:
                D = 2 * self.syn.style_dim
                refs = np.concatenate([r.ref_s if r.ref_s is not None
                                       else np.zeros((1, D), np.float32) for r in group])
                # a lone request too: inference_batch of one text is inference
                wavs = self.syn.inference_batch(
                    [r.text for r in group], ref_s=refs, alpha=alpha, beta=beta,
                    diffusion_steps=steps, embedding_scale=scale, speed=speed, seed=seed)
                for r, w in zip(group, wavs):
                    r.wav = w
            except Exception as e:  # reported to each request; the server keeps serving
                traceback.print_exc()
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
            finally:
                for r in group:
                    r.done.set()


class TTSServer:
    """The Synthesizer, the voice table, the batcher and the HTTP server."""

    def __init__(self, synthesizer, voices: Optional[Dict[str, np.ndarray]] = None,
                 max_batch: int = 8, window_ms: float = 15.0):
        self.syn = synthesizer
        self.voices = dict(voices or {})
        self.batcher = Batcher(synthesizer, max_batch, window_ms)
        self.httpd: Optional[ThreadingHTTPServer] = None

    @staticmethod
    def load_voices(synthesizer, voices_dir: str) -> Dict[str, np.ndarray]:
        """Each WAV in voices_dir, resampled to 24 kHz, becomes a named
        reference style (`compute_style`)."""
        from styletts2_tpu_torch.utils import read_wav, resample_sinc

        table = {}
        for fn in sorted(os.listdir(voices_dir)):
            if not fn.lower().endswith(".wav"):
                continue
            wav, sr = read_wav(os.path.join(voices_dir, fn))
            table[os.path.splitext(fn)[0]] = synthesizer.compute_style(resample_sinc(wav, sr, SR))
        return table

    def handle_tts(self, body: dict) -> bytes:
        text = body.get("text")
        if not text or not isinstance(text, str):
            raise ValueError("missing 'text'")
        if body.get("raw_text"):
            from styletts2_tpu_torch.text import phonemize

            try:
                text = phonemize(text)
            except ImportError as e:  # the optional frontend: the server cannot, the client may
                raise NotImplementedError(str(e)) from e
        ref_s = None
        voice = body.get("voice")
        if voice is not None:
            if voice not in self.voices:
                raise ValueError(f"unknown voice {voice!r}")
            ref_s = self.voices[voice]
        params = (
            float(body.get("alpha", 0.3)),
            float(body.get("beta", 0.7)),
            int(body.get("diffusion_steps", 5)),
            float(body.get("embedding_scale", 1.0)),
            float(body.get("speed", 1.0)),
            int(body.get("seed", 0)),
        )
        req = self.batcher.submit(_Request(text=text, ref_s=ref_s, params=params))
        if req.error:
            raise RuntimeError(req.error)
        return wav_bytes(req.wav)

    def healthz(self) -> dict:
        return {
            "status": "ok",
            "multispeaker": bool(self.syn.multispeaker),
            "voices": sorted(self.voices),
            "stats": dict(self.batcher.stats),
        }

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj: dict):
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, server.healthz())
                elif self.path == "/voices":
                    self._send_json(200, {"voices": sorted(server.voices)})
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/tts":
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    wav = server.handle_tts(json.loads(self.rfile.read(n) or b"{}"))
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                except NotImplementedError as e:  # raw_text without a phonemizer
                    self._send_json(501, {"error": str(e)})
                except Exception as e:
                    self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                else:
                    self._send(200, wav, "audio/wav")

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8760):
        self.httpd = ThreadingHTTPServer((host, port), self.make_handler())
        try:
            self.httpd.serve_forever()
        finally:
            self.close()

    def start_background(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a daemon thread; returns the bound port."""
        self.httpd = ThreadingHTTPServer((host, port), self.make_handler())
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self.httpd.server_address[1]

    def close(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        self.batcher.close()


def load_synthesizer(config: Optional[str], ckpt: Optional[str] = None, device: str = "cuda",
                     decoder_dtype: Optional[str] = None, seed: int = 0):
    """The Synthesizer of a YAML config (`Config()` without one) on `device`.
    The repository's two configs are built without PyYAML
    (`config.config_from_path`). `ckpt` is a StyleTTS 2 checkpoint, a torch
    file {"net": {module: state_dict}}: the reference's own `.pth` (its
    DataParallel `module.` prefixes and its diffusion model's `unet.`
    weights included) or one of the port's trainers, both read by
    `convert.state_dict_from_reference`. Each module synthesis runs
    (`build.module_keys`) is loaded strictly, the training-only ones
    (aligner, pitch extractor, discriminators) are skipped, and a module or
    a weight the file lacks is an error. The sampler's sigma_data is the
    file's `sigma_data` (the port's stage-2 estimate), else the config's.
    Without `ckpt` the weights are random, drawn from `seed`. A CUDA device
    that is not there is an error, never a fall-back to the CPU.
    `decoder_dtype`: see `Synthesizer`."""
    import torch

    from styletts2_tpu_torch.config import Config, config_from_path
    from styletts2_tpu_torch.convert import state_dict_from_reference
    from styletts2_tpu_torch.inference import Synthesizer

    cfg = config_from_path(config) if config else Config()
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available")
    state_dict, sigma_data = None, cfg.model_params.diffusion.dist.sigma_data
    if ckpt:
        payload = torch.load(ckpt, map_location="cpu", weights_only=True)
        state_dict = state_dict_from_reference(payload["net"], cfg)
        sigma_data = float(payload.get("sigma_data", sigma_data))
    return Synthesizer(cfg, state_dict=state_dict, seed=seed, device=device,
                       sigma_data=sigma_data, decoder_dtype=decoder_dtype)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/config.yml")
    ap.add_argument("--ckpt", default=None,
                    help='StyleTTS 2 checkpoint {"net": {module: state_dict}}: the reference\'s '
                         '.pth or a file of the port\'s trainers')
    ap.add_argument("--voices", default=None, help="directory of reference WAVs -> named voices")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8760)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decoder-dtype", default=None, choices=["bfloat16"],
                    help="run the decoder in bf16 (its f32 islands kept)")
    return ap.parse_args(argv)


def make_server(args) -> TTSServer:
    """The TTSServer that `main` runs for parsed arguments, not yet serving.
    Convolutions and matmuls run in f32 (`utils.set_f32_compute`)."""
    from styletts2_tpu_torch.utils import set_f32_compute

    set_f32_compute()
    syn = load_synthesizer(args.config, args.ckpt, args.device, args.decoder_dtype)
    voices = TTSServer.load_voices(syn, args.voices) if args.voices else None
    return TTSServer(syn, voices, args.max_batch, args.window_ms)


def main(argv=None):
    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    server = make_server(args)
    print(f"serving on http://{args.host}:{args.port} (max_batch={args.max_batch}, "
          f"window={args.window_ms} ms, device={args.device}, decoder "
          f"{args.decoder_dtype or 'float32'})", flush=True)
    server.serve(args.host, args.port)


if __name__ == "__main__":
    main()
