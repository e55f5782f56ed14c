"""How precisely a bidirectional LSTM computes on the card through each of
cuDNN's paths, against the same LSTM in f64 on the CPU.

    python3 tools/lstm_precision_torch.py

For the prosody predictor's LSTM at full width (input 640, hidden 256) at
one utterance's 400 frames and at batch 16 of 200 frames, and at the
narrow width of `chip_smoke.py`'s phase 19 (input 96, hidden 32, 2 x 40):
the relative L2 error of the output and of the input gradient (train mode)
through cuDNN's unpacked path (`nn.LSTM` on a tensor), its packed path
(full rows through `pack_padded_sequence`, what `layers.BiLSTM` takes on a
card) and PyTorch's own kernels (cuDNN off), each in f32 with TF32 off
(`utils.set_f32_compute`), the unpacked one also under
`torch.backends.cudnn.rnn.fp32_precision = "ieee"` and
`cudnn.deterministic`; f32 on the CPU beside them. Then the forward's time
in one CUDA graph replay (CUDA events over 20 replays) for each path at the
first shape, and the eager forward and backward of a training step (train
mode, CUDA events over 20 steps, the paths in the order ABBA) through the
unpacked and the packed path at the second. Needs a CUDA device; ~25 s.
"""

import contextlib
import subprocess
import sys
from pathlib import Path

import torch
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from styletts2_tpu_torch.utils import set_f32_compute  # noqa: E402

SHAPES = [(1, 400, 640, 256), (16, 200, 640, 256), (2, 40, 96, 32)]  # (B, T, C, H)


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def _forward(lstm, x, path):
    if path == "packed":
        B, T = x.shape[:2]
        packed = pack_padded_sequence(x, torch.full((B,), T, dtype=torch.int64), batch_first=True)
        return pad_packed_sequence(lstm(packed)[0], batch_first=True, total_length=T)[0]
    return lstm(x)[0]


@contextlib.contextmanager
def _setting(name):
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled, cudnn.rnn.fp32_precision, cudnn.deterministic
    cudnn.enabled = name != "native"
    if name == "unpacked, rnn ieee":
        cudnn.rnn.fp32_precision = "ieee"
    if name == "unpacked, deterministic":
        cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.enabled, cudnn.rnn.fp32_precision, cudnn.deterministic = saved


def _errors(ref, lstm, x, dy, path, dev):
    """(output, input gradient) errors of `lstm` on `dev` by `path`."""
    want_x = x.double().requires_grad_()
    want = ref(want_x)[0]
    want.backward(dy.double())
    got_x = x.detach().to(dev, copy=True).requires_grad_()
    got = _forward(lstm, got_x, "packed" if path == "packed" else "unpacked")
    got.backward(dy.to(dev))
    return _rel(got, want), _rel(got_x.grad, want_x.grad)


def _replay_ms(lstm, x, path):
    """One graph replay of the forward, ms (the mean of 20)."""
    with torch.no_grad(), _setting(path):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _forward(lstm, x, path)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _forward(lstm, x, path)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20


def _train_ms(lstm, x, dy, path):
    """One eager forward and backward in train mode, ms (the mean of 20,
    after 3 warm-up steps)."""
    def step():
        x.grad = None
        _forward(lstm, x, path).backward(dy)

    for _ in range(3):
        step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    set_f32_compute()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}")
    dev = torch.device("cuda")
    paths = ("unpacked", "unpacked, rnn ieee", "unpacked, deterministic", "packed", "native")
    for shape in SHAPES:
        B, T, C, H = shape
        g = torch.Generator().manual_seed(0)
        ref = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).double()
        with torch.no_grad():
            for w in ref.parameters():
                w.copy_(torch.randn(w.shape, generator=g, dtype=torch.float64) * 0.1)
        x, dy = torch.randn(B, T, C, generator=g), torch.randn(B, T, 2 * H, generator=g)
        state = {k: v.float() for k, v in ref.state_dict().items()}
        cpu = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True)
        cpu.load_state_dict(state)
        errs = _errors(ref, cpu, x, dy, "unpacked", "cpu")
        parts = [f"CPU f32 {'/'.join(f'{e:.2e}' for e in errs)}"]
        for path in paths:
            card = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to(dev)
            card.load_state_dict(state)
            card.train()
            with _setting(path):
                errs = _errors(ref, card, x, dy, path, dev)
            parts.append(f"{path} {'/'.join(f'{e:.2e}' for e in errs)}")
            ref.zero_grad()
        print(f"(B, T, C, H) {shape}, output / input gradient against f64: " + "; ".join(parts),
              flush=True)
    B, T, C, H = SHAPES[0]
    lstm = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to(dev).eval()
    x = torch.randn(B, T, C, device=dev)
    print(f"(B, T, C, H) {SHAPES[0]}, one graph replay of the forward: " + ", ".join(
        f"{path} {_replay_ms(lstm, x, path):.3f} ms" for path in ("unpacked", "packed", "native")))
    B, T, C, H = SHAPES[1]
    lstm = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to(dev).train()
    x = torch.randn(B, T, C, device=dev, requires_grad=True)
    dy = torch.randn(B, T, 2 * H, device=dev)
    order = ("unpacked", "packed", "packed", "unpacked")
    ms = [(path, _train_ms(lstm, x, dy, path)) for path in order]
    print(f"(B, T, C, H) {SHAPES[1]}, one eager training forward and backward: " + ", ".join(
        f"{path} {t:.3f} ms" for path, t in ms))


if __name__ == "__main__":
    main()
