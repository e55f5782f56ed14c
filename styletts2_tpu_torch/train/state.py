"""Per-module optimizers, selective stepping and checkpoints
(`styletts2_tpu/train/state.py`).

One `torch.optim.AdamW` per module (betas (0, 0.99), eps 1e-9, weight decay
1e-4, the config's lr), as the reference's per-key optimizers; stage 2
gives `bert` bert_lr, betas (0.9, 0.99) and weight decay 0.01, and the
decoder and the style encoder ft_lr. A step updates only the modules it
names (`step_modules`); a parameter of a stepped module that got no
gradient is stepped with a zero one, because optax applies the weight
decay to every parameter of the module it updates (after TMA the pitch
extractor learns nothing but that decay) and `torch.optim` would skip it.
An LSTM's bias_hh is stepped with a zero gradient too: the JAX LSTM has one
bias, b_ih + b_hh, whose gradient bias_ih alone takes.

Checkpoints use the reference layout `{"net": {module: state_dict},
"optimizer": {module: state_dict}, "iters", "epoch"}` plus stage 2's
estimated `sigma_data`, written atomically (a temporary file, then a
rename). The frozen WavLM is never written. Under tensor parallelism the
file still holds the full tensors: `snapshot` gathers the shards and
`load_checkpoint` cuts them again (`parallel/mesh.py`).
`AsyncSaver` writes a `snapshot` (the state copied to host memory) on a
background thread; `find_latest_checkpoint` finds the newest epoch file
for auto-resume.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models.build import FROZEN_MODULES
from styletts2_tpu_torch.parallel.mesh import (full_optimizer_state, full_state_dict,
                                               local_optimizer_state, local_state_dict)


def build_optimizers(cfg: Config, models: nn.ModuleDict,
                     stage2: bool = False) -> Dict[str, torch.optim.AdamW]:
    op = cfg.optimizer_params

    def adamw(k, m):
        if stage2 and k == "bert":
            return torch.optim.AdamW(m.parameters(), lr=op.bert_lr, betas=(0.9, 0.99), eps=1e-9,
                                     weight_decay=0.01)
        lr = op.ft_lr if stage2 and k in ("decoder", "style_encoder") else op.lr
        return torch.optim.AdamW(m.parameters(), lr=lr, betas=(0.0, 0.99), eps=1e-9,
                                 weight_decay=1e-4)

    return {k: adamw(k, m) for k, m in models.items() if k not in FROZEN_MODULES}


def drop_bias_hh_grads(module: nn.Module) -> None:
    """Zero the gradient of every LSTM bias_hh under `module` (see above)."""
    for mod in module.modules():
        if isinstance(mod, nn.LSTM):
            for name, p in mod.named_parameters():
                if name.startswith("bias_hh") and p.grad is not None:
                    p.grad.zero_()


def step_modules(models: nn.ModuleDict, opts: Dict[str, torch.optim.Optimizer],
                 keys: Iterable[str]) -> None:
    """Step the optimizers of `keys`, every parameter of those modules
    included (a zero gradient where none arrived, and at an LSTM's
    bias_hh), then clear their grads."""
    for k in keys:
        drop_bias_hh_grads(models[k])
        for p in models[k].parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opts[k].step()
        opts[k].zero_grad(set_to_none=True)


@dataclass
class TrainState:
    models: nn.ModuleDict
    opts: Dict[str, torch.optim.Optimizer]
    step: int = 0
    epoch: int = 0
    sigma_data: Optional[float] = None  # stage 2's estimate; None in stage 1


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot(state: TrainState) -> dict:
    """The checkpoint payload, copied to host memory: the full tensors of
    sharded layers and their moments (a collective of the model group under
    tensor parallelism, so every rank of it takes the snapshot)."""
    payload = {
        "net": {k: full_state_dict(m) for k, m in state.models.items()
                if k not in FROZEN_MODULES},
        "optimizer": {k: full_optimizer_state(state.models[k], o) for k, o in state.opts.items()},
        "iters": state.step,
        "epoch": state.epoch,
    }
    if state.sigma_data is not None:
        payload["sigma_data"] = state.sigma_data
    return _to_host(payload)


def write_payload(path: str, payload: dict) -> None:
    """Atomic write: a crash mid-save never leaves a truncated file where
    auto-resume would find it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState) -> None:
    write_payload(path, snapshot(state))


class AsyncSaver:
    """Checkpoint writes on one background thread: `submit` queues a
    snapshot's write and returns; `wait_for_saves` blocks until every write
    landed and re-raises the first failure. `close` waits, then stops the
    thread."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt_save")
        self._pending: List[Tuple[str, Future]] = []

    def submit(self, path: str, payload: dict) -> Future:
        """Write a payload `snapshot` took."""
        fut = self._pool.submit(write_payload, path, payload)
        self._pending.append((path, fut))
        return fut

    def wait_for_saves(self) -> None:
        pending, self._pending = self._pending, []
        for _, fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait_for_saves()
        finally:
            self._pool.shutdown(wait=True)


def find_latest_checkpoint(log_dir: str, prefix: str) -> Optional[str]:
    """The newest `{prefix}NNNNN.pth` in log_dir by epoch number, or None."""
    if not os.path.isdir(log_dir):
        return None
    pat = re.compile(re.escape(prefix) + r"(\d+)\.pth$")
    found = [(int(m.group(1)), name) for name in os.listdir(log_dir)
             if (m := pat.match(name))]
    return os.path.join(log_dir, max(found)[1]) if found else None


def load_checkpoint(path: str, state: TrainState, load_only_params: bool = False,
                    ignore_modules: Iterable[str] = ()) -> TrainState:
    """Restore the modules, optimizers, step, epoch and sigma_data of a
    checkpoint; a module the file lacks (the frozen WavLM) or that
    `ignore_modules` names keeps its live weights. `load_only_params`
    restores the modules' weights (spectral-norm vectors included) and
    nothing else, as the reference's `load_checkpoint`. A sharded layer
    (`parallel/mesh.py`) takes this rank's slice of the file's full
    tensors and moments."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for k, sd in payload["net"].items():
        if k in state.models and k not in ignore_modules:
            state.models[k].load_state_dict(local_state_dict(state.models[k], sd))
    if load_only_params:
        return state
    for k, sd in payload.get("optimizer", {}).items():
        if k in state.opts and k not in ignore_modules:
            state.opts[k].load_state_dict(local_optimizer_state(state.models[k], sd))
    state.step = int(payload.get("iters", 0))
    state.epoch = int(payload.get("epoch", 0))
    if "sigma_data" in payload:
        state.sigma_data = float(payload["sigma_data"])
    return state
