"""Data parallelism over processes (`styletts2_tpu/parallel/mesh.py`'s data
axis): one process per device, launched by

    python -m torch.distributed.run --nproc_per_node N \\
        -m styletts2_tpu_torch.train.run first --config_path cfg.yml

which sets RANK, WORLD_SIZE and LOCAL_RANK. `init` joins the
process group (NCCL on the card, each process on `cuda:LOCAL_RANK`; gloo on
the CPU); without those variables it does nothing and training runs in one
process as before.

`batch_size` is the global batch: each rank takes `batch_size // world`
rows (a batch that does not divide raises) from its own slice of the
training list (`process_shard`); validation is not sharded. A step on N
ranks computes what one process computes on the N ranks' batches
concatenated, rank r holding global rows [r * b, (r + 1) * b):

- every rank pads its batch to the global shapes (`pad_batch`) and draws
  from the same seeded host stream over the global batch's lengths
  (`gather_host`), keeping its rows;
- the draws inside the models (dropout masks, the NSF source, the
  diffusion's noise, the SLM clips) come from each rank's own stream
  (`rank_seed`): the same distributions as one process's draws on the
  global batch, other values;
- a loss that is a ratio of batch sums or a median over the batch takes
  its sums through `global_sum` and its rows through `gather_rows`; their
  backward sums the gradient over ranks, so every rank's gradient of a
  global term is N times its own share, as a per-row mean over the rank's
  b rows is, and the MEAN all-reduce of the gradients before each
  optimizer step (`all_reduce_grads`) gives the global batch's gradient;
- metrics and stage 2's sigma_data estimate are averaged over ranks.
Rank 0 alone writes logs, metrics, checkpoints and eval artifacts. Every
rank runs validation and the eval artifacts on the same (unsharded) data:
their global sums add equal terms, and a ratio of them is one process's.

With tensor parallelism (`parallel/mesh.py`, STYLETTS2_TPU_MODEL_PARALLEL
= k) the world is a (world // k, k) mesh: "ranks" above are the data
axis's. `rank()` and `world()` are this rank's data index and the data
axis's size, every collective here runs over this rank's data group (the
ranks that hold the same shards), and global rank 0 alone writes (`lead`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from styletts2_tpu_torch.parallel import mesh


def active() -> bool:
    """Whether this process is one rank of a data axis of 2 or more."""
    return world() > 1


def world() -> int:
    """The data axis's size: the ranks whose batches make the global batch."""
    return mesh.current().data


def rank() -> int:
    """This rank's index on the data axis (its rows of the global batch)."""
    return mesh.current().data_rank


def global_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def global_world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def lead() -> bool:
    """Whether this is global rank 0, the one that writes."""
    return global_rank() == 0


def _group():
    return mesh.current().data_group


def launched() -> bool:
    """Whether torch.distributed.run (or another launcher) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device_type: str) -> torch.device:
    """Join the process group the launcher's variables describe (NCCL for
    `cuda`, gloo for `cpu`) and return this rank's device: `cuda:LOCAL_RANK`
    or `cpu`. Without a launcher: nothing is joined, the device is
    `device_type` itself."""
    if not launched():
        return torch.device(device_type)
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def backend() -> str:
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else "none"


def process_shard(n_items: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous slice of n_items, balanced to +-1 over
    `world` ranks (`styletts2_tpu/parallel/mesh.py:107-115`)."""
    base, rem = divmod(n_items, world)
    start = rank * base + min(rank, rem)
    return slice(start, start + base + (1 if rank < rem else 0))


def local_batch_size(batch_size: int, world: int) -> int:
    """Each rank's rows of a global batch of `batch_size`; raises unless it divides."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not divide over {world} ranks")
    return batch_size // world


# ---------------------------------------------------------------------------
# the global batch


def gather_host(a: np.ndarray) -> np.ndarray:
    """The global batch's rows of a host array whose rows this rank holds
    (every rank the same number): the ranks' arrays concatenated in rank
    order. One process: `a` itself."""
    if not active():
        return np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_device())
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t, group=_group())
    return torch.cat(out).cpu().numpy()


def max_over_ranks(values: Sequence[int]) -> list:
    """Each of `values` maximised over the ranks."""
    if not active():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64, device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group())
    return t.tolist()


def pad_batch(batch):
    """The batch with each padded axis (waves, tokens, the reference texts
    and waves) zero-padded to its largest size over the ranks, the shapes
    of the global batch. One process: the batch itself."""
    if not active():
        return batch
    fields = ("waves", "tokens", "ref_tokens", "ref_waves")
    sizes = max_over_ranks([getattr(batch, f).shape[1] for f in fields])
    out = {}
    for f, n in zip(fields, sizes):
        a = getattr(batch, f)
        out[f] = np.pad(a, ((0, 0), (0, n - a.shape[1]))) if n > a.shape[1] else a
    return dataclasses.replace(batch, **out)


def rank_seed(seed: int) -> int:
    """The seed of this rank's own draws in a step whose draws one process
    seeds with `seed`: `seed` itself on data rank 0 (one process draws as
    without a group), another stream on each other data rank. It follows
    the data rank, so every rank of one model group draws alike (the
    shards of one activation see one dropout mask, one NSF source)."""
    r = rank()
    return seed if r == 0 else int(np.random.SeedSequence((seed, r)).generate_state(1)[0] >> 1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y, group=_group())
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_group())
        return g


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.n = x.shape[0]
        out = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(out, x, group=_group())
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_group())
        return g[rank() * ctx.n: (rank() + 1) * ctx.n]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """In a group of 2 or more ranks, x summed over the ranks, the backward
    summing the gradient over the ranks; else x."""
    return _AllReduceSum.apply(x) if active() else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """In a group of 2 or more ranks, the ranks' x (equal shapes)
    concatenated along the first axis, the backward summing the gradient
    over the ranks and keeping this rank's rows; else x."""
    return _GatherRows.apply(x) if active() else x


def mean(x: torch.Tensor) -> torch.Tensor:
    """A detached value averaged over the ranks."""
    if not active():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=_group())
    return y / world()


def mean_metrics(metrics: Optional[Dict[str, float]]) -> Optional[Dict[str, float]]:
    """A step's metrics averaged over the ranks (every rank returns None alike)."""
    if metrics is None or not active():
        return metrics
    keys = sorted(metrics)
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=_device())
    dist.all_reduce(t, group=_group())
    return dict(zip(keys, (t / world()).tolist()))


def all_reduce_grads(modules: Iterable[nn.Module]) -> None:
    """The mean over the ranks of every parameter's gradient in `modules`
    (a zero gradient where none arrived), one flat all-reduce per dtype."""
    if not active():
        return
    params = [p for mod in modules for p in mod.parameters()]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, group=_group())
        flat /= world()
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            p.grad.copy_(g.view_as(p.grad))


def finish() -> None:
    """Leave the process group, where one was joined, and forget the mesh."""
    mesh.reset()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Every rank of the world waits for the others."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(device_ids=[torch.cuda.current_device()] if backend() == "nccl" else None)


def _device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if backend() == "nccl" else torch.device("cpu")
