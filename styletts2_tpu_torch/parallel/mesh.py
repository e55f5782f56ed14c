"""Tensor parallelism over a 'model' axis (`styletts2_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a ('data', 'model') mesh and lets
GSPMD shard every 2-D weight with a side of 1024 or more over 'model'
(`param_pspec`). The port lays its ranks out the same way (`make_mesh`:
rank r at data index r // k and model index r % k, for k-way model
parallelism) and shards explicit Megatron pairs, one all-reduce each way:

- a column-parallel layer (`ShardedLinear`, dim 0) holds a slice of the
  output features; its input enters through `copy_to_model` (identity
  forward, the gradient all-reduced over the model group backward);
- the row-parallel layer after it (dim 1) holds the matching slice of the
  input features; its partial product leaves through `reduce_from_model`
  (all-reduced forward, identity backward), and its bias, replicated, is
  added after the sum.

The pairs (`plan`): PL-BERT's feed-forward (ffn -> ffn_output); the
denoiser's to_mapping pair, and in each transformer block its attention
split by heads (to_q and to_kv column-parallel, to_kv's key and value
halves each split, attention.to_out row-parallel) and its feed-forward;
WavLM's feed-forward in every layer (frozen). Activations between a pair
are elementwise, and none of these modules draws dropout, so the shards
need no draws of their own.

Replicated, where the JAX rule shards a side of 1024 or more (a test,
tests/test_torch_tp.py, holds every such weight to one of these reasons):

- the LSTM gate kernels (weight_ih, weight_hh: 4H = 1024 at full width) of
  the predictor, the text encoder, the aligner and JDC: a gate-split LSTM
  needs a collective inside every time step of the recurrence, which the
  fused cuDNN LSTM cannot take;
- the style affines (AdaIN / AdaLayerNorm `fc`, 128 -> 1024) and the
  denoiser's to_time / to_features (257 or 256 -> 1024): one row per item,
  too small a product to pay for the collective its output would need.

A pair whose shared side (the hidden width, or the heads) k does not
divide stays replicated, as the JAX rule keeps a weight whose side k does
not divide (`:58-66`); `shard_` logs those names once. A world that k does
not divide raises, where the JAX `make_mesh` falls back to k = 1.

Norms over parameters: a sharded weight's norm is the square root of its
shards' squared norms summed over the model group, a replicated one's is
counted once. The one such norm in the trainers, the SLM pass's division
by the predictor's gradient norm (`train/stage2.py:scale_slm_grads`),
reads only the predictor, which stays replicated: it is unchanged.

Checkpoints stay one reference-layout file: `full_state_dict` and
`full_optimizer_state` gather the shards (an all-reduce of each shard in
a zero tensor of the full shape, exact), `local_state_dict` and
`local_optimizer_state` slice a full file for this rank. Only
`all_reduce` is used, which gloo also runs on CUDA tensors.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

MODEL_PARALLEL_ENV = "STYLETTS2_TPU_MODEL_PARALLEL"  # the JAX package's variable

log = logging.getLogger("styletts2_tpu_torch")


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the ('data', 'model') mesh: the axes' sizes, its
    indices and the process groups of its data and model axes (None for an
    axis of size 1, or for the data axis when it is the whole world)."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None


_mesh: Optional[Mesh] = None


def model_parallel_from_env() -> int:
    """The model axis's size that STYLETTS2_TPU_MODEL_PARALLEL asks for (1 unset)."""
    return int(os.environ.get(MODEL_PARALLEL_ENV, "1") or 1)


def make_mesh(world: int, model_parallel: int = 1) -> Mesh:
    """Lay `world` ranks out as (world // k, k), k = model_parallel, rank r
    at data index r // k and model index r % k (the JAX `make_mesh`'s
    reshape), build each axis's process groups (every rank builds every
    group, in one order) and make the mesh this process's. Raises where k
    does not divide the world, or the world is not the process group's."""
    global _mesh
    k = int(model_parallel)
    if k < 1 or world % k:
        raise ValueError(f"model parallel {k} does not divide a world of {world} ranks")
    joined = dist.is_available() and dist.is_initialized()
    if world != (dist.get_world_size() if joined else 1):
        raise ValueError(f"a world of {world} ranks, but the process group has "
                         f"{dist.get_world_size() if joined else 1}")
    rank, n = (dist.get_rank() if joined else 0), world // k
    data_group = model_group = None
    if k > 1:
        for m in range(k):  # the data axis: the ranks of one model index
            g = dist.new_group([d * k + m for d in range(n)]) if n > 1 else None
            if rank % k == m:
                data_group = g
        for d in range(n):  # the model axis: the ranks of one data index
            g = dist.new_group([d * k + m for m in range(k)])
            if rank // k == d:
                model_group = g
    m = Mesh(n, k, rank // k, rank % k, data_group, model_group)
    if world > 1:  # one process keeps no mesh: `current` follows the process group
        _mesh = m
    return m


def current() -> Mesh:
    """This process's mesh: the one `make_mesh` made, else the whole process
    group as the data axis (no model axis), else one process."""
    if _mesh is not None:
        return _mesh
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_world_size(), 1, dist.get_rank(), 0)
    return Mesh()


def reset() -> None:
    """Forget the mesh (the process group is being left)."""
    global _mesh
    _mesh = None


# ---------------------------------------------------------------------------
# the collectives of a pair


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=current().model_group)
        return g


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=current().model_group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel layer's input: x forward, its gradient summed over
    the model group backward."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer's output: x summed over the model group
    forward, its gradient as it is backward."""
    return _ReduceFromModel.apply(x)


def _pieces(size: int, parts: int, k: int, r: int) -> List[Tuple[int, int]]:
    """(start, length) of rank r's pieces of an axis of `size` split into
    `parts` equal chunks, each chunk split k ways."""
    chunk = size // parts
    return [(p * chunk + r * (chunk // k), chunk // k) for p in range(parts)]


class ShardedLinear(nn.Linear):
    """An `nn.Linear` whose weight holds this model rank's slice: of the
    output features (dim 0, column-parallel; the bias sliced alike) or of
    the input features (dim 1, row-parallel; the bias replicated). With
    `parts` > 1 the split axis is `parts` chunks (to_kv's key and value),
    each split k ways. The parameter names stay the Linear's."""

    def __init__(self, full: nn.Linear, dim: int, parts: int, k: int, r: int):
        nn.Module.__init__(self)
        self.dim, self.parts, self.k, self.r = dim, parts, k, r
        self.full_in, self.full_out = full.in_features, full.out_features
        self.in_features = full.in_features // (k if dim == 1 else 1)
        self.out_features = full.out_features // (k if dim == 0 else 1)
        w = full.weight
        self.weight = nn.Parameter(self.local(w.detach(), "weight").clone(),
                                   requires_grad=w.requires_grad)
        if full.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(self.local(full.bias.detach(), "bias").clone(),
                                     requires_grad=full.bias.requires_grad)

    def sharded(self, name: str) -> bool:
        return name == "weight" or self.dim == 0

    def local(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the full `name` tensor (a weight, or a tensor
        of its shape such as an Adam moment)."""
        if not self.sharded(name):
            return full
        return torch.cat([full.narrow(self.dim, s, n)
                          for s, n in _pieces(full.shape[self.dim], self.parts, self.k, self.r)],
                         dim=self.dim)

    def gather(self, shard: torch.Tensor, name: str) -> torch.Tensor:
        """The full `name` tensor from every model rank's `shard`: each in a
        zero tensor of the full shape, all-reduced (exact)."""
        if not self.sharded(name):
            return shard.detach().clone()
        shape = list(shard.shape)
        shape[self.dim] = self.full_out if self.dim == 0 else self.full_in
        full = torch.zeros(shape, dtype=shard.dtype, device=shard.device)
        offset = 0
        for s, n in _pieces(shape[self.dim], self.parts, self.k, self.r):
            full.narrow(self.dim, s, n).copy_(shard.detach().narrow(self.dim, offset, n))
            offset += n
        dist.all_reduce(full, group=current().model_group)
        return full

    def forward(self, x):
        if self.dim == 0:
            return F.linear(copy_to_model(x), self.weight, self.bias)
        y = reduce_from_model(F.linear(x, self.weight))
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        kind = "column" if self.dim == 0 else "row"
        return f"{super().extra_repr()}, {kind}-parallel {self.r} of {self.k}, parts={self.parts}"


# ---------------------------------------------------------------------------
# the layout


@dataclass
class Pair:
    """Layers sharded together: (path under the owner, dim, parts) of each,
    the side k must divide, and whether the owner's `num_heads` is split."""

    key: str  # the module of the ModuleDict
    owner: str  # the owner's path in that module
    members: List[Tuple[str, int, int]]
    side: int
    heads: bool = False


def plan(models: nn.ModuleDict) -> List[Pair]:
    """The Megatron pairs of `models`, by module type (the module docstring)."""
    from styletts2_tpu_torch.models.diffusion.denoiser import (SelfAttention, TransformerBlock,
                                                               Transformer1d)
    from styletts2_tpu_torch.models.plbert import AlbertLayer
    from styletts2_tpu_torch.models.wavlm import FeedForward

    def width(mod, path):
        return _get(mod, path).out_features

    pairs = []
    for key, module in models.items():
        for name, mod in module.named_modules():
            if isinstance(mod, AlbertLayer):
                pairs.append(Pair(key, name, [("ffn", 0, 1), ("ffn_output", 1, 1)],
                                  width(mod, "ffn")))
            elif isinstance(mod, Transformer1d):
                pairs.append(Pair(key, name, [("to_mapping.0", 0, 1), ("to_mapping.2", 1, 1)],
                                  width(mod, "to_mapping.0")))
            elif isinstance(mod, SelfAttention):
                pairs.append(Pair(key, name, [("to_q", 0, 1), ("to_kv", 0, 2),
                                              ("attention.to_out", 1, 1)],
                                  _heads(mod), heads=True))
            elif isinstance(mod, TransformerBlock):
                pairs.append(Pair(key, name, [("feed_forward.0", 0, 1), ("feed_forward.2", 1, 1)],
                                  width(mod, "feed_forward.0")))
            elif isinstance(mod, FeedForward):
                pairs.append(Pair(key, name, [("intermediate_dense", 0, 1),
                                              ("output_dense", 1, 1)],
                                  width(mod, "intermediate_dense")))
    return pairs


def _heads(attn) -> int:
    return getattr(attn, "full_heads", attn.num_heads)


def _get(module: nn.Module, path: str) -> nn.Module:
    for part in path.split(".") if path else ():
        module = module._modules[part]
    return module


def _set(module: nn.Module, path: str, new: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    _get(module, parent)._modules[name] = new


def _names(pair: Pair) -> Iterator[str]:
    for path, _, _ in pair.members:
        yield ".".join(x for x in (pair.key, pair.owner, path) if x)


def shard_(models: nn.ModuleDict, mesh: Optional[Mesh] = None) -> List[str]:
    """Shard `models` in place over the mesh's model axis (before their
    optimizers are built, so the Adam moments follow the shards); returns
    the sharded layers' names. A pair whose side k does not divide stays
    replicated, its names logged once. Nothing to do without a model axis."""
    mesh = mesh or current()
    k, r = mesh.model, mesh.model_rank
    if k == 1:
        return []
    done, kept = [], []
    for pair in plan(models):
        owner = _get(models[pair.key], pair.owner)
        if pair.side % k:
            kept.extend(_names(pair))
            continue
        for (path, dim, parts), name in zip(pair.members, _names(pair)):
            lin = _get(owner, path)
            if not isinstance(lin, ShardedLinear):
                _set(owner, path, ShardedLinear(lin, dim, parts, k, r))
            done.append(name)
        if pair.heads and not hasattr(owner, "full_heads"):
            owner.full_heads = owner.num_heads
            owner.num_heads //= k
    if kept:
        log.info(f"tensor parallel: {len(kept)} layers kept replicated, a side that "
                 f"{k} does not divide: {', '.join(kept)}")
    return done


def gather_(models: nn.ModuleDict) -> None:
    """Undo `shard_` in place: every sharded layer a full `nn.Linear` again
    (a collective of the model group), the heads restored."""
    for pair in plan(models):
        owner = _get(models[pair.key], pair.owner)
        for path, _, _ in pair.members:
            lin = _get(owner, path)
            if isinstance(lin, ShardedLinear):
                full = nn.Linear(lin.full_in, lin.full_out, bias=lin.bias is not None,
                                 device=lin.weight.device, dtype=lin.weight.dtype)
                with torch.no_grad():
                    full.weight.copy_(lin.gather(lin.weight, "weight"))
                    if lin.bias is not None:
                        full.bias.copy_(lin.gather(lin.bias, "bias"))
                full.requires_grad_(lin.weight.requires_grad)
                _set(owner, path, full)
        if pair.heads and hasattr(owner, "full_heads"):
            owner.num_heads = owner.full_heads
            del owner.full_heads


def sharded_parameters(module: nn.Module) -> Dict[str, Tuple[ShardedLinear, str]]:
    """{state_dict name: (its layer, weight or bias)} of the sharded tensors."""
    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, ShardedLinear):
            for p in ("weight", "bias"):
                if getattr(sub, p) is not None and sub.sharded(p):
                    out[f"{name}.{p}" if name else p] = (sub, p)
    return out


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every shard gathered to its full tensor (a
    collective of the model group where the module is sharded)."""
    sd = module.state_dict()
    for name, (lin, p) in sharded_parameters(module).items():
        sd[name] = lin.gather(sd[name], p)
    return sd


def local_state_dict(module: nn.Module, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full state_dict of `module` cut to this rank's shards."""
    sharded = sharded_parameters(module)
    return {n: sharded[n][0].local(v, sharded[n][1]) if n in sharded else v
            for n, v in full.items()}


def _by_index(module: nn.Module) -> Dict[int, Tuple[ShardedLinear, str]]:
    """{index in module.parameters(): (its layer, weight or bias)} of the
    sharded parameters: the optimizer's state indices (one group over
    `module.parameters()`, `train/state.py:build_optimizers`)."""
    sharded = sharded_parameters(module)
    return {i: sharded[n] for i, (n, _) in enumerate(module.named_parameters()) if n in sharded}


def full_optimizer_state(module: nn.Module, opt: torch.optim.Optimizer) -> dict:
    """`opt.state_dict()` with the moments of sharded parameters gathered."""
    sd = opt.state_dict()
    for i, (lin, p) in _by_index(module).items():
        st = sd["state"].get(i)
        if st:
            sd["state"][i] = {k: lin.gather(v, p) if torch.is_tensor(v) and v.dim() else v
                              for k, v in st.items()}
    return sd


def local_optimizer_state(module: nn.Module, full: dict) -> dict:
    """A full optimizer state_dict of `module` cut to this rank's shards."""
    by_index = _by_index(module)
    state = {}
    for i, st in full["state"].items():
        if int(i) in by_index:
            lin, p = by_index[int(i)]
            st = {k: lin.local(v, p) if torch.is_tensor(v) and v.dim() else v
                  for k, v in st.items()}
        state[i] = st
    return {"state": state, "param_groups": full["param_groups"]}
