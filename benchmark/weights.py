"""Seeded random weights for a configuration, made on the device.

One generator on the device seeded from the run's seed; one draw per
distribution over every tensor that takes it (U(-1, 1), a normal truncated
at 2 std, N(0, 1)), scaled per tensor; then the weight-norm gains that
equal ||v|| and the spectral-norm vectors (three power iterations from a
drawn u). The same state dict is handed to the program and to the
reference."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import Spec

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated at +-2


@torch.no_grad()
def make(specs: Dict[str, Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    g = torch.Generator(dev).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("uniform", "lecun", "normal"):
        names = [n for n, (_, k, _) in specs.items() if k == kind]
        sizes = [int(torch.Size(specs[n][0]).numel()) for n in names]
        flat = torch.empty(sum(sizes), device=dev)
        if kind == "uniform":
            flat.uniform_(-1.0, 1.0, generator=g)
        elif kind == "lecun":
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
        else:
            flat.normal_(generator=g)
        scale = torch.tensor([specs[n][2] / (_TRUNC_STD if kind == "lecun" else 1.0)
                              for n in names], device=dev)
        flat *= scale.repeat_interleave(torch.tensor(sizes, device=dev))
        for n, piece in zip(names, flat.split(sizes)):
            out[n] = piece.view(specs[n][0])
    for n, (shape, kind, _) in specs.items():
        if kind in ("zeros", "ones"):
            out[n] = (torch.zeros if kind == "zeros" else torch.ones)(shape, device=dev)
        elif kind == "wn_norm":
            v = out[n[: -len("_g")] + "_v"]
            out[n] = v.norm(dim=tuple(range(1, v.dim())), keepdim=True)
    sn = [n[: -len(".weight_u")] for n, (_, k, _) in specs.items() if k == "sn_u"]
    us = torch.randn(sum(specs[f"{p}.weight_u"][0][0] for p in sn), device=dev, generator=g)
    for p, u in zip(sn, us.split([specs[f"{p}.weight_u"][0][0] for p in sn])):
        w = out[f"{p}.weight_orig"].double()
        wm, u = w.reshape(w.shape[0], -1), u.double()
        for _ in range(3):
            v = wm.T @ u
            v = v / (v.norm() + 1e-12)
            u = wm @ v
            u = u / (u.norm() + 1e-12)
        out[f"{p}.weight_u"], out[f"{p}.weight_v"] = u.float(), v.float()
    return out
