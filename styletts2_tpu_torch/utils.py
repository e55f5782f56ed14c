"""Alignment expansion from integer durations."""

from __future__ import annotations

import torch


def duration_to_alignment(durations: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Integer durations (B, N) -> hard one-hot alignment (B, N, n_frames) f32:
    frame t belongs to token i iff cumsum[i-1] <= t < cumsum[i]."""
    cs = torch.cumsum(durations, dim=-1)
    starts = cs - durations
    t = torch.arange(n_frames, device=durations.device)[None, None, :]
    return ((t >= starts[..., None]) & (t < cs[..., None])).to(torch.float32)
