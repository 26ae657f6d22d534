"""Grouped residual FSQ, decode half. Each group's linear weights are
stored (in, out): {"project_out": {"w": (d_cb, dim_g), "b": (dim_g,)}}."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from fish_speech_tpu_torch.config import DownsampleFSQConfig
from fish_speech_tpu_torch.device import device_constant
from fish_speech_tpu_torch.models.codec import fsq


def _linear(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x @ w + b in the wider of the two dtypes (float32 lattice sums
    against bf16 weights stay float32, as JAX promotes them)."""
    dtype = torch.promote_types(x.dtype, p["w"].dtype)
    out = x.to(dtype) @ p["w"].to(dtype)
    if p.get("b") is not None:
        out = out + p["b"].to(dtype)
    return out


def _scales(levels: Tuple[int, ...], num_quantizers: int) -> List[float]:
    """(levels[0] - 1)^-i per residual stage."""
    base = float(levels[0] - 1)
    return [base ** (-i) for i in range(num_quantizers)]


def residual_fsq_decode(indices: torch.Tensor, group_params: Dict,
                        levels: Tuple[int, ...], num_quantizers: int) -> torch.Tensor:
    """indices (B, T, Q) -> (B, T, dim_g); the lattice sum runs in float32."""
    scales = device_constant(tuple(_scales(levels, num_quantizers)), torch.float32,
                             indices.device)
    codes = fsq.indices_to_codes(indices, levels)  # (B, T, Q, d_cb)
    summed = torch.sum(codes * scales[None, None, :, None], dim=2)
    return _linear(summed, group_params["project_out"])


def grouped_decode(indices: torch.Tensor, params: List[Dict],
                   cfg: DownsampleFSQConfig) -> torch.Tensor:
    """indices (G, B, T, Q) -> (B, T, dim)."""
    return torch.cat([
        residual_fsq_decode(indices[g], params[g], cfg.levels, cfg.n_codebooks)
        for g in range(cfg.n_groups)
    ], dim=-1)
