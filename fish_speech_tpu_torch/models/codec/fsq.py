"""Finite Scalar Quantization: features to integer indices (encode) and
indices to normalised codes by mixed-radix arithmetic (decode, no
table). With levels (8, 5, 5, 5) the implicit codebook has 1000 entries.

The rounding is `torch.round`, half to even as `jnp.round` is."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.device import device_constant


def _basis(levels: Tuple[int, ...]) -> np.ndarray:
    """Mixed-radix basis [1, l0, l0*l1, ...]."""
    basis = np.ones(len(levels), dtype=np.float32)
    for i in range(1, len(levels)):
        basis[i] = basis[i - 1] * levels[i - 1]
    return basis


def indices_to_codes(indices: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """(...,) integer indices -> (..., d) float32 codes in [-1, 1]."""
    lv = device_constant(tuple(float(v) for v in levels), torch.float32, indices.device)
    basis = device_constant(tuple(_basis(levels).tolist()), torch.float32, indices.device)
    x = indices[..., None].float()
    noncentered = torch.floor(x / basis)
    noncentered = noncentered - torch.floor(noncentered / lv) * lv
    half_width = torch.floor(lv / 2.0)
    return (noncentered - half_width) / half_width


def _bound_constants(levels: Tuple[int, ...]):
    """(half_l, offset, shift), each computed in float32 numpy as the JAX
    package computes them in float32 (a float64 half_l rounds one ulp
    off at some levels)."""
    lv = np.asarray(levels, np.float32)
    half_l = (lv - np.float32(1)) * np.float32(1.001) / np.float32(2)
    offset = np.where(lv % 2 == 0, np.float32(0.5), np.float32(0)).astype(np.float32)
    shift = np.arctanh(offset / half_l).astype(np.float32)
    return tuple(tuple(a.tolist()) for a in (half_l, offset, shift))


def bound(z: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """tanh-bound z into the quantisation range, in float32: half the
    level count widened by 1.001; even levels are offset by 0.5, with an
    atanh pre-shift that centres the rounding grid."""
    dev = z.device
    half_l, offset, shift = (device_constant(c, torch.float32, dev)
                             for c in _bound_constants(tuple(levels)))
    return torch.tanh(z.float() + shift) * half_l - offset


def quantize(z: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """Round to the grid, normalised to [-1, 1]."""
    half_width = device_constant(tuple(float(lv // 2) for lv in levels), torch.float32, z.device)
    return torch.round(bound(z, levels)) / half_width


def codes_to_indices(codes: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """(..., d) normalised codes -> (...,) int32 indices."""
    dev = codes.device
    half_width = device_constant(tuple(float(lv // 2) for lv in levels), torch.float32, dev)
    basis = device_constant(tuple(_basis(levels).tolist()), torch.float32, dev)
    zhat = codes * half_width + half_width
    return torch.sum(zhat * basis, dim=-1).to(torch.int32)


def fsq_forward(z: torch.Tensor, levels: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise (B, T, d) -> (codes (B, T, d), indices (B, T) int32)."""
    codes = quantize(z, levels)
    return codes, codes_to_indices(codes, levels)
