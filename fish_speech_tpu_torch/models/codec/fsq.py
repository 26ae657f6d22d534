"""Finite Scalar Quantization, decode half: integer indices to
normalised codes by mixed-radix arithmetic (no table)."""

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
