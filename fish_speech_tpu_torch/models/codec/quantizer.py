"""Downsampling FSQ quantizer. Encode: the strided-conv + ConvNeXt
downsample stack, then grouped residual FSQ to the (B, G*Q, T') integer
grid of the LM's codebook rows. Decode: the grouped residual FSQ lookup,
then the transposed-conv + ConvNeXt upsample stack."""

from __future__ import annotations

from typing import Dict

import torch

from fish_speech_tpu_torch.config import DownsampleFSQConfig, FishVersion
from fish_speech_tpu_torch.models.codec import grfsq
from fish_speech_tpu_torch.models.codec.conv import fish_conv1d, fish_conv_transpose1d
from fish_speech_tpu_torch.models.codec.convnext import convnext_block


def quantizer_encode(z: torch.Tensor, p: Dict, cfg: DownsampleFSQConfig,
                     version: FishVersion) -> torch.Tensor:
    """(B, dim, T) features -> (B, G*Q, T') int32 codes, laid out
    `g b l r -> b (g r) l`."""
    for i, factor in enumerate(cfg.downsample_factor):
        layer = p["downsample"][i]
        z = fish_conv1d(z, layer["conv"], stride=factor, version=version)
        z = convnext_block(z, layer["block"], version=version)
    _, indices = grfsq.grouped_forward(z.transpose(1, 2), p["rvqs"], cfg)  # (G, B, T', Q)
    g, b, t, q = indices.shape
    return indices.permute(1, 0, 3, 2).reshape(b, g * q, t)


def quantizer_decode(indices: torch.Tensor, p: Dict, cfg: DownsampleFSQConfig,
                     version: FishVersion) -> torch.Tensor:
    """(B, G*Q, T') codes -> (B, dim, T' * total_downsample) features.
    The FSQ lattice math runs in float32; the conv stack runs in the
    parameters' dtype. Checkpoint index order of the upsample stages is
    application order; stage i uses stride downsample_factor[i]."""
    b, _, t = indices.shape
    g, q = cfg.n_groups, cfg.n_codebooks
    grouped = indices.reshape(b, g, q, t).permute(1, 0, 3, 2)  # (G, B, T', Q)
    z = grfsq.grouped_decode(grouped, p["rvqs"], cfg)  # (B, T', dim)
    z = z.transpose(1, 2).to(p["upsample"][0]["conv"]["w"].dtype)
    for i, layer in enumerate(p["upsample"]):
        z = fish_conv_transpose1d(z, layer["conv"], stride=cfg.downsample_factor[i],
                                  version=version)
        z = convnext_block(z, layer["block"], version=version)
    return z
