"""ConvNeXt blocks and the encoder backbone of the Firefly codec (exact
erf GELU, as upstream)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.config import BackboneConfig, FishVersion
from fish_speech_tpu_torch.models.codec.conv import fish_conv1d
from fish_speech_tpu_torch.ops.norms import layer_norm, layer_norm_channels_first


def convnext_block(x: torch.Tensor, p: Dict, *, version: FishVersion,
                   kernel_size: int = 7, dilation: int = 1) -> torch.Tensor:
    """(B, C, T) -> (B, C, T): depthwise conv, LayerNorm, pointwise MLP,
    layer scale, residual."""
    dim = x.shape[1]
    pad_1_2 = round(dilation * (kernel_size - 1) / 2)
    h = fish_conv1d(x, p["dwconv"], dilation=dilation, groups=dim, version=version,
                    pad_1_2=pad_1_2)
    h = h.transpose(1, 2)  # (B, T, C)
    h = layer_norm(h, p["norm"]["w"], p["norm"]["b"], 1e-6)
    h = h @ p["pwconv1"]["w"] + p["pwconv1"]["b"]
    h = F.gelu(h.float(), approximate="none").to(h.dtype)
    h = h @ p["pwconv2"]["w"] + p["pwconv2"]["b"]
    if p.get("gamma") is not None:
        h = p["gamma"] * h
    return x + h.transpose(1, 2)


def convnext_encoder(x: torch.Tensor, p: Dict, cfg: BackboneConfig,
                     version: FishVersion) -> torch.Tensor:
    """(B, input_channels, T) -> (B, dims[-1], T): the stem (FishConvNet,
    channels-first LayerNorm at eps 1e-6, blocks), the mid stages
    (LayerNorm, 1x1 conv, blocks) and a final LayerNorm."""
    h = fish_conv1d(x, p["stem"]["conv"], version=version, pad_1_2=cfg.kernel_size // 2)
    h = layer_norm_channels_first(h, p["stem"]["norm"]["w"], p["stem"]["norm"]["b"], 1e-6)
    for bp in p["stem"]["blocks"]:
        h = convnext_block(h, bp, version=version, kernel_size=cfg.kernel_size)
    for mid in p["mid"]:
        h = layer_norm_channels_first(h, mid["norm"]["w"], mid["norm"]["b"], 1e-6)
        h = F.conv1d(h, mid["conv"]["w"], mid["conv"]["b"])
        for bp in mid["blocks"]:
            h = convnext_block(h, bp, version=version, kernel_size=cfg.kernel_size)
    return layer_norm_channels_first(h, p["final_norm"]["w"], p["final_norm"]["b"], 1e-6)
