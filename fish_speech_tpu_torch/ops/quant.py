"""Weight-only int8 quantization of the DualAR matmul stacks.

Counterpart of `fish_speech_tpu/ops/quant.py`, with the same layout, so
one converter serves both packages: each quantized weight is a dict
{"q": int8 (..., in, out), "s": bfloat16 (..., 1, out)}, one scale per
output column. Embeddings, norms and the heads stay unquantized.

The quantization is bit-equal to the JAX package's, on the CPU and on
the card: the scale is max|w| / 127 in float32 (at least 1e-8), q is
round-half-to-even(w / scale) with that float32 scale, clipped to
+-127, and only then is the scale stored as bfloat16.

`matmul` is the product every stack goes through: x @ q in x's dtype,
then the per-column rescale in x's dtype (two roundings in bf16). On the
card it stays a PyTorch product on the unfused paths (it converts q to
x's dtype on every call); the fused kernels take q and s as they are.
"""

from __future__ import annotations

from typing import Dict

import torch

QUANT_KEYS = ("wqkv", "wo", "w1", "w2", "w3")


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) float -> {"q": int8, "s": per-out-column bf16 scales}."""
    wf = w.float()
    # divide by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, which rounds otherwise than JAX's
    # (and the CPU's) true division
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax / torch.full((), 127.0, device=wf.device), min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def dequantize_weight(wq: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (wq["q"].float() * wq["s"].float()).to(dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain tensors or quantized {"q", "s"} dicts."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def quantize_lm_params(params: Dict) -> Dict:
    """A new parameter dict whose slow and fast matmul stacks are
    quantized; every other entry is shared with `params`."""
    out = dict(params)
    for stack in ("slow", "fast"):
        new_stack = dict(params[stack])
        for k in QUANT_KEYS:
            new_stack[k] = quantize_weight(params[stack][k])
        out[stack] = new_stack
    return out
