"""Parameters of the JAX package -> parameters of the port.

Both packages keep the same tree layout (stacked layers, (in, out)
linear weights, torch conv layouts), so conversion is a leaf-by-leaf
copy. The input is the JAX parameter tree with every leaf turned into a
numpy array (`jax.tree.map(np.asarray, params)`); bfloat16 arrays
(numpy dtype `bfloat16` from ml_dtypes) are carried bit for bit. A
`dtype=` casts floating-point leaves only; the int8-quantized stacks of
`ops/quant.py` ({"q": int8, "s": bfloat16}) keep both types whatever the
dtype, as the JAX package keeps them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:  # a quantized weight keeps its types
            return {k: tensor_from_numpy(v, device) for k, v in tree.items()}
        return {k: _convert(v, device, dtype) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    t = tensor_from_numpy(tree, device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def dual_ar_params_from_numpy(tree: Dict, device="cpu", dtype=None) -> Dict:
    """DualAR parameters (models/dual_ar.py layout), dense or with
    int8-quantized slow/fast stacks."""
    return _convert(tree, device, dtype)


def firefly_params_from_numpy(tree: Dict, device="cpu", dtype=None) -> Dict:
    """The whole Firefly tree: the encoder backbone, the quantizer's
    downsample and upsample stacks and residual-FSQ projections (in and
    out), and the HiFiGAN head."""
    return _convert(tree, device, dtype)


def mimi_params_from_numpy(tree: Dict, device="cpu", dtype=None) -> Dict:
    """The whole Mimi tree (models/codec/mimi.py layout): the SEANet
    encoder and decoder, both transformers, the split-RVQ codebooks and
    projections, the resampling convs. Entries that are None in the JAX
    tree (a conv without bias, an RVQ without projections) are left out."""
    return _convert(tree, device, dtype)
