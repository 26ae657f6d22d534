"""Device choice of the entry points, and moving parameter trees."""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """CUDA unless the caller asks otherwise; raises when CUDA is asked
    for and missing (there is no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def tree_to(tree, device):
    """Move every tensor of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def host_to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on `device`, queued behind the
    current stream's work without waiting for it. A copy from pageable
    memory waits for the stream to drain; this one stages the data in
    pinned memory, whose block PyTorch's host allocator does not reuse
    before the copy has run. Device tensors are only cast."""
    t = torch.as_tensor(array)
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor on `device`, made once per device and
    shared (callers never write it): made from host values at every call,
    it would be a copy that waits for the work queued on the card."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


class Fetch:
    """Device tensors copied to the host behind the work that makes them,
    on the current stream; `get` waits for those copies only, not for
    work launched after them."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        cuda = tensors[0].device.type == "cuda"
        self.host = [t.to("cpu", non_blocking=cuda) if cuda else t.clone() for t in tensors]
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]
