"""Decode attention with an in-place KV-cache write: the CUDA kernel
(`csrc/decode_attention.cu`) and its plain PyTorch version.

Counterpart of the TPU kernel `fish_speech_tpu/ops/attention_pallas.py::
fused_decode_attention`. Unlike the JAX function, which returns new
caches, both versions here update `ck`/`cv` in place and return attn.
"""

from __future__ import annotations

import dataclasses

import torch

from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops.attention import decode_mask, gqa_attention

launches = 0  # kernel launches since the last reset (set to 0 to reset)

HEAD_DIM = 64
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
MAX_GROUP = 8  # query heads per KV head the kernel takes (1, 2, 4 or 8)
# the kernel's constants (csrc/decode_attention.cu)
_THREADS = 256
_WARPS = _THREADS // 32
_TILE = 32  # keys a block step
_MAX_STEPS = 16  # tiles a rank takes
_MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The launch of csrc/decode_attention.cu for a cache of length S:
    `cluster` blocks per (row, KV head), each taking key tiles of 32
    keys round-robin. A function of S alone: never of the batch or of
    pos, so a row's sums run in one order whatever its co-tenants and a
    CUDA graph can hold the launch."""

    cluster: int
    max_cache: int  # the longest cache the plan takes

    def blocks(self, batch: int, kv_heads: int) -> int:
        return batch * kv_heads * self.cluster


def decode_plan(cache_len: int) -> DecodePlan:
    """P = the power of two >= ceil(S / 128), at most 8: 4 blocks a (row,
    KV head) at the serving cache of 512, 8 at 4096."""
    cluster = 1
    while cluster < _MAX_CLUSTER and cluster * 128 < cache_len:
        cluster *= 2
    return DecodePlan(cluster=cluster, max_cache=cluster * _TILE * _MAX_STEPS)


def decode_smem_bytes(group: int) -> int:
    """Static shared memory of one block: the warps' per-head max and sum,
    the cluster's per-head max and sum slots and the PV partials, sized
    by the group, not by S."""
    return 4 * (2 * _WARPS * group + 2 * _MAX_CLUSTER * group + _WARPS * group * HEAD_DIM
                + group * HEAD_DIM)


def decode_supported(cache_len: int, group: int) -> bool:
    """Whether the kernel takes a cache of this length at this group."""
    return group in (1, 2, 4, MAX_GROUP) and cache_len <= decode_plan(cache_len).max_cache


def decode_attention_plain(q, k_new, v_new, pos, ck, cv, layer: int):
    """q (B, H, hd), k_new/v_new (B, KV, hd), pos (B,) int, ck/cv
    (L, B, KV, S, hd). Writes k_new/v_new at [layer, b, :, pos[b]] and
    returns attn (B, H, hd) over positions 0..pos[b]."""
    rows = torch.arange(q.shape[0], device=q.device)
    pos = pos.long()
    ck[layer, rows, :, pos, :] = k_new.to(ck.dtype)
    cv[layer, rows, :, pos, :] = v_new.to(cv.dtype)
    mask = decode_mask(ck.shape[3], pos[:, None, None, None] + 1, q.device)
    attn = gqa_attention(
        q[:, :, None, :], ck[layer], cv[layer], mask, 1.0 / q.shape[-1] ** 0.5
    )
    return attn[:, :, 0, :]


def decode_attention(q, k_new, v_new, pos, ck, cv, layer: int):
    """Same contract as `decode_attention_plain`. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, pos, ck, cv, layer)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    lib = _cuda_build.load_library()
    bsz, h, hd = q.shape
    n_layer, _, kv, s, _ = ck.shape
    _check(q, k_new, v_new, pos, ck, cv, layer)
    group = h // kv
    if not decode_supported(s, group):
        raise ValueError(
            f"decode_attention: the kernel takes groups of 1, 2, 4 or {MAX_GROUP} query "
            f"heads and caches of at most {decode_plan(s).max_cache}; got group {group}, "
            f"cache length {s}"
        )
    out = torch.empty_like(q)
    rc = lib.fs_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(),
        ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
        bsz, h, kv, s, n_layer, int(layer), decode_plan(s).cluster, 1.0 / hd**0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _cuda_build.check(rc, "fs_decode_attention")
    global launches
    launches += 1
    return out


def decode_attention_sharded(q, k_new, v_new, pos, ck, cv, layer: int, *, heads, tp: int):
    """Decode attention on one rank's rows and heads: the counterpart of
    `fused_decode_attention_sharded` (attention_pallas.py:148), which
    shard_maps the TPU kernel over a (dp, tp) mesh. Here each rank's
    process holds only its shard, so the arguments are local: q (B_local,
    H / tp, hd), caches (L, B_local, KV / tp, S, hd). heads: the model's
    (H, KV). Raises, as JAX asserts, where tp does not divide them; the
    kernel itself needs no communication."""
    h, kv = heads
    if h % tp or kv % tp:
        raise ValueError(f"decode_attention_sharded: heads ({h} q, {kv} kv) not divisible "
                         f"by tp={tp}")
    if q.shape[1] != h // tp or ck.shape[2] != kv // tp:
        raise ValueError(f"decode_attention_sharded: q {tuple(q.shape)} and cache "
                         f"{tuple(ck.shape)} are not one rank's {h // tp} q and {kv // tp} "
                         "KV heads")
    return decode_attention(q, k_new, v_new, pos, ck, cv, layer)


def _check(q, k_new, v_new, pos, ck, cv, layer):
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "ck": ck, "cv": cv}
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: {name} must be bfloat16, got {t.dtype}")
    for name, t in {**tensors, "pos": pos}.items():
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, got {pos.dtype}")
    bsz, h, hd = q.shape
    if ck.dim() != 5 or ck.shape != cv.shape:
        raise ValueError(f"decode_attention: caches {tuple(ck.shape)} / {tuple(cv.shape)}")
    n_layer, cb, kv, _, chd = ck.shape
    if hd != HEAD_DIM or chd != HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim must be {HEAD_DIM}, got {hd}/{chd}")
    if cb != bsz or h % kv or tuple(k_new.shape) != (bsz, kv, hd) \
            or k_new.shape != v_new.shape or tuple(pos.shape) != (bsz,):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
            f"v_new {tuple(v_new.shape)}, pos {tuple(pos.shape)}, cache {tuple(ck.shape)}"
        )
    if not 0 <= int(layer) < n_layer:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {n_layer})")
