"""Flash prefill attention: the CUDA kernel (`csrc/prefill_attention.cu`)
and its plain PyTorch version.

Counterpart of the TPU kernel `fish_speech_tpu/ops/prefill_pallas.py::
flash_prefill_attention`. Query i of row b sits at absolute position
offset + i; key j is visible iff j <= offset + i, offset + i - j <
window, j < offset + seq_lens[b] and j < E. Masked scores take the
finite NEG_INF, so no output is NaN.

Unlike `flash_prefill_supported` on the TPU, the kernel takes every
S_pad and E: there is no fallback to the plain version for CUDA tensors.
Its launch plan is `prefill_plan`, a function of (S_pad, E, H, KV, SM
count) only, mirrored here from `fs_prefill_plan`, and which CTA computes
which rows and key tiles is `cta_work`, mirrored from the kernel's index
arithmetic, so that the CPU tests can check the coverage; on a card both
are held against the built library's own (`plan_on_card`,
`cta_work_on_card`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from fish_speech_tpu_torch.ops import _cuda_build, launch_count
from fish_speech_tpu_torch.ops.attention import NEG_INF, causal_mask, gqa_attention

launches = 0  # kernels launched since the last reset (set to 0 to reset): two a call
# when the plan splits keys (the blocks, then the combine), else one

HEAD_DIM = 64
# the kernel's constants (csrc/prefill_attention.cu)
_WG_ROWS = 64  # M rows of a consumer warpgroup: q heads x queries
_NWG = 2  # consumer warpgroups a CTA
_BLOCK_N = 64  # keys a tile
_STAGES = 4  # K/V ring stages
_THREADS = 128 * _NWG + 32  # and the producer warp
_MAX_SPLITS = 8
_SMEM_BYTES = 1024 + _NWG * _WG_ROWS * HEAD_DIM * 2 + 2 * _STAGES * _BLOCK_N * HEAD_DIM * 2 + 8 * (
    2 * _STAGES + 1)
_PART_FLOATS = _NWG * _WG_ROWS * (HEAD_DIM + 2)


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """The launch of csrc/prefill_attention.cu: each CTA owns one (row,
    KV head, block of `queries` queries) with all of the KV head's q heads
    as its `rows`, walking key tiles of `block_n` through a ring of
    `stages`; a block's tiles are cut into chunks of `chunk`, one CTA of
    `splits` each, and the partials of a block of more than one chunk are
    combined by a second launch. Depends on shapes and the SM count only,
    never on the batch, offset, window or seq_lens."""

    queries: int
    qblocks: int
    splits: int
    chunk: int  # key tiles a split takes
    ctas: int  # CTAs a batch row
    rows: int = _NWG * _WG_ROWS
    block_n: int = _BLOCK_N
    stages: int = _STAGES
    threads: int = _THREADS
    smem: int = _SMEM_BYTES
    part_floats: int = _PART_FLOATS


def prefill_supported(n_head: int, n_kv: int) -> bool:
    """Whether the kernel takes this head grouping (any S_pad and E)."""
    return n_kv > 0 and n_head % n_kv == 0 and n_head // n_kv <= _WG_ROWS


@functools.lru_cache(maxsize=256)
def prefill_plan(s_pad: int, kv_len: int, n_head: int, n_kv: int, sms: int) -> PrefillPlan:
    """The plan `fs_prefill_plan` builds: G = H / KV q heads by 64 / G
    queries a warpgroup, two warpgroups a CTA; the chunk is the extent's
    tiles halved (at most 8 ways) until it is no longer than twice a CTA
    slot's share (2 x sms slots) of a full-length prompt's tiles at the
    end of the extent, and never below 4 tiles."""
    if not prefill_supported(n_head, n_kv) or s_pad <= 0 or kv_len <= 0:
        raise ValueError(f"prefill_plan: unsupported shape S_pad {s_pad}, E {kv_len}, "
                         f"H {n_head}, KV {n_kv}")
    queries = _NWG * (_WG_ROWS // (n_head // n_kv))
    qblocks = -(-s_pad // queries)
    tiles = -(-kv_len // _BLOCK_N)
    off0 = max(0, kv_len - s_pad)
    total = n_kv * sum(-(-min(kv_len, off0 + min(s_pad, (qb + 1) * queries)) // _BLOCK_N)
                       for qb in range(qblocks))
    target = 2 * max(2, -(-total // (2 * sms)))
    splits = 1
    while splits < _MAX_SPLITS and -(-tiles // splits) > target:
        splits *= 2
    return PrefillPlan(queries=queries, qblocks=qblocks, splits=splits,
                       chunk=-(-tiles // splits), ctas=n_kv * qblocks * splits)


def cta_work(plan: PrefillPlan, batch: int, n_kv: int, s_pad: int, kv_len: int, offset: int,
             seq_lens, window: int) -> list:
    """(row b, KV head g, query block, split, the block's first tile and
    tile count, the CTA's first tile and tile count) of each of the batch x
    plan.ctas CTAs, tile j covering keys [64 j, 64 j + 64): the longest
    query blocks first; a block's tiles run from its first query's window
    start to the last key its last (or padding) query sees, cut into
    chunks of plan.chunk, one a split."""
    per_qb = batch * n_kv * plan.splits
    work = []
    for cta in range(batch * plan.ctas):
        r = cta % per_qb
        b, g = r // (n_kv * plan.splits), (r // plan.splits) % n_kv
        qb, sp = plan.qblocks - 1 - cta // per_qb, r % plan.splits
        q0 = qb * plan.queries
        lim = min(kv_len, offset + int(seq_lens[b]))
        key_begin = max(0, offset + q0 - window + 1)
        key_end = min(lim, offset + min(q0 + plan.queries, s_pad))
        t0 = key_begin // plan.block_n
        n = -(-key_end // plan.block_n) - t0 if key_end > key_begin else 0
        ts = t0 + min(n, sp * plan.chunk)
        work.append((b, g, qb, sp, t0, n, ts, t0 + min(n, (sp + 1) * plan.chunk) - ts))
    return work


def plan_on_card(s_pad: int, kv_len: int, n_head: int, n_kv: int, sms: int) -> PrefillPlan:
    """The plan as the built kernel computes it (`fs_prefill_plan`)."""
    lib = _cuda_build.load_library()
    out = (ctypes.c_int * 11)()
    _cuda_build.check(lib.fs_prefill_plan(s_pad, kv_len, n_head, n_kv, sms, out),
                      "fs_prefill_plan")
    return PrefillPlan(*out)


def cta_work_on_card(s_pad: int, kv_len: int, n_head: int, n_kv: int, sms: int, offset: int,
                     seq_lens, window: int) -> list:
    """`cta_work` as the built kernel's own index arithmetic computes it
    (`fs_prefill_cta_work`)."""
    lib = _cuda_build.load_library()
    plan = plan_on_card(s_pad, kv_len, n_head, n_kv, sms)
    lens = (ctypes.c_int * len(seq_lens))(*(int(n) for n in seq_lens))
    out = (ctypes.c_int * (8 * len(seq_lens) * plan.ctas))()
    _cuda_build.check(lib.fs_prefill_cta_work(s_pad, kv_len, n_head, n_kv, sms, len(seq_lens),
                                              offset, window, lens, out), "fs_prefill_cta_work")
    return [tuple(out[8 * x:8 * x + 8]) for x in range(len(seq_lens) * plan.ctas)]


def prefill_mask(s_pad: int, kv_len: int, offset: int, seq_lens, window: int):
    """Additive float32 mask (B, 1, S_pad, kv_len) of the prefill rule."""
    device = seq_lens.device
    causal = causal_mask(s_pad, kv_len, window, offset, device)  # (1, 1, S_pad, E)
    k_pos = torch.arange(kv_len, device=device)
    k_valid = k_pos[None, :] < (offset + seq_lens.long()[:, None])  # (B, E)
    return torch.where(k_valid[:, None, None, :], causal,
                       torch.full((), NEG_INF, device=device))


def prefill_attention_plain(q, k, v, offset: int, seq_lens, window: int):
    """q (B, H, S_pad, hd), k/v (B, KV, E, hd), seq_lens (B,) int ->
    (B, H, S_pad, hd)."""
    mask = prefill_mask(q.shape[2], k.shape[2], offset, seq_lens, window)
    return gqa_attention(q, k, v, mask, 1.0 / q.shape[-1] ** 0.5)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def prefill_attention(q, k, v, offset: int, seq_lens, window: int):
    """Same contract as `prefill_attention_plain`. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise. k and v may
    be strided views of the cache (rows of hd contiguous elements)."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, offset, seq_lens, window)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    lib = _cuda_build.load_library()
    _check(q, k, v, seq_lens)
    bsz, h, s_pad, hd = q.shape
    kv, e = k.shape[1], k.shape[2]
    sms = _sm_count(q.device.index)
    plan = prefill_plan(s_pad, e, h, kv, sms)
    out = torch.empty_like(q)
    launched = ctypes.c_int(0)
    scratch = None
    if plan.splits > 1:
        scratch = torch.empty(bsz * plan.ctas * plan.part_floats, dtype=torch.float32,
                              device=q.device)
    rc = lib.fs_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), bsz, h, kv, s_pad, e, k.stride(0),
        k.stride(1), int(offset), int(window), 1.0 / hd**0.5, sms,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(launched),
    )
    launch_count.add(__name__, launches=launched.value)
    _cuda_build.check(rc, "fs_prefill_attention")
    return out


def _check(q, k, v, seq_lens):
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"prefill_attention: {name} must be bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"prefill_attention: {name} must be 16-byte aligned")
    for name, t in {"k": k, "v": v, "seq_lens": seq_lens}.items():
        if t.device != q.device:
            raise ValueError(f"prefill_attention: {name} is on {t.device}, q on {q.device}")
    if seq_lens.dtype != torch.int32 or not seq_lens.is_contiguous():
        raise TypeError("prefill_attention: seq_lens must be contiguous int32")
    if not q.is_contiguous():
        raise ValueError("prefill_attention: q must be contiguous")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(
            f"prefill_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
            " (k and v must share shape and strides)"
        )
    bsz, h, _, hd = q.shape
    kb, kv, _, khd = k.shape
    if hd != HEAD_DIM or khd != HEAD_DIM:
        raise ValueError(f"prefill_attention: head_dim must be {HEAD_DIM}, got {hd}/{khd}")
    if kb != bsz or not prefill_supported(h, kv) or tuple(seq_lens.shape) != (bsz,):
        raise ValueError(
            f"prefill_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"seq_lens {tuple(seq_lens.shape)}"
        )
    if k.stride(3) != 1 or k.stride(2) != HEAD_DIM or k.stride(1) % 8 or k.stride(0) % 8:
        raise ValueError(f"prefill_attention: unsupported k/v strides {k.stride()}")
